// K5: fused polyphase rational resample -> FIR, f32, with the gain folded
// into the FIR taps by the caller:
//
//   t_g = g*D - offset,  o_g = (-t_g) mod I,  i_g = (t_g + o_g) / I
//   yr[g] = sum_k T[o_g, k] * v[start + i_g + k],   v = concat(hist, x)
//   y[m]  = sum_j taps[j] * yr[m + j]
//
// Replaces the TPU kernel sdr_tpu/kernels/backhalf_pallas.py:
// resample_fir_gain (pl.pallas_call at :213, body _kernel :128).
//
// Bound on an H100: memory.  On the stereo chain's block-parallel batch
// (32 rows x 2 channels of 655,360 + H f32 samples, 3/10 with 31 taps,
// 64-tap FIR) it reads 167.8 MB and writes 50.3 MB: about 0.065 ms at
// 3.35 TB/s.  The arithmetic, 2 * (11 + 64) FLOP per output, takes about
// 0.028 ms at the f32 rate of 67 TFLOP/s.
//
// Design: the TPU kernel is two chained banded matmuls per row tile, its
// first stage extended past the tile so the grid needs no carry.  Here one
// CUDA block computes a tile of TILE consecutive outputs of one row:
// * stage 1 computes the tile's TILE + Kf - 1 resampled values from the
//   closed-form phase into shared memory, reading the stream through two
//   pointers (history, block), so the intermediate never reaches device
//   memory and no concatenated copy is made; reads past the end of the
//   stream read zero, as K2 does;
// * stage 2 runs the FIR out of shared memory, one thread per output.
// Every (I, D, offset, start, num) is covered: no lane-aligned plan and no
// ragged-tail path.  Both sums run in tap order, each product and sum one
// rounded operation (no FMA contraction), exactly as K2 then K3 compute
// them, so the output equals the unfused pair and the plain PyTorch
// version bitwise, whatever the grid.  Each block recomputes the Kf - 1
// resampled values it shares with the next tile (25% extra stage-1 work
// at TILE 256).  No atomics.

#include <cuda_runtime.h>

namespace {

constexpr int TILE = 256;

__global__ void __launch_bounds__(TILE)
backhalf_kernel(const float* __restrict__ x, const float* __restrict__ hist,
                const float* __restrict__ table,
                const float* __restrict__ taps, float* __restrict__ y,
                long long n, int H, int I, int D, int Kp, int Kf, int offset,
                long long start, long long num) {
  extern __shared__ float smem[];
  float* s_table = smem;                 // [I, Kp]
  float* s_taps = s_table + I * Kp;      // [Kf]
  float* s_yr = s_taps + Kf;             // [TILE + Kf - 1]
  for (int k = threadIdx.x; k < I * Kp; k += TILE) s_table[k] = table[k];
  for (int k = threadIdx.x; k < Kf; k += TILE) s_taps[k] = taps[k];
  __syncthreads();

  const long long row = blockIdx.y;
  const long long m0 = static_cast<long long>(blockIdx.x) * TILE;
  const long long len = H + n;
  const float* xr = x + row * n;
  const float* hr = hist + row * H;
  const int ng = static_cast<int>(min(static_cast<long long>(TILE),
                                      num - m0)) + Kf - 1;
  for (int g = threadIdx.x; g < ng; g += TILE) {
    const long long t = (m0 + g) * D - offset;
    const long long o = ((-t) % I + I) % I;
    const long long base = start + (t + o) / I;
    const float* T = s_table + o * Kp;
    float acc = 0.f;
    for (int k = 0; k < Kp; ++k) {
      const long long p = base + k;
      const float v = p < H ? hr[p] : (p < len ? __ldg(xr + (p - H)) : 0.f);
      acc = __fadd_rn(acc, __fmul_rn(T[k], v));
    }
    s_yr[g] = acc;
  }
  __syncthreads();

  const long long m = m0 + threadIdx.x;
  if (m >= num) return;
  const float* w = s_yr + threadIdx.x;
  float acc = 0.f;
  for (int j = 0; j < Kf; ++j) acc = __fadd_rn(acc, __fmul_rn(s_taps[j], w[j]));
  y[row * num + m] = acc;
}

}  // namespace

// x [rows, n] f32, hist [rows, H] f32, table [I, Kp] f32, taps [Kf] f32 ->
// y [rows, num] f32
extern "C" int launch_backhalf(const void* x, const void* hist,
                               const void* table, const void* taps, void* y,
                               long long rows, long long n, int H, int I,
                               int D, int Kp, int Kf, int offset,
                               long long start, long long num, void* stream) {
  const long long smem = sizeof(float) * (static_cast<long long>(I) * Kp +
                                          Kf + TILE + Kf - 1);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        backhalf_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 grid(static_cast<unsigned>((num + TILE - 1) / TILE),
                  static_cast<unsigned>(rows));
  backhalf_kernel<<<grid, TILE, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(hist),
      static_cast<const float*>(table), static_cast<const float*>(taps),
      static_cast<float*>(y), n, H, I, D, Kp, Kf, offset, start, num);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* kernel_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}

// This library links its own CUDA runtime, whose current device is not
// PyTorch's: the wrapper selects the tensors' device before each launch.
extern "C" int kernel_set_device(int device) {
  return static_cast<int>(cudaSetDevice(device));
}
