// K2: polyphase rational resampler over concat(hist, x), f32.
//
//   t_m = m*D - offset,  o_m = (-t_m) mod I,  i_m = (t_m + o_m) / I
//   y[m] = sum_k T[o_m, k] * v[start + i_m + k],   v = concat(hist, x)
//
// Replaces the TPU kernel sdr_tpu/kernels/resample_pallas.py:resample_band
// (pl.pallas_call at :156, body _kernel :109).
//
// Bound on an H100: memory.  At the FM chain's 3/10 stage (31 taps, 11 per
// phase) on the block-parallel batch it reads 84 MB and writes 25 MB of
// f32: about 0.033 ms at 3.35 TB/s; 2 * 11 FLOP per output is a fraction
// of a percent of the f32 rate.
//
// Design: the TPU form is a lane-aligned banded matmul for the MXU, which
// applies only to some geometries (resample_band returns None otherwise)
// and sends ragged tails to a gather path.  Here each thread computes one
// output directly from the closed form, so every (K, I, D, offset, start,
// num) is covered by the one kernel.  Neighbouring outputs read
// overlapping windows about D/I samples apart, which L1 serves.  The
// phase table lives in shared memory.  A row's stream is read through two
// pointers (history, block), so no concatenated copy is made; reads past
// the end of the stream read zero, as the JAX gather path pads.  The sum
// runs in tap order, each product and sum one rounded operation (no FMA
// contraction), so an output does not depend on the grid and equals the
// plain PyTorch version bitwise.  No atomics.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;

__global__ void __launch_bounds__(THREADS)
resample_kernel(const float* __restrict__ x, const float* __restrict__ hist,
                const float* __restrict__ table, float* __restrict__ y,
                long long n, int H, int I, int D, int Kp, int offset,
                long long start, long long num) {
  extern __shared__ float s_table[];
  for (int k = threadIdx.x; k < I * Kp; k += THREADS) s_table[k] = table[k];
  __syncthreads();
  const long long m = static_cast<long long>(blockIdx.x) * THREADS +
                      threadIdx.x;
  if (m >= num) return;
  const long long row = blockIdx.y;
  const long long t = m * D - offset;
  const long long o = ((-t) % I + I) % I;
  const long long base = start + (t + o) / I;
  const long long len = H + n;
  const float* xr = x + row * n;
  const float* hr = hist + row * H;
  const float* T = s_table + o * Kp;
  float acc = 0.f;
  for (int k = 0; k < Kp; ++k) {
    const long long p = base + k;
    const float v = p < H ? hr[p] : (p < len ? __ldg(xr + (p - H)) : 0.f);
    acc = __fadd_rn(acc, __fmul_rn(T[k], v));
  }
  y[row * num + m] = acc;
}

}  // namespace

// x [rows, n] f32, hist [rows, H] f32, table [I, Kp] f32 -> y [rows, num]
extern "C" int launch_resample(const void* x, const void* hist,
                               const void* table, void* y, long long rows,
                               long long n, int H, int I, int D, int Kp,
                               int offset, long long start, long long num,
                               void* stream) {
  const dim3 grid(static_cast<unsigned>((num + THREADS - 1) / THREADS),
                  static_cast<unsigned>(rows));
  const size_t smem = sizeof(float) * I * Kp;
  resample_kernel<<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(hist),
      static_cast<const float*>(table), static_cast<float*>(y), n, H, I, D,
      Kp, offset, start, num);
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
