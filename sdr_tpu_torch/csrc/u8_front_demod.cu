// K1: fused u8 IQ -> (x - 128) -> K-tap decimate-by-f (exact int32) ->
// FM demod (polynomial atan2 of x[m] * conj(x[m-1])).
//
// Replaces the TPU kernel sdr_tpu/kernels/u8_front_demod_pallas.py:
// u8_front_demod_pallas (pl.pallas_call at :112, body _demod_kernel :73).
//
// Bound on an H100: memory.  On the FM chain's block-parallel batch
// (32 rows of 10,485,760 u8 bytes, K = 51, f = 8) it reads 335.5 MB and
// writes 84 MB: about 0.125 ms at 3.35 TB/s.  The integer work, 2 * K
// multiply-adds per output and plane, is far below the card's rate.
//
// Design:
// * One CUDA block per tile of TILE consecutive outputs of one row.  The
//   block copies the tile's input window into shared memory once, so each
//   input byte is read from device memory about once, and every thread
//   then reads its own window (I and Q bytes as one 16-bit word) there.
//   The window loading and the integer sums are K4's too (u8_window.cuh).
// * A row's stream is concat(hist, x): byte p < H comes from the row's
//   H-byte history, the rest from its block.  Reading through the two
//   pointers covers every output; no concatenated copy is ever made.
// * The TPU kernel passes the previous tile's last sample through VMEM
//   scratch, because its grid runs in order.  CUDA blocks run in no order,
//   so each block recomputes the sample before its first output from its
//   own window; the first tile of a row takes it from the carry last_iq.
// * Every output is an independent int32 dot product, one f32 epilogue
//   multiply and the atan2 polynomial, each step one rounded operation
//   (no FMA contraction), so a sample does not depend on the tile or grid
//   that computed it and equals the plain PyTorch version bitwise.  No
//   atomics.
// * The block that holds a row's last output writes its (I, Q) as the
//   row's next carry.

#include <cuda_runtime.h>
#include <stdint.h>

#include "u8_window.cuh"

namespace {

using u8w::align16;
using u8w::front_sample;

constexpr int TILE = 256;

__device__ __forceinline__ float poly_atan2(float b, float a) {
  // sdr_tpu/ops/demod.py:fast_atan2; coefficients rounded to f32 as
  // numpy rounds them (double literal, then float)
  const float ab = fabsf(b), aa = fabsf(a);
  const float hi = fmaxf(aa, ab);
  const float z = __fdiv_rn(fminf(aa, ab), hi == 0.f ? 1.f : hi);
  const float z2 = __fmul_rn(z, z);
  float p = static_cast<float>(0.00809729493);
  p = __fadd_rn(__fmul_rn(p, z2), static_cast<float>(-0.0377517076));
  p = __fadd_rn(__fmul_rn(p, z2), static_cast<float>(0.0847596977));
  p = __fadd_rn(__fmul_rn(p, z2), static_cast<float>(-0.135376751));
  p = __fadd_rn(__fmul_rn(p, z2), static_cast<float>(0.198950258));
  p = __fadd_rn(__fmul_rn(p, z2), static_cast<float>(-0.33327976));
  p = __fadd_rn(__fmul_rn(p, z2), static_cast<float>(0.999999715));
  float r = __fmul_rn(p, z);
  if (ab > aa) r = __fsub_rn(static_cast<float>(1.5707963267948966), r);
  if (a < 0.f) r = __fsub_rn(static_cast<float>(3.141592653589793), r);
  return b < 0.f ? -r : r;
}

__global__ void __launch_bounds__(TILE)
u8_front_demod_kernel(const uint8_t* __restrict__ x,
                      const uint8_t* __restrict__ hist,
                      const float* __restrict__ last_iq,
                      const int32_t* __restrict__ taps,
                      float* __restrict__ y, float* __restrict__ iq_out,
                      long long n, int H, int K, int f, long long num,
                      float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  int32_t* s_taps = reinterpret_cast<int32_t*>(smem);
  float2* s_iq = reinterpret_cast<float2*>(smem + align16(4LL * K));
  unsigned char* s_win = smem + align16(4LL * K) + 8LL * (TILE + 1);

  const long long row = blockIdx.y;
  const long long m0 = static_cast<long long>(blockIdx.x) * TILE;
  const long long m_end = min(m0 + TILE, num);
  const int t = threadIdx.x;
  // the window covers the predecessor of m0 (if any) through m_end - 1
  const long long pb = 2LL * (m0 > 0 ? m0 - 1 : 0) * f;
  const long long pe = 2LL * ((m_end - 1) * f + K);
  const uint8_t* xr = x + row * n;
  const uint8_t* hr = hist + row * H;
  for (int k = t; k < K; k += TILE) s_taps[k] = taps[k];
  u8w::load_window(s_win, hr, xr, H, pb, pe);
  __syncthreads();

  const unsigned short* w16 = reinterpret_cast<const unsigned short*>(s_win);
  const long long m = m0 + t;
  if (m < m_end)
    s_iq[t + 1] = front_sample(w16 + (m * f - pb / 2), s_taps, K, scale);
  if (t == 0)
    s_iq[0] = m0 > 0
        ? front_sample(w16 + ((m0 - 1) * f - pb / 2), s_taps, K, scale)
        : make_float2(last_iq[2 * row], last_iq[2 * row + 1]);
  __syncthreads();

  if (m < m_end) {
    const float2 c = s_iq[t + 1], p = s_iq[t];
    const float b = __fsub_rn(__fmul_rn(c.y, p.x), __fmul_rn(c.x, p.y));
    const float a = __fadd_rn(__fmul_rn(c.x, p.x), __fmul_rn(c.y, p.y));
    y[row * num + m] = poly_atan2(b, a);
    if (m == num - 1) {
      iq_out[2 * row] = c.x;
      iq_out[2 * row + 1] = c.y;
    }
  }
}

// taps, (I, Q) of the tile and its predecessor, and the byte window
long long smem_bytes(int K, int f) {
  return align16(4LL * K) + 8LL * (TILE + 1) + 2LL * (TILE * f + K);
}

}  // namespace

// x [rows, n] u8, hist [rows, H] u8, last_iq [rows, 2] f32, taps [K] i32
// -> y [rows, num] f32, iq_out [rows, 2] f32.  The caller checks that
// every window lies inside concat(hist, x).
extern "C" int launch_u8_front_demod(const void* x, const void* hist,
                                     const void* last_iq, const void* taps,
                                     void* y, void* iq_out, long long rows,
                                     long long n, int H, int K, int f,
                                     long long num, float scale,
                                     void* stream) {
  const long long smem = smem_bytes(K, f);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        u8_front_demod_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 grid(static_cast<unsigned>((num + TILE - 1) / TILE),
                  static_cast<unsigned>(rows));
  u8_front_demod_kernel<<<grid, TILE, smem,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(x), static_cast<const uint8_t*>(hist),
      static_cast<const float*>(last_iq), static_cast<const int32_t*>(taps),
      static_cast<float*>(y), static_cast<float*>(iq_out), n, H, K, f, num,
      scale);
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
