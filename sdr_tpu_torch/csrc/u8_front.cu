// K4: u8 IQ -> (x - 128) -> K-tap decimate-by-f (exact int32) -> planar
// f32 I and Q:
//
//   y[c, m] = scale * sum_k Tq[k] * (v[start + 2(m*f + k) + c] - 128)
//
// over a row's stream v = concat(hist, x), c = 0 (I) and 1 (Q).
//
// Replaces the TPU kernel sdr_tpu/kernels/u8_front_pallas.py:
// u8_front_pallas (pl.pallas_call at :166, body _kernel :141, sums in
// band_acc :125).
//
// Bound on an H100: memory.  On the stereo chain's block-parallel batch
// (32 rows of 10,485,760 u8 bytes, K = 51, f = 8) it reads 335.5 MB and
// writes 167.8 MB: about 0.150 ms at 3.35 TB/s.  The integer work, 2 * K
// multiply-adds per output and plane, is far below the card's rate.
//
// Design: K1's without the demod (the window loading and integer sums are
// the same code, u8_window.cuh).
// * The TPU kernel forms the windows as a banded int8 matmul for the MXU
//   (two bands for 16-bit taps) over a reshaped input.  Here one CUDA
//   block computes a tile of TILE consecutive outputs of one row: it
//   copies the tile's byte window into shared memory once, and each
//   thread sums its own output's window there.  16-bit taps are one int32
//   per tap, so s8 and s16 plans run the same code.
// * The stream is read through two pointers (history, block), and any
//   byte offset `start` moves the windows, so neither a seam split nor a
//   concatenated or sliced copy of the block is ever made.
// * Every output is an independent int32 dot product and one rounded f32
//   multiply, so it equals the plain PyTorch version bitwise whatever the
//   grid.  No atomics.

#include <cuda_runtime.h>
#include <stdint.h>

#include "u8_window.cuh"

namespace {

constexpr int TILE = 256;

__global__ void __launch_bounds__(TILE)
u8_front_kernel(const uint8_t* __restrict__ x,
                const uint8_t* __restrict__ hist,
                const int32_t* __restrict__ taps, float* __restrict__ y,
                long long n, int H, int K, int f, long long start,
                long long num, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  int32_t* s_taps = reinterpret_cast<int32_t*>(smem);
  unsigned char* s_win = smem + u8w::align16(4LL * K);

  const long long row = blockIdx.y;
  const long long m0 = static_cast<long long>(blockIdx.x) * TILE;
  const long long m_end = min(m0 + TILE, num);
  const long long pb = start + 2LL * m0 * f;
  const long long pe = start + 2LL * ((m_end - 1) * f + K);
  for (int k = threadIdx.x; k < K; k += TILE) s_taps[k] = taps[k];
  u8w::load_window(s_win, hist + row * H, x + row * n, H, pb, pe);
  __syncthreads();

  const long long m = m0 + threadIdx.x;
  if (m < m_end) {
    const unsigned short* w16 =
        reinterpret_cast<const unsigned short*>(s_win);
    const float2 s = u8w::front_sample(w16 + (m - m0) * f, s_taps, K, scale);
    y[2 * row * num + m] = s.x;
    y[(2 * row + 1) * num + m] = s.y;
  }
}

// taps and the byte window of one tile
long long smem_bytes(int K, int f) {
  return u8w::align16(4LL * K) + 2LL * ((TILE - 1) * f + K);
}

}  // namespace

// x [rows, n] u8, hist [rows, H] u8, taps [K] i32 -> y [rows, 2, num] f32.
// The caller checks that every window lies inside concat(hist, x).
extern "C" int launch_u8_front(const void* x, const void* hist,
                               const void* taps, void* y, long long rows,
                               long long n, int H, int K, int f,
                               long long start, long long num, float scale,
                               void* stream) {
  const long long smem = smem_bytes(K, f);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        u8_front_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 grid(static_cast<unsigned>((num + TILE - 1) / TILE),
                  static_cast<unsigned>(rows));
  u8_front_kernel<<<grid, TILE, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(x), static_cast<const uint8_t*>(hist),
      static_cast<const int32_t*>(taps), static_cast<float*>(y), n, H, K, f,
      start, num, scale);
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
