// K3: strided FIR, f32:  y[i] = sum_j taps[j] * x[start + i*f + j],
// leading dimensions batched as rows.
//
// Replaces the TPU kernel sdr_tpu/kernels/fir_pallas.py:fir_strided
// (pl.pallas_call at :125, body _kernel :62).
//
// Bound on an H100.  Bytes: the FM chain's 64-tap audio filter (volume
// folded into the taps) on the block-parallel batch reads and writes 25 MB
// of f32 each, about 0.015 ms at 3.35 TB/s; StereoDecode's 65-tap filters
// move 84 MB each way, 0.050 ms.  The order this kernel keeps (below)
// sets a higher floor: 2 * K separate f32 instructions per output, at 132
// SMs x 128 lanes x 1.98 GHz (3.3e13 a second) 0.024 ms for the audio
// filter (6.29 M outputs x 64 taps x 2 = 8.1e8) and 0.082 ms at 65 taps
// (20.97 M x 65 x 2 = 2.73e9).  FMA would halve it but round once where
// the plain version rounds twice.
//
// Design (f == 1, the paths' case):
// * Tiles of TILE = 3072 consecutive outputs of a row.  A tile's input
//   span [start + m0, start + m0 + TILE + K - 1) is staged in shared memory
//   by cp.async: 16-byte copies for the chunks that lie in x, 4-byte ones
//   at the tensor's two ends.  A row base is generally not 16-byte aligned
//   (the mono rows hold 196,671 floats), so the span is staged at its
//   device address mod 16 (OFF, 0 to 3 floats) and the compute is
//   instantiated for each OFF, which the block selects per tile.
// * Persistent, double-buffered: as many blocks as fit on the card at
//   once walk the tiles; each issues the copies of its next tile before it
//   computes the current one, so every block keeps a tile's bytes in
//   flight while it computes.  The taps go to shared memory once per
//   block.
// * Register tiling (fir_tile.cuh, shared with K5's second stage): thread
//   t computes G = 3 groups of R = 4 consecutive outputs from a ring of
//   float4s in registers, 4/48 shared-memory reads a product, no bank
//   conflict.  The paths' tap counts (64, 65) are compiled with the tap
//   loop unrolled.
// * Each output's sum runs in tap order, each product and sum one rounded
//   operation (__fmul_rn, __fadd_rn: no FMA contraction), from +0, so an
//   output does not depend on the tile or grid and equals the plain
//   PyTorch version bitwise.  No atomics.
// f > 1 (the AM and channelizer decimators): one thread per output reads
// its window through the read-only cache, the taps in shared memory.
//
// Shared memory (`plan`): f == 1 takes the taps padded to a multiple of 4
// (kp floats) and two staging buffers of buf_floats(K) = TILE + kp + 8
// floats (up to 3 floats of alignment, the TILE + K - 1 of the span, and
// the last float4s the register ring reads past it); f > 1 takes the K
// taps.  At an H100 block's 232,448 bytes that is K <= 17,316 at f == 1
// and K <= 58,112 above; more taps return kTooManyTaps.

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

#include "fir_tile.cuh"
#include "persistent.cuh"

namespace {

using namespace fir_tile;
using persistent::cp_async16;
using persistent::cp_async4;
using persistent::tile_origin;

// Issue the copies of tile `it`'s span into xs (staged from xs[off] on);
// returns off.  [xb, xe) is the whole tensor x.
__device__ __forceinline__ int stage(float* xs, const float* __restrict__ x,
                                    const float* xb, const float* xe,
                                    long long n, long long num, int K,
                                    long long start, int tile,
                                    long long tiles_per_row, long long it) {
  long long row, m0;
  tile_origin(it, tiles_per_row, tile, &row, &m0);
  const int span = static_cast<int>(min(static_cast<long long>(tile),
                                        num - m0)) + K - 1;
  const float* src = x + row * n + start + m0;
  const int off =
      static_cast<int>((reinterpret_cast<uintptr_t>(src) >> 2) & 3);
  const float* base = src - off;                     // 16-byte aligned
  const int chunks = (off + span + 3) / 4;
  for (int c = threadIdx.x; c < chunks; c += NT) {
    const float* g = base + 4 * c;
    if (g >= xb && g + 4 <= xe) {
      cp_async16(xs + 4 * c, g);
    } else {
      for (int i = 0; i < 4; ++i)
        if (g + i >= xb && g + i < xe) cp_async4(xs + 4 * c + i, g + i);
    }
  }
  return off;
}

// at most 64 registers: 4 blocks an SM
__global__ void __launch_bounds__(NT, 4)
fir1_kernel(const float* __restrict__ x, const float* __restrict__ taps,
            float* __restrict__ y, long long rows, long long n,
            long long num, int K, long long start, int tile) {
  extern __shared__ __align__(16) float smem[];
  const int kp = (K + 3) & ~3;
  float* s_taps = smem;
  float* const buf0 = smem + kp;                     // two staging buffers
  const int bf = buf_floats(K);
  const long long tiles_per_row = (num + tile - 1) / tile;
  const long long tiles = rows * tiles_per_row;
  const float* xb = x;
  const float* xe = x + rows * n;
  for (int k = threadIdx.x; k < K; k += NT) s_taps[k] = taps[k];

  long long it = blockIdx.x;
  if (it >= tiles) return;
  int off = stage(buf0, x, xb, xe, n, num, K, start, tile, tiles_per_row,
                  it);
  persistent::commit();
  for (int b = 0; it < tiles; it += gridDim.x, b ^= 1) {
    // the next tile's copies fly while this one is computed
    const long long next = it + gridDim.x;
    int off_next = 0;
    if (next < tiles)
      off_next = stage(buf0 + (b ^ 1) * bf, x, xb, xe, n, num, K, start, tile,
                       tiles_per_row, next);
    persistent::commit();
    persistent::wait_prev();
    __syncthreads();

    long long row, m0;
    tile_origin(it, tiles_per_row, tile, &row, &m0);
    const int nb = static_cast<int>(min(static_cast<long long>(tile),
                                        num - m0));
    if (R * static_cast<int>(threadIdx.x) < nb) {
      float acc[G][R] = {};
      const float* xs = buf0 + b * bf;
      if (K == 64)
        sums_at<64>(acc, xs, s_taps, K, off);
      else if (K == 65)
        sums_at<65>(acc, xs, s_taps, K, off);
      else
        sums_at<0>(acc, xs, s_taps, K, off);
      store_sums(acc, y + row * num + m0, nb);
    }
    off = off_next;
    __syncthreads();                  // buffer b is refilled next
  }
}

__global__ void __launch_bounds__(NT)
fir_kernel(const float* __restrict__ x, const float* __restrict__ taps,
           float* __restrict__ y, long long n, long long num, int K, int f,
           long long start) {
  extern __shared__ float s_taps[];
  for (int k = threadIdx.x; k < K; k += NT) s_taps[k] = taps[k];
  __syncthreads();
  const long long m = static_cast<long long>(blockIdx.x) * NT + threadIdx.x;
  if (m >= num) return;
  const long long row = blockIdx.y;
  const float* xr = x + row * n + start + m * f;
  float acc = 0.f;
  for (int k = 0; k < K; ++k)
    acc = __fadd_rn(acc, __fmul_rn(s_taps[k], __ldg(xr + k)));
  y[row * num + m] = acc;
}

constexpr int kTooManyTaps = -1;      // launch_fir's code for taps that
                                      // do not fit

// (outputs of a block, shared-memory bytes) of a launch, or kTooManyTaps
// (or a CUDA error) when the taps do not fit the device's block
int plan(int K, int f, int* tile, int* smem) {
  const long long kp = (K + 3) & ~3;
  const long long bytes = f == 1 ? 4 * (kp + 2LL * buf_floats(K)) : 4LL * K;
  int dev = 0, most = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&most, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (bytes > most) return kTooManyTaps;
  *tile = f == 1 ? TILE : NT;
  *smem = static_cast<int>(bytes);
  return 0;
}

}  // namespace

// x [rows, n] f32, taps [K] f32 -> y [rows, num] f32.  The caller checks
// start + (num - 1) * f + K <= n.
extern "C" int launch_fir(const void* x, const void* taps, void* y,
                          long long rows, long long n, long long num, int K,
                          int f, long long start, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* xp = static_cast<const float*>(x);
  const float* tp = static_cast<const float*>(taps);
  float* yp = static_cast<float*>(y);
  int tile = 0, smem = 0;
  const int p = plan(K, f, &tile, &smem);
  if (p != 0) return p;
  if (f == 1) {
    int blocks = 0;
    const int e = persistent::resident_blocks(fir1_kernel, NT, smem, &blocks);
    if (e != 0) return e;
    const long long tiles = rows * ((num + tile - 1) / tile);
    const unsigned grid = static_cast<unsigned>(
        std::min(tiles, static_cast<long long>(blocks)));
    fir1_kernel<<<grid, NT, smem, st>>>(xp, tp, yp, rows, n, num, K, start,
                                        tile);
  } else {
    if (smem > 48 * 1024) {
      cudaError_t e = cudaFuncSetAttribute(
          fir_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      if (e != cudaSuccess) return static_cast<int>(e);
    }
    const dim3 grid(static_cast<unsigned>((num + tile - 1) / tile),
                    static_cast<unsigned>(rows));
    fir_kernel<<<grid, NT, smem, st>>>(xp, tp, yp, n, num, K, f, start);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* kernel_error_string(int e) {
  if (e == kTooManyTaps)
    return "the taps do not fit a block's shared memory (at most 17,316 "
           "taps at factor 1 and 58,112 above on an H100)";
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}

// This library links its own CUDA runtime, whose current device is not
// PyTorch's: the wrapper selects the tensors' device before each launch.
extern "C" int kernel_set_device(int device) {
  return static_cast<int>(cudaSetDevice(device));
}
