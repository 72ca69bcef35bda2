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
// * Register tiling: thread t computes G = 3 groups of R = 4 consecutive
//   outputs, 4(t + g NT) .. 4(t + g NT) + 3.  Per 4 taps it reads one
//   float4 of taps (the same address for every thread: a broadcast) and
//   one new float4 of input per group, and keeps a ring of three input
//   float4s per group in registers, so each of the 48 products of a step
//   costs 4/48 shared-memory reads instead of 2, and twelve independent
//   sums hide the add latency.  Neighbouring threads read neighbouring
//   16-byte words: a quarter-warp's 8 threads cover 128 contiguous bytes,
//   one pass, no bank conflict.  The paths' tap counts (64, 65) are
//   compiled with the tap loop unrolled.
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

#include "persistent.cuh"

namespace {

using persistent::cp_async16;

constexpr int NT = 256;
constexpr int R = 4;                  // consecutive outputs per group
constexpr int G = 3;                  // groups per thread, NT * R apart

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(gmem));
}

// one 4-tap step of the 4 outputs: taps tp (the first nj of them) over the
// 12 staged inputs a, b, c, of which output r, tap jj reads OFF + jj + r
template <int OFF>
__device__ __forceinline__ void step(float (&acc)[R], float4 tp, float4 a,
                                     float4 b, float4 c, int nj) {
  const float w[12] = {a.x, a.y, a.z, a.w, b.x, b.y,
                       b.z, b.w, c.x, c.y, c.z, c.w};
  const float tj[4] = {tp.x, tp.y, tp.z, tp.w};
#pragma unroll
  for (int jj = 0; jj < 4; ++jj)
    if (jj < nj) {
#pragma unroll
      for (int r = 0; r < R; ++r)
        acc[r] = __fadd_rn(acc[r], __fmul_rn(tj[jj], w[OFF + jj + r]));
    }
}

// outputs 4(t + g NT) .. 4(t + g NT) + 3 of the tile, g < G, the span
// staged from xs[OFF] on; KC > 0 fixes the tap count at compile time
template <int OFF, int KC>
__device__ __forceinline__ void tile_sums(float (&acc)[G][R],
                                          const float* xs,
                                          const float* s_taps, int K_rt) {
  const int K = KC > 0 ? KC : K_rt;
  const float4* x4 = reinterpret_cast<const float4*>(xs) + threadIdx.x;
  const float4* t4 = reinterpret_cast<const float4*>(s_taps);
  const int full = K / 4;
  float4 c0[G], c1[G], c2[G];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    c0[g] = x4[g * NT];
    c1[g] = x4[g * NT + 1];
  }
  int s = 0;
  // a ring of three chunks, so the unrolled group moves no registers
#pragma unroll
  for (; s + 3 <= full; s += 3) {
    const float4 ta = t4[s], tb = t4[s + 1], tc = t4[s + 2];
#pragma unroll
    for (int g = 0; g < G; ++g) {
      c2[g] = x4[g * NT + s + 2];
      step<OFF>(acc[g], ta, c0[g], c1[g], c2[g], 4);
      c0[g] = x4[g * NT + s + 3];
      step<OFF>(acc[g], tb, c1[g], c2[g], c0[g], 4);
      c1[g] = x4[g * NT + s + 4];
      step<OFF>(acc[g], tc, c2[g], c0[g], c1[g], 4);
    }
  }
#pragma unroll
  for (; s < full; ++s) {
    const float4 ta = t4[s];
#pragma unroll
    for (int g = 0; g < G; ++g) {
      c2[g] = x4[g * NT + s + 2];
      step<OFF>(acc[g], ta, c0[g], c1[g], c2[g], 4);
      c0[g] = c1[g];
      c1[g] = c2[g];
    }
  }
  if (K % 4) {
#pragma unroll
    for (int g = 0; g < G; ++g)
      step<OFF>(acc[g], t4[s], c0[g], c1[g], x4[g * NT + s + 2], K % 4);
  }
}

// the tile's sums for the staging offset off: the paths' tap counts (64,
// 65) compiled with their loops unrolled, others with a loop
template <int KC>
__device__ __forceinline__ void sums_at(float (&acc)[G][R], const float* xs,
                                        const float* s_taps, int K,
                                        int off) {
  switch (off) {
    case 0: tile_sums<0, KC>(acc, xs, s_taps, K); break;
    case 1: tile_sums<1, KC>(acc, xs, s_taps, K); break;
    case 2: tile_sums<2, KC>(acc, xs, s_taps, K); break;
    default: tile_sums<3, KC>(acc, xs, s_taps, K); break;
  }
}

constexpr int TILE = G * R * NT;      // outputs of a tile at f == 1

// floats of one staging buffer: alignment slack, the span, and the ring's
// read past it
__host__ __device__ constexpr int buf_floats(int K) {
  return TILE + ((K + 3) & ~3) + 8;
}

// row and first output of tile it (32-bit division where the counts
// allow)
__device__ __forceinline__ void tile_origin(long long it, long long per_row,
                                            int tile, long long* row,
                                            long long* m0) {
  if (it < (1LL << 32) && per_row < (1LL << 32)) {
    const unsigned q = static_cast<unsigned>(it) /
                       static_cast<unsigned>(per_row);
    *row = q;
    *m0 = (it - static_cast<long long>(q) * per_row) * tile;
  } else {
    *row = it / per_row;
    *m0 = (it % per_row) * tile;
  }
}

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
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const int u0 = R * (threadIdx.x + g * NT);
        float* yr = y + row * num + m0 + u0;
        if (u0 + R <= nb && (reinterpret_cast<uintptr_t>(yr) & 15) == 0) {
          *reinterpret_cast<float4*>(yr) =
              make_float4(acc[g][0], acc[g][1], acc[g][2], acc[g][3]);
        } else {
#pragma unroll
          for (int r = 0; r < R; ++r)
            if (u0 + r < nb) yr[r] = acc[g][r];
        }
      }
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
