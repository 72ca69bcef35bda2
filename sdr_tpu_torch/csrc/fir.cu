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
//
// Design (f > 1: the exact FM front's decimate-by-8, 51 taps, and the AM
// channel filter's decimate-by-16, 64 taps; `fird_kernel`).  Bound on an
// H100, bytes: the [32, 2, 5,242,880] f32 planes read once (1.342 GB) and
// 168 MB (f = 8) or 84 MB (f = 16) written, 0.451 and 0.426 ms at 3.35
// TB/s; the order kept costs 2 K f32 instructions an output, 0.128 and
// 0.080 ms at the boost clock, so the bytes bind.  No tensor cores:
// `wgmma` takes its operands as TF32, BF16 or FP16, not f32, and the
// no-FMA f32 sum in tap order is the kernel's contract with its plain
// version (hazard H1).
// * Tiles of T consecutive outputs of a row (T = 8192 / f, at most 1024:
//   1024 at f = 8, 512 at f = 16).  A tile's input span [start + m0 f,
//   start + (m0 + T - 1) f + K) is staged by the same `stage` as f == 1
//   (16-byte cp.async copies from the span's 16-byte offset OFF, 4-byte
//   ones at the tensor's two ends), so every input is read from device
//   memory once, plus a (K - f)-float halo a tile.  Persistent and
//   double-buffered: the next tile's copies fly while this one is split
//   and summed.
// * The staged span is split into f polyphase rows in shared memory: row
//   p holds span[p + f q] at column q, so output i reads row j mod f at
//   column i + j div f, and neighbouring outputs read neighbouring words.
//   Threads read the span as float4s and write each float to its row.  The
//   rows are padded to RS = 4 mod 8 floats at f = 8 and 2 mod 8 at f = 16,
//   so a warp's writes (f / 4 rows of 128 / f consecutive columns) fall in
//   distinct banks.
// * A thread sums RC = 2 consecutive outputs from float2s of the rows,
//   with a window of up to 3 values a phase in registers: a q step reads at
//   most one new float2 a phase for 2 products, and neighbouring threads
//   read neighbouring 8-byte words.  (4 outputs from float4s, RC = 4,
//   needs up to 7 values a phase: at f = 8 that is 56 registers of
//   windows, and under the 128 that two blocks an SM allow ptxas spilled,
//   which cost an H100 0.33 ms at f = 8 and 0.23 ms at f = 16.)  The sum walks the
//   taps in order, j = q f + p with the phases inside each q step, each
//   product and sum one rounded operation from +0, so an output equals the
//   plain version bitwise.  The paths' geometries (51, 8) and (64, 16) are
//   compiled with every loop unrolled; others take a loop over scalar
//   reads.
// * The switch: the staged branch takes every (K, f) whose buffers fit a
//   block, its tile halved until they fit two blocks an SM; on an H100
//   that is up to 14,520 taps at f = 2, 14,496 at f = 8 and 14,493 at
//   f = 16, so ceil(K / f) <= 897 (the TPU kernel's range) at every factor
//   up to 16.  Above that `fir_kernel` (one thread an output, its window
//   through the read-only cache) takes up to 58,112 taps.  `plan` chooses
//   from (K, f) before the launch.
//
// Shared memory (`plan`): f == 1 takes the taps padded to a multiple of 4
// (kp floats) and two staging buffers of buf_floats(K) = TILE + kp + 8
// floats (up to 3 floats of alignment, the TILE + K - 1 of the span, and
// the last float4s the register ring reads past it); the staged f > 1
// branch the kp taps, two staging buffers of dec_raw_floats and f rows of
// dec_row_stride floats; `fir_kernel` the K taps.  At an H100 block's
// 232,448 bytes that is K <= 17,316 at f == 1 and K <= 58,112 above; more
// taps return kTooManyTaps.

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

// Issue the copies of tile `it`'s span (outputs m0 .. m0 + nb - 1 at
// stride f: (nb - 1) f + K floats) into xs (staged from xs[off] on);
// returns off.  [xb, xe) is the whole tensor x.
__device__ __forceinline__ int stage(float* xs, const float* __restrict__ x,
                                    const float* xb, const float* xe,
                                    long long n, long long num, int K,
                                    long long start, int tile,
                                    long long tiles_per_row, long long it,
                                    int f = 1) {
  long long row, m0;
  tile_origin(it, tiles_per_row, tile, &row, &m0);
  const int span = (static_cast<int>(min(static_cast<long long>(tile),
                                         num - m0)) - 1) * f + K;
  const float* src = x + row * n + start + m0 * f;
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

// ---- f > 1: the staged polyphase branch ----

constexpr int kDecSpan = 8192;        // about a full tile's span, floats

// floats of a staging buffer for tiles of T outputs: up to 3 floats of
// alignment and the (T - 1) f + K of the span, in whole float4s
__host__ __device__ constexpr int dec_raw_floats(int T, int K, int f) {
  return ((T - 1) * f + K + 6) & ~3;
}

// floats of a phase row: the T + (K - 1) / f columns a tile's outputs
// read and the chunk the register window reads past them, padded so that
// the split's writes of a warp fall in distinct banks at f = 8 (RS = 4 mod
// 8) and f = 16 (2 mod 8)
__host__ __device__ constexpr int dec_row_stride(int T, int K, int f) {
  return ((T + (K - 1) / f + 4 + 7) & ~7) +
         (f % 4 == 0 && f <= 32 ? (32 / f) % 8 : 0);
}

__host__ __device__ constexpr long long dec_floats(int K, int f, int T) {
  return ((K + 3) & ~3) + 2LL * dec_raw_floats(T, K, f) +
         static_cast<long long>(f) * dec_row_stride(T, K, f);
}

template <int RC> struct Chunk;
template <> struct Chunk<2> { using type = float2; };
template <> struct Chunk<4> { using type = float4; };

// element r of a chunk, r known at compile time (no address taken, so the
// chunk stays in registers)
__device__ __forceinline__ float elem(float4 v, int r) {
  return r == 0 ? v.x : r == 1 ? v.y : r == 2 ? v.z : v.w;
}

__device__ __forceinline__ float elem(float2 v, int r) {
  return r == 0 ? v.x : v.y;
}

// the staged span (S floats from xs[off] on) into its f phase rows:
// P[p * RS + q] = span[p + f q]; FC > 0 fixes f at compile time
template <int FC>
__device__ __forceinline__ void split_phases(float* P, const float* xs,
                                             int off, int S, int f_rt,
                                             int RS) {
  const int f = FC > 0 ? FC : f_rt;
  const float4* x4 = reinterpret_cast<const float4*>(xs);
  const int chunks = (off + S + 3) / 4;
  for (int c = threadIdx.x; c < chunks; c += NT) {
    const float4 v = x4[c];
    const float e4[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int s = 4 * c + e - off;
      if (s >= 0 && s < S) P[(s % f) * RS + s / f] = e4[e];
    }
  }
}

// outputs RC u .. RC u + RC - 1 of the tile from the phase rows, the
// geometry (KC taps, factor FC) compiled: phase p's window holds columns
// RC u + q .. RC u + q + RC - 1 at q step q, its chunks of RC columns read
// as they are first needed
template <int KC, int FC, int RC>
__device__ __forceinline__ void poly_sums(float (&a)[RC], const float* P,
                                          int RS, const float* s_taps,
                                          int u) {
  using V = typename Chunk<RC>::type;
  constexpr int JQ = (KC + FC - 1) / FC;            // q steps
  constexpr int NCH = (RC + JQ - 2) / RC + 1;       // chunks a phase reads
  float w[FC][NCH * RC];
  float4 tv;
#pragma unroll
  for (int q = 0; q < JQ; ++q) {
#pragma unroll
    for (int p = 0; p < FC; ++p) {
      const int j = q * FC + p;
      if (j < KC) {
        if (q == 0 || (q + RC - 1) % RC == 0) {
          const int k = (q + RC - 1) / RC;
          const V v = *reinterpret_cast<const V*>(P + p * RS + RC * (u + k));
#pragma unroll
          for (int r = 0; r < RC; ++r) w[p][RC * k + r] = elem(v, r);
        }
        if (j % 4 == 0)                 // the next 4 taps, one broadcast
          tv = *reinterpret_cast<const float4*>(s_taps + j);
        const float t = elem(tv, j % 4);
#pragma unroll
        for (int r = 0; r < RC; ++r)
          a[r] = __fadd_rn(a[r], __fmul_rn(t, w[p][q + r]));
      }
    }
  }
}

// the same for any geometry: a loop over the taps in order, scalar reads
template <int RC>
__device__ __forceinline__ void poly_sums_rt(float (&a)[RC], const float* P,
                                             int RS, const float* s_taps,
                                             int u, int K, int f) {
  int j = 0;
  for (int q = 0; j < K; ++q) {
    for (int p = 0; p < f && j < K; ++p, ++j) {
      const float t = s_taps[j];
      const float* row = P + p * RS + RC * u + q;
#pragma unroll
      for (int r = 0; r < RC; ++r)
        a[r] = __fadd_rn(a[r], __fmul_rn(t, row[r]));
    }
  }
}

__device__ __forceinline__ void store_chunk(float* y, const float (&a)[4]) {
  *reinterpret_cast<float4*>(y) = make_float4(a[0], a[1], a[2], a[3]);
}

__device__ __forceinline__ void store_chunk(float* y, const float (&a)[2]) {
  *reinterpret_cast<float2*>(y) = make_float2(a[0], a[1]);
}

// one tile: split the staged span into phase rows, then sum and store its
// nb outputs to yt (the tile's first output)
template <int KC, int FC, int RC>
__device__ __forceinline__ void dec_tile(float* P, const float* xs, int off,
                                         int nb, int K, int f, int RS,
                                         const float* s_taps, float* yt) {
  split_phases<FC>(P, xs, off, (nb - 1) * f + K, f, RS);
  __syncthreads();
  for (int u = threadIdx.x; RC * u < nb; u += NT) {
    float a[RC] = {};
    if constexpr (KC > 0)
      poly_sums<KC, FC, RC>(a, P, RS, s_taps, u);
    else
      poly_sums_rt<RC>(a, P, RS, s_taps, u, K, f);
    float* y = yt + RC * u;
    if (RC * u + RC <= nb &&
        (reinterpret_cast<uintptr_t>(y) & (4 * RC - 1)) == 0) {
      store_chunk(y, a);
    } else {
#pragma unroll
      for (int r = 0; r < RC; ++r)
        if (RC * u + r < nb) y[r] = a[r];
    }
  }
}

// at most 128 registers: 2 blocks an SM, as the plan's buffers allow
__global__ void __launch_bounds__(NT, 2)
fird_kernel(const float* __restrict__ x, const float* __restrict__ taps,
            float* __restrict__ y, long long rows, long long n,
            long long num, int K, int f, long long start, int tile) {
  extern __shared__ __align__(16) float smem[];
  const int kp = (K + 3) & ~3;
  float* s_taps = smem;
  const int rf = dec_raw_floats(tile, K, f);
  float* const raw0 = smem + kp;                     // two staging buffers
  float* const P = raw0 + 2 * rf;                    // the f phase rows
  const int RS = dec_row_stride(tile, K, f);
  const long long tiles_per_row = (num + tile - 1) / tile;
  const long long tiles = rows * tiles_per_row;
  const float* xb = x;
  const float* xe = x + rows * n;
  for (int k = threadIdx.x; k < K; k += NT) s_taps[k] = taps[k];

  long long it = blockIdx.x;
  if (it >= tiles) return;
  int off = stage(raw0, x, xb, xe, n, num, K, start, tile, tiles_per_row,
                  it, f);
  persistent::commit();
  for (int b = 0; it < tiles; it += gridDim.x, b ^= 1) {
    // the next tile's copies fly while this one is split and summed
    const long long next = it + gridDim.x;
    int off_next = 0;
    if (next < tiles)
      off_next = stage(raw0 + (b ^ 1) * rf, x, xb, xe, n, num, K, start,
                       tile, tiles_per_row, next, f);
    persistent::commit();
    persistent::wait_prev();
    __syncthreads();                  // also: the last tile's sums are done

    long long row, m0;
    tile_origin(it, tiles_per_row, tile, &row, &m0);
    const int nb = static_cast<int>(min(static_cast<long long>(tile),
                                        num - m0));
    const float* xs = raw0 + b * rf;
    float* yt = y + row * num + m0;
    if (f == 8 && K == 51)
      dec_tile<51, 8, 2>(P, xs, off, nb, K, f, RS, s_taps, yt);
    else if (f == 16 && K == 64)
      dec_tile<64, 16, 2>(P, xs, off, nb, K, f, RS, s_taps, yt);
    else
      dec_tile<0, 0, 2>(P, xs, off, nb, K, f, RS, s_taps, yt);
    off = off_next;
  }
}

constexpr int kTooManyTaps = -1;      // launch_fir's code for taps that
                                      // do not fit

enum Branch { kFactor1 = 0, kStaged = 1, kPerOutput = 2 };

// (branch, outputs of a tile, shared-memory bytes) of a launch of K taps
// at factor f, or kTooManyTaps (or a CUDA error) when the taps do not fit
// the device's block.  f > 1 takes the staged branch where its buffers fit
// a block, with T halved from 8192 / f (at most 1024) until they fit two
// blocks an SM, and fir_kernel above.
int plan(int K, int f, int* branch, int* tile, int* smem) {
  int dev = 0, most = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&most, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  long long bytes;
  if (f == 1) {
    bytes = 4 * (((K + 3) & ~3) + 2LL * buf_floats(K));
    *branch = kFactor1;
    *tile = TILE;
  } else {
    int T = std::min(1024, std::max(1, kDecSpan / f));
    while (T > 1 && 4 * dec_floats(K, f, T) > most / 2 - 1024)
      T = (T + 1) / 2;
    bytes = 4 * dec_floats(K, f, T);
    *branch = kStaged;
    *tile = T;
    if (bytes > most) {
      bytes = 4LL * K;
      *branch = kPerOutput;
      *tile = NT;
    }
  }
  if (bytes > most) return kTooManyTaps;
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
  int branch = 0, tile = 0, smem = 0;
  const int p = plan(K, f, &branch, &tile, &smem);
  if (p != 0) return p;
  if (branch == kFactor1) {
    int blocks = 0;
    const int e = persistent::resident_blocks(fir1_kernel, NT, smem, &blocks);
    if (e != 0) return e;
    const long long tiles = rows * ((num + tile - 1) / tile);
    const unsigned grid = static_cast<unsigned>(
        std::min(tiles, static_cast<long long>(blocks)));
    fir1_kernel<<<grid, NT, smem, st>>>(xp, tp, yp, rows, n, num, K, start,
                                        tile);
  } else if (branch == kStaged) {
    int blocks = 0;
    const int e = persistent::resident_blocks(fird_kernel, NT, smem, &blocks);
    if (e != 0) return e;
    const long long tiles = rows * ((num + tile - 1) / tile);
    const unsigned grid = static_cast<unsigned>(
        std::min(tiles, static_cast<long long>(blocks)));
    fird_kernel<<<grid, NT, smem, st>>>(xp, tp, yp, rows, n, num, K, f,
                                        start, tile);
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

// The plan of a launch of K taps at factor f, as launch_fir makes it:
// branch (0: factor 1, 1: the staged f > 1 branch, 2: fir_kernel), outputs
// of a tile and shared-memory bytes; kTooManyTaps where they do not fit.
extern "C" int fir_plan(int K, int f, int* branch, int* tile, int* smem) {
  return plan(K, f, branch, tile, smem);
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
