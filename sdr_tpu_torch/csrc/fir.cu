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
//
// The complex form (`launch_fir_complex`): complex64 x -> complex64 y,
// each output's real and imaginary sums the real form's over the I and
// the Q values, in the same order (so bitwise the plain version over the
// [..., 2, n] planes, which the JAX package's `_dispatch` computes).  It
// reads x where it lies, in one of two layouts, and writes rows of y at
// any row stride (the caller's `out=`, so that a `Fir` writes its seam
// and main launches into one tensor).  Bound on an H100, bytes: x read
// once, y written once; at the exact front's [32, 5,242,880] -> 655,354
// (f = 8, 51 taps) 1.342 + 0.168 GB, 0.451 ms; AM's -> 327,677 (f = 16,
// 64 taps) 0.426 ms; the wideband bank's [32, 64, 64,000] -> 8,000
// channel-major (f = 8) 1.049 + 0.131 GB, 0.352 ms.  The order kept costs
// 4 K f32 instructions a complex output (0.128, 0.080 and 0.100 ms at the
// boost clock), so the bytes bind.
// * Time-contiguous rows (the last axis stride 1, rows at any stride rs:
//   the exact front's convert, the complex `Mix`, the narrowband
//   basebands, the seam's `cat`), f > 1: `fir_iq_kernel`, the staged
//   branch over the interleaved floats.  A tile's span of (T - 1) f + K
//   samples is 2 ((T - 1) f + K) floats, staged once by `stage_span`'s
//   16-byte copies (a complex64 lies 8-byte aligned, so its 16-byte
//   offset is 0 or 2 floats), then split into 2 f phase rows, I phases
//   first: sample k's I to row k mod f and its Q to row f + k mod f, at
//   column k div f.  Each plane is then summed by the real branch's
//   `poly_sums` (its rows RS apart): a thread takes one plane's two
//   outputs at a time and stores that plane's floats 2 apart (both
//   planes' windows at once spill under 128 registers and ran slower on
//   an H100, `kernel_variants`' fir_iq_both_planes).  Rows are
//   padded to RS = 32 / f mod 16 floats: a warp's split writes (every
//   other phase of one plane, 64 / f columns) fall in distinct banks,
//   and RS stays even for the float2 reads.  T is the real branch's rule
//   on twice the floats:
//   512 at (51, 8), 256 at (64, 16).
// * Channel-major (x a transpose of a contiguous [..., n, C]: strides (1,
//   C) on its last two axes, `Channelize`'s output), any f:
//   `fir_cm_kernel`.  A tile is kChannels = 32 consecutive channels x T
//   outputs of one batch row, staged as (T - 1) f + K time samples of 32
//   contiguous complex (256 bytes, two whole 128-byte lines; 16-byte
//   copies where the tile's channels pair up aligned, else 8-byte ones),
//   so a warp's copies coalesce across channels and no thread strides
//   through time in device memory.  Thread t sums channel t mod 32's
//   outputs t div 32, + 8, ... in tap order from the staged samples
//   (neighbouring lanes read neighbouring 8-byte words, the taps one
//   broadcast), writes them to a small output stage, and the block writes
//   each channel's T outputs as one run.  (A compiled (51, 8) form with
//   the taps in registers, each sample read once for two outputs, ran
//   slower on an H100.)  A last group of fewer than 32 channels is
//   masked; tiles never cross a batch row.  T is the most (up to 64)
//   whose two buffers fit two blocks an SM: 21 at (51, 8), so a tile
//   rereads (K - f) / (T f) = 26 % of its samples as halo, from L2 (the
//   next tile in time is a neighbouring block's).
// * Anything else either layout asks for (f == 1 rows, taps past the
//   staged buffers, up to 58,112): `fir_c1_kernel`, one thread an output
//   through the read-only cache, rows looped past the grid's 65,535.

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

#include "fir_tile.cuh"
#include "persistent.cuh"

// the block's dynamic shared memory, and a launch that sizes it (the host
// test harness defines its own)
#ifndef DYNAMIC_SMEM
#define DYNAMIC_SMEM(name) extern __shared__ __align__(16) float name[]
#endif
#ifndef KERNEL_LAUNCH_SMEM
#define KERNEL_LAUNCH_SMEM(kernel, grid, block, smem, stream, ...) \
  kernel<<<grid, block, smem, stream>>>(__VA_ARGS__)
#endif

namespace {

using namespace fir_tile;
using persistent::cp_async16;
using persistent::cp_async4;
using persistent::cp_async8;
using persistent::tile_origin;

// Issue the copies of the `span` floats from src into xs, staged from
// xs[off] on (off: src's 16-byte offset in floats); returns off.  [xb, xe)
// is the whole tensor x.
__device__ __forceinline__ int stage_span(float* xs, const float* src,
                                          int span, const float* xb,
                                          const float* xe) {
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
  return stage_span(xs, x + row * n + start + m0 * f, span, xb, xe);
}

// at most 64 registers: 4 blocks an SM
__global__ void __launch_bounds__(NT, 4)
fir1_kernel(const float* __restrict__ x, const float* __restrict__ taps,
            float* __restrict__ y, long long rows, long long n,
            long long num, int K, long long start, int tile) {
  DYNAMIC_SMEM(smem);
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
  DYNAMIC_SMEM(s_taps);
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
  DYNAMIC_SMEM(smem);
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

// ---- the complex form: interleaved complex64 ----

enum Layout { kRows = 0, kChannelMajor = 1 };

// floats of a complex tile's staging buffer: up to 2 floats of alignment
// and the 2 ((T - 1) f + K) floats of the interleaved span, in whole
// float4s
__host__ __device__ constexpr int iq_raw_floats(int T, int K, int f) {
  return (2 * ((T - 1) * f + K) + 2 + 3) & ~3;
}

// floats of one of the 2 f phase rows: dec_row_stride's columns, padded
// to RS = 32 / f mod 16 (the split's writes of a warp in distinct banks;
// even, for the float2 reads)
__host__ __device__ constexpr int iq_row_stride(int T, int K, int f) {
  return ((T + (K - 1) / f + 4 + 15) & ~15) +
         (f <= 16 && 32 % f == 0 ? (32 / f) % 16 : 0);
}

__host__ __device__ constexpr long long iq_floats(int K, int f, int T) {
  return ((K + 3) & ~3) + 2LL * iq_raw_floats(T, K, f) +
         2LL * f * iq_row_stride(T, K, f);
}

// the staged interleaved span (S samples, 2 S floats from xs[off] on) into
// its phase rows: sample k's I to row k mod f, its Q to row f + k mod f,
// column k div f; FC > 0 fixes f at compile time
template <int FC>
__device__ __forceinline__ void split_iq(float* P, const float* xs, int off,
                                         int S, int f_rt, int RS) {
  const int f = FC > 0 ? FC : f_rt;
  const float4* x4 = reinterpret_cast<const float4*>(xs);
  const int chunks = (off + 2 * S + 3) / 4;
  for (int c = threadIdx.x; c < chunks; c += NT) {
    const float4 v = x4[c];
    const float e4[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int s = 4 * c + e - off;
      if (s >= 0 && s < 2 * S) {
        const int k = s >> 1;
        P[((s & 1) * f + k % f) * RS + k / f] = e4[e];
      }
    }
  }
}

// one complex tile: split the staged span, then sum each plane of the nb
// outputs, two outputs of one plane a thread, and store them to yt (the
// tile's first output's I), each plane's floats 2 apart.  A call, not
// inlined: the persistent loop's state is saved once a tile, and the sums
// get every register
template <int KC, int FC>
__device__ __noinline__ void iq_tile(float* P, const float* xs, int off,
                                     int nb, int K, int f, int RS,
                                     const float* s_taps, float* yt) {
  split_iq<FC>(P, xs, off, (nb - 1) * f + K, f, RS);
  __syncthreads();
  const int pairs = (nb + 1) / 2;
  for (int v = threadIdx.x; v < 2 * pairs; v += NT) {
    // a work item is one plane's two outputs, I items first: a thread
    // holds one plane's windows (both planes' at once spill under the 128
    // registers of two blocks an SM)
    const int c = v >= pairs, u = v - c * pairs;
    float a[2] = {};
    if constexpr (KC > 0)
      poly_sums<KC, FC, 2>(a, P + c * f * RS, RS, s_taps, u);
    else
      poly_sums_rt<2>(a, P + c * f * RS, RS, s_taps, u, K, f);
    float* y = yt + 4 * u + c;
    y[0] = a[0];
    if (2 * u + 1 < nb) y[2] = a[1];
  }
}

// time-contiguous complex rows (row r at x + 2 rs r floats), f > 1: the
// staged branch over the interleaved floats; y's rows ys complex apart
__global__ void __launch_bounds__(NT, 2)
fir_iq_kernel(const float* __restrict__ x, const float* __restrict__ taps,
              float* __restrict__ y, long long rows, long long rs,
              long long n, long long ys, long long num, int K, int f,
              long long start, int tile) {
  DYNAMIC_SMEM(smem);
  const int kp = (K + 3) & ~3;
  float* s_taps = smem;
  const int rf = iq_raw_floats(tile, K, f);
  float* const raw0 = smem + kp;                     // two staging buffers
  float* const P = raw0 + 2 * rf;                    // the 2 f phase rows
  const int RS = iq_row_stride(tile, K, f);
  const long long tiles_per_row = (num + tile - 1) / tile;
  const long long tiles = rows * tiles_per_row;
  const float* xb = x;
  const float* xe = x + 2 * ((rows - 1) * rs + n);
  for (int k = threadIdx.x; k < K; k += NT) s_taps[k] = taps[k];

  // tile `t`'s interleaved span into buffer `buf`; returns its offset
  auto stage_tile = [&](float* buf, long long t) {
    long long row, m0;
    tile_origin(t, tiles_per_row, tile, &row, &m0);
    const int nb = static_cast<int>(min(static_cast<long long>(tile),
                                        num - m0));
    return stage_span(buf, x + 2 * (row * rs + start + m0 * f),
                      2 * ((nb - 1) * f + K), xb, xe);
  };
  long long it = blockIdx.x;
  if (it >= tiles) return;
  int off = stage_tile(raw0, it);
  persistent::commit();
  for (int b = 0; it < tiles; it += gridDim.x, b ^= 1) {
    // the next tile's copies fly while this one is split and summed
    const long long next = it + gridDim.x;
    int off_next = 0;
    if (next < tiles) off_next = stage_tile(raw0 + (b ^ 1) * rf, next);
    persistent::commit();
    persistent::wait_prev();
    __syncthreads();                  // also: the last tile's sums are done

    long long row, m0;
    tile_origin(it, tiles_per_row, tile, &row, &m0);
    const int nb = static_cast<int>(min(static_cast<long long>(tile),
                                        num - m0));
    const float* xs = raw0 + b * rf;
    float* yt = y + 2 * (row * ys + m0);
    if (K == 51 && f == 8)
      iq_tile<51, 8>(P, xs, off, nb, K, f, RS, s_taps, yt);
    else if (K == 64 && f == 16)
      iq_tile<64, 16>(P, xs, off, nb, K, f, RS, s_taps, yt);
    else
      iq_tile<0, 0>(P, xs, off, nb, K, f, RS, s_taps, yt);
    off = off_next;
  }
}

constexpr int kChannels = 32;         // channels of a channel-major tile
constexpr int kCmOutputs = 64;        // the most outputs a channel of it

// floats of a channel-major staging buffer: (T - 1) f + K time samples of
// kChannels complex
__host__ __device__ constexpr long long cm_raw_floats(int T, int K, int f) {
  return 2LL * kChannels * ((T - 1) * f + K);
}

// float2s between two channels' outputs in the output stage: odd, so a
// warp's writes (one output of 32 channels) fall in distinct banks
__host__ __device__ constexpr int cm_out_stride(int T) { return T | 1; }

__host__ __device__ constexpr long long cm_floats(int K, int f, int T) {
  return ((K + 3) & ~3) + 2 * cm_raw_floats(T, K, f) +
         2LL * kChannels * cm_out_stride(T);
}

// channel group g of batch row bi, outputs m0 .. of tile `it`
struct CmTile {
  long long bi, m0;
  int c0, cw, nb;
};

__device__ __forceinline__ CmTile cm_tile(long long it, long long per_row,
                                          long long groups, long long C,
                                          long long num, int tile) {
  long long rg, m0;
  tile_origin(it, per_row, tile, &rg, &m0);
  CmTile t;
  t.bi = rg / groups;
  t.c0 = static_cast<int>(rg - t.bi * groups) * kChannels;
  t.cw = static_cast<int>(min(static_cast<long long>(kChannels), C - t.c0));
  t.m0 = m0;
  t.nb = static_cast<int>(min(static_cast<long long>(tile), num - m0));
  return t;
}

// Issue the copies of a channel-major tile's (nb - 1) f + K time samples,
// each the cw complex of its channels, into xs (kChannels complex a
// sample): 16-byte copies where the channels pair up 16-byte aligned in
// every sample, else 8-byte ones.
__device__ __forceinline__ void stage_cm(float2* xs, const float2* x,
                                         const CmTile& t, long long C,
                                         long long bs, int K, int f,
                                         long long start) {
  const int S = (t.nb - 1) * f + K;
  const float2* src = x + t.bi * bs + (start + t.m0 * f) * C + t.c0;
  if ((t.cw & 1) == 0 && (C & 1) == 0 &&
      (reinterpret_cast<uintptr_t>(src) & 15) == 0) {
    const int pairs = t.cw / 2;
    for (int q = threadIdx.x; q < S * pairs; q += NT) {
      const int s = q / pairs, h = q - s * pairs;
      cp_async16(xs + s * kChannels + 2 * h, src + s * C + 2 * h);
    }
  } else {
    for (int q = threadIdx.x; q < S * t.cw; q += NT) {
      const int s = q / t.cw, c = q - s * t.cw;
      cp_async8(xs + s * kChannels + c, src + s * C + c);
    }
  }
}

// one channel's output from its staged samples xi (kChannels complex
// apart), both planes in tap order
__device__ __forceinline__ float2 cm_sum(const float2* xi,
                                         const float* s_taps, int K) {
  float re = 0.f, im = 0.f;
  for (int j = 0; j < K; ++j) {
    const float t = s_taps[j];
    const float2 v = xi[j * kChannels];
    re = __fadd_rn(re, __fmul_rn(t, v.x));
    im = __fadd_rn(im, __fmul_rn(t, v.y));
  }
  return make_float2(re, im);
}

// channel-major x (batch row bi, channel c, sample t at bi bs + c + t C):
// tiles of kChannels channels x T outputs; y's row bi C + c, ys apart
__global__ void __launch_bounds__(NT, 2)
fir_cm_kernel(const float2* __restrict__ x, const float* __restrict__ taps,
              float2* __restrict__ y, long long batch, long long C,
              long long bs, long long ys, long long num, int K, int f,
              long long start, int tile) {
  DYNAMIC_SMEM(smem);
  const int kp = (K + 3) & ~3;
  float* s_taps = smem;
  const long long rf2 = cm_raw_floats(tile, K, f) / 2;  // float2s a buffer
  float2* const raw0 = reinterpret_cast<float2*>(smem + kp);
  float2* const s_y = raw0 + 2 * rf2;                    // the output stage
  const int LY = cm_out_stride(tile);
  const long long groups = (C + kChannels - 1) / kChannels;
  const long long tiles_per_row = (num + tile - 1) / tile;
  const long long tiles = batch * groups * tiles_per_row;
  for (int k = threadIdx.x; k < K; k += NT) s_taps[k] = taps[k];

  long long it = blockIdx.x;
  if (it >= tiles) return;
  stage_cm(raw0, x, cm_tile(it, tiles_per_row, groups, C, num, tile), C, bs,
           K, f, start);
  persistent::commit();
  const int c = threadIdx.x % kChannels;
  for (int b = 0; it < tiles; it += gridDim.x, b ^= 1) {
    // the next tile's copies fly while this one is summed and stored
    const long long next = it + gridDim.x;
    if (next < tiles)
      stage_cm(raw0 + (b ^ 1) * rf2, x,
               cm_tile(next, tiles_per_row, groups, C, num, tile), C, bs, K,
               f, start);
    persistent::commit();
    persistent::wait_prev();
    __syncthreads();                  // also: the last tile's stores are done

    const CmTile t = cm_tile(it, tiles_per_row, groups, C, num, tile);
    const float2* xs = raw0 + b * rf2 + c;
    if (c < t.cw) {
      for (int i = threadIdx.x / kChannels; i < t.nb; i += NT / kChannels)
        s_y[c * LY + i] = cm_sum(xs + i * f * kChannels, s_taps, K);
    }
    __syncthreads();                  // the sums are staged, buffer b read
    float2* yr = y + (t.bi * C + t.c0) * ys + t.m0;
    for (int q = threadIdx.x; q < t.cw * t.nb; q += NT) {
      const int cc = q / t.nb, i = q - cc * t.nb;
      yr[cc * ys + i] = s_y[cc * LY + i];
    }
  }
}

// any complex layout, one thread an output (batch row bi, channel c,
// sample t at bi bs + c cs + t ts); rows past the grid's y extent loop
__global__ void __launch_bounds__(NT)
fir_c1_kernel(const float2* __restrict__ x, const float* __restrict__ taps,
              float2* __restrict__ y, long long batch, long long C,
              long long bs, long long cs, long long ts, long long ys,
              long long num, int K, int f, long long start) {
  DYNAMIC_SMEM(s_taps);
  for (int k = threadIdx.x; k < K; k += NT) s_taps[k] = taps[k];
  __syncthreads();
  const long long m = static_cast<long long>(blockIdx.x) * NT + threadIdx.x;
  if (m >= num) return;
  for (long long r = blockIdx.y; r < batch * C; r += gridDim.y) {
    const long long bi = r / C, c = r - bi * C;
    const float2* xr = x + bi * bs + c * cs + (start + m * f) * ts;
    float re = 0.f, im = 0.f;
    for (int k = 0; k < K; ++k) {
      const float t = s_taps[k];
      const float2 v = __ldg(xr + k * ts);
      re = __fadd_rn(re, __fmul_rn(t, v.x));
      im = __fadd_rn(im, __fmul_rn(t, v.y));
    }
    y[r * ys + m] = make_float2(re, im);
  }
}

constexpr int kTooManyTaps = -1;      // launch_fir's code for taps that
                                      // do not fit

enum Branch { kFactor1 = 0, kStaged = 1, kPerOutput = 2, kChannelTile = 3 };

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

// The same for the complex form in `layout`: rows at f > 1 take the
// staged fir_iq_kernel (T halved from 8192 / f, at most 1024, until its
// buffers fit two blocks an SM), channel-major x fir_cm_kernel (the most
// outputs up to kCmOutputs that fit two blocks an SM, else one), each
// where its buffers fit a block; all else fir_c1_kernel.
int plan_complex(int K, int f, int layout, int* branch, int* tile,
                 int* smem) {
  int dev = 0, most = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&most, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  long long bytes = 4LL * K;
  *branch = kPerOutput;
  *tile = NT;
  if (layout == kRows && f > 1) {
    int T = std::min(1024, std::max(1, kDecSpan / f));
    while (T > 1 && 4 * iq_floats(K, f, T) > most / 2 - 1024)
      T = (T + 1) / 2;
    if (4 * iq_floats(K, f, T) <= most) {
      bytes = 4 * iq_floats(K, f, T);
      *branch = kStaged;
      *tile = T;
    }
  } else if (layout == kChannelMajor) {
    int T = kCmOutputs;
    while (T > 1 && 4 * cm_floats(K, f, T) > most / 2 - 1024) --T;
    if (4 * cm_floats(K, f, T) <= most) {
      bytes = 4 * cm_floats(K, f, T);
      *branch = kChannelTile;
      *tile = T;
    }
  }
  if (bytes > most) return kTooManyTaps;
  *smem = static_cast<int>(bytes);
  return 0;
}

// blocks of a persistent kernel's grid: as many as fit on the card at
// once, at most one a tile
template <typename Kern>
int persistent_grid(Kern kernel, int smem, long long tiles,
                    unsigned* grid) {
  int blocks = 0;
  const int e = persistent::resident_blocks(kernel, NT, smem, &blocks);
  *grid = static_cast<unsigned>(
      std::min(tiles, static_cast<long long>(blocks)));
  return e;
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
  const long long tiles = rows * ((num + tile - 1) / tile);
  unsigned grid = 0;
  if (branch == kFactor1) {
    const int e = persistent_grid(fir1_kernel, smem, tiles, &grid);
    if (e != 0) return e;
    KERNEL_LAUNCH_SMEM(fir1_kernel, grid, NT, smem, st, xp, tp, yp, rows, n,
                       num, K, start, tile);
  } else if (branch == kStaged) {
    const int e = persistent_grid(fird_kernel, smem, tiles, &grid);
    if (e != 0) return e;
    KERNEL_LAUNCH_SMEM(fird_kernel, grid, NT, smem, st, xp, tp, yp, rows, n,
                       num, K, f, start, tile);
  } else {
    if (smem > 48 * 1024) {
      cudaError_t e = cudaFuncSetAttribute(
          fir_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      if (e != cudaSuccess) return static_cast<int>(e);
    }
    const dim3 grid2(static_cast<unsigned>((num + tile - 1) / tile),
                     static_cast<unsigned>(rows));
    KERNEL_LAUNCH_SMEM(fir_kernel, grid2, NT, smem, st, xp, tp, yp, n, num, K,
                       f, start);
  }
  return static_cast<int>(cudaGetLastError());
}

// The complex form: x complex64 in `layout` (0: rows, batch row b's sample
// t at b bs + t; 1: channel-major, batch row b, channel c, sample t at b
// bs + c + t C), of n samples a row; taps [K] f32 -> y complex64, row b C
// + c at (b C + c) ys, num outputs a row (strides in complex elements; C
// is 1 for rows).  The caller checks start + (num - 1) * f + K <= n.
extern "C" int launch_fir_complex(const void* x, const void* taps, void* y,
                                  long long batch, long long C, long long bs,
                                  int layout, long long n, long long ys,
                                  long long num, int K, int f,
                                  long long start, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* tp = static_cast<const float*>(taps);
  int branch = 0, tile = 0, smem = 0;
  const int p = plan_complex(K, f, layout, &branch, &tile, &smem);
  if (p != 0) return p;
  unsigned grid = 0;
  if (branch == kStaged) {
    const long long tiles = batch * ((num + tile - 1) / tile);
    const int e = persistent_grid(fir_iq_kernel, smem, tiles, &grid);
    if (e != 0) return e;
    KERNEL_LAUNCH_SMEM(fir_iq_kernel, grid, NT, smem, st,
                       static_cast<const float*>(x), tp,
                       static_cast<float*>(y), batch, bs, n, ys, num, K, f,
                       start, tile);
  } else if (branch == kChannelTile) {
    const long long tiles = batch * ((C + kChannels - 1) / kChannels) *
                            ((num + tile - 1) / tile);
    const int e = persistent_grid(fir_cm_kernel, smem, tiles, &grid);
    if (e != 0) return e;
    KERNEL_LAUNCH_SMEM(fir_cm_kernel, grid, NT, smem, st,
                       static_cast<const float2*>(x), tp,
                       static_cast<float2*>(y), batch, C, bs, ys, num, K, f,
                       start, tile);
  } else {
    if (smem > 48 * 1024) {
      cudaError_t e = cudaFuncSetAttribute(
          fir_c1_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      if (e != cudaSuccess) return static_cast<int>(e);
    }
    const dim3 grid2(static_cast<unsigned>((num + NT - 1) / NT),
                     static_cast<unsigned>(std::min(batch * C, 65535LL)));
    KERNEL_LAUNCH_SMEM(fir_c1_kernel, grid2, NT, smem, st,
                       static_cast<const float2*>(x), tp,
                       static_cast<float2*>(y), batch, C, bs,
                       layout == kRows ? 0LL : 1LL,
                       layout == kRows ? 1LL : C, ys, num, K, f, start);
  }
  return static_cast<int>(cudaGetLastError());
}

// The plan of a launch of K taps at factor f, as launch_fir makes it:
// branch (0: factor 1, 1: the staged f > 1 branch, 2: fir_kernel), outputs
// of a tile and shared-memory bytes; kTooManyTaps where they do not fit.
extern "C" int fir_plan(int K, int f, int* branch, int* tile, int* smem) {
  return plan(K, f, branch, tile, smem);
}

// The same for the complex form in `layout` (0: rows, 1: channel-major);
// branch 1 is fir_iq_kernel, 2 fir_c1_kernel, 3 fir_cm_kernel.
extern "C" int fir_plan_complex(int K, int f, int layout, int* branch,
                                int* tile, int* smem) {
  return plan_complex(K, f, layout, branch, tile, smem);
}

extern "C" const char* kernel_error_string(int e) {
  if (e == kTooManyTaps)
    return "the taps do not fit a block's shared memory (at most 17,316 "
           "taps at factor 1 and 58,112 above on an H100; 58,112 at any "
           "factor in the complex form)";
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}

// This library links its own CUDA runtime, whose current device is not
// PyTorch's: the wrapper selects the tensors' device before each launch.
extern "C" int kernel_set_device(int device) {
  return static_cast<int>(cudaSetDevice(device));
}
