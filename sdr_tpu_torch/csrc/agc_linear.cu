// K12: the linear AGC's affine scan, f32.
//
// Over rows of real envelopes m [rows, n], or of planar I/Q x [rows, 2, n]
// whose envelope it takes itself as sqrt(re*re + im*im), the positive-gain
// AGC recurrence
//
//   g[n+1] = a[n] * g[n] + b,   a[n] = 1 - mu*m[n],   b = mu*ref,
//
// in one of two modes:
//
//   reduce  each row's affine map (A, B), g_out = A * g_in + B, by the
//           pairwise tree of scans.affine_reduce;
//   scan    from each row's entering gain g0: the gain applied to every
//           sample (envelope rows) or y = x * g on both planes (planar
//           rows), and the gain after the row, in the order of
//           scans.linear_scan.
//
// Every product, sum and root is one rounded f32 operation (__fmul_rn,
// __fadd_rn, __fsub_rn, __fsqrt_rn: no FMA contraction), in the plain
// PyTorch version's order (kernels/agc_linear.py), so the kernel equals it
// bitwise:
//
//   compose(late, early) = (la*ea, la*eb + lb);
//   scan: three levels of the Hillis-Steele doubling of
//     parallel/halo.py:exclusive_affine_prefix (step d composes each map
//     after the one d before it): inside each sub-chunk of kSub samples;
//     over each chunk's kChunk / kSub sub-chunk maps (a sub-chunk's whole
//     map is the doubling's value at its last sample, and the chunk's
//     whole map the second level's at its last sub-chunk); over a row's
//     chunk maps, as exclusive prefixes.  Then the state entering chunk
//     c, enter = PA*y0 + PB; entering sub-chunk s, g = XA*enter + XB (X
//     the exclusive prefix of the chunk's sub-chunks); and each sample's
//     h = IA*g + IB (I its inclusive prefix in the sub-chunk), the gain
//     of the next sample (sample 0 takes the row's g0);
//   reduce: the pairwise tree over the row padded with identity maps
//     (1, 0) to a power of two, which is the tree scans.affine_reduce
//     builds by padding each odd level (an identity composed after a map
//     leaves it as it is).
//
// Replaces no TPU kernel: the JAX package evaluates the recurrence with
// jax.lax.associative_scan (sdr_tpu/ops/scans.py:44-61 linear_scan, used by
// agc_gains :97-114 and agc_affine :83-94), one XLA op.  The port ran it as
// scores of whole-tensor PyTorch passes.
//
// Bound on an H100: bytes.  The AM path's planar rows ([32, 2, 327,677]
// f32) are read once and written once in the scan mode (2 x 83.9 MB,
// 0.050 ms at 3.35 TB/s) and read once in the reduce mode (0.025 ms); some
// 30 f32 operations a sample take 0.005 ms.
//
// Design: the scan in one launch, a block of kScanThreads threads a tile of
// kScanTile samples, a thread a sub-chunk, one ticket a block, the
// tickets in waves of rows (tickets.cuh).  A first-pass block stages the
// tile in shared memory (cp.async, coalesced), each thread folds its
// sub-chunk's 32 maps in registers by the aligned pairwise tree (the
// doubling's value at the last sample is that tree), the chunk's 4
// sub-chunk maps fold by __shfl_up_sync, and the chunk maps go to
// scratch; a row's last first-pass block runs the doubling over the row's
// chunk maps (in shared memory while they fit, else in place in scratch
// through L2) and writes each chunk's entering state.  An output block
// stages its tile again with the sample after it, and waits for its row
// and loads its chunks' entering states while those copies are in
// flight; it runs the sub-chunk doubling in registers (5 steps, no shared
// memory), the sub-chunk level by shuffles, and writes each sample's
// output (the gain h[i] goes to sample i + 1) through shared memory.
// (The first design ran the in-chunk doubling over 128 samples in shared
// memory, 16 bytes a sample a step for 7 steps, in each of two passes in
// three kernels.)  What is left (kernel_variants on an H100): the output's
// stores and the second read, at 4 blocks an SM (128 registers); waves of
// 32 MB beat 8 MB, whose output tickets come up before their row's
// doubling is done.  The reduce: blocks of kReduceThreads threads each
// fold an aligned tile of kReduceTile maps, 16 consecutive maps a thread
// in registers and then the threads' roots in shared memory; tiles' roots
// fold again by the same kernel until one map a row is left.

#include <cuda_runtime.h>

#include "affine.cuh"
#include "tickets.cuh"

// launches `kernel` on `grid` blocks of `block` threads (the host test
// harness defines its own)
#ifndef KERNEL_LAUNCH
#define KERNEL_LAUNCH(kernel, grid, block, stream, ...) \
  kernel<<<grid, block, 0, stream>>>(__VA_ARGS__)
#endif

namespace {

constexpr int kChunk = 128;             // CHUNK of kernels/agc_linear.py
constexpr int kSub = 32;                // SUB of kernels/agc_linear.py
constexpr int kScanThreads = 128;       // a thread a sub-chunk
constexpr int kScanTile = kScanThreads * kSub;   // samples a scan block
constexpr int kSlots = kScanTile + kScanTile / kSub + 1;   // and one more
constexpr int kRowCap = kSlots;         // chunk maps doubled in shared memory
constexpr int kPer = 8;                 // maps a thread a doubling step
constexpr int kGroup = kPer * kScanThreads;
constexpr long long kWaveBytes = 32LL << 20;     // input a wave of rows
constexpr int kSpan = 16;               // maps a thread folds in registers
constexpr int kReduceThreads = 256;
constexpr int kReduceTile = kSpan * kReduceThreads;   // maps a reduce block

// the composition and the envelope (a sample's map is (1 - mu*|x|,
// mu*ref)) of affine.cuh, shared with K15 and K16
using affine::compose;
using affine::envelope;

// the map held d lanes lower in this thread's chunk (4 lanes, a thread a
// sub-chunk); every thread of the block calls it
__device__ __forceinline__ float2 shfl_up2(float2 v, int d) {
  return make_float2(__shfl_up_sync(0xffffffffu, v.x, d, 4),
                     __shfl_up_sync(0xffffffffu, v.y, d, 4));
}

__device__ __forceinline__ int slot(int k) { return k + k / kSub; }

// Start staging cnt samples of row r from t0 (each plane: kIn 0 an
// envelope row [rows, n], 1 a planar row [rows, 2, n]; copy4, waited for
// by copy_wait).
template <int kIn>
__device__ __forceinline__ void stage(const float* __restrict__ src,
                                      long long r, long long n, long long t0,
                                      int cnt, float* xs) {
  constexpr int kPlanes = kIn == 0 ? 1 : 2;
#pragma unroll
  for (int p = 0; p < kPlanes; ++p) {
    const float* row = src + (kPlanes * r + p) * n + t0;
    for (int k = threadIdx.x; k < cnt; k += kScanThreads)
      tickets::copy4(xs + p * kSlots + slot(k), row + k);
  }
}

// The aligned pairwise tree over v[0 .. 2W): the doubling's value at the
// last of 2W maps, left in v[0].
template <int W>
__device__ __forceinline__ void fold(float2* v) {
#pragma unroll
  for (int q = 0; q < W; ++q) v[q] = compose(v[2 * q + 1], v[2 * q]);
  if constexpr (W > 1) fold<W / 2>(v);
}

// The doubling's steps D, 2D, ... over v[0 .. kSub): every inclusive
// prefix (from the last map down, each step reads the maps before it)
template <int D>
__device__ __forceinline__ void doubling(float2* v) {
#pragma unroll
  for (int l = kSub - 1; l >= D; --l) v[l] = compose(v[l], v[l - D]);
  if constexpr (2 * D < kSub) doubling<2 * D>(v);
}

// The maps of this thread's sub-chunk (tile-relative samples base..base +
// 31), identities past the row's end (t0 + k >= n).
template <int kIn>
__device__ __forceinline__ void sub_maps(const float* xs, int base,
                                         long long t0, long long n, float mu,
                                         float muref, float2* v) {
#pragma unroll
  for (int q = 0; q < kSub; ++q) {
    const int k = slot(base + q);
    v[q] = make_float2(1.f, 0.f);
    if (t0 + base + q < n) {
      const float m = kIn == 0 ? xs[k] : envelope(xs[k], xs[kSlots + k]);
      v[q] = make_float2(__fsub_rn(1.f, __fmul_rn(mu, m)), muref);
    }
  }
}

template <bool kGlobal>
__device__ __forceinline__ float2 load2(const float2* p) {
  if constexpr (kGlobal) return __ldcg(p);
  else return *p;
}

template <bool kGlobal>
__device__ __forceinline__ void store2(float2* p, float2 v) {
  if constexpr (kGlobal) __stcg(p, v);
  else *p = v;
}

// The inclusive doubling over a row's nc chunk maps m, in place (shared
// memory, or scratch through L2): each step reads every map it composes
// before any is written, kGroup maps at a time from the last group down
// (a group's writes lie above every map a later group reads).
template <bool kGlobal>
__device__ void row_doubling(float2* m, long long nc) {
  for (long long d = 1; d < nc; d <<= 1) {
    for (long long g = (nc - 1) / kGroup * kGroup; g >= 0; g -= kGroup) {
      float2 v[kPer];
#pragma unroll
      for (int q = 0; q < kPer; ++q) {
        const long long c = g + q * kScanThreads + threadIdx.x;
        if (c < nc && c >= d)
          v[q] = compose(load2<kGlobal>(m + c), load2<kGlobal>(m + c - d));
      }
      __syncthreads();
#pragma unroll
      for (int q = 0; q < kPer; ++q) {
        const long long c = g + q * kScanThreads + threadIdx.x;
        if (c < nc && c >= d) store2<kGlobal>(m + c, v[q]);
      }
      __syncthreads();
    }
  }
}

// The state entering each chunk of row r, enter = PA*g0 + PB from the
// exclusive prefix of the row's chunk maps.
template <bool kGlobal>
__device__ void row_enter(const float2* m, long long nc, float y0,
                          float* enter) {
  for (long long c = threadIdx.x; c < nc; c += kScanThreads) {
    const float2 p = c ? load2<kGlobal>(m + c - 1) : make_float2(1.f, 0.f);
    enter[c] = __fadd_rn(__fmul_rn(p.x, y0), p.y);
  }
}

// One launch of the scan: a first-pass ticket folds a tile's chunk maps
// into maps [rows, nc] (a row's last one then writes enter [rows, nc]), an
// output ticket writes a tile's outputs.
template <int kIn>
__global__ void __launch_bounds__(kScanThreads)
scan_kernel(const float* __restrict__ src, const float* __restrict__ g0,
            long long n, float mu, float muref, tickets::Waves waves,
            long long nc, float2* maps, float* enter, unsigned* counters,
            float* __restrict__ out, float* __restrict__ final_gain) {
  __shared__ float2 buf[kSlots];        // the planes, or a row's maps
  float* xs = reinterpret_cast<float*>(buf);
  constexpr int kPlanes = kIn == 0 ? 1 : 2;
  unsigned* done = counters + 2;
  unsigned* ready = done + waves.rows;
  const tickets::Work work = tickets::decode(waves,
                                             tickets::take(counters));
  const long long r = work.row, t0 = work.tile * kScanTile;
  const int j = threadIdx.x, base = j * kSub, s = j & 3;
  const long long c = work.tile * (kScanTile / kChunk) + j / 4;
  // an output tile stages the sample after it too
  const int cnt = static_cast<int>(min(
      static_cast<long long>(kScanTile + work.pass), n - t0));
  stage<kIn>(src, r, n, t0, cnt, xs);
  // an output tile: its chunks' entering states, while the copies are in
  // flight (a row's last first-pass block writes them)
  __shared__ float en_chunk[kScanThreads / 4];
  if (work.pass == 1) {
    tickets::wait(ready, r);
    __syncthreads();
    if (j < kScanThreads / 4) {
      const long long cj = work.tile * (kScanTile / kChunk) + j;
      en_chunk[j] = cj < nc ? __ldcg(enter + r * nc + cj) : 0.f;
    }
  }
  tickets::copy_wait();
  __syncthreads();
  float2 v[kSub];
  sub_maps<kIn>(xs, base, t0, n, mu, muref, v);
  if (work.pass == 0) {
    fold<kSub / 2>(v);                  // the sub-chunk's map
    // the chunk's: the second level's at its last sub-chunk
    const float2 pair = compose(v[0], shfl_up2(v[0], 1));
    const float2 whole = compose(pair, shfl_up2(pair, 2));
    if (s == 3 && c < nc) {
      maps[r * nc + c] = whole;
      __threadfence();
    }
    if (tickets::finish(done, r, waves.first)) {
      float2* row = maps + r * nc;
      if (nc <= kRowCap) {
        for (long long k = j; k < nc; k += kScanThreads)
          buf[k] = __ldcg(row + k);
        __syncthreads();
        row_doubling<false>(buf, nc);
        row_enter<false>(buf, nc, g0[r], enter + r * nc);
      } else {
        row_doubling<true>(row, nc);
        row_enter<true>(row, nc, g0[r], enter + r * nc);
      }
      tickets::publish(ready, r);
    }
    return;
  }
  doubling<1>(v);                       // the sub-chunk's prefixes
  // the chunk's sub-chunks: the doubling over 4, then exclusive
  float2 q = v[kSub - 1];
  float2 o = shfl_up2(q, 1);
  if (s >= 1) q = compose(q, o);
  o = shfl_up2(q, 2);
  if (s >= 2) q = compose(q, o);
  o = shfl_up2(q, 1);
  const float2 x = s ? o : make_float2(1.f, 0.f);
  __syncthreads();                      // every map read: outputs follow
  const float g = __fadd_rn(__fmul_rn(x.x, en_chunk[j / 4]), x.y);
#pragma unroll
  for (int l = 0; l < kSub; ++l) {
    const float h = __fadd_rn(__fmul_rn(v[l].x, g), v[l].y);
    const long long i = t0 + base + l;      // h is sample i + 1's gain
    if (i + 1 < n) {
      const int k = slot(base + l + 1);
      if constexpr (kIn == 0) {
        xs[k] = h;
      } else {
        xs[k] = __fmul_rn(xs[k], h);
        xs[kSlots + k] = __fmul_rn(xs[kSlots + k], h);
      }
    } else if (i + 1 == n) {
      final_gain[r] = h;
    }
  }
  if (t0 == 0 && j == 0) {
    const float y0 = g0[r];
    if constexpr (kIn == 0) {
      xs[0] = y0;
    } else {
      xs[0] = __fmul_rn(xs[0], y0);
      xs[kSlots] = __fmul_rn(xs[kSlots], y0);
    }
  }
  __syncthreads();
  const int lo = t0 == 0 ? 0 : 1;
#pragma unroll
  for (int p = 0; p < kPlanes; ++p) {
    float* row = out + (kPlanes * r + p) * n + t0;
    for (int k = lo + j; k < cnt; k += kScanThreads)
      row[k] = xs[p * kSlots + slot(k)];
  }
}

// One fold of the pairwise tree: each block folds tile blockIdx.x of row
// blockIdx.y (kReduceTile maps, identities past `count`) into one map,
// written to oa/ob at (row * tiles + tile) * stride.  kIn 0 and 1 read
// samples (envelopes, or planar I/Q), 2 the maps [rows, count] of an earlier fold.
template <int kIn>
__global__ void __launch_bounds__(kReduceThreads)
reduce_kernel(const void* __restrict__ src, long long count, float mu,
              float muref, float* __restrict__ oa, float* __restrict__ ob,
              int stride) {
  // 16 maps a thread, one pad a run of 16: a thread's run in 17 slots
  __shared__ float2 s[kReduceTile + kReduceThreads];
  __shared__ float2 roots[kReduceThreads];
  const int t = threadIdx.x;
  const long long r = blockIdx.y;
  const long long k0 = static_cast<long long>(blockIdx.x) * kReduceTile;
  // every load of the tile in flight before any map is formed
  float2 raw[kSpan];
#pragma unroll
  for (int q = 0; q < kSpan; ++q) {
    const long long i = k0 + t + q * kReduceThreads;
    raw[q] = make_float2(1.f, 0.f);
    if (i < count) {
      if constexpr (kIn == 2) {
        raw[q] = static_cast<const float2*>(src)[r * count + i];
      } else if constexpr (kIn == 1) {
        const float* x = static_cast<const float*>(src);
        raw[q] = make_float2(x[2 * r * count + i], x[(2 * r + 1) * count + i]);
      } else {
        raw[q].x = static_cast<const float*>(src)[r * count + i];
      }
    }
  }
#pragma unroll
  for (int q = 0; q < kSpan; ++q) {
    const int k = t + q * kReduceThreads;
    float2 v = raw[q];
    if (kIn != 2 && k0 + k < count) {
      const float m = kIn == 1 ? envelope(raw[q].x, raw[q].y) : raw[q].x;
      v = make_float2(__fsub_rn(1.f, __fmul_rn(mu, m)), muref);
    }
    s[k + k / kSpan] = v;
  }
  __syncthreads();
  float2 v[kSpan];
#pragma unroll
  for (int q = 0; q < kSpan; ++q) v[q] = s[t * (kSpan + 1) + q];
#pragma unroll
  for (int w = kSpan / 2; w >= 1; w /= 2)
#pragma unroll
    for (int q = 0; q < w; ++q) v[q] = compose(v[2 * q + 1], v[2 * q]);
  roots[t] = v[0];
  __syncthreads();
  for (int w = kReduceThreads / 2; w >= 1; w /= 2) {
    float2 u = make_float2(1.f, 0.f);
    if (t < w) u = compose(roots[2 * t + 1], roots[2 * t]);
    __syncthreads();
    if (t < w) roots[t] = u;
    __syncthreads();
  }
  if (t == 0) {
    const long long o = (r * gridDim.x + blockIdx.x) * stride;
    oa[o] = roots[0].x;
    ob[o] = roots[0].y;
  }
}

constexpr long long kMaxGrid = 0x7fffffffLL;

int invalid() { return static_cast<int>(cudaErrorInvalidValue); }

}  // namespace

// src [rows, n] envelopes or [rows, 2, n] planar f32 (planar = 1) -> A, B
// [rows] f32.  scratch: 2 * rows * (tiles of each fold but the last)
// floats.
extern "C" int launch_agc_linear_reduce(const void* src, void* A, void* B,
                                        void* scratch,
                                        long long scratch_floats,
                                        long long rows, long long n,
                                        float mu, float muref, int planar,
                                        void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (rows <= 0 || rows > 65535 || n <= 0) return invalid();
  const void* in = src;
  int kind = planar ? 1 : 0;
  long long count = n, used = 0;
  for (;;) {
    const long long tiles = (count + kReduceTile - 1) / kReduceTile;
    if (tiles > kMaxGrid) return invalid();
    float* oa = static_cast<float*>(A);
    float* ob = static_cast<float*>(B);
    int stride = 1;
    if (tiles > 1) {
      if (used + 2 * rows * tiles > scratch_floats) return invalid();
      oa = static_cast<float*>(scratch) + used;
      ob = oa + 1;
      stride = 2;
    }
    const dim3 grid(static_cast<unsigned>(tiles),
                    static_cast<unsigned>(rows));
    if (kind == 0)
      KERNEL_LAUNCH(reduce_kernel<0>, grid, kReduceThreads, st, in, count,
                    mu, muref, oa, ob, stride);
    else if (kind == 1)
      KERNEL_LAUNCH(reduce_kernel<1>, grid, kReduceThreads, st, in, count,
                    mu, muref, oa, ob, stride);
    else
      KERNEL_LAUNCH(reduce_kernel<2>, grid, kReduceThreads, st, in, count,
                    mu, muref, oa, ob, stride);
    if (tiles == 1) break;
    in = oa;
    kind = 2;
    count = tiles;
    used += 2 * rows * tiles;
  }
  return static_cast<int>(cudaGetLastError());
}

// src as above, g0 [rows] f32 -> out: the gains [rows, n] (envelope rows)
// or y [rows, 2, n] (planar), final_gain [rows].  scratch: 3 * rows *
// chunks + 2 * rows + 2 floats (the counters, the chunk maps, the
// entering states).
extern "C" int launch_agc_linear_scan(const void* src, const void* g0,
                                      void* out, void* final_gain,
                                      void* scratch, long long scratch_floats,
                                      long long rows, long long n, float mu,
                                      float muref, int planar, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (rows <= 0 || rows > 65535 || n <= 0) return invalid();
  const long long nc = (n + kChunk - 1) / kChunk;
  const long long tiles = (n + kScanTile - 1) / kScanTile;
  const long long words = tickets::counter_words(rows);
  const tickets::Waves waves{
      rows, tickets::wave_rows(n * 4 * (planar ? 2 : 1), kWaveBytes, rows),
      tiles, tiles};
  if (tickets::total(waves) > kMaxGrid ||
      words + 3 * rows * nc > scratch_floats)
    return invalid();
  unsigned* counters = static_cast<unsigned*>(scratch);
  float2* maps = reinterpret_cast<float2*>(counters + words);
  float* enter = reinterpret_cast<float*>(maps + rows * nc);
  const int rc = static_cast<int>(
      cudaMemsetAsync(counters, 0, words * sizeof(unsigned), st));
  if (rc != 0) return rc;
  const float* x = static_cast<const float*>(src);
  const float* g = static_cast<const float*>(g0);
  float* o = static_cast<float*>(out);
  float* f = static_cast<float*>(final_gain);
  const unsigned grid = static_cast<unsigned>(tickets::total(waves));
  if (planar)
    KERNEL_LAUNCH(scan_kernel<1>, grid, kScanThreads, st, x, g, n, mu, muref,
                  waves, nc, maps, enter, counters, o, f);
  else
    KERNEL_LAUNCH(scan_kernel<0>, grid, kScanThreads, st, x, g, n, mu, muref,
                  waves, nc, maps, enter, counters, o, f);
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
