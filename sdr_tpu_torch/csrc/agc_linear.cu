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
//   scan: inside each chunk of kChunk samples the Hillis-Steele doubling
//     of parallel/halo.py:exclusive_affine_prefix (the chunk's whole map
//     is a_last composed after the exclusive prefix at the last sample),
//     then the same doubling over a row's chunk maps, the state entering
//     chunk c enter = PA*y0 + PB, and each sample's h = a*(EA*enter + EB)
//     + b; sample i takes the gain h[i-1] (sample 0 the row's g0);
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
// Design: a scan in three kernels on the stream.  (1) a block of kChunk
// threads a chunk, one sample a thread: the envelope, the sample's map and
// the doubling in shared memory; the last thread writes the chunk's map
// (blocks of 8 chunks, a thread a sample of each, ran slower on the H100:
// the doubling's shared-memory traffic, 16 bytes a sample a step, bounds
// both);
// (2) a block a row: the doubling over the row's chunk maps in two global
// buffers (a few KB a row, in L2; each thread's loads of a step issued
// together), then each chunk's entering state;
// (3) as (1), then each sample's gain and its output.  So the scan reads
// the input twice (the second read replaces storing each sample's prefix)
// and writes the output once.  The reduce: blocks of kReduceThreads
// threads each fold an aligned tile of kReduceTile maps, 16 consecutive
// maps a thread in registers and then the threads' roots in shared
// memory; tiles' roots fold again by the same kernel until one map a row
// is left.

#include <cuda_runtime.h>

// launches `kernel` on `grid` blocks of `block` threads (the host test
// harness defines its own)
#ifndef KERNEL_LAUNCH
#define KERNEL_LAUNCH(kernel, grid, block, stream, ...) \
  kernel<<<grid, block, 0, stream>>>(__VA_ARGS__)
#endif

namespace {

constexpr int kChunk = 128;             // scans.CHUNK: samples a chunk
constexpr int kBatch = 4;               // maps a thread loads at once (2)
constexpr int kPrefixThreads = 256;     // threads of a row's chunk doubling
constexpr int kSpan = 16;               // maps a thread folds in registers
constexpr int kReduceThreads = 256;
constexpr int kReduceTile = kSpan * kReduceThreads;   // maps a reduce block

// the map of `late` composed after `early`
__device__ __forceinline__ float2 compose(float2 late, float2 early) {
  return make_float2(__fmul_rn(late.x, early.x),
                     __fadd_rn(__fmul_rn(late.x, early.y), late.y));
}

// sample i's map (1 - mu*m, mu*ref): kIn 0 reads an envelope row
// [rows, n], 1 a planar row [rows, 2, n]
__device__ __forceinline__ float envelope(float re, float im) {
  return __fsqrt_rn(__fadd_rn(__fmul_rn(re, re), __fmul_rn(im, im)));
}

template <int kIn>
__device__ __forceinline__ float2 sample_map(const float* src, long long r,
                                             long long n, long long i,
                                             float mu, float muref) {
  const float m = kIn == 0 ? src[r * n + i]
                           : envelope(src[2 * r * n + i],
                                      src[(2 * r + 1) * n + i]);
  return make_float2(__fsub_rn(1.f, __fmul_rn(mu, m)), muref);
}

// The inclusive doubling over a chunk's maps, thread j holding map j:
// returns the buffer of s that holds every prefix of maps 0..j.
__device__ __forceinline__ int chunk_prefix(float2 v, float2 (*s)[kChunk]) {
  const int j = threadIdx.x;
  int p = 0;
  s[0][j] = v;
  __syncthreads();
  for (int d = 1; d < kChunk; d <<= 1) {
    if (j >= d) v = compose(v, s[p][j - d]);
    s[p ^ 1][j] = v;
    __syncthreads();
    p ^= 1;
  }
  return p;
}

// (1) each chunk's whole map: grid (chunks, rows)
template <int kIn>
__global__ void __launch_bounds__(kChunk)
chunk_maps_kernel(const float* __restrict__ src, long long n, float mu,
                  float muref, float2* __restrict__ maps) {
  __shared__ float2 s[2][kChunk];
  const long long c = blockIdx.x, r = blockIdx.y, nc = gridDim.x;
  const long long i = c * kChunk + threadIdx.x;
  const float2 own = i < n ? sample_map<kIn>(src, r, n, i, mu, muref)
                           : make_float2(1.f, 0.f);
  const int p = chunk_prefix(own, s);
  if (threadIdx.x == kChunk - 1)        // a_last after the exclusive prefix
    maps[r * nc + c] = compose(own, s[p][kChunk - 2]);
}

// (2) the state entering each chunk of a row: the doubling over the row's
// chunk maps in m0 and m1 (m0 holds them; both are overwritten), then
// enter = PA*g0 + PB from the exclusive prefix.  Grid: rows.
__global__ void __launch_bounds__(kPrefixThreads)
chunk_enter_kernel(float2* m0, float2* m1, long long nc,
                   const float* __restrict__ g0, float* __restrict__ enter) {
  const long long r = blockIdx.x;
  float2* in = m0 + r * nc;
  float2* out = m1 + r * nc;
  for (long long d = 1; d < nc; d <<= 1) {
    for (long long c0 = threadIdx.x; c0 < nc;
         c0 += kBatch * kPrefixThreads) {
      float2 v[kBatch], e[kBatch];
#pragma unroll
      for (int q = 0; q < kBatch; ++q) {
        const long long c = c0 + q * kPrefixThreads;
        if (c < nc) v[q] = in[c];
        if (c < nc && c >= d) e[q] = in[c - d];
      }
#pragma unroll
      for (int q = 0; q < kBatch; ++q) {
        const long long c = c0 + q * kPrefixThreads;
        if (c < nc) out[c] = c >= d ? compose(v[q], e[q]) : v[q];
      }
    }
    __syncthreads();
    float2* t = in;
    in = out;
    out = t;
  }
  const float y0 = g0[r];
  for (long long c = threadIdx.x; c < nc; c += blockDim.x) {
    const float2 p = c ? in[c - 1] : make_float2(1.f, 0.f);
    enter[r * nc + c] = __fadd_rn(__fmul_rn(p.x, y0), p.y);
  }
}

// sample k of row r takes the gain g: kIn 0 writes g, 1 both planes x*g
template <int kIn>
__device__ __forceinline__ void put(const float* src, float* out,
                                    long long r, long long n, long long k,
                                    float g) {
  if constexpr (kIn == 0) {
    out[r * n + k] = g;
  } else {
    const long long o = 2 * r * n + k;
    out[o] = __fmul_rn(src[o], g);
    out[o + n] = __fmul_rn(src[o + n], g);
  }
}

// (3) each sample's gain h[i] = a*(EA*enter + EB) + b, the gain of sample
// i + 1, and its output; the row's last h is the gain after the row.
// Grid (chunks, rows).
template <int kIn>
__global__ void __launch_bounds__(kChunk)
chunk_out_kernel(const float* __restrict__ src, long long n, float mu,
                 float muref, const float* __restrict__ enter,
                 const float* __restrict__ g0, float* __restrict__ out,
                 float* __restrict__ final_gain) {
  __shared__ float2 s[2][kChunk];
  const int j = threadIdx.x;
  const long long c = blockIdx.x, r = blockIdx.y, nc = gridDim.x;
  const long long i = c * kChunk + j;
  const float2 own = i < n ? sample_map<kIn>(src, r, n, i, mu, muref)
                           : make_float2(1.f, 0.f);
  const int p = chunk_prefix(own, s);
  const float2 e = j ? s[p][j - 1] : make_float2(1.f, 0.f);
  if (i < n) {
    const float en = enter[r * nc + c];
    const float h = __fadd_rn(
        __fmul_rn(own.x, __fadd_rn(__fmul_rn(e.x, en), e.y)), own.y);
    if (i + 1 < n) put<kIn>(src, out, r, n, i + 1, h);
    else final_gain[r] = h;
  }
  if (i == 0) put<kIn>(src, out, r, n, 0, g0[r]);
}

// One fold of the pairwise tree: each block folds tile blockIdx.x of row
// blockIdx.y (kReduceTile maps, identities past `count`) into one map,
// written to oa/ob at (row * tiles + tile) * stride.  kIn 0 and 1 read
// samples (sample_map), 2 the maps [rows, count] of an earlier fold.
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
// or y [rows, 2, n] (planar), final_gain [rows].  scratch: 5 * rows *
// chunks floats (two buffers of chunk maps, the entering states).
extern "C" int launch_agc_linear_scan(const void* src, const void* g0,
                                      void* out, void* final_gain,
                                      void* scratch, long long scratch_floats,
                                      long long rows, long long n, float mu,
                                      float muref, int planar, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (rows <= 0 || rows > 65535 || n <= 0) return invalid();
  const long long nc = (n + kChunk - 1) / kChunk;
  if (nc > kMaxGrid || 5 * rows * nc > scratch_floats) return invalid();
  float2* m0 = static_cast<float2*>(scratch);
  float2* m1 = m0 + rows * nc;
  float* enter = reinterpret_cast<float*>(m1 + rows * nc);
  const float* x = static_cast<const float*>(src);
  const float* g = static_cast<const float*>(g0);
  float* o = static_cast<float*>(out);
  float* f = static_cast<float*>(final_gain);
  const dim3 grid(static_cast<unsigned>(nc), static_cast<unsigned>(rows));
  const unsigned row_grid = static_cast<unsigned>(rows);
  if (planar) {
    KERNEL_LAUNCH(chunk_maps_kernel<1>, grid, kChunk, st, x, n, mu, muref,
                  m0);
    KERNEL_LAUNCH(chunk_enter_kernel, row_grid, kPrefixThreads, st, m0, m1,
                  nc, g, enter);
    KERNEL_LAUNCH(chunk_out_kernel<1>, grid, kChunk, st, x, n, mu, muref,
                  enter, g, o, f);
  } else {
    KERNEL_LAUNCH(chunk_maps_kernel<0>, grid, kChunk, st, x, n, mu, muref,
                  m0);
    KERNEL_LAUNCH(chunk_enter_kernel, row_grid, kPrefixThreads, st, m0, m1,
                  nc, g, enter);
    KERNEL_LAUNCH(chunk_out_kernel<0>, grid, kChunk, st, x, n, mu, muref,
                  enter, g, o, f);
  }
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
