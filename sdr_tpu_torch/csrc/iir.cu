// K13: one constant-coefficient IIR section over rows x [rows, n] f32,
// with history carried in:
//
//   u[n] = b0 x[n] + b1 x[n-1] (+ b2 x[n-2])           (f32, as rounded
//                                                       by the plain form)
//   y[n] = u[n] + a1 y[n-1] (+ a2 y[n-2])              (order p = 1 or 2)
//
// from each row's entering inputs (x[-2], x[-1]) and entering state
// (y[-1], ..., y[-p]).  It writes y (unless store is 0) and the state
// after the row, (y[n-1], ..., y[n-p]).  The DC blocker is the section
// b = (1, -1), a = (alpha,); a biquad of Iir the section (b0, b1, b2),
// (-a1, -a2).
//
// Replaces no TPU kernel: the JAX package evaluates the recurrence with
// jax.lax.associative_scan (sdr_tpu/ops/iir.py:30-65 linear_recurrence,
// sdr_tpu/ops/scans.py:64-80 dc_blocker), one XLA op.  The port ran it as
// the blocked closed form of ops/iir.py: cuBLAS products and some thirty
// PyTorch passes.
//
// Bound on an H100: bytes.  The AM path's DC blocker ([32, 327,677] f32)
// reads and writes 41.9 MB each way, 0.025 ms at 3.35 TB/s; the stereo
// de-emphasis ([32, 2, 196,671]) 0.030 ms.  The operations (about 5 a
// sample) take a few microseconds.
//
// Numbers: the drive u is rounded in f32 exactly as the plain version
// (kernels/iir.py) rounds it; the recurrence runs in float64 (FMA) and
// each output is rounded to f32 once, so y is the recurrence of u within
// about an ulp.  The plain version's blocked f32 products round otherwise:
// the two agree within 1e-5 of each row's peak |y| (H7's limit), not
// bitwise.
//
// Design: three kernels on the stream, over tiles of kTile samples, a
// block a tile, a thread a run of kSpan samples.  (1) each tile but a
// row's last stages its samples in shared memory (coalesced), each thread
// runs its samples from a zero state, and one thread chains the runs'
// final states into the tile's, S' = C^kSpan S + v; (2) a block a row
// chains the tiles the same way by C^kTile from the entering state: the
// state entering each tile; (3) each tile (or only each row's last, when
// just the final state is asked for) stages its samples again, chains its
// runs from the tile's entering state, reruns each from its own entering
// state and stores y through shared memory.  The powers of the companion
// matrix C come from float64 on the host.

#include <cuda_runtime.h>

// launches `kernel` on `grid` blocks of `block` threads (the host test
// harness defines its own)
#ifndef KERNEL_LAUNCH
#define KERNEL_LAUNCH(kernel, grid, block, stream, ...) \
  kernel<<<grid, block, 0, stream>>>(__VA_ARGS__)
#endif

namespace {

constexpr int kThreads = 128;
constexpr int kSpan = 32;                      // samples a thread
constexpr int kTile = kThreads * kSpan;        // samples a block
constexpr int kPad = kTile + kThreads;         // a pad after each run
constexpr int kSegment = 1024;                 // tiles a chaining step

struct Section {
  float b[3];           // feed-forward taps
  int q;                // taps used: 2 or 3
  double a[2];          // feedback a_1, a_2
  double span[4];       // C^kSpan, row-major p x p
  double tile[4];       // C^kTile
};

// s' = M s + v for the p-state s (y[-1], ..., y[-p])
template <int P>
__device__ __forceinline__ void advance(const double* M, double* s,
                                        const double* v) {
  if constexpr (P == 1) {
    s[0] = fma(M[0], s[0], v[0]);
  } else {
    const double s0 = fma(M[0], s[0], fma(M[1], s[1], v[0]));
    const double s1 = fma(M[2], s[0], fma(M[3], s[1], v[1]));
    s[0] = s0;
    s[1] = s1;
  }
}

__device__ __forceinline__ float drive(const Section& sec, float x0,
                                       float x1, float x2) {
  float u = __fadd_rn(__fmul_rn(sec.b[0], x0), __fmul_rn(sec.b[1], x1));
  if (sec.q == 3) u = __fadd_rn(u, __fmul_rn(sec.b[2], x2));
  return u;
}

template <int P>
__device__ __forceinline__ void step(const Section& sec, float u,
                                     double* s) {
  double y = fma(sec.a[0], s[0], static_cast<double>(u));
  if constexpr (P == 2) {
    y = fma(sec.a[1], s[1], y);
    s[1] = s[0];
  }
  s[0] = y;
}

__device__ __forceinline__ int slot(int k) { return k + k / kSpan; }

// Stage a tile's samples (cnt of them, from row r at t0) and the two
// before it; returns x of tile-relative sample k (k >= -2).
struct Tile {
  float* xs;
  float h[2];           // x[t0 - 2], x[t0 - 1]
  __device__ float at(int k) const { return k < 0 ? h[k + 2] : xs[slot(k)]; }
};

__device__ __forceinline__ void stage(const float* __restrict__ x,
                                      const float* __restrict__ xin,
                                      long long r, long long n, long long t0,
                                      int cnt, Tile* tile) {
  const float* row = x + r * n + t0;
  float v[kSpan];                       // every load in flight at once
#pragma unroll
  for (int q = 0; q < kSpan; ++q) {
    const int k = threadIdx.x + q * kThreads;
    v[q] = k < cnt ? row[k] : 0.f;
  }
#pragma unroll
  for (int q = 0; q < kSpan; ++q) {
    const int k = threadIdx.x + q * kThreads;
    if (k < cnt) tile->xs[slot(k)] = v[q];
  }
  row = x + r * n;
  for (int k = 0; k < 2; ++k) {
    const long long i = t0 - 2 + k;
    tile->h[k] = i >= 0 ? row[i] : xin[2 * r + 2 + i];
  }
}

// Run samples [base, end) of a tile (end - base <= kSpan) from the state
// s, the inputs before base being x1 = x[base-1], x2 = x[base-2]; with
// `out` the outputs overwrite the staged samples.
template <int P>
__device__ __forceinline__ void run(const Section& sec, const Tile& tile,
                                    int base, int end, float x1, float x2,
                                    double* s, bool out) {
#pragma unroll
  for (int q = 0; q < kSpan; ++q) {
    const int k = base + q;
    if (k >= end) break;
    const float x0 = tile.xs[slot(k)];
    step<P>(sec, drive(sec, x0, x1, x2), s);
    x2 = x1;
    x1 = x0;
    if (out) tile.xs[slot(k)] = static_cast<float>(s[0]);
  }
}

// (1) each full tile's final state from a zero state: ends [rows, tiles,
// P].  Grid (tiles - 1, rows): a row's last tile is not needed.
template <int P>
__global__ void __launch_bounds__(kThreads)
tile_ends_kernel(const float* __restrict__ x, const float* __restrict__ xin,
                 long long n, Section sec, double* __restrict__ ends,
                 long long tiles) {
  __shared__ float xs[kPad];
  __shared__ double v[kThreads][P];
  const long long r = blockIdx.y, tile_ix = blockIdx.x;
  const long long t0 = tile_ix * kTile;
  Tile tile{xs, {0.f, 0.f}};
  stage(x, xin, r, n, t0, kTile, &tile);
  __syncthreads();
  const int base = threadIdx.x * kSpan;
  double s[P] = {};
  run<P>(sec, tile, base, base + kSpan, tile.at(base - 1),
         tile.at(base - 2), s, false);
  for (int k = 0; k < P; ++k) v[threadIdx.x][k] = s[k];
  __syncthreads();
  if (threadIdx.x == 0) {
    double e[P] = {};
    for (int t = 0; t < kThreads; ++t) advance<P>(sec.span, e, v[t]);
    for (int k = 0; k < P; ++k) ends[(r * tiles + tile_ix) * P + k] = e[k];
  }
}

// (2) the state entering each tile of a row, from the row's entering
// state s0 [rows, P] f32 and the tiles' ends: enter [rows, tiles, P].
// Grid: rows.
template <int P>
__global__ void __launch_bounds__(kThreads)
tile_enter_kernel(const double* __restrict__ ends,
                  const float* __restrict__ s0, Section sec,
                  double* __restrict__ enter, long long tiles) {
  __shared__ double seg[kSegment][P];
  const long long r = blockIdx.x;
  double s[P];
  for (int k = 0; k < P; ++k) s[k] = s0[r * P + k];
  for (long long first = 0; first < tiles; first += kSegment) {
    const int cnt = static_cast<int>(min(static_cast<long long>(kSegment),
                                         tiles - first));
    for (int i = threadIdx.x; i < cnt * P; i += kThreads)
      seg[i / P][i % P] = ends[(r * tiles + first) * P + i];
    __syncthreads();
    if (threadIdx.x == 0) {
      for (int t = 0; t < cnt; ++t) {
        double e[P];
        for (int k = 0; k < P; ++k) e[k] = seg[t][k];
        for (int k = 0; k < P; ++k) seg[t][k] = s[k];
        advance<P>(sec.tile, s, e);
      }
    }
    __syncthreads();
    for (int i = threadIdx.x; i < cnt * P; i += kThreads)
      enter[(r * tiles + first) * P + i] = seg[i / P][i % P];
    __syncthreads();
  }
}

// (3) the outputs of tiles first.. (grid (tiles - first, rows)) from
// their entering states, y written unless store is 0; the block of a
// row's last tile writes the state after the row, s_out [rows, P].
template <int P>
__global__ void __launch_bounds__(kThreads)
tile_out_kernel(const float* __restrict__ x, const float* __restrict__ xin,
                long long n, Section sec, const double* __restrict__ enter,
                long long tiles, long long first, float* __restrict__ y,
                float* __restrict__ s_out, int store) {
  __shared__ float xs[kPad];
  __shared__ double v[kThreads][P];
  const long long r = blockIdx.y, tile_ix = first + blockIdx.x;
  const long long t0 = tile_ix * kTile;
  const int cnt = static_cast<int>(min(static_cast<long long>(kTile),
                                       n - t0));
  Tile tile{xs, {0.f, 0.f}};
  stage(x, xin, r, n, t0, cnt, &tile);
  __syncthreads();
  const int base = threadIdx.x * kSpan;
  const int end = min(base + kSpan, cnt);
  // the run's inputs before it, read before any output overwrites them
  const float x1 = tile.at(base - 1), x2 = tile.at(base - 2);
  double s[P] = {};
  run<P>(sec, tile, base, end, x1, x2, s, false);
  for (int k = 0; k < P; ++k) v[threadIdx.x][k] = s[k];
  __syncthreads();
  if (threadIdx.x == 0) {       // v[t] becomes the state entering run t
    double e[P];
    for (int k = 0; k < P; ++k) e[k] = enter[(r * tiles + tile_ix) * P + k];
    for (int t = 0; t < kThreads; ++t) {
      double w[P];
      for (int k = 0; k < P; ++k) {
        w[k] = v[t][k];
        v[t][k] = e[k];
      }
      advance<P>(sec.span, e, w);
    }
  }
  __syncthreads();
  for (int k = 0; k < P; ++k) s[k] = v[threadIdx.x][k];
  run<P>(sec, tile, base, end, x1, x2, s, store != 0);
  if (tile_ix == tiles - 1 && base < cnt && cnt <= base + kSpan)
    for (int k = 0; k < P; ++k) s_out[r * P + k] = static_cast<float>(s[k]);
  if (store) {
    __syncthreads();
    float* out = y + r * n + t0;
    for (int k = threadIdx.x; k < cnt; k += kThreads) out[k] = xs[slot(k)];
  }
}

int invalid() { return static_cast<int>(cudaErrorInvalidValue); }

template <int P>
int launch(const float* x, const float* xin, const float* s0, float* y,
           float* s_out, double* scratch, long long rows, long long n,
           const Section& sec, int store, cudaStream_t st) {
  const long long tiles = (n + kTile - 1) / kTile;
  double* ends = scratch;
  double* enter = scratch + rows * tiles * P;
  const unsigned R = static_cast<unsigned>(rows);
  if (tiles > 1)
    KERNEL_LAUNCH(tile_ends_kernel<P>,
                  dim3(static_cast<unsigned>(tiles - 1), R), kThreads, st,
                  x, xin, n, sec, ends, tiles);
  KERNEL_LAUNCH(tile_enter_kernel<P>, R, kThreads, st, ends, s0, sec, enter,
                tiles);
  const long long first = store ? 0 : tiles - 1;
  KERNEL_LAUNCH(tile_out_kernel<P>,
                dim3(static_cast<unsigned>(tiles - first), R), kThreads, st,
                x, xin, n, sec, enter, tiles, first, y, s_out, store);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x [rows, n], xin [rows, 2] (x[-2], x[-1]), s0 [rows, p] (y[-1], ...,
// y[-p]) f32 -> y [rows, n] (unless store is 0; y may then be null),
// s_out [rows, p] (y[n-1], ..., y[n-p]).  params (float64): b0, b1, b2,
// q, a1, a2, C^kSpan (4), C^kTile (4), the matrices p x p in their first
// p*p entries.  scratch: 2 * rows * tiles * p doubles.
extern "C" int launch_iir_section(const void* x, const void* xin,
                                  const void* s0, void* y, void* s_out,
                                  void* scratch, long long scratch_doubles,
                                  long long rows, long long n, int p,
                                  const void* params, int store,
                                  void* stream) {
  const long long tiles = (n + kTile - 1) / kTile;
  if (rows <= 0 || rows > 65535 || n <= 0 || (p != 1 && p != 2) ||
      tiles > 0x7fffffffLL || 2 * rows * tiles * p > scratch_doubles)
    return invalid();
  const double* h = static_cast<const double*>(params);
  Section sec;
  for (int k = 0; k < 3; ++k) sec.b[k] = static_cast<float>(h[k]);
  sec.q = static_cast<int>(h[3]);
  if (sec.q != 2 && sec.q != 3) return invalid();
  sec.a[0] = h[4];
  sec.a[1] = h[5];
  for (int k = 0; k < 4; ++k) {
    sec.span[k] = h[6 + k];
    sec.tile[k] = h[10 + k];
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* xf = static_cast<const float*>(x);
  const float* xi = static_cast<const float*>(xin);
  const float* sf = static_cast<const float*>(s0);
  float* yf = static_cast<float*>(y);
  float* of = static_cast<float*>(s_out);
  double* sc = static_cast<double*>(scratch);
  if (p == 1)
    return launch<1>(xf, xi, sf, yf, of, sc, rows, n, sec, store, st);
  return launch<2>(xf, xi, sf, yf, of, sc, rows, n, sec, store, st);
}

extern "C" const char* kernel_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}

// This library links its own CUDA runtime, whose current device is not
// PyTorch's: the wrapper selects the tensors' device before each launch.
extern "C" int kernel_set_device(int device) {
  return static_cast<int>(cudaSetDevice(device));
}
