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
// de-emphasis ([32, 2, 196,608]) 0.030 ms.  The final state alone reads
// once: 0.0125 and 0.0150 ms.  The operations (about 5 a sample) take a
// few microseconds.
//
// Numbers: the drive u is rounded in f32 exactly as the plain version
// (kernels/iir.py) rounds it; the recurrence runs in float64 (FMA) and
// each output is rounded to f32 once, so y is the recurrence of u within
// about an ulp.  The plain version's blocked f32 products round otherwise:
// the two agree within 1e-5 of each row's peak |y| (H7's limit), not
// bitwise.  Every composition's order is fixed by the geometry, so two
// launches agree bitwise, and the final-state launch's state is the full
// launch's.
//
// Design: one launch over tiles of kTile samples, a block a tile (one
// ticket), a thread a run of kSpan samples, the tickets in waves of rows
// (tickets.cuh).  A first-pass block stages a tile (every tile of a row
// but its last) in shared memory, each thread runs its samples from a
// zero state (the drives formed ahead, only the float64 chain in turn),
// and the runs' maps s -> C^kSpan s + w_j are scanned across the block:
// by __shfl_up_sync within each warp, then across the 4 warps through
// shared memory, with the powers of the companion matrix C from a float64
// table (C^(kSpan k), C^(kTile k), k = 0..32, made on the host).  The
// tile's end state goes to scratch; a row's last first-pass block scans
// its tiles' ends the same way, by C^kTile, into the state entering each
// tile.  An output block (every tile, or only each row's last when just
// the final state is asked for) stages its tile again, waits for its row
// and loads its entering state while those copies are in flight, scans
// its runs from it, reruns each run from its own and stores y through
// shared memory.  (The first design ran three kernels, read the input
// twice from HBM and chained each tile's 128 runs in one thread.)  What is
// left (kernel_variants on an H100): the stores, the runs, the wait and
// the scans, a few microseconds each, over some 2,500 short blocks.

#include <cuda_runtime.h>

#include "tickets.cuh"

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
constexpr int kPowers = 33;                    // C^(step k), k = 0..32
constexpr long long kWaveBytes = 8LL << 20;    // input a wave of rows

struct Section {
  float b[3];           // feed-forward taps
  int q;                // taps used: 2 or 3
  double a[2];          // feedback a_1, a_2
  const double* span;   // C^(kSpan k), k = 0..32, 4 doubles each (p x p)
  const double* tile;   // C^(kTile k)
};

// s' = M s + v for the p-state s (y[-1], ..., y[-p])
template <int P>
__device__ __forceinline__ void advance(const double* M, double* s,
                                        const double* v) {
  if constexpr (P == 1) {
    s[0] = fma(__ldg(M), s[0], v[0]);
  } else {
    const double s0 = fma(__ldg(M), s[0], fma(__ldg(M + 1), s[1], v[0]));
    const double s1 = fma(__ldg(M + 2), s[0], fma(__ldg(M + 3), s[1], v[1]));
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

// y = a_1 y[-1] + a_2 y[-2] + u, the a_2 term first (off the chain)
template <int P>
__device__ __forceinline__ void step(const Section& sec, float u,
                                     double* s) {
  if constexpr (P == 1) {
    s[0] = fma(sec.a[0], s[0], static_cast<double>(u));
  } else {
    const double y = fma(sec.a[0], s[0],
                         fma(sec.a[1], s[1], static_cast<double>(u)));
    s[1] = s[0];
    s[0] = y;
  }
}

__device__ __forceinline__ int slot(int k) { return k + k / kSpan; }

// A staged tile: x of tile-relative sample k (k >= -2).
struct Tile {
  float* xs;
  float h[2];           // x[t0 - 2], x[t0 - 1]
  __device__ float at(int k) const { return k < 0 ? h[k + 2] : xs[slot(k)]; }
};

// Start staging cnt samples of row r from t0 into xs (copy4, waited for
// by copy_wait), with the two samples before them (from the row, or the
// row's entering inputs).
__device__ __forceinline__ Tile stage(const float* __restrict__ x,
                                      const float* __restrict__ xin,
                                      long long r, long long n, long long t0,
                                      int cnt, float* xs) {
  const float* row = x + r * n;
  for (int k = threadIdx.x; k < cnt; k += kThreads)
    tickets::copy4(xs + slot(k), row + t0 + k);
  Tile tile{xs, {0.f, 0.f}};
  for (int k = 0; k < 2; ++k) {
    const long long i = t0 - 2 + k;
    tile.h[k] = i >= 0 ? row[i] : xin[2 * r + 2 + i];
  }
  return tile;
}

// Run samples [base, end) of a tile (end - base <= kSpan) from the state
// s, the inputs before base being x1 = x[base-1], x2 = x[base-2]; with
// `out` the outputs overwrite the staged samples.  The drives are formed
// kGroup at a time ahead of their steps, so mostly the float64 chain
// runs in turn.
template <int P>
__device__ __forceinline__ void run(const Section& sec, const Tile& tile,
                                    int base, int end, float x1, float x2,
                                    double* s, bool out) {
  constexpr int kGroup = 8;
#pragma unroll
  for (int g = 0; g < kSpan; g += kGroup) {
    float u[kGroup];
#pragma unroll
    for (int q = 0; q < kGroup; ++q) {
      const float x0 = tile.xs[slot(base + g + q)];   // past end: not used
      u[q] = drive(sec, x0, x1, x2);
      x2 = x1;
      x1 = x0;
    }
#pragma unroll
    for (int q = 0; q < kGroup; ++q) {
      if (base + g + q < end) {
        step<P>(sec, u[q], s);
        if (out) tile.xs[slot(base + g + q)] = static_cast<float>(s[0]);
      }
    }
  }
}

// The block's exclusive scan of the maps s -> M s + w_j, one a thread
// (M^k at pw + 4k, k = 0..32, M the same for every thread): from the
// state `enter` entering thread 0, `w` becomes the state entering this
// thread; returns in `after` the state after thread kThreads - 1.  Within
// each warp the doubling by __shfl_up_sync (step d composes by M^d), then
// the warps' totals in turn by M^32.  Every thread of the block calls it.
template <int P>
__device__ __forceinline__ void block_scan(const double* pw, double* w,
                                           const double* enter,
                                           double* after,
                                           double (*totals)[P]) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    double o[P];
#pragma unroll
    for (int k = 0; k < P; ++k) o[k] = __shfl_up_sync(0xffffffffu, w[k], d);
    if (lane >= d) {
      double v[P];
#pragma unroll
      for (int k = 0; k < P; ++k) v[k] = w[k];
      advance<P>(pw + 4 * d, o, v);
#pragma unroll
      for (int k = 0; k < P; ++k) w[k] = o[k];
    }
  }
  if (lane == 31)
    for (int k = 0; k < P; ++k) totals[warp][k] = w[k];
  double ex[P];
#pragma unroll
  for (int k = 0; k < P; ++k) {
    ex[k] = __shfl_up_sync(0xffffffffu, w[k], 1);
    if (lane == 0) ex[k] = 0.0;
  }
  __syncthreads();
  // the state entering each warp, then after the last, in turn
  double e[P], mine[P];
  for (int k = 0; k < P; ++k) e[k] = enter[k];
  for (int v = 0; v < kThreads / 32; ++v) {
    if (v == warp)
      for (int k = 0; k < P; ++k) mine[k] = e[k];
    advance<P>(pw + 4 * 32, e, totals[v]);
  }
  for (int k = 0; k < P; ++k) after[k] = e[k];
  advance<P>(pw + 4 * lane, mine, ex);
  for (int k = 0; k < P; ++k) w[k] = mine[k];
  __syncthreads();                      // totals free for the next scan
}

// The state entering each tile of row r from the tiles' ends [rows,
// tiles, P] (every tile but the last) and the row's entering state: the
// tiles in segments of kThreads, each scanned by C^kTile from the state
// entering the segment.  enter [rows, tiles, P]; tile 0's is s0's.
template <int P>
__device__ void row_scan(const Section& sec, const double* ends,
                         const float* __restrict__ s0, double* enter,
                         long long r, long long tiles,
                         double (*totals)[P]) {
  double e[P];
  for (int k = 0; k < P; ++k) e[k] = s0[r * P + k];
  for (long long first = 0; first < tiles - 1; first += kThreads) {
    const long long i = first + threadIdx.x;
    double w[P], after[P];
    for (int k = 0; k < P; ++k)
      w[k] = i < tiles - 1 ? __ldcg(ends + (r * tiles + i) * P + k) : 0.0;
    block_scan<P>(sec.tile, w, e, after, totals);
    // w enters tile i, so the state after tile i enters tile i + 1
    if (i < tiles - 1) {
      double v[P];
      for (int k = 0; k < P; ++k)
        v[k] = __ldcg(ends + (r * tiles + i) * P + k);
      advance<P>(sec.tile + 4, w, v);
      for (int k = 0; k < P; ++k) enter[(r * tiles + i + 1) * P + k] = w[k];
    }
    for (int k = 0; k < P; ++k) e[k] = after[k];
  }
}

template <int P>
__global__ void __launch_bounds__(kThreads)
section_kernel(const float* __restrict__ x, const float* __restrict__ xin,
               const float* __restrict__ s0, long long n, Section sec,
               tickets::Waves waves, long long tiles, double* ends,
               double* enter, unsigned* counters, float* __restrict__ y,
               float* __restrict__ s_out, int store) {
  __shared__ float xs[kPad];
  __shared__ double totals[kThreads / 32][P];
  unsigned* done = counters + 2;
  unsigned* ready = done + waves.rows;
  const tickets::Work work = tickets::decode(waves,
                                             tickets::take(counters));
  const long long r = work.row;
  // an output ticket of the final-state launch is its row's last tile
  const long long t = work.pass == 0 || store ? work.tile : tiles - 1;
  const long long t0 = t * kTile;
  const int cnt = static_cast<int>(min(static_cast<long long>(kTile),
                                       n - t0));
  const Tile tile = stage(x, xin, r, n, t0, cnt, xs);
  // an output tile past its row's first: its entering state, while the
  // copies are in flight
  __shared__ double e[P];
  if (work.pass == 1 && threadIdx.x == 0) {
    if (t == 0) {
      for (int k = 0; k < P; ++k) e[k] = s0[r * P + k];
    } else {
      tickets::wait(ready, r);
      for (int k = 0; k < P; ++k)
        e[k] = __ldcg(enter + (r * tiles + t) * P + k);
    }
  }
  tickets::copy_wait();
  __syncthreads();
  const int base = threadIdx.x * kSpan, end = min(base + kSpan, cnt);
  // the run's inputs before it, read before any output overwrites them
  const float x1 = tile.at(base - 1), x2 = tile.at(base - 2);
  double s[P] = {}, after[P];
  run<P>(sec, tile, base, end, x1, x2, s, false);   // from a zero state
  if (work.pass == 0) {                 // the tile's end
    const double zero[P] = {};
    block_scan<P>(sec.span, s, zero, after, totals);
    if (threadIdx.x == 0) {
      for (int k = 0; k < P; ++k) ends[(r * tiles + t) * P + k] = after[k];
      __threadfence();
    }
    if (tickets::finish(done, r, waves.first)) {
      row_scan<P>(sec, ends, s0, enter, r, tiles, totals);
      tickets::publish(ready, r);
    }
    return;
  }
  block_scan<P>(sec.span, s, e, after, totals);
  run<P>(sec, tile, base, end, x1, x2, s, store != 0);
  if (t == tiles - 1 && base < cnt && cnt <= base + kSpan)
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
  const tickets::Waves waves{
      rows, tickets::wave_rows(n * 4, kWaveBytes, rows), tiles - 1,
      store ? tiles : 1};
  const long long blocks = tickets::total(waves);
  if (blocks > 0x7fffffffLL) return invalid();
  double* ends = scratch;
  double* enter = ends + rows * tiles * P;
  unsigned* counters = reinterpret_cast<unsigned*>(enter + rows * tiles * P);
  const int rc = static_cast<int>(cudaMemsetAsync(
      counters, 0, tickets::counter_words(rows) * sizeof(unsigned), st));
  if (rc != 0) return rc;
  KERNEL_LAUNCH(section_kernel<P>, static_cast<unsigned>(blocks), kThreads,
                st, x, xin, s0, n, sec, waves, tiles, ends, enter, counters,
                y, s_out, store);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x [rows, n], xin [rows, 2] (x[-2], x[-1]), s0 [rows, p] (y[-1], ...,
// y[-p]) f32 -> y [rows, n] (unless store is 0; y may then be null),
// s_out [rows, p] (y[n-1], ..., y[n-p]).  params (float64, on the host):
// b0, b1, b2, q, a1, a2; powers (float64, on the device): C^(32 k) then
// C^(4096 k) for k = 0..32, each 4 entries, the p x p matrix in its first
// p*p.  scratch: 2 * rows * tiles * p + rows + 1 doubles.
extern "C" int launch_iir_section(const void* x, const void* xin,
                                  const void* s0, void* y, void* s_out,
                                  void* scratch, long long scratch_doubles,
                                  long long rows, long long n, int p,
                                  const void* params, const void* powers,
                                  int store, void* stream) {
  const long long tiles = (n + kTile - 1) / kTile;
  if (rows <= 0 || rows > 65535 || n <= 0 || (p != 1 && p != 2) ||
      tiles > 0x7fffffffLL ||
      2 * rows * tiles * p + tickets::counter_words(rows) / 2 >
          scratch_doubles)
    return invalid();
  const double* h = static_cast<const double*>(params);
  Section sec;
  for (int k = 0; k < 3; ++k) sec.b[k] = static_cast<float>(h[k]);
  sec.q = static_cast<int>(h[3]);
  if (sec.q != 2 && sec.q != 3) return invalid();
  sec.a[0] = h[4];
  sec.a[1] = h[5];
  sec.span = static_cast<const double*>(powers);
  sec.tile = sec.span + 4 * kPowers;
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
