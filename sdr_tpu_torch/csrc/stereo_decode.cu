// K14: StereoDecode's pilot, carrier, difference and mono cascade, f32.
// All five filters have K = 65 taps.  With xe = [hist (192) | x (n)] a
// row's extended composite, nt = n + 192, and fir(t, v)[i] = sum_j t[j]
// v[i + j] (j ascending):
//
//   pilot[q] = fir(bp19, xe)[q], sq = pilot^2              q < nt - 64
//   car[k] = fir(bp38, sq)[k], norm[k] = fir(avg, sq)[k]   k < nt - 128
//   prod[k] = xe[64 + k] (car[k] norm[k] / (norm[k] norm[k] + pf2))
//   diff[i] = fir(lp15, prod)[i], m[i] = fir(lp15, xe)[64 + i]   i < n
//   r = mean(sq) / (mean(xe xe) + 1e-12) over the whole row
//   lock' = 1 if r > lock_hi, 0 if r < lock_lo, else the entering lock
//   s = (diff gain) gate,  L = m + s,  R = m - s
//
// where gate is lock' (or 1 without the pilot lock).  Two launches:
//
//   * launch A (power_kernel), the pilot power: the row's sums of sq and
//     xe xe, then r, lock' and the row's affine map on the lock (a, b):
//     a decisive row is the constant b, a row in the hysteresis band the
//     identity (StereoDecode.shard_carry composes them across rows);
//   * launch B (cascade_kernel): every stage of a tile in shared memory,
//     gated by lock', read on the device (the host never waits for it),
//     L and R written into y [rows, 2, n].
//
// Replaces no TPU kernel: the JAX package runs the five filters through
// sdr_tpu/ops/fir.py:271-287 _dispatch (the Pallas fir_strided where its
// tuning picks it, else XLA's conv) and the glue as XLA fusions
// (sdr_tpu/stream/ops.py:732-795).  The port ran them as six K3 launches
// and some 25-30 eager passes.
//
// Numbers: every sum runs in tap order from +0, each product and sum one
// rounded operation (__fmul_rn, __fadd_rn: no FMA), the elementwise steps
// in the plain version's order (__fdiv_rn), so each intermediate equals
// the plain PyTorch version's (kernels/stereo_decode.py) bitwise.  The
// row sums of launch A run in an order fixed by the geometry: each thread
// sums its 12 values of a tile (fir_tile's groups, then runs), a pairwise
// tree over the 256 threads gives the tile's sum, and the row's last
// block (a completion count, tickets.cuh) adds the tiles in index order.
// The plain version follows the same order, so r and the lock are bitwise
// too, and two launches agree bitwise.
//
// Bound on an H100: operations.  The stereo path ([32, 655,360]) runs six
// 65-tap passes (one in A, five in B, their halos aside): 6 x 2.73
// Gflop, 0.25 ms at 65.5 Tflop/s; its bytes (84 MB in, 168 MB out) take
// 0.075 ms.  Without FMA the sums take two instructions a tap, about
// 0.49 ms on 132 SMs at 1.995 GHz.
//
// Design: a block a tile of 256 threads, each stage fir_tile's
// register-tiled sums (TILE = 3072 outputs a call, a thread 3 groups of 4
// consecutive outputs).  Launch A sums one tile of pilot outputs per
// block from xe staged in shared memory and writes sq to device memory.
// Launch B's tile is OUT = TILE - 128 outputs: it stages xe over OUT +
// 192 samples (through the two row pointers, so no concatenated copy
// exists) and launch A's sq over TILE = OUT + 128 positions, computes car
// and norm over TILE (of which OUT + 64 are needed), prod in place of sq,
// then diff and m over TILE, and stores the first OUT.  The halo costs
// (OUT + 128) / OUT on every stage, 4.3 %.  Staging sq took less time on
// an H100 than summing the pilot a second time in launch B (PERF.md).

#include <cuda_runtime.h>

#include <cstdint>

#include "fir_tile.cuh"
#include "tickets.cuh"

// launches `kernel` on `grid` blocks of `block` threads (the host test
// harness defines its own)
#ifndef KERNEL_LAUNCH
#define KERNEL_LAUNCH(kernel, grid, block, stream, ...) \
  kernel<<<grid, block, 0, stream>>>(__VA_ARGS__)
#endif

namespace {

using fir_tile::G;
using fir_tile::NT;
using fir_tile::R;
using fir_tile::TILE;

constexpr int K = 65;                          // taps of every filter
constexpr int KP = 68;                         // a filter padded to float4s
constexpr int H = 3 * (K - 1);                 // 192: the history
constexpr int OUT = TILE - 2 * (K - 1);        // 2944 outputs a B tile
constexpr int BUF = fir_tile::buf_floats(K);   // a stage's input buffer

// a launch's rows: hist [rows, H] and x [rows, n], each at its own row
// stride (the last axis contiguous)
struct Rows {
  const float* hist;
  long long hs;
  const float* x;
  long long xs;
  long long n;
};

// xe[p0 .. p0 + count) of row r to s, zeros past the row's end; the
// copies are cp.async, in flight together until the caller's copy_wait
__device__ __forceinline__ void stage(float* s, const Rows& g, long long r,
                                      long long p0, int count) {
  const long long nt = g.n + H;
  const float* hr = g.hist + r * g.hs;
  const float* xr = g.x + r * g.xs - H;
  for (int k = threadIdx.x; k < count; k += NT) {
    const long long p = p0 + k;
    if (p < H)
      tickets::copy4(s + k, hr + p);
    else if (p < nt)
      tickets::copy4(s + k, xr + p);
    else
      s[k] = 0.f;
  }
}

// the filter's 65 taps, zero-padded to KP
__device__ __forceinline__ void load_taps(float* s, const float* t) {
  for (int k = threadIdx.x; k < KP; k += NT)
    s[k] = k < K ? __ldg(t + k) : 0.f;
}

__device__ __forceinline__ void zero(float (&acc)[G][R]) {
#pragma unroll
  for (int g = 0; g < G; ++g)
#pragma unroll
    for (int j = 0; j < R; ++j) acc[g][j] = 0.f;
}

// the tile's offset of the thread's output (g, j)
__device__ __forceinline__ int slot(int g, int j) {
  return R * (static_cast<int>(threadIdx.x) + g * NT) + j;
}

// v[0] (and v2[0]) become the pairwise sums of the NT entries: at each
// level entry t adds entry t + half
__device__ __forceinline__ void tree(float* v, float* v2) {
  __syncthreads();
  for (int half = NT / 2; half > 0; half /= 2) {
    if (static_cast<int>(threadIdx.x) < half) {
      v[threadIdx.x] = __fadd_rn(v[threadIdx.x], v[threadIdx.x + half]);
      v2[threadIdx.x] = __fadd_rn(v2[threadIdx.x], v2[threadIdx.x + half]);
    }
    __syncthreads();
  }
}

// Launch A: grid (tiles, rows).  Tile t of row r sums sq over q in
// [t TILE, t TILE + TILE) and xe xe over the same p, into part[r][t]; the
// row's last block adds the tiles in order and writes the row's outputs.
__global__ void __launch_bounds__(NT)
power_kernel(Rows g, const float* __restrict__ bp19,
             const float* __restrict__ lock, float lock_hi, float lock_lo,
             float* __restrict__ part, unsigned* __restrict__ done,
             float* __restrict__ lock_out, float* __restrict__ a_out,
             float* __restrict__ b_out, float* __restrict__ sq) {
  __align__(16) __shared__ float xs[BUF];
  __align__(16) __shared__ float taps[KP];
  __shared__ float red[2][NT];
  const long long tiles = gridDim.x, t = blockIdx.x, r = blockIdx.y;
  const long long nt = g.n + H, nq = nt - (K - 1), q0 = t * TILE;
  stage(xs, g, r, q0, BUF);
  load_taps(taps, bp19);
  tickets::copy_wait();
  __syncthreads();
  float acc[G][R];
  zero(acc);
  fir_tile::tile_sums<0, K>(acc, xs, taps, K);
  float ssq = 0.f, sxx = 0.f;
#pragma unroll
  for (int gi = 0; gi < G; ++gi)
#pragma unroll
    for (int j = 0; j < R; ++j) {
      const int u = slot(gi, j);
      if (q0 + u < nq) {
        const float v = __fmul_rn(acc[gi][j], acc[gi][j]);
        ssq = __fadd_rn(ssq, v);
        if (sq != nullptr) sq[r * nq + q0 + u] = v;
      }
      if (q0 + u < nt) sxx = __fadd_rn(sxx, __fmul_rn(xs[u], xs[u]));
    }
  red[0][threadIdx.x] = ssq;
  red[1][threadIdx.x] = sxx;
  tree(red[0], red[1]);
  if (threadIdx.x == 0) {
    part[2 * (r * tiles + t)] = red[0][0];
    part[2 * (r * tiles + t) + 1] = red[1][0];
    __threadfence();
  }
  if (!tickets::finish(done, r, tiles)) return;
  // the row's last block: the tiles' sums in index order, NT at a time
  float s_sq = 0.f, s_xx = 0.f;
  for (long long c0 = 0; c0 < tiles; c0 += NT) {
    __syncthreads();
    const long long k = c0 + threadIdx.x;
    if (k < tiles) {
      red[0][threadIdx.x] = __ldcg(part + 2 * (r * tiles + k));
      red[1][threadIdx.x] = __ldcg(part + 2 * (r * tiles + k) + 1);
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      const int m = static_cast<int>(min(static_cast<long long>(NT),
                                         tiles - c0));
      for (int j = 0; j < m; ++j) {
        s_sq = __fadd_rn(s_sq, red[0][j]);
        s_xx = __fadd_rn(s_xx, red[1][j]);
      }
    }
  }
  if (threadIdx.x != 0) return;
  const float mean_sq = __fdiv_rn(s_sq, static_cast<float>(nq));
  const float mean_xx = __fdiv_rn(s_xx, static_cast<float>(nt));
  const float ratio =
      __fdiv_rn(mean_sq, __fadd_rn(mean_xx, static_cast<float>(1e-12)));
  const bool hi = ratio > lock_hi, lo = ratio < lock_lo;
  if (lock_out != nullptr)
    lock_out[r] = hi ? 1.f : (lo ? 0.f : (lock != nullptr ? lock[r] : 0.f));
  a_out[r] = hi || lo ? 0.f : 1.f;
  b_out[r] = hi ? 1.f : 0.f;
}

// Launch B: grid (tiles, rows), outputs [t OUT, t OUT + OUT) of row r,
// from launch A's sq.  taps [4][K]: bp19 (launch A's, not read here),
// bp38, avg, lp15.  One set of sums is live at a time: a stage's value
// that a later one needs waits in the thread's own slot of cs (car for
// norm's step, s for mono's), and a barrier between two stages that read
// the same buffer keeps the compiler from merging their sums (merged,
// they took 255 registers and spilled).
__global__ void __launch_bounds__(NT)
cascade_kernel(Rows g, const float* __restrict__ taps_in,
               const float* __restrict__ gate, float gain, float pf2,
               const float* __restrict__ sq, float* __restrict__ y) {
  __align__(16) __shared__ float xs[2 * (K - 1) + BUF];   // xe from i0
  __align__(16) __shared__ float ws[BUF];                 // sq, then prod
  __align__(16) __shared__ float cs[TILE];                // car, then s
  __align__(16) __shared__ float taps[4][KP];
  const long long r = blockIdx.y;
  const long long i0 = blockIdx.x * static_cast<long long>(OUT);
  const long long n = g.n, nq = n + H - (K - 1);
  stage(xs, g, r, i0, 2 * (K - 1) + BUF);
  for (int k = threadIdx.x; k < BUF; k += NT) {
    if (i0 + k < nq)
      tickets::copy4(ws + k, sq + r * nq + i0 + k);
    else
      ws[k] = 0.f;
  }
  for (int f = 1; f < 4; ++f) load_taps(taps[f], taps_in + f * K);
  tickets::copy_wait();
  __syncthreads();
  float acc[G][R];
  zero(acc);
  fir_tile::tile_sums<0, K>(acc, ws, taps[1], K);            // car
#pragma unroll
  for (int gi = 0; gi < G; ++gi)
#pragma unroll
    for (int j = 0; j < R; ++j) cs[slot(gi, j)] = acc[gi][j];
  __syncthreads();      // a fence: the two stages' sums are not merged
  zero(acc);
  fir_tile::tile_sums<0, K>(acc, ws, taps[2], K);            // norm
  __syncthreads();
#pragma unroll
  for (int gi = 0; gi < G; ++gi)
#pragma unroll
    for (int j = 0; j < R; ++j) {
      const int u = slot(gi, j);
      const float c = cs[u], m = acc[gi][j];
      const float carn =
          __fdiv_rn(__fmul_rn(c, m), __fadd_rn(__fmul_rn(m, m), pf2));
      ws[u] = __fmul_rn(xs[K - 1 + u], carn);                // prod
    }
  __syncthreads();
  const float gt = gate != nullptr ? gate[r] : 1.f;
  zero(acc);
  fir_tile::tile_sums<0, K>(acc, ws, taps[3], K);            // diff
#pragma unroll
  for (int gi = 0; gi < G; ++gi)
#pragma unroll
    for (int j = 0; j < R; ++j)
      cs[slot(gi, j)] = __fmul_rn(__fmul_rn(acc[gi][j], gain), gt);   // s
  __syncthreads();
  zero(acc);
  fir_tile::tile_sums<0, K>(acc, xs + (K - 1), taps[3], K);  // mono
  float rv[G][R];
#pragma unroll
  for (int gi = 0; gi < G; ++gi)
#pragma unroll
    for (int j = 0; j < R; ++j) {
      const float s = cs[slot(gi, j)], m = acc[gi][j];
      acc[gi][j] = __fadd_rn(m, s);                          // L
      rv[gi][j] = __fsub_rn(m, s);                           // R
    }
  const int nb = static_cast<int>(min(static_cast<long long>(OUT), n - i0));
  float* yl = y + 2 * r * n + i0;
  fir_tile::store_sums(acc, yl, nb);
  fir_tile::store_sums(rv, yl + n, nb);
}

int invalid() { return static_cast<int>(cudaErrorInvalidValue); }

Rows rows_of(const void* hist, long long hs, const void* x, long long xs,
             long long n) {
  return Rows{static_cast<const float*>(hist), hs,
              static_cast<const float*>(x), xs, n};
}

}  // namespace

// Launch A.  hist [rows, 192] at row stride hs, x [rows, n] at row stride
// xs, bp19 [65], lock [rows] (may be null: the entering lock taken as 0)
// f32 -> lock_out [rows] (may be null), a, b [rows]; sq [rows, n + 128]
// (may be null: shard_carry's form) takes the squared pilot.  scratch: 2 rows tiles + rows
// floats, tiles = ceil((n + 192) / 3072).
extern "C" int launch_pilot_power(const void* hist, long long hs,
                                  const void* x, long long xs,
                                  long long rows, long long n,
                                  const void* bp19, const void* lock,
                                  float lock_hi, float lock_lo,
                                  void* lock_out, void* a, void* b,
                                  void* scratch, long long scratch_floats,
                                  void* sq, void* stream) {
  const long long tiles = (n + H + TILE - 1) / TILE;
  if (rows <= 0 || rows > 65535 || n < 0 || tiles > 0x7fffffffLL ||
      2 * rows * tiles + rows > scratch_floats)
    return invalid();
  float* part = static_cast<float*>(scratch);
  unsigned* done = reinterpret_cast<unsigned*>(part + 2 * rows * tiles);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int rc = static_cast<int>(
      cudaMemsetAsync(done, 0, rows * sizeof(unsigned), st));
  if (rc != 0) return rc;
  const dim3 grid(static_cast<unsigned>(tiles), static_cast<unsigned>(rows));
  KERNEL_LAUNCH(power_kernel, grid, NT, st, rows_of(hist, hs, x, xs, n),
                static_cast<const float*>(bp19),
                static_cast<const float*>(lock), lock_hi, lock_lo, part, done,
                static_cast<float*>(lock_out), static_cast<float*>(a),
                static_cast<float*>(b), static_cast<float*>(sq));
  return static_cast<int>(cudaGetLastError());
}

// Launch B.  hist, x as launch A's; taps [4, 65] (bp19, bp38, avg, lp15),
// gate [rows] (may be null: 1), sq [rows, n + 128] (launch A's squared
// pilot) f32 -> y [rows, 2, n] (L, R).
extern "C" int launch_stereo_cascade(const void* hist, long long hs,
                                     const void* x, long long xs,
                                     long long rows, long long n,
                                     const void* taps, const void* gate,
                                     float gain, float pf2, const void* sq,
                                     void* y, void* stream) {
  const long long tiles = (n + OUT - 1) / OUT;
  if (rows <= 0 || rows > 65535 || n <= 0 || tiles > 0x7fffffffLL ||
      sq == nullptr)
    return invalid();
  const dim3 grid(static_cast<unsigned>(tiles), static_cast<unsigned>(rows));
  KERNEL_LAUNCH(cascade_kernel, grid, NT, static_cast<cudaStream_t>(stream),
                rows_of(hist, hs, x, xs, n), static_cast<const float*>(taps),
                static_cast<const float*>(gate), gain, pf2,
                static_cast<const float*>(sq), static_cast<float*>(y));
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
