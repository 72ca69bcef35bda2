// K14: StereoDecode's pilot, carrier, difference and mono cascade, f32.
// All five filters have K = 65 taps.  With xe = [hist (192) | x (n)] a
// row's extended composite, nt = n + 192, and fir(t, v)[i] = sum_j t[j]
// v[i + j] (j ascending):
//
//   pilot[q] = fir(bp19, xe)[q], sq = pilot^2              q < nt - 64
//   car[k] = fir(bp38, sq)[k], norm[k] = box(sq)[k]        k < nt - 128
//   prod[k] = xe[64 + k] (car[k] norm[k] / (norm[k] norm[k] + pf2))
//   diff[i] = fir(lp15, prod)[i], m[i] = fir(lp15, xe)[64 + i]   i < n
//   r = mean(sq) / (mean(xe xe) + 1e-12) over the whole row
//   lock' = 1 if r > lock_hi, 0 if r < lock_lo, else the entering lock
//   s = (diff gain) gate,  L = m + s,  R = m - s
//
// where box(sq)[k] = a S[k], a = avg[0] = f32(1/65) (the moving average's
// taps are one constant), S[k] the sum of sq[k .. k + 64], and gate is
// lock' (or 1 without the pilot lock).  Two launches:
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
// Numbers.  Every 65-tap filter sum (the pilot; the carrier, difference
// and mono) runs in tap order from +0, each step one fused multiply-add
// rounded once: acc = __fmaf_rn(t[j], v[i + j], acc).  S is built for
// each quad of outputs k = 4m .. 4m + 3 (m counted from the row's first
// norm output; launch B's tile origin t OUT is a multiple of 4, so the
// quads sit at the same positions in every tile) from the 62 terms the
// four share, adds only, in this order:
//
//   C  = sq[4m + 3] + sq[4m + 4] + ... + sq[4m + 64]      (left to right)
//   L2 = sq[4m + 2] + C,  L1 = sq[4m + 1] + L2
//   S[4m]     = sq[4m] + L1
//   S[4m + 1] = L1 + sq[4m + 65]
//   S[4m + 2] = (L2 + sq[4m + 65]) + sq[4m + 66]
//   S[4m + 3] = ((C + sq[4m + 65]) + sq[4m + 66]) + sq[4m + 67]
//
// (sq >= 0: any order of S is accurate to about 65 ulp, no cancellation.)
// The elementwise steps run in the plain version's order, each one
// rounded operation (__fmul_rn, __fadd_rn, __fdiv_rn).  The plain
// versions (kernels/stereo_decode.py) take each FMA exactly
// (kernels/_fma.py) and S in the quad order, so each intermediate equals
// theirs bitwise.  The row sums of launch A run in an order fixed by the
// geometry: each thread sums its 12 values of a tile (groups, then runs;
// each xe xe a product then a sum), a pairwise tree over the 256 threads
// gives the tile's sum, and the row's last block to count its tiles done
// (a completion count) adds the tiles in index order, whichever block
// that is.  The plain version follows the same order, so r and the lock
// are bitwise too, and two launches agree bitwise.
//
// Bound on an H100, at the stereo path's [32, 655,360].  Launch A: bytes
// (84 MB of xe in, 84 MB of sq out: 0.050 ms at 3.35 TB/s); its 1.36 G
// FFMA take 0.040 ms at 128 lanes x 132 SMs x 1.995 GHz.  Launch B:
// operations, its three 65-tap sums (4.09 G FFMA), the boxcar's 18.5
// instructions an output and the glue: about 4.7 G f32 instructions,
// 0.14 ms; its bytes (168 MB in, 168 MB out) take 0.100 ms.  The former
// design took each product and sum as two instructions and summed the
// average as a fourth filter: its no-FMA floor alone was 0.32 ms.
//
// Design.  Both launches are persistent: resident_blocks sizes the grid
// to the blocks that fit on the card, and each block walks the (row,
// tile) pairs: launch A a run of consecutive ones, launch B every
// grid-th one.  A tile's inputs go to shared
// memory by cp.async, 16 bytes a copy where the source is 16-byte aligned
// (past a row's history, where the row base is aligned; sq rows when n %
// 4 == 0), else 4 bytes (the history, which may be a view of the last
// block, the ragged end, unaligned views), zeros past the row.  The next
// tile's copies are issued into a second buffer before the current
// tile's sums, so the loads of one tile run under the arithmetic of the
// one before.  Each sum is register-tiled: a thread computes RUN = 12
// consecutive outputs from a window of 16 inputs that slides by one
// float4 each 4 taps, so 16 bytes read from shared memory feed 48 FFMAs.
// (Four outputs a thread, as fir_tile.cuh has them, feed 16: shared
// memory's 128 bytes a cycle then set the pace, not the FFMAs.)  The
// float4s of neighbouring threads lie 48 bytes apart: a quarter warp
// covers all 32 banks once.  Launch A sums a tile of 3,072 pilot outputs
// from xe, squares them into shared memory, from where the row sums read
// them in their fixed order and the stores of sq go out a float4 a
// thread, neighbours on neighbouring words; then the tile's two row
// partial sums.  Launch B's tile is OUT = 2,944 outputs: it stages xe
// over OUT + 192 samples (through the two row pointers, no concatenated
// copy) and sq over OUT + 128, computes car and norm over 3,072 positions
// (of which OUT + 64 are needed), prod in place of sq, then diff and m
// over 3,072, and stores the first OUT of L and R from shared memory as
// launch A stores sq: the halo costs 4.3 % on every stage.  One set of
// sums is live at a time: a stage's value that a later one needs waits in
// the thread's own slots of cs (car for norm's step, s for mono's), and a
// barrier between two stages that read the same buffer keeps the compiler
// from merging their sums (merged, they took 255 registers and spilled).
// Launch B's two buffers take 64 KB of dynamic shared memory: three blocks
// an SM.

#include <cuda_runtime.h>

#include <cstdint>

#include "persistent.cuh"

// launches `kernel` on `grid` blocks of `block` threads, with `smem` bytes
// of dynamic shared memory in the second form; the block's dynamic shared
// memory (the host test harness defines its own)
#ifndef KERNEL_LAUNCH
#define KERNEL_LAUNCH(kernel, grid, block, stream, ...) \
  kernel<<<grid, block, 0, stream>>>(__VA_ARGS__)
#endif
#ifndef KERNEL_LAUNCH_SMEM
#define KERNEL_LAUNCH_SMEM(kernel, grid, block, smem, stream, ...) \
  kernel<<<grid, block, smem, stream>>>(__VA_ARGS__)
#endif
#ifndef DYNAMIC_SMEM
#define DYNAMIC_SMEM(name) extern __shared__ __align__(16) float name[]
#endif

namespace {

constexpr int NT = 256;                 // threads a block
constexpr int RUN = 12;                 // consecutive outputs a thread
constexpr int TILE = NT * RUN;          // 3072 outputs a tile
constexpr int K = 65;                   // taps of every filter
constexpr int KP = 68;                  // a filter padded to float4s
constexpr int H = 3 * (K - 1);          // 192: the history
constexpr int OUT = TILE - 2 * (K - 1); // 2944 outputs a B tile
static_assert(OUT % 4 == 0, "B's quads sit at absolute positions");
constexpr int XA = TILE + (K - 1);      // A's staged xe
constexpr int XB = TILE + 2 * (K - 1);  // B's staged xe
constexpr int WB = TILE + (K - 1);      // B's staged sq
// B's shared memory: taps [4][KP], cs [TILE], two stages of xe and sq
constexpr int B_FLOATS = 4 * KP + TILE + 2 * (XB + WB);
constexpr long long SMEM_B = 4LL * B_FLOATS;

// a launch's rows: hist [rows, H] and x [rows, n], each at its own row
// stride (the last axis contiguous)
struct Rows {
  const float* hist;
  long long hs;
  const float* x;
  long long xs;
  long long n;
};

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// Issue the copies of xe[p0 .. p0 + count) of row r to s (p0 and count
// multiples of 4), zeros past the row's end.
__device__ __forceinline__ void stage_xe(float* s, const Rows& g,
                                         long long r, long long p0,
                                         int count) {
  const long long nt = g.n + H;
  const float* hr = g.hist + r * g.hs;
  const float* xr = g.x + r * g.xs;             // xe[p] = xr[p - H], p >= H
  const bool vec = aligned16(xr);
  for (int c = threadIdx.x; c < count / 4; c += NT) {
    const long long p = p0 + 4 * c;
    float* d = s + 4 * c;
    if (vec && p >= H && p + 4 <= nt) {
      persistent::cp_async16(d, xr + (p - H));
    } else {
      for (int i = 0; i < 4; ++i) {
        if (p + i < H)
          persistent::cp_async4(d + i, hr + p + i);
        else if (p + i < nt)
          persistent::cp_async4(d + i, xr + (p + i - H));
        else
          d[i] = 0.f;
      }
    }
  }
}

// Issue the copies of v[p0 .. p0 + count) to s (p0 and count multiples
// of 4), zeros from v[len] on.
__device__ __forceinline__ void stage_row(float* s, const float* v,
                                          long long len, long long p0,
                                          int count) {
  const bool vec = aligned16(v);
  for (int c = threadIdx.x; c < count / 4; c += NT) {
    const long long p = p0 + 4 * c;
    float* d = s + 4 * c;
    if (vec && p + 4 <= len) {
      persistent::cp_async16(d, v + p);
    } else {
      for (int i = 0; i < 4; ++i) {
        if (p + i < len)
          persistent::cp_async4(d + i, v + p + i);
        else
          d[i] = 0.f;
      }
    }
  }
}

// s[0 .. nb) to y: a float4 a thread and step where y is 16-byte aligned
// (neighbouring threads on neighbouring words), else floats
__device__ __forceinline__ void store_row(const float* s, float* y, int nb) {
  const bool vec = aligned16(y);
  for (int c = threadIdx.x; 4 * c < nb; c += NT) {
    if (vec && 4 * c + 4 <= nb) {
      *reinterpret_cast<float4*>(y + 4 * c) =
          *reinterpret_cast<const float4*>(s + 4 * c);
    } else {
      for (int i = 0; i < 4; ++i)
        if (4 * c + i < nb) y[4 * c + i] = s[4 * c + i];
    }
  }
}

// the filter's 65 taps, zero-padded to KP
__device__ __forceinline__ void load_taps(float* s, const float* t) {
  for (int k = threadIdx.x; k < KP; k += NT)
    s[k] = k < K ? __ldg(t + k) : 0.f;
}

__device__ __forceinline__ void zero(float (&acc)[RUN]) {
#pragma unroll
  for (int j = 0; j < RUN; ++j) acc[j] = 0.f;
}

__device__ __forceinline__ void put4(float* w, float4 v) {
  w[0] = v.x;
  w[1] = v.y;
  w[2] = v.z;
  w[3] = v.w;
}

// the thread's outputs 4q .. 4q + 3 of acc as a float4
__device__ __forceinline__ float4 quad(const float (&acc)[RUN], int q) {
  return make_float4(acc[4 * q], acc[4 * q + 1], acc[4 * q + 2],
                     acc[4 * q + 3]);
}

// one 4-tap step of the thread's outputs: taps tp (the first nj of them)
// over the window w, of which output j, tap jj reads w[jj + j]
__device__ __forceinline__ void step(float (&acc)[RUN], float4 tp,
                                     const float (&w)[RUN + 4], int nj) {
  const float tj[4] = {tp.x, tp.y, tp.z, tp.w};
#pragma unroll
  for (int jj = 0; jj < 4; ++jj)
    if (jj < nj) {
#pragma unroll
      for (int j = 0; j < RUN; ++j)
        acc[j] = __fmaf_rn(tj[jj], w[jj + j], acc[j]);
    }
}

// The 65-tap sums of the thread's outputs u = RUN t + j of a tile staged
// from xs[0]: acc[j] += sum_k taps[k] xs[u + k], k ascending.  The window
// of RUN + 4 inputs slides by one float4 a step: 48 FMAs for each 16 bytes
// read from shared memory, so the sums, not the loads, set the pace.
__device__ __forceinline__ void fma_sums(float (&acc)[RUN], const float* xs,
                                         const float* taps) {
  const float4* x4 =
      reinterpret_cast<const float4*>(xs) + (RUN / 4) * threadIdx.x;
  const float4* t4 = reinterpret_cast<const float4*>(taps);
  float w[RUN + 4];
#pragma unroll
  for (int i = 0; i < RUN / 4; ++i) put4(w + 4 * i, x4[i]);
#pragma unroll
  for (int s = 0; s < K / 4; ++s) {
    put4(w + RUN, x4[s + RUN / 4]);
    step(acc, t4[s], w, 4);
#pragma unroll
    for (int i = 0; i < RUN; ++i) w[i] = w[i + 4];
  }
  step(acc, t4[K / 4], w, K % 4);   // the last tap reads w[0 .. RUN)
}

// norm over the thread's RUN / 4 quads of a tile whose sq is staged from
// ws[0]: acc[j] = a S[u], u = RUN t + j, S in the quad order above
__device__ __forceinline__ void boxcar(float (&acc)[RUN], const float* ws,
                                       float a) {
  constexpr int Q = RUN / 4;
  const float4* w4 = reinterpret_cast<const float4*>(ws) + Q * threadIdx.x;
  float c[Q];
  float4 head[Q], e[Q];
#pragma unroll
  for (int q = 0; q < Q; ++q) {
    head[q] = w4[q];                            // sq[u .. u + 3]
    c[q] = head[q].w;
  }
#pragma unroll
  for (int s = 1; s < Q + K / 4; ++s) {
    const float4 v = w4[s];
#pragma unroll
    for (int q = 0; q < Q; ++q) {
      if (s > q && s < q + K / 4) {             // sq[u + 4 .. u + 63]
        c[q] = __fadd_rn(c[q], v.x);
        c[q] = __fadd_rn(c[q], v.y);
        c[q] = __fadd_rn(c[q], v.z);
        c[q] = __fadd_rn(c[q], v.w);
      }
      if (s == q + K / 4) e[q] = v;             // sq[u + 64 .. u + 67]
    }
  }
#pragma unroll
  for (int q = 0; q < Q; ++q) {
    const float cc = __fadd_rn(c[q], e[q].x);   // C
    const float l2 = __fadd_rn(head[q].z, cc);
    const float l1 = __fadd_rn(head[q].y, l2);
    acc[4 * q] = __fmul_rn(a, __fadd_rn(head[q].x, l1));
    acc[4 * q + 1] = __fmul_rn(a, __fadd_rn(l1, e[q].y));
    acc[4 * q + 2] = __fmul_rn(a, __fadd_rn(__fadd_rn(l2, e[q].y), e[q].z));
    acc[4 * q + 3] = __fmul_rn(
        a, __fadd_rn(__fadd_rn(__fadd_rn(cc, e[q].y), e[q].z), e[q].w));
  }
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

// After the block's last tile of row r (thread 0 has written the partial
// sums of `count` of them, and fenced): counts them done and returns, to
// every thread, whether that completed the row's `tiles`.
__device__ __forceinline__ bool count_done(unsigned* done, long long r,
                                           int count, long long tiles) {
  __shared__ int last;
  __syncthreads();
  if (threadIdx.x == 0)
    last = atomicAdd(done + r, static_cast<unsigned>(count)) +
               static_cast<unsigned>(count) == static_cast<unsigned>(tiles);
  __syncthreads();
  const bool is_last = last != 0;
  if (is_last) __threadfence();
  return is_last;
}

// Launch A.  Tile t of row r sums sq over q in [t TILE, t TILE + TILE)
// and xe xe over the same p, into part[r][t]; the row's last block to
// count its tiles done adds the tiles in index order and writes the row's
// outputs.  Each block walks a run of consecutive tiles and counts a
// row's tiles done once it leaves the row, behind one fence: once or
// twice a block (a walk at a stride of the grid fenced at every tile,
// PERF.md).  The squares wait in sqs, so that the row sums read them in
// their fixed order and the stores of sq go out a float4 a thread,
// neighbours on neighbouring words.
__global__ void __launch_bounds__(NT)
power_kernel(Rows g, long long rows, long long tiles,
             const float* __restrict__ bp19, const float* __restrict__ lock,
             float lock_hi, float lock_lo, float* __restrict__ part,
             unsigned* __restrict__ done, float* __restrict__ lock_out,
             float* __restrict__ a_out, float* __restrict__ b_out,
             float* __restrict__ sq) {
  __align__(16) __shared__ float xs[2][XA];
  __align__(16) __shared__ float sqs[TILE];
  __align__(16) __shared__ float taps[KP];
  __shared__ float red[2][NT];
  const long long total = rows * tiles;
  const long long nt = g.n + H, nq = nt - (K - 1);
  const long long per = (total + gridDim.x - 1) / gridDim.x;
  long long it = blockIdx.x * per;
  const long long end = min(total, it + per);
  if (it >= end) return;
  load_taps(taps, bp19);
  {
    long long r, q0;
    persistent::tile_origin(it, tiles, TILE, &r, &q0);
    stage_xe(xs[0], g, r, q0, XA);
  }
  persistent::commit();
  int pending = 0;              // tiles of the row not yet counted done
  for (int b = 0; it < end; ++it, b ^= 1) {
    // the next tile's copies fly while this one is summed
    const long long next = it + 1;
    if (next < end) {
      long long r, q0;
      persistent::tile_origin(next, tiles, TILE, &r, &q0);
      stage_xe(xs[b ^ 1], g, r, q0, XA);
    }
    persistent::commit();
    persistent::wait_prev();
    __syncthreads();
    long long r, q0;
    persistent::tile_origin(it, tiles, TILE, &r, &q0);
    const long long t = q0 / TILE;
    const float* x = xs[b];
    float acc[RUN];
    zero(acc);
    fma_sums(acc, x, taps);                                   // pilot
#pragma unroll
    for (int j = 0; j < RUN; ++j) acc[j] = __fmul_rn(acc[j], acc[j]);
    float4* sq4 = reinterpret_cast<float4*>(sqs) + (RUN / 4) * threadIdx.x;
#pragma unroll
    for (int q = 0; q < RUN / 4; ++q) sq4[q] = quad(acc, q);
    __syncthreads();
    if (sq != nullptr)
      store_row(sqs, sq + r * nq + q0,
                static_cast<int>(min(static_cast<long long>(TILE), nq - q0)));
    // the thread's 12 values in the row sums' order: u = 4 (t + NT g) + j
    float ssq = 0.f, sxx = 0.f;
#pragma unroll
    for (int gi = 0; gi < RUN / 4; ++gi) {
      const int u0 = 4 * (static_cast<int>(threadIdx.x) + NT * gi);
      const float4 v = *reinterpret_cast<const float4*>(sqs + u0);
      const float4 e = *reinterpret_cast<const float4*>(x + u0);
      const float vv[4] = {v.x, v.y, v.z, v.w}, ee[4] = {e.x, e.y, e.z, e.w};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (q0 + u0 + j < nq) ssq = __fadd_rn(ssq, vv[j]);
        if (q0 + u0 + j < nt) sxx = __fadd_rn(sxx, __fmul_rn(ee[j], ee[j]));
      }
    }
    red[0][threadIdx.x] = ssq;
    red[1][threadIdx.x] = sxx;
    tree(red[0], red[1]);
    ++pending;
    const bool leaves = next >= end || next / tiles != r;
    if (threadIdx.x == 0) {
      part[2 * (r * tiles + t)] = red[0][0];
      part[2 * (r * tiles + t) + 1] = red[1][0];
      if (leaves) __threadfence();
    }
    if (!leaves) {
      __syncthreads();          // xs[b], sqs and red are rewritten next
      continue;
    }
    const int count = pending;
    pending = 0;
    if (count_done(done, r, count, tiles)) {
      // the row's last block to count: the tiles' sums in index order, NT
      // at a time
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
      if (threadIdx.x == 0) {
        const float mean_sq = __fdiv_rn(s_sq, static_cast<float>(nq));
        const float mean_xx = __fdiv_rn(s_xx, static_cast<float>(nt));
        const float ratio = __fdiv_rn(
            mean_sq, __fadd_rn(mean_xx, static_cast<float>(1e-12)));
        const bool hi = ratio > lock_hi, lo = ratio < lock_lo;
        if (lock_out != nullptr)
          lock_out[r] =
              hi ? 1.f : (lo ? 0.f : (lock != nullptr ? lock[r] : 0.f));
        a_out[r] = hi || lo ? 0.f : 1.f;
        b_out[r] = hi ? 1.f : 0.f;
      }
    }
    __syncthreads();            // xs[b], sqs and red are rewritten next
  }
}

// Launch B: the grid walks the rows x tiles pairs (row-major); a tile is
// outputs [t OUT, t OUT + OUT) of row r, from launch A's sq.  taps [4][K]:
// bp19 (launch A's, not read here), bp38, avg (its first tap scales the
// boxcar), lp15.  Each thread keeps its own RUN positions of cs and ws,
// read and written a float4 at a time.  Its shared memory holds three
// blocks an SM: the bound lets each take 85 registers (it uses 64; at the
// compiler's own 40 it took 2.7 % longer, PERF.md).
__global__ void __launch_bounds__(NT, 3)
cascade_kernel(Rows g, long long rows, long long tiles,
               const float* __restrict__ taps_in,
               const float* __restrict__ gate, float gain, float pf2,
               const float* __restrict__ sq, float* __restrict__ y) {
  DYNAMIC_SMEM(smem);
  float* const taps = smem;                       // [4][KP]
  float* const cs = smem + 4 * KP;                // car, then s, then L
  float* const stages = cs + TILE;                // 2 x (xe [XB], sq [WB])
  constexpr int Q = RUN / 4;
  const long long total = rows * tiles;
  const long long n = g.n, nq = n + H - (K - 1);
  long long it = blockIdx.x;
  if (it >= total) return;
  for (int f = 1; f < 4; ++f) load_taps(taps + f * KP, taps_in + f * K);
  {
    long long r, i0;
    persistent::tile_origin(it, tiles, OUT, &r, &i0);
    stage_xe(stages, g, r, i0, XB);
    stage_row(stages + XB, sq + r * nq, nq, i0, WB);
  }
  persistent::commit();
  float4* const c4 = reinterpret_cast<float4*>(cs) + Q * threadIdx.x;
  for (int b = 0; it < total; it += gridDim.x, b ^= 1) {
    // the next tile's copies fly while this one is computed
    const long long next = it + gridDim.x;
    if (next < total) {
      long long r, i0;
      persistent::tile_origin(next, tiles, OUT, &r, &i0);
      float* nx = stages + (b ^ 1) * (XB + WB);
      stage_xe(nx, g, r, i0, XB);
      stage_row(nx + XB, sq + r * nq, nq, i0, WB);
    }
    persistent::commit();
    persistent::wait_prev();
    __syncthreads();
    long long r, i0;
    persistent::tile_origin(it, tiles, OUT, &r, &i0);
    float* const xs = stages + b * (XB + WB);     // xe from i0
    float* const ws = xs + XB;                    // sq, then prod, then R
    float4* const w4 = reinterpret_cast<float4*>(ws) + Q * threadIdx.x;
    const float4* const x4 =
        reinterpret_cast<const float4*>(xs + (K - 1)) + Q * threadIdx.x;
    float acc[RUN];
    zero(acc);
    fma_sums(acc, ws, taps + KP);                             // car
#pragma unroll
    for (int q = 0; q < Q; ++q) c4[q] = quad(acc, q);
    __syncthreads();    // a fence: the two stages' sums are not merged
    boxcar(acc, ws, taps[2 * KP]);                            // norm
    __syncthreads();
#pragma unroll
    for (int q = 0; q < Q; ++q) {
      const float4 c = c4[q], e = x4[q];
      const float cv[4] = {c.x, c.y, c.z, c.w}, ev[4] = {e.x, e.y, e.z, e.w};
      float p[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float m = acc[4 * q + j];
        const float carn = __fdiv_rn(__fmul_rn(cv[j], m),
                                     __fadd_rn(__fmul_rn(m, m), pf2));
        p[j] = __fmul_rn(ev[j], carn);                          // prod
      }
      w4[q] = make_float4(p[0], p[1], p[2], p[3]);
    }
    __syncthreads();
    const float gt = gate != nullptr ? gate[r] : 1.f;
    zero(acc);
    fma_sums(acc, ws, taps + 3 * KP);                         // diff
#pragma unroll
    for (int j = 0; j < RUN; ++j)
      acc[j] = __fmul_rn(__fmul_rn(acc[j], gain), gt);        // s
#pragma unroll
    for (int q = 0; q < Q; ++q) c4[q] = quad(acc, q);
    __syncthreads();
    zero(acc);
    fma_sums(acc, xs + (K - 1), taps + 3 * KP);               // mono
#pragma unroll
    for (int q = 0; q < Q; ++q) {
      const float4 s = c4[q];
      const float sv[4] = {s.x, s.y, s.z, s.w};
      float lv[4], rv[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        lv[j] = __fadd_rn(acc[4 * q + j], sv[j]);               // L
        rv[j] = __fsub_rn(acc[4 * q + j], sv[j]);               // R
      }
      c4[q] = make_float4(lv[0], lv[1], lv[2], lv[3]);
      w4[q] = make_float4(rv[0], rv[1], rv[2], rv[3]);
    }
    __syncthreads();
    const int nb = static_cast<int>(min(static_cast<long long>(OUT), n - i0));
    float* yl = y + 2 * r * n + i0;
    store_row(cs, yl, nb);
    store_row(ws, yl + n, nb);
    __syncthreads();          // the stage b and cs are rewritten next
  }
}

int invalid() { return static_cast<int>(cudaErrorInvalidValue); }

Rows rows_of(const void* hist, long long hs, const void* x, long long xs,
             long long n) {
  return Rows{static_cast<const float*>(hist), hs,
              static_cast<const float*>(x), xs, n};
}

// the blocks of a persistent launch: as many as fit on the card at once
// (each kernel keeps its own answer: the two differ in type), at most one
// a tile
template <typename Kern>
int persistent_grid(Kern kernel, long long smem, long long work,
                    unsigned* grid) {
  int blocks = 0;
  const int e = persistent::resident_blocks(kernel, NT, smem, &blocks);
  *grid = static_cast<unsigned>(work < blocks ? work : blocks);
  return e;
}

}  // namespace

// Launch A.  hist [rows, 192] at row stride hs, x [rows, n] at row stride
// xs, bp19 [65], lock [rows] (may be null: the entering lock taken as 0)
// f32 -> lock_out [rows] (may be null), a, b [rows]; sq [rows, n + 128]
// (may be null: shard_carry's form) takes the squared pilot.  scratch: 2
// rows tiles + rows floats, tiles = ceil((n + 192) / 3072).
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
  unsigned grid = 0;
  int rc = persistent_grid(power_kernel, 0, rows * tiles, &grid);
  if (rc != 0) return rc;
  rc = static_cast<int>(cudaMemsetAsync(done, 0, rows * sizeof(unsigned), st));
  if (rc != 0) return rc;
  KERNEL_LAUNCH(power_kernel, grid, NT, st, rows_of(hist, hs, x, xs, n),
                rows, tiles, static_cast<const float*>(bp19),
                static_cast<const float*>(lock), lock_hi, lock_lo, part, done,
                static_cast<float*>(lock_out), static_cast<float*>(a),
                static_cast<float*>(b), static_cast<float*>(sq));
  return static_cast<int>(cudaGetLastError());
}

// Launch B.  hist, x as launch A's; taps [4, 65] (bp19, bp38, avg, lp15;
// avg a constant, its first tap the boxcar's scale), gate [rows] (may be
// null: 1), sq [rows, n + 128] (launch A's squared pilot) f32 -> y [rows,
// 2, n] (L, R).
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
  unsigned grid = 0;
  const int rc = persistent_grid(cascade_kernel, SMEM_B, rows * tiles, &grid);
  if (rc != 0) return rc;
  KERNEL_LAUNCH_SMEM(cascade_kernel, grid, NT, SMEM_B,
                     static_cast<cudaStream_t>(stream),
                     rows_of(hist, hs, x, xs, n), rows, tiles,
                     static_cast<const float*>(taps),
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
