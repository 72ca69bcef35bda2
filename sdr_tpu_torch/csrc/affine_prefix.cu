// K15: the exclusive affine prefix over rows, f32.
//
// Over B rows of maps s -> M s + v, one map a row and a lane (M [p, p],
// v [p]; the scalar form y -> a*y + b is p = 1), row b gets the
// composition of the maps of rows < b, row 0 the identity: the state
// entering row b of a block-parallel run is A[b] s0 + c[b].  Optionally
// every prefix is composed after an entering map, made from R maps in
// order (the whole maps of the ranks before this one in a process group),
// and optionally the launch writes the state entering each row from s0,
// or only the rows' inclusive total (the map a rank gathers to the
// others).
//
// Every product and sum is one rounded f32 operation (__fmul_rn,
// __fadd_rn: no FMA contraction), in the order of the plain PyTorch
// version (kernels/affine_prefix.py), so the kernel equals it bitwise:
//
//   compose(late, early) = (L E, L ev + lv): entry (i, j) of L E is the
//     products L[i][k] E[k][j], k = 0 .. p-1, summed left to right from
//     the first; entry i of L ev likewise, then + lv[i].  At p = 1 this
//     is (la*ea, la*eb + lb), affine.cuh's compose, the order of the
//     port's eager doubling before this kernel;
//   the doubling: at d = 1, 2, 4, ... < B every row b >= d takes
//     compose(cur[b], cur[b - d]) of the level before; then the rows
//     shift by one, the identity at row 0;
//   the entering map: pre[0], then compose(pre[r], enter) for r = 1 ..
//     R-1; each row's prefix then becomes compose(prefix, enter) (not
//     composed at all when R = 0);
//   the state: c[i] + (A[i][0] s0[0] + ... + A[i][p-1] s0[p-1]), the sum
//     left to right from the first product.
//
// Replaces no TPU kernel: the JAX package composes the shards' maps with
// one all_gather and one lax.scan inside its jitted program
// (sdr_tpu/parallel/halo.py:71 exclusive_affine_prefix, :99
// exclusive_matrix_affine_prefix).  The port ran the doubling as eager
// PyTorch operators: a composition's 3 (scalar) or 4 (matrix) operators
// and 2 cats a level, the shift's cats and the callers' epilogue, some
// 30 launches a composition at B = 32.
//
// Bound on an H100: the maps are a few hundred bytes (32 rows of one or
// two lanes on the paths), so a launch's own latency binds it, not its
// bytes or operations.
//
// Design: two forms of one order.  Up to 32 rows at p = 1 or 2 (every
// composition on the paths): a warp a lane, a thread a row, the map in
// registers; each level of the doubling is a shuffle up by d (every row
// reads the row d before it as it stood at the level before) and a
// composition, the shift a shuffle by one.  Otherwise one thread a lane:
// the thread copies its rows' maps into its column of shared memory (or
// of a scratch buffer in device memory when they do not fit), runs each
// level of the doubling from the last row down, in place (row b - d still
// holds the level before when row b reads it, so no barrier is needed),
// and writes each row's prefix, composed after the entering map, and its
// state.  A map read in place at a row stride of 0 (Iir's C^n,
// DcBlocker's alpha^n) is never expanded.

#include <cuda_runtime.h>

#include "affine.cuh"

// launches `kernel` on `grid` blocks of `block` threads (the host test
// harness defines its own)
#ifndef KERNEL_LAUNCH
#define KERNEL_LAUNCH(kernel, grid, block, stream, ...) \
  kernel<<<grid, block, 0, stream>>>(__VA_ARGS__)
#endif

namespace {

constexpr int kThreads = 128;           // lanes a block, at most
constexpr int kWarpRows = 32;           // rows of the warp form, at most
constexpr int kWarpLanes = 4;           // lanes (warps) a block of it
constexpr int kSharedFloats = 8192;     // a block's workspace (32 KB)
constexpr int kExtra = 3;               // slots past the rows: T, E, X

// One map read in place: M[i][j] at m[(i p + j) ml], v[i] at v[i vl].
struct In {
  const float* m;
  long long ml;
  const float* v;
  long long vl;
  __device__ __forceinline__ float M(int i, int j, int p) const {
    return m[(i * p + j) * ml];
  }
  __device__ __forceinline__ float V(int i) const { return v[i * vl]; }
};

// One map written in place, laid out as In.
struct Out {
  float* m;
  long long ml;
  float* v;
  long long vl;
  __device__ __forceinline__ float& M(int i, int j, int p) const {
    return m[(i * p + j) * ml];
  }
  __device__ __forceinline__ float& V(int i) const { return v[i * vl]; }
  __device__ __forceinline__ In in() const { return In{m, ml, v, vl}; }
};

// A lane's workspace: slot s (a map of C = p p + p floats, M then v),
// element e at base[(s C + e) ld].
struct Ws {
  float* base;
  long long ld;
  int p;
  __device__ __forceinline__ Out slot(long long s) const {
    float* m = base + s * (p * p + p) * ld;
    return Out{m, ld, m + p * p * ld, ld};
  }
};

struct Args {
  const float* M;             // the rows' maps, [B, L, p, p] and [B, L, p]
  long long m_row, m_lane;    //   at these strides (floats; 0: one map)
  const float* v;
  long long v_row, v_lane;
  const float* pre_M;         // R maps composed ahead of the rows,
  const float* pre_v;         //   [R, L, p, p] and [R, L, p]
  long long R;
  const float* s0;            // the state before row 0, [(B,) L, p] at
  long long s0_row, s0_lane;  //   these strides, or s0_value everywhere
  float s0_value;             //   when s0 is null
  float* A;                   // the prefixes [B, L, p, p], [B, L, p]
  float* c;                   //   (null: not written)
  float* state;               // the entering states [B, L, p] (or null)
  float* total_M;             // the inclusive total [L, p, p], [L, p]
  float* total_v;             //   (or null)
  float* scratch;             // the workspace when not in shared memory
  long long B, L;
  int p;
};

// dst = compose(late, early); dst aliases neither
template <int P>
__device__ __forceinline__ void compose_into(Out d, In late, In early,
                                             int p) {
  if constexpr (P == 1) {               // the scalar form
    const float2 r = affine::compose(make_float2(late.M(0, 0, 1), late.V(0)),
                                     make_float2(early.M(0, 0, 1),
                                                 early.V(0)));
    d.M(0, 0, 1) = r.x;
    d.V(0) = r.y;
    return;
  }
  const int q = P ? P : p;
#pragma unroll
  for (int i = 0; i < q; ++i) {
#pragma unroll
    for (int j = 0; j < q; ++j) {
      float s = __fmul_rn(late.M(i, 0, q), early.M(0, j, q));
#pragma unroll
      for (int k = 1; k < q; ++k)
        s = __fadd_rn(s, __fmul_rn(late.M(i, k, q), early.M(k, j, q)));
      d.M(i, j, q) = s;
    }
    float s = __fmul_rn(late.M(i, 0, q), early.V(0));
#pragma unroll
    for (int k = 1; k < q; ++k)
      s = __fadd_rn(s, __fmul_rn(late.M(i, k, q), early.V(k)));
    d.V(i) = __fadd_rn(s, late.V(i));
  }
}

template <int P>
__device__ __forceinline__ void copy(Out d, In s, int p) {
  const int q = P ? P : p;
#pragma unroll
  for (int i = 0; i < q; ++i) {
#pragma unroll
    for (int j = 0; j < q; ++j) d.M(i, j, q) = s.M(i, j, q);
    d.V(i) = s.V(i);
  }
}

template <int P>
__device__ __forceinline__ void identity(Out d, int p) {
  const int q = P ? P : p;
#pragma unroll
  for (int i = 0; i < q; ++i) {
#pragma unroll
    for (int j = 0; j < q; ++j) d.M(i, j, q) = i == j ? 1.f : 0.f;
    d.V(i) = 0.f;
  }
}

// P: p at compile time (1, 2), or 0 for p read from the arguments
template <int P>
__global__ void __launch_bounds__(kThreads)
prefix_thread_kernel(Args a) {
  __shared__ float shared[kSharedFloats];
  const long long lane =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (lane >= a.L) return;
  const int p = P ? P : a.p;
  const long long B = a.B, L = a.L, pp = static_cast<long long>(p) * p;
  const Ws w = a.scratch ? Ws{a.scratch + lane, L, p}
                         : Ws{shared + threadIdx.x,
                              static_cast<long long>(blockDim.x), p};
  const Out T = w.slot(B), E = w.slot(B + 1), X = w.slot(B + 2);
  for (long long b = 0; b < B; ++b)
    copy<P>(w.slot(b), In{a.M + b * a.m_row + lane * a.m_lane, 1,
                          a.v + b * a.v_row + lane * a.v_lane, 1}, p);
  // the doubling, each level from the last row down, in place
  for (long long d = 1; d < B; d <<= 1)
    for (long long b = B - 1; b >= d; --b) {
      compose_into<P>(T, w.slot(b).in(), w.slot(b - d).in(), p);
      copy<P>(w.slot(b), T.in(), p);
    }
  if (a.total_M)
    copy<P>(Out{a.total_M + lane * pp, 1, a.total_v + lane * p, 1},
            w.slot(B - 1).in(), p);
  if (!a.A && !a.state) return;
  // the entering map, the R maps composed in order
  if (a.R > 0) {
    copy<P>(E, In{a.pre_M + lane * pp, 1, a.pre_v + lane * p, 1}, p);
    for (long long r = 1; r < a.R; ++r) {
      compose_into<P>(X, In{a.pre_M + (r * L + lane) * pp, 1,
                            a.pre_v + (r * L + lane) * p, 1},
                      E.in(), p);
      copy<P>(E, X.in(), p);
    }
  }
  // the prefixes: the inclusive ones shifted by a row
  for (long long b = 0; b < B; ++b) {
    Out x = b ? w.slot(b - 1) : T;
    if (!b) identity<P>(T, p);
    if (a.R > 0) {
      compose_into<P>(X, x.in(), E.in(), p);
      x = X;
    }
    const long long o = b * L + lane;
    if (a.A) copy<P>(Out{a.A + o * pp, 1, a.c + o * p, 1}, x.in(), p);
    if (a.state) {
      const float* s0 = a.s0 ? a.s0 + b * a.s0_row + lane * a.s0_lane
                             : nullptr;
      for (int i = 0; i < p; ++i) {
        float s = __fmul_rn(x.M(i, 0, p), s0 ? s0[0] : a.s0_value);
        for (int k = 1; k < p; ++k)
          s = __fadd_rn(s, __fmul_rn(x.M(i, k, p), s0 ? s0[k] : a.s0_value));
        a.state[o * p + i] = __fadd_rn(x.V(i), s);
      }
    }
  }
}

// A map of order P in registers.
template <int P>
struct Reg {
  float m[P * P];
  float v[P];
};

template <int P>
__device__ __forceinline__ Reg<P> load(In s) {
  Reg<P> r;
#pragma unroll
  for (int i = 0; i < P; ++i) {
#pragma unroll
    for (int j = 0; j < P; ++j) r.m[i * P + j] = s.M(i, j, P);
    r.v[i] = s.V(i);
  }
  return r;
}

template <int P>
__device__ __forceinline__ void store(Out d, const Reg<P>& r) {
#pragma unroll
  for (int i = 0; i < P; ++i) {
#pragma unroll
    for (int j = 0; j < P; ++j) d.M(i, j, P) = r.m[i * P + j];
    d.V(i) = r.v[i];
  }
}

template <int P>
__device__ __forceinline__ Reg<P> ident() {
  Reg<P> r;
#pragma unroll
  for (int i = 0; i < P; ++i) {
#pragma unroll
    for (int j = 0; j < P; ++j) r.m[i * P + j] = i == j ? 1.f : 0.f;
    r.v[i] = 0.f;
  }
  return r;
}

// compose_into's order, in registers
template <int P>
__device__ __forceinline__ Reg<P> compose_reg(const Reg<P>& l,
                                              const Reg<P>& e) {
  Reg<P> o;
  if constexpr (P == 1) {
    const float2 r = affine::compose(make_float2(l.m[0], l.v[0]),
                                     make_float2(e.m[0], e.v[0]));
    o.m[0] = r.x;
    o.v[0] = r.y;
    return o;
  }
#pragma unroll
  for (int i = 0; i < P; ++i) {
#pragma unroll
    for (int j = 0; j < P; ++j) {
      float s = __fmul_rn(l.m[i * P], e.m[j]);
#pragma unroll
      for (int k = 1; k < P; ++k)
        s = __fadd_rn(s, __fmul_rn(l.m[i * P + k], e.m[k * P + j]));
      o.m[i * P + j] = s;
    }
    float s = __fmul_rn(l.m[i * P], e.v[0]);
#pragma unroll
    for (int k = 1; k < P; ++k)
      s = __fadd_rn(s, __fmul_rn(l.m[i * P + k], e.v[k]));
    o.v[i] = __fadd_rn(s, l.v[i]);
  }
  return o;
}

// the map held d threads lower in the warp; every thread of the block
// calls it
template <int P>
__device__ __forceinline__ Reg<P> shfl_up(const Reg<P>& r, int d) {
  Reg<P> o;
#pragma unroll
  for (int k = 0; k < P * P; ++k)
    o.m[k] = __shfl_up_sync(0xffffffffu, r.m[k], d);
#pragma unroll
  for (int k = 0; k < P; ++k) o.v[k] = __shfl_up_sync(0xffffffffu, r.v[k], d);
  return o;
}

// The warp form: B <= 32 rows, p = P in {1, 2}; warp w of the block is
// lane blockIdx.x * kWarpLanes + w, thread t its row t.
template <int P>
__global__ void __launch_bounds__(32 * kWarpLanes)
prefix_warp_kernel(Args a) {
  const int t = static_cast<int>(threadIdx.x & 31);
  const long long lane =
      static_cast<long long>(blockIdx.x) * (blockDim.x / 32) +
      threadIdx.x / 32;
  const bool row = lane < a.L && t < a.B;
  Reg<P> v = ident<P>();
  if (row)
    v = load<P>(In{a.M + t * a.m_row + lane * a.m_lane, 1,
                   a.v + t * a.v_row + lane * a.v_lane, 1});
  // the doubling: every thread shuffles, each row b >= d composes
  for (int d = 1; d < a.B; d <<= 1) {
    const Reg<P> e = shfl_up<P>(v, d);
    if (t >= d) v = compose_reg<P>(v, e);
  }
  Reg<P> x = shfl_up<P>(v, 1);            // the shift by a row
  if (!row) return;
  if (a.total_M && t == a.B - 1)
    store<P>(Out{a.total_M + lane * P * P, 1, a.total_v + lane * P, 1}, v);
  if (!a.A && !a.state) return;
  if (t == 0) x = ident<P>();
  if (a.R > 0) {                          // the entering map, in order
    Reg<P> E = load<P>(In{a.pre_M + lane * P * P, 1, a.pre_v + lane * P,
                          1});
    for (long long r = 1; r < a.R; ++r)
      E = compose_reg<P>(load<P>(In{a.pre_M + (r * a.L + lane) * P * P, 1,
                                    a.pre_v + (r * a.L + lane) * P, 1}),
                         E);
    x = compose_reg<P>(x, E);
  }
  const long long o = t * a.L + lane;
  if (a.A) store<P>(Out{a.A + o * P * P, 1, a.c + o * P, 1}, x);
  if (a.state) {
    const float* s0 = a.s0 ? a.s0 + t * a.s0_row + lane * a.s0_lane
                           : nullptr;
#pragma unroll
    for (int i = 0; i < P; ++i) {
      float s = __fmul_rn(x.m[i * P], s0 ? s0[0] : a.s0_value);
#pragma unroll
      for (int k = 1; k < P; ++k)
        s = __fadd_rn(s, __fmul_rn(x.m[i * P + k], s0 ? s0[k] : a.s0_value));
      a.state[o * P + i] = __fadd_rn(x.v[i], s);
    }
  }
}

// Lanes a block and the workspace in shared memory (or 0 threads: the
// scratch): kernels/affine_prefix.py:plan mirrors it.
int block_threads(long long B, long long L, int p) {
  const long long per_lane = (B + kExtra) * (static_cast<long long>(p) * p
                                             + p);
  long long want = L < kThreads ? L : kThreads;
  const long long fit = kSharedFloats / per_lane;
  return static_cast<int>(fit >= want ? want : fit);
}

int invalid() { return static_cast<int>(cudaErrorInvalidValue); }

}  // namespace

// The prefixes A [B, L, p, p], c [B, L, p] (A null: not written), the
// states [B, L, p] from s0 (state null: not written) and the inclusive
// total [L, p, p], [L, p] (total_M null: not written) of the rows' maps
// M, v.  scratch: (B + 3) (p p + p) L floats where the thread form's rows
// do not fit shared memory (kernels/affine_prefix.py:plan), else unused.
extern "C" int launch_affine_prefix(
    const void* M, long long m_row, long long m_lane, const void* v,
    long long v_row, long long v_lane, const void* pre_M, const void* pre_v,
    long long R, const void* s0, long long s0_row, long long s0_lane,
    float s0_value, void* A, void* c, void* state, void* total_M,
    void* total_v, void* scratch, long long scratch_floats, long long B,
    long long L, int p, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B < 1 || L < 1 || p < 1 || R < 0 || (R > 0 && (!pre_M || !pre_v)) ||
      (A && !c) || (total_M && !total_v) || (!A && !state && !total_M))
    return invalid();
  Args args{static_cast<const float*>(M), m_row, m_lane,
            static_cast<const float*>(v), v_row, v_lane,
            static_cast<const float*>(pre_M),
            static_cast<const float*>(pre_v), R,
            static_cast<const float*>(s0), s0_row, s0_lane, s0_value,
            static_cast<float*>(A), static_cast<float*>(c),
            static_cast<float*>(state), static_cast<float*>(total_M),
            static_cast<float*>(total_v), nullptr, B, L, p};
  if (B <= kWarpRows && p <= 2) {         // the warp form
    const long long blocks = (L + kWarpLanes - 1) / kWarpLanes;
    if (blocks > 0x7fffffffLL) return invalid();
    const unsigned grid = static_cast<unsigned>(blocks);
    const int threads = 32 * static_cast<int>(L < kWarpLanes ? L
                                                             : kWarpLanes);
    if (p == 1)
      KERNEL_LAUNCH(prefix_warp_kernel<1>, grid, threads, st, args);
    else
      KERNEL_LAUNCH(prefix_warp_kernel<2>, grid, threads, st, args);
    return static_cast<int>(cudaGetLastError());
  }
  int threads = block_threads(B, L, p);
  if (threads == 0) {
    if ((B + kExtra) * (static_cast<long long>(p) * p + p) * L >
        scratch_floats)
      return invalid();
    args.scratch = static_cast<float*>(scratch);
    threads = L < kThreads ? static_cast<int>(L) : kThreads;
  }
  const long long blocks = (L + threads - 1) / threads;
  if (blocks > 0x7fffffffLL) return invalid();
  const unsigned grid = static_cast<unsigned>(blocks);
  if (p == 1)
    KERNEL_LAUNCH(prefix_thread_kernel<1>, grid, threads, st, args);
  else if (p == 2)
    KERNEL_LAUNCH(prefix_thread_kernel<2>, grid, threads, st, args);
  else
    KERNEL_LAUNCH(prefix_thread_kernel<0>, grid, threads, st, args);
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
