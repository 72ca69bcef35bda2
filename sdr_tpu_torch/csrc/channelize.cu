// K7: the polyphase channelizer's branch filter, complex64 rows:
//
//   v[m, r] = sum_{p=0..P-1} hb[p, r] * z[(m + p) C + r],   z = cat(hist, x)
//
// for m < num and r < C, leading dimensions batched as rows; hb [P, C] f32,
// hist [H] and x [n] complex64 read through their own pointers (no
// concatenated copy), v [num, C] complex64.  The real and imaginary parts
// are two f32 lanes that share the real tap.  Each product is one rounded
// f32 multiply and the products are summed p = 0..P-1 from the first
// product, each add one rounded operation (__fmul_rn, __fadd_rn: no FMA
// contraction): the order of the plain PyTorch loop (kernels/channelize.py)
// `v = x2[0:num] * hb[0]; v += x2[p:p + num] * hb[p]`, so the kernel equals
// it but for the sign of a zero (PyTorch multiplies by hb promoted to
// complex, adding a product with a zero imaginary part).
//
// Replaces no TPU kernel: the JAX package writes this stencil as P shifted
// views of the row-major reshape weighted by the tap rows
// (sdr_tpu/ops/channelize.py:108-114), which XLA fuses into one pass over
// the stream.  Run eagerly as PyTorch operators it is 2P - 1 passes.
//
// Bound on an H100: bytes.  The wideband bank (32 rows of 4,096,000
// samples, C = 64, P = 12) reads 32 x (4,096,000 + 704) x 8 B and writes
// 32 x 64,000 x 64 x 8 B, 2.097 GB, 0.626 ms at 3.35 TB/s; its 6.0 Gflop
// (one multiply and one add a tap and lane) take 0.19 ms as separate
// f32 instructions at 132 SMs x 128 lanes x 1.98 GHz.
//
// Design:
// * A block takes a tile of T consecutive output rows of one row of the
//   batch (T a multiple of kR, from a budget of about 48 KB of staged
//   input).  Output row m is 2C contiguous floats, and it reads input rows
//   m .. m + P - 1 of the same 2C floats, so the block stages the T + P - 1
//   input rows its tile reads into shared memory (16-byte loads where the
//   device address is 16-byte aligned, 8-byte ones at the ends; the part
//   in hist and the part in x separately), and the taps beside them, then
//   sums from shared memory.  Every input is read from device memory
//   once, plus a (P - 1)-row halo a tile that neighbouring tiles read too.
// * A thread owns V floats of a row (V = 4 when C is even, one float4 and
//   two taps; V = 2 when C is odd, one float2 and one tap) in kR = 4
//   consecutive output rows.  It keeps the kR input rows the current tap
//   reads in a ring of registers: a tap step reads one new staged row and
//   one tap for kR x V products, and neighbouring threads read
//   neighbouring words.
// * Each output row is written whole, V floats a thread, coalesced.
// * Any C >= 1 and P >= 1; a geometry whose kR + P - 1 staged rows and
//   taps do not fit a block's shared memory raises (kDoesNotFit).

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kR = 4;                   // output rows a thread sums
constexpr int kStageFloats = 12288;     // staged floats a block aims at
constexpr int kDoesNotFit = -1;         // launch code: no tile fits

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// Copy cnt floats (even) from g to d, both 8-byte aligned: 16-byte loads
// from g's first 16-byte boundary, the 8-byte head and tail apart.
__device__ __forceinline__ void stage(float* d, const float* g,
                                      long long cnt) {
  const int head = (aligned16(g) || cnt == 0) ? 0 : 2;
  const long long nv = (cnt - head) / 4;
  const int tail = static_cast<int>(cnt - head - 4 * nv);
  if (threadIdx.x == 0 && head)
    *reinterpret_cast<float2*>(d) = *reinterpret_cast<const float2*>(g);
  if (threadIdx.x == 1 && tail)
    *reinterpret_cast<float2*>(d + cnt - 2) =
        *reinterpret_cast<const float2*>(g + cnt - 2);
  const float4* gv = reinterpret_cast<const float4*>(g + head);
  float* dv = d + head;
  if (aligned16(dv)) {
#pragma unroll 4
    for (long long i = threadIdx.x; i < nv; i += kThreads)
      reinterpret_cast<float4*>(dv)[i] = gv[i];
  } else {
#pragma unroll 4
    for (long long i = threadIdx.x; i < nv; i += kThreads) {
      const float4 q = gv[i];
      reinterpret_cast<float2*>(dv)[2 * i] = make_float2(q.x, q.y);
      reinterpret_cast<float2*>(dv)[2 * i + 1] = make_float2(q.z, q.w);
    }
  }
}

// V floats of a row and their taps: a float4 with two taps (even C), or a
// float2 with one (odd C)
template <int V> struct Lanes;
template <> struct Lanes<4> {
  using Vec = float4;
  using Tap = float2;
  static __device__ __forceinline__ Tap tap(const float* t) {
    return *reinterpret_cast<const float2*>(t);
  }
  static __device__ __forceinline__ Vec mul(Tap h, Vec w) {
    return make_float4(__fmul_rn(h.x, w.x), __fmul_rn(h.x, w.y),
                       __fmul_rn(h.y, w.z), __fmul_rn(h.y, w.w));
  }
  static __device__ __forceinline__ Vec add(Vec a, Vec b) {
    return make_float4(__fadd_rn(a.x, b.x), __fadd_rn(a.y, b.y),
                       __fadd_rn(a.z, b.z), __fadd_rn(a.w, b.w));
  }
};
template <> struct Lanes<2> {
  using Vec = float2;
  using Tap = float;
  static __device__ __forceinline__ Tap tap(const float* t) { return *t; }
  static __device__ __forceinline__ Vec mul(Tap h, Vec w) {
    return make_float2(__fmul_rn(h, w.x), __fmul_rn(h, w.y));
  }
  static __device__ __forceinline__ Vec add(Vec a, Vec b) {
    return make_float2(__fadd_rn(a.x, b.x), __fadd_rn(a.y, b.y));
  }
};

template <int V>
__global__ void __launch_bounds__(kThreads)
branch_filter_kernel(const float* __restrict__ hb,
                     const float* __restrict__ hist,
                     const float* __restrict__ x, float* __restrict__ v,
                     long long H, long long n, long long num, int C, int P,
                     int T, long long tiles_per_row) {
  using L = Lanes<V>;
  using Vec = typename L::Vec;
  extern __shared__ __align__(16) float smem[];
  const int W = 2 * C;                  // floats an output or input row
  float* const s = smem;                // (T + P - 1) x W staged floats
  float* const taps = smem + static_cast<long long>(T + P - 1) * W;

  const long long row = blockIdx.x / tiles_per_row;
  const long long m0 = (blockIdx.x - row * tiles_per_row) * T;
  const int rows_here = static_cast<int>(
      min(static_cast<long long>(T), num - m0));

  for (int i = threadIdx.x; i < P * C; i += kThreads) taps[i] = hb[i];
  // the staged samples [a, b) of z: the part in hist, the part in x
  const long long a = m0 * C;
  const long long b = (m0 + rows_here + P - 1) * C;
  if (a < H)
    stage(s, hist + 2 * (row * H + a), 2 * (min(b, H) - a));
  if (b > H) {
    const long long e0 = max(a, H);
    stage(s + 2 * (e0 - a), x + 2 * (row * n + e0 - H), 2 * (b - e0));
  }
  __syncthreads();

  // item (g, l): output rows g kR .. g kR + kR - 1, floats l V .. l V + V - 1
  // (rows past rows_here are summed from unstaged words and not stored)
  const int lanes = W / V;
  const int items = lanes * ((rows_here + kR - 1) / kR);
  float* const vt = v + (row * num + m0) * W;
  for (int it = threadIdx.x; it < items; it += kThreads) {
    const int g = it / lanes;
    const int j = (it - g * lanes) * V;
    const int i0 = g * kR;
    const float* const sp = s + i0 * W + j;
    const float* const tp = taps + j / 2;
    // ring: staged row i0 + q lives in w[q % kR]
    Vec w[kR], acc[kR];
    const typename L::Tap h0 = L::tap(tp);
#pragma unroll
    for (int k = 0; k < kR; ++k) {
      w[k] = *reinterpret_cast<const Vec*>(sp + k * W);
      acc[k] = L::mul(h0, w[k]);
    }
    for (int p0 = 1; p0 < P; p0 += kR) {
#pragma unroll
      for (int u = 0; u < kR; ++u) {
        const int p = p0 + u;
        if (p < P) {
          // tap p reads rows i0 + p .. i0 + p + kR - 1: the newest one
          // replaces row i0 + p - 1, in slot (p - 1) % kR = u
          w[u] = *reinterpret_cast<const Vec*>(sp + (p + kR - 1) * W);
          const typename L::Tap h = L::tap(tp + p * C);
#pragma unroll
          for (int k = 0; k < kR; ++k)
            acc[k] = L::add(acc[k], L::mul(h, w[(k + 1 + u) % kR]));
        }
      }
    }
#pragma unroll
    for (int k = 0; k < kR; ++k)
      if (i0 + k < rows_here)
        *reinterpret_cast<Vec*>(vt + (i0 + k) * W + j) = acc[k];
  }
}

// The tile (output rows a block) and shared-memory bytes of a launch at
// C channels and P taps a branch with num output rows, or kDoesNotFit
// (or a CUDA error) when kR rows do not fit the device's block.
int plan(int C, int P, long long num, int* tile, int* smem) {
  int dev = 0, most = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&most, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  const long long W = 2LL * C;
  long long T = (kStageFloats / W - (P - 1)) / kR * kR;
  const long long need = (num + kR - 1) / kR * kR;
  if (T > need) T = need;
  if (T < kR) T = kR;
  const long long bytes = 4 * ((T + P - 1) * W + static_cast<long long>(P) * C);
  if (bytes > most) return kDoesNotFit;
  *tile = static_cast<int>(T);
  *smem = static_cast<int>(bytes);
  return 0;
}

template <int V>
int launch(const float* hb, const float* hist, const float* x, float* v,
           long long rows, long long H, long long n, long long num, int C,
           int P, int T, int smem, cudaStream_t st) {
  auto kernel = branch_filter_kernel<V>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const long long tiles_per_row = (num + T - 1) / T;
  const long long blocks = rows * tiles_per_row;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  kernel<<<static_cast<unsigned>(blocks), kThreads, smem, st>>>(
      hb, hist, x, v, H, n, num, C, P, T, tiles_per_row);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// hb [P, C] f32, hist [rows, H] and x [rows, n] complex64 (as f32 pairs,
// 8-byte aligned) -> v [rows, num, C] complex64.  The caller checks
// (num + P - 1) * C <= H + n.
extern "C" int launch_branch_filter(const void* hb, const void* hist,
                                    const void* x, void* v, long long rows,
                                    long long H, long long n, long long num,
                                    int C, int P, void* stream) {
  int T = 0, smem = 0;
  const int p = plan(C, P, num, &T, &smem);
  if (p != 0) return p;
  const auto* h = static_cast<const float*>(hb);
  const auto* hs = static_cast<const float*>(hist);
  const auto* xs = static_cast<const float*>(x);
  auto* vs = static_cast<float*>(v);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (C % 2 == 0)
    return launch<4>(h, hs, xs, vs, rows, H, n, num, C, P, T, smem, st);
  return launch<2>(h, hs, xs, vs, rows, H, n, num, C, P, T, smem, st);
}

// The plan launch_branch_filter makes: output rows a tile and
// shared-memory bytes a block; kDoesNotFit where no tile fits.
extern "C" int branch_filter_plan(int C, int P, long long num, int* tile,
                                  int* smem) {
  return plan(C, P, num, tile, smem);
}

extern "C" const char* kernel_error_string(int e) {
  if (e == kDoesNotFit)
    return "the branch filter's staged rows and taps do not fit a block's "
           "shared memory ((P + 3) * 2C + P * C floats at most 58,112 on "
           "an H100)";
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}

// This library links its own CUDA runtime, whose current device is not
// PyTorch's: the wrapper selects the tensors' device before each launch.
extern "C" int kernel_set_device(int device) {
  return static_cast<int>(cudaSetDevice(device));
}
