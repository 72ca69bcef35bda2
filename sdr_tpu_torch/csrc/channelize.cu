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

#include "dft.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kR = 4;                   // output rows a thread sums
constexpr int kStageFloats = 12288;     // staged floats a block aims at
constexpr int kDoesNotFit = -1;         // launch code: no tile fits

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// 16 bytes from device memory at g to shared memory at d, both 16-byte
// aligned, without a round trip through registers: cp.async, waited for
// by copy_wait (a plain copy where this source is built for the host)
__device__ __forceinline__ void copy16(float* d, const float* g) {
#ifdef __CUDA_ARCH__
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(d));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(g));
#else
  *reinterpret_cast<float4*>(d) = *reinterpret_cast<const float4*>(g);
#endif
}

__device__ __forceinline__ void copy_wait() {
#ifdef __CUDA_ARCH__
  asm volatile("cp.async.wait_all;\n" ::);
#endif
}

// Copy cnt floats (even) from g to d, both 8-byte aligned: 16-byte loads
// from g's first 16-byte boundary, the 8-byte head and tail apart.  With
// kAsync, the 16-byte copies into a 16-byte aligned d are cp.async (the
// caller waits with copy_wait).
template <bool kAsync = false>
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
  if (kAsync && aligned16(dv)) {
    for (long long i = threadIdx.x; i < nv; i += kThreads)
      copy16(dv + 4 * i, reinterpret_cast<const float*>(gv + i));
  } else if (aligned16(dv)) {
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

// The sums of one item, output rows i0 .. i0 + kR - 1 x floats j .. j +
// V - 1, into acc[k] for row i0 + k: sp is staged row i0 at float j, tp
// the taps at branch j / 2.  A ring of registers: staged row i0 + q lives
// in w[q % kR].
template <int V>
__device__ __forceinline__ void item_sums(const float* sp, const float* tp,
                                          int W, int C, int P,
                                          typename Lanes<V>::Vec* acc) {
  using L = Lanes<V>;
  using Vec = typename L::Vec;
  Vec w[kR];
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
}

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
    Vec acc[kR];
    item_sums<V>(s + i0 * W + j, taps + j / 2, W, C, P, acc);
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

// ---------------------------------------------------------------------
// K7 + DFT: the filterbank in one launch, from the wideband samples to
//
//   Y[m, k] = sum_r v[m, r] exp(-2 pi i k r / C),   v as K7's above,
//
// complex64 [num, C] a row of the batch (each row's C values contiguous,
// so Y.transpose(-1, -2) is the channel-major [C, num] view K3's complex
// form reads in place).
//
// Replaces no TPU kernel: the JAX package runs the stencil (above), then
// XLA's C-point FFT across the branches and a transpose
// (sdr_tpu/ops/channelize.py:108-116).  The port ran K7, then cuFFT over
// v, which wrote v to device memory and read it back.
//
// Bound on an H100: bytes, the same as K7's: 2.097 GB for the wideband
// bank, 0.626 ms at 3.35 TB/s.  Its work: the stencil's 6.3 Gflop and the
// DFTs' 3.9 (5 C log2 C a row of 2.05 M rows), about 0.3 ms of f32
// instructions at 132 SMs x 128 lanes x 1.995 GHz.
//
// Design:
// * A block of 256 threads takes T = 4,096 / C consecutive output rows of
//   one row of the batch (fewer where the row ends, or while the staged
//   rows and taps exceed a block's shared memory); three blocks an SM, at
//   most 80 registers a thread.  (A tile of 8,192 / C rows, one row DFT
//   for every thread, needs four stencil items a thread and runs two
//   blocks an SM, or spills at three: slower; kernel_variants.)
// * The stencil is K7's: the T + P - 1 input rows staged (cp.async where
//   the addresses allow), the taps beside them, each thread summing two
//   items of kR rows x 4 floats from its register ring, with K7's rounded
//   products and adds in K7's order, so v is bitwise K7's.  The sums stay
//   in registers across a barrier; then they go to the DFT's two padded
//   planes, which reuse the staging area.
// * The transform is dft.cuh's Stockham passes, K9's plan at N = C (at C
//   = 64 one radix-32 pass and one radix-2 pass, two threads a row, so
//   half the block's threads), its twiddles the same table
//   (kernels/fft_stream.py:twiddles); no window, |X| or shift.
// * The last pass writes X into the planes in natural order; the tile's
//   T x C outputs are one contiguous run of device memory, so the block
//   writes it a float4 a thread, each store a warp's 512 consecutive
//   bytes.
// * A row's Y depends only on its inputs, never on its tile or block, so
//   a streamed run equals the block-parallel call bitwise.
// * C a power of two from 64 to 1,024 (kBadSize otherwise: at 2,048 a
//   tile of kR rows would take four stencil items a thread); any P >= 1;
//   a geometry whose kR + P - 1 staged rows and taps do not fit a block
//   raises (kDoesNotFit).  kernels/channelize.py:dft_plan mirrors the
//   plan.

#ifndef DYNAMIC_SMEM
#define DYNAMIC_SMEM(name) extern __shared__ __align__(16) float name[]
#endif
#ifndef KERNEL_LAUNCH_SMEM
#define KERNEL_LAUNCH_SMEM(kernel, grid, block, smem, stream, ...) \
  kernel<<<grid, block, smem, stream>>>(__VA_ARGS__)
#endif

namespace {

using namespace stockham;

constexpr int kDftRows = 4096;          // C x T at most
constexpr int kItems = kDftRows / 8 / kThreads;   // stencil items a thread
constexpr int kBadSize = -3;            // launch code: C out of range
constexpr int kLog2Lo = 6, kLog2Hi = 10;
static_assert((kR << kLog2Hi) <= kDftRows, "a tile of kR rows at most");

template <int LOG2C>
__global__ void __launch_bounds__(kThreads, 3)
branch_dft_kernel(const float* __restrict__ hb,
                  const float* __restrict__ hist,
                  const float* __restrict__ x,
                  const float2* __restrict__ tw, float* __restrict__ y,
                  long long H, long long n, long long num, int P, int T,
                  long long tiles_per_row) {
  using G = Geometry<LOG2C>;
  constexpr int C = G::N, W = 2 * C, lanes = W / 4;
  DYNAMIC_SMEM(smem);
  float* const s = smem;                // (T + P - 1) x W staged floats
  float* const taps = smem + static_cast<long long>(T + P - 1) * W;
  const int tid = threadIdx.x;

  const long long row = blockIdx.x / tiles_per_row;
  const long long m0 = (blockIdx.x - row * tiles_per_row) * T;
  const int rows_here = static_cast<int>(
      min(static_cast<long long>(T), num - m0));

  for (int i = tid; i < P * C; i += kThreads) taps[i] = hb[i];
  const long long a = m0 * C;
  const long long b = (m0 + rows_here + P - 1) * C;
  if (a < H)
    stage<true>(s, hist + 2 * (row * H + a), 2 * (min(b, H) - a));
  if (b > H) {
    const long long e0 = max(a, H);
    stage<true>(s + 2 * (e0 - a), x + 2 * (row * n + e0 - H),
                2 * (b - e0));
  }
  copy_wait();
  __syncthreads();

  // K7's sums: item (g, l) is output rows g kR .. g kR + kR - 1, floats
  // l 4 .. l 4 + 3 (rows past rows_here are summed from unstaged words and
  // never stored)
  const int items = lanes * ((rows_here + kR - 1) / kR);
  float4 acc[kItems][kR];
#pragma unroll
  for (int u = 0; u < kItems; ++u) {
    const int it = tid + u * kThreads;
    if (it < items) {
      const int g = it / lanes;
      const int j = (it - g * lanes) * 4;
      item_sums<4>(s + g * kR * W + j, taps + j / 2, W, C, P, acc[u]);
    }
  }
  __syncthreads();                      // the staged rows and taps are read

  // v into the planes: row i's value c at pr[pad(c)], pi[pad(c)], pr =
  // smem + i P', pi = smem + (T + i) P'
#pragma unroll
  for (int u = 0; u < kItems; ++u) {
    const int it = tid + u * kThreads;
    if (it < items) {
      const int g = it / lanes;
      const int c = (it - g * lanes) * 2;
#pragma unroll
      for (int k = 0; k < kR; ++k) {
        float* const pr = smem + (g * kR + k) * G::P;
        float* const pi = smem + (T + g * kR + k) * G::P;
        pr[pad(c)] = acc[u][k].x;
        pi[pad(c)] = acc[u][k].y;
        pr[pad(c + 1)] = acc[u][k].z;
        pi[pad(c + 1)] = acc[u][k].w;
      }
    }
  }
  __syncthreads();

  // the DFT of tile row `slot`, thread t of its G::T
  const int slot = tid / G::T, t = tid % G::T;
  const bool busy = slot < rows_here;
  float* const xr = smem + slot * G::P;
  float* const xi = smem + (T + slot) * G::P;
  float re[G::E], im[G::E];
  if (busy) load_pass<G, 0>(re, im, xr, xi, tw, t);
  __syncthreads();
  run_passes<G, 1>(re, im, xr, xi, tw, t, busy,
                   [&](const float* fr, const float* fi) {
                     __syncthreads();   // the last pass's reads are done
                     if (busy)
                       store_pass<G, G::kPasses - 1>(fr, fi, xr, xi, t);
                   });
  __syncthreads();

  // the tile's rows_here x C outputs, contiguous: a float4 (two values) a
  // thread
  float4* const out = reinterpret_cast<float4*>(y + (row * num + m0) * W);
  const int pairs = rows_here * (C / 2);
  for (int i = tid; i < pairs; i += kThreads) {
    const int r = i >> (LOG2C - 1);
    const int c = 2 * (i & (C / 2 - 1));
    const float* const pr = smem + r * G::P;
    const float* const pi = smem + (T + r) * G::P;
    out[i] = make_float4(pr[pad(c)], pi[pad(c)], pr[pad(c + 1)],
                         pi[pad(c + 1)]);
  }
}

// shared-memory floats of a tile of T rows: the staged rows and taps, or
// the planes where they take more
long long dft_smem_floats(int C, int P, long long T) {
  const long long staged =
      (T + P - 1) * 2LL * C + static_cast<long long>(P) * C;
  const long long planes = 2 * T * (C + C / 32);
  return staged > planes ? staged : planes;
}

// The tile (output rows a block) and shared-memory bytes of a fused launch
// with num output rows, or kBadSize, kDoesNotFit (or a CUDA error).
int dft_plan(int C, int P, long long num, int* tile, int* smem) {
  if (C < (1 << kLog2Lo) || C > (1 << kLog2Hi) || (C & (C - 1)) || P < 1)
    return kBadSize;
  int dev = 0, most = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&most, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  long long T = kDftRows / C;
  const long long need = (num + kR - 1) / kR * kR;
  if (T > need) T = need;
  if (T < kR) T = kR;
  while (T > kR && 4 * dft_smem_floats(C, P, T) > most) T -= kR;
  const long long bytes = 4 * dft_smem_floats(C, P, T);
  if (bytes > most) return kDoesNotFit;
  *tile = static_cast<int>(T);
  *smem = static_cast<int>(bytes);
  return 0;
}

template <int LOG2C>
int launch_dft(const float* hb, const float* hist, const float* x,
               const float2* tw, float* y, long long rows, long long H,
               long long n, long long num, int P, int T, int smem,
               cudaStream_t st) {
  auto kernel = branch_dft_kernel<LOG2C>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const long long tiles_per_row = (num + T - 1) / T;
  const long long blocks = rows * tiles_per_row;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  KERNEL_LAUNCH_SMEM(kernel, static_cast<unsigned>(blocks), kThreads, smem,
                     st, hb, hist, x, tw, y, H, n, num, P, T,
                     tiles_per_row);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// hb [P, C] f32, hist [rows, H] and x [rows, n] complex64 (as f32 pairs,
// 8-byte aligned), tw kernels/fft_stream.py:twiddles(C) -> y [rows, num,
// C] complex64 (16-byte aligned).  The caller checks (num + P - 1) * C <=
// H + n.
extern "C" int launch_branch_dft(const void* hb, const void* hist,
                                 const void* x, const void* tw, void* y,
                                 long long rows, long long H, long long n,
                                 long long num, int C, int P, void* stream) {
  int T = 0, smem = 0;
  const int p = dft_plan(C, P, num, &T, &smem);
  if (p != 0) return p;
  const auto* h = static_cast<const float*>(hb);
  const auto* hs = static_cast<const float*>(hist);
  const auto* xs = static_cast<const float*>(x);
  const auto* t = static_cast<const float2*>(tw);
  auto* ys = static_cast<float*>(y);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (C) {
#define K7_DFT_SIZE(L)                                                    \
  case 1 << L:                                                            \
    return launch_dft<L>(h, hs, xs, t, ys, rows, H, n, num, P, T, smem, st);
    K7_DFT_SIZE(6) K7_DFT_SIZE(7) K7_DFT_SIZE(8) K7_DFT_SIZE(9)
    K7_DFT_SIZE(10)
#undef K7_DFT_SIZE
    default:
      return kBadSize;
  }
}

// The plan launch_branch_dft makes: output rows a tile and shared-memory
// bytes a block; kBadSize or kDoesNotFit where it refuses.
extern "C" int branch_dft_plan(int C, int P, long long num, int* tile,
                               int* smem) {
  return dft_plan(C, P, num, tile, smem);
}

extern "C" const char* kernel_error_string(int e) {
  if (e == kDoesNotFit)
    return "the branch filter's staged rows and taps do not fit a block's "
           "shared memory (K7: (P + 3) * 2C + P * C floats at most 58,112 "
           "on an H100; K7 + DFT: kernels/channelize.py:dft_plan)";
  if (e == kBadSize)
    return "the fused branch DFT takes C a power of two from 64 to 1,024";
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}

// This library links its own CUDA runtime, whose current device is not
// PyTorch's: the wrapper selects the tensors' device before each launch.
extern "C" int kernel_set_device(int device) {
  return static_cast<int>(cudaSetDevice(device));
}
