// K9: the waterfall's FftStream in one pass, HBM to HBM.  For each row of
// the batch, over z = cat(hist, x) along the samples:
//
//   frame f = z[f hop, f hop + N) * window       (one rounded f32 product
//                                                 a component)
//   X_f[k] = sum_j frame[j] exp(-2 pi i j k / N)  (unnormalised forward DFT)
//   out[f, k'] = |X_f[k]|  (f32)  or  X_f[k]  (complex64),
//   k' = k ^ (N / 2) with the fftshift, else k
//
// for f < nf frames; hist [H] and x [n] are planar f32 planes [2, .] or
// complex64 samples, read through their own pointers (no concatenated copy
// and no complex64 rebuild of the planes), and the leading dimensions are
// batched as rows.
//
// Replaces no TPU kernel: the JAX package frames, windows, transforms
// (XLA's FFT, or on a TPU its own four-step DFT on the matrix unit,
// `fft_mxu_planar`) and takes |X| and the shift inside XLA fusions
// (sdr_tpu/stream/ops.py:1268-1295).  Run eagerly the port made that
// cuFFT plus five passes over device memory.
//
// Bound on an H100: bytes.  The waterfall's batch, planar [32, 2,
// 5,242,880] f32 in and [32, 10,240, 1,024] f32 out, moves 2.684 GB: 0.801
// ms at 3.35 TB/s.  Its 16.8 Gflop (5 N log2 N a frame) take about 0.26 ms
// at the card's f32 rate.  So the transform must stay on chip and out of
// shared memory's way.
//
// Design:
// * A block takes F consecutive frames of one row (F N / E threads, E the
//   elements a thread holds; F = max(1, 256 E / N), so 256 threads up to
//   N = 8,192).  It stages the (F - 1) hop + N samples they span into
//   shared memory once, each plane (or the interleaved samples) with
//   16-byte loads from each pointer's first 16-byte boundary, at a
//   shared-memory offset that keeps the block's part 16-byte aligned too.
//   Overlapping frames are not read twice from device memory.
// * The DFT is dft.cuh's Stockham passes (radix 32 in registers, one
//   padded shared-memory exchange a pass, twiddles from a float64 table
//   rounded once, as the JAX package's `_dft_consts` rounds its own).  The
//   first pass reads the staged samples times the window; the last writes
//   device memory, |X| or X, with the shift in the index (each store a
//   warp's 128 or 256 consecutive bytes).  The staging area is reused for
//   the exchanges.
// * Frame independence: a frame's result depends only on its N samples,
//   never on its slot or block, so a streamed run equals the
//   block-parallel call bitwise, and so do the planar and complex forms.
// * N a power of two from 64 to 16,384 (kernels/fft_stream.py:plan); any
//   other size raises (kBadSize), as does a plan that does not fit.

#include <cuda_runtime.h>

#include <cstdint>

#include "dft.cuh"

namespace {

using namespace stockham;

// launch codes: the shared memory exceeds a block; frames, threads or
// shared memory not the plan; the size not a power of two in range
constexpr int kDoesNotFit = -1;
constexpr int kBadPlan = -2;
constexpr int kBadSize = -3;
constexpr int kBatch = 8;         // staged 16-byte loads in flight a thread

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

// Copy cnt floats from g to d: 16-byte loads from g's first 16-byte
// boundary, asynchronous (copy16) where d is then 16-byte aligned too,
// else through registers (kBatch loads in flight a thread) a float at a
// time; head and tail apart.
__device__ __forceinline__ void stage(float* d, const float* __restrict__ g,
                                      long long cnt, int tid, int nthreads) {
  if (cnt <= 0) return;
  const long long lead =
      ((16 - (reinterpret_cast<uintptr_t>(g) & 15)) & 15) >> 2;
  const int head = static_cast<int>(cnt < lead ? cnt : lead);
  const long long nv = (cnt - head) >> 2;
  const int tail = static_cast<int>(cnt - head - 4 * nv);
  if (tid < head) d[tid] = g[tid];
  if (tid < tail) d[cnt - tail + tid] = g[cnt - tail + tid];
  const float* gv = g + head;
  float* dv = d + head;
  if (aligned16(dv)) {
    for (long long i = tid; i < nv; i += nthreads)
      copy16(dv + 4 * i, gv + 4 * i);
    return;
  }
  for (long long i0 = tid; i0 < nv; i0 += kBatch * nthreads) {
    float4 q[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const long long i = i0 + static_cast<long long>(u) * nthreads;
      if (i < nv) q[u] = __ldg(reinterpret_cast<const float4*>(gv) + i);
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const long long i = i0 + static_cast<long long>(u) * nthreads;
      if (i < nv) {
        dv[4 * i] = q[u].x;
        dv[4 * i + 1] = q[u].y;
        dv[4 * i + 2] = q[u].z;
        dv[4 * i + 3] = q[u].w;
      }
    }
  }
}

// Stage z[a, b) of one plane (planar: a float a sample) or of the
// interleaved samples (two floats a sample) into shared memory at d plus
// an offset in [0, 4) floats that puts the part read from x (or, with
// none, from hist) on the same 16-byte phase as its device address;
// returns the staged plane's start.
__device__ __forceinline__ float* stage_plane(
    float* d, const float* __restrict__ h, const float* __restrict__ x,
    long long H, long long a, long long b, int u, int tid, int nthreads) {
  const long long e0 = a > H ? a : H;       // first sample from x
  const float* lead = b > H ? x + u * (e0 - H) : h + u * a;
  const long long lead_at = b > H ? u * (e0 - a) : 0;
  const int o = static_cast<int>(
      ((reinterpret_cast<uintptr_t>(lead) >> 2) - lead_at) & 3);
  float* s = d + o;
  if (a < H) stage(s, h + u * a, u * ((b < H ? b : H) - a), tid, nthreads);
  if (b > H) stage(s + u * (e0 - a), x + u * (e0 - H), u * (b - e0), tid,
                   nthreads);
  return s;
}

// The last pass's stores into device memory: output k = jj + k' Ns of
// butterfly jj, at k ^ (N / 2) with the shift; |X| as f32 or X as
// complex64.
template <class G, int p>
__device__ __forceinline__ void store_out(const float* re, const float* im,
                                          float* __restrict__ out, int t,
                                          bool magnitude, bool shift) {
  using S = Pass<G, p>;
  constexpr int R = S::R, NS = S::NS;
  const int flip = shift ? G::N / 2 : 0;
  if (magnitude) {
#pragma unroll
    for (int q = 0; q < G::E / R; ++q) {
#pragma unroll
      for (int k = 0; k < R; ++k) {
        const int v = q * R + bitrev(k, S::kLog2R);
        out[(t + q * G::T + k * NS) ^ flip] =
            sqrtf(re[v] * re[v] + im[v] * im[v]);
      }
    }
  } else {
#pragma unroll
    for (int q = 0; q < G::E / R; ++q) {
#pragma unroll
      for (int k = 0; k < R; ++k) {
        const int v = q * R + bitrev(k, S::kLog2R);
        reinterpret_cast<float2*>(out)[(t + q * G::T + k * NS) ^ flip] =
            make_float2(re[v], im[v]);
      }
    }
  }
}

// Shared-memory floats of a block: the exchanged planes of F frames (the
// staged span, at most F N + 6 floats a plane, fits inside them).
__host__ __device__ constexpr long long smem_floats(int log2n, int frames) {
  return 2LL * frames * ((1LL << log2n) + (1LL << log2n) / 32);
}

template <int LOG2N>
__global__ void __launch_bounds__(Geometry<LOG2N>::kThreads,
                                  Geometry<LOG2N>::kMinBlocks)
fft_stream_kernel(const float* __restrict__ hist,
                  const float* __restrict__ x,
                  const float* __restrict__ win,
                  const float2* __restrict__ tw, float* __restrict__ out,
                  long long H, long long n, long long nf, int hop, int F,
                  long long tiles_per_row, int planar, int magnitude,
                  int shift) {
  using G = Geometry<LOG2N>;
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x;
  const int nthreads = F * G::T;
  const int slot = tid / G::T, t = tid % G::T;

  const long long row = blockIdx.x / tiles_per_row;
  const long long f0 = (blockIdx.x - row * tiles_per_row) * F;
  const long long fc = nf - f0 < F ? nf - f0 : F;   // frames of this block
  const long long a = f0 * hop;                     // staged z[a, b)
  const long long b = (f0 + fc - 1) * hop + G::N;

  // stage: two planes of at most (F - 1) hop + N + 3 floats each, at
  // smem and smem + F P (each a multiple of 4 floats), or the interleaved
  // samples (2 ((F - 1) hop + N) + 3 floats) at smem
  const float* s_re;
  const float* s_im;
  if (planar) {
    s_re = stage_plane(smem, hist + 2 * row * H, x + 2 * row * n, H, a, b, 1,
                       tid, nthreads);
    s_im = stage_plane(smem + F * G::P, hist + (2 * row + 1) * H,
                       x + (2 * row + 1) * n, H, a, b, 1, tid, nthreads);
  } else {
    s_re = stage_plane(smem, hist + 2 * row * H, x + 2 * row * n, H, a, b, 2,
                       tid, nthreads);
    s_im = s_re + 1;
  }
  copy_wait();
  __syncthreads();

  // the first pass: E elements t + r T of the frame times the window
  float re[G::E], im[G::E];
  const int at = slot * hop;
  if (planar) {
#pragma unroll
    for (int r = 0; r < G::E; ++r) {
      const int i = t + r * G::T;
      const float w = __ldg(win + i);
      re[r] = __fmul_rn(s_re[at + i], w);
      im[r] = __fmul_rn(s_im[at + i], w);
    }
  } else {
#pragma unroll
    for (int r = 0; r < G::E; ++r) {
      const int i = t + r * G::T;
      const float w = __ldg(win + i);
      const float2 v = reinterpret_cast<const float2*>(s_re)[at + i];
      re[r] = __fmul_rn(v.x, w);
      im[r] = __fmul_rn(v.y, w);
    }
  }
  dft<G::E>(re, im);
  __syncthreads();                      // the staged samples are read

  float* const xr = smem + slot * G::P;
  float* const xi = smem + (F + slot) * G::P;
  float* const o = out + (row * nf + f0 + slot) * G::N * (magnitude ? 1 : 2);
  run_passes<G, 1>(re, im, xr, xi, tw, t, true,
                   [&](const float* fr, const float* fi) {
                     if (slot < fc)
                       store_out<G, G::kPasses - 1>(fr, fi, o, t,
                                                    magnitude != 0,
                                                    shift != 0);
                   });
}

// 0 where frames, threads and smem are the plan at N = 2^LOG2N
// (kernels/fft_stream.py:plan), else kBadPlan
template <int LOG2N>
int plan_error(int frames, int threads, int smem) {
  using G = Geometry<LOG2N>;
  const int want = G::T >= kTargetThreads ? 1 : kTargetThreads / G::T;
  return frames == want && threads == want * G::T &&
                 smem == 4 * smem_floats(LOG2N, want)
             ? 0
             : kBadPlan;
}

int device_smem_limit(int* most) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(most, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               dev);
  return static_cast<int>(e);
}

template <int LOG2N>
int launch(const float* hist, const float* x, const float* win,
           const float2* tw, float* out, long long rows, long long H,
           long long n, long long nf, int hop, int frames, int threads,
           int smem, int planar, int magnitude, int shift, cudaStream_t st) {
  const int p = plan_error<LOG2N>(frames, threads, smem);
  if (p != 0) return p;
  int most = 0;
  const int e = device_smem_limit(&most);
  if (e != 0) return e;
  if (smem > most) return kDoesNotFit;
  auto kernel = fft_stream_kernel<LOG2N>;
  if (smem > 48 * 1024) {
    const cudaError_t s = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (s != cudaSuccess) return static_cast<int>(s);
  }
  const long long tiles_per_row = (nf + frames - 1) / frames;
  const long long blocks = rows * tiles_per_row;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  kernel<<<static_cast<unsigned>(blocks), threads, smem, st>>>(
      hist, x, win, tw, out, H, n, nf, hop, frames, tiles_per_row, planar,
      magnitude, shift);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// hist [rows, 2, H] and x [rows, 2, n] planar f32 (planar = 1), or hist
// [rows, H] and x [rows, n] complex64 (8-byte aligned); win [size] f32;
// tw the wrapper's twiddle table for size (float2 [size]) -> out [rows,
// nf, size] f32 (magnitude = 1) or complex64.  frames, threads and smem
// are kernels/fft_stream.py:plan's; the caller checks (nf - 1) hop + size
// <= H + n and 1 <= hop <= size.
extern "C" int launch_fft_stream(const void* hist, const void* x,
                                 const void* win, const void* tw, void* out,
                                 long long rows, long long H, long long n,
                                 long long nf, int size, int hop, int frames,
                                 int threads, int smem, int planar,
                                 int magnitude, int shift, void* stream) {
  const auto* hs = static_cast<const float*>(hist);
  const auto* xs = static_cast<const float*>(x);
  const auto* w = static_cast<const float*>(win);
  const auto* t = static_cast<const float2*>(tw);
  auto* o = static_cast<float*>(out);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (size) {
#define K9_SIZE(L)                                                          \
  case 1 << L:                                                              \
    return launch<L>(hs, xs, w, t, o, rows, H, n, nf, hop, frames, threads, \
                     smem, planar, magnitude, shift, st);
    K9_SIZE(6) K9_SIZE(7) K9_SIZE(8) K9_SIZE(9) K9_SIZE(10) K9_SIZE(11)
    K9_SIZE(12) K9_SIZE(13) K9_SIZE(14)
#undef K9_SIZE
    default:
      return kBadSize;
  }
}

extern "C" const char* kernel_error_string(int e) {
  if (e == kDoesNotFit)
    return "the FFT stream's exchanged planes do not fit a block's shared "
           "memory";
  if (e == kBadPlan)
    return "frames, threads or shared memory are not the FFT stream's plan";
  if (e == kBadSize)
    return "the FFT stream's size is not a power of two from 64 to 16,384";
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}

// This library links its own CUDA runtime, whose current device is not
// PyTorch's: the wrapper selects the tensors' device before each launch.
extern "C" int kernel_set_device(int device) {
  return static_cast<int>(cudaSetDevice(device));
}
