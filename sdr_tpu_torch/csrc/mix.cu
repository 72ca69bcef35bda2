// K8: the planar oscillator mix, f32 I/Q planes:
//
//   pr = lo_r c_r - lo_i c_i,   pi = lo_r c_i + lo_i c_r
//   y_r = x_r pr - x_i pi,      y_i = x_r pi + x_i pr
//
// over rows x [2, n] (the I and Q planes), leading dimensions batched as
// rows, with the oscillator's table lo [2, n] (cos, sin) shared by every
// row and each row's unit phasor carry [2] = (c_r, c_i).  Each product,
// sum and difference is one rounded f32 operation (__fmul_rn, __fadd_rn,
// __fsub_rn: no FMA contraction), in the order of the plain PyTorch form
// (kernels/mix.py, the planar Mix of stream/ops.py), so the kernel equals
// it bitwise.
//
// Replaces no TPU kernel: the JAX package writes the planar Mix as two
// planar rotations (sdr_tpu/stream/ops.py:1148-1154), which XLA fuses into
// one pass.  Run eagerly as PyTorch operators it builds the rotated table
// as two [rows, n] planes and makes six more passes.
//
// Bound on an H100: bytes.  The AM path ([32, 2, 5,242,880] f32) reads and
// writes 1.342 GB each way and reads the 42 MB table once: 2.726 GB,
// 0.814 ms at 3.35 TB/s; its 12 f32 operations a sample (2.0 G) take
// 0.06 ms.
//
// Design: one pass.  A block takes a tile of 4 x 256 samples across every
// row of the batch: each thread loads its 4 samples of the table once (two
// 16-byte loads) and then walks the rows, rotating them by the row's
// phasor and the row's 4 I and 4 Q samples by the result, with 16-byte
// loads and stores (a row whose planes are not 16-byte aligned, or the
// ragged end of a row, takes scalar ones).  So the table is read from
// device memory once, not once a row (a 1.34 GB saving at the AM path's
// 32 rows), and every sample once.
//
// The complex form (mix_complex_kernel) reads interleaved complex64 rows
// x [rows, n], the table lo [n] complex64 and each row's phasor carry
// [rows] complex64, and computes (x lo) carry in the complex Mix's order:
//
//   p_r = x_r lo_r - x_i lo_i,   p_i = x_r lo_i + x_i lo_r
//   y_r = p_r c_r - p_i c_i,     y_i = p_r c_i + p_i c_r
//
// each step one rounded f32 operation, so it equals its plain version
// (explicit real operations over view_as_real) bitwise.  It replaces the
// JAX package's complex Mix (sdr_tpu/stream/ops.py:1163, one XLA fusion),
// which the port ran as two complex multiplies in two passes.  The same
// layout: a thread's 4 samples of the table (two 16-byte loads) walk
// every row, so the AM sequential path's 42 MB table is read once; rows
// whose samples are not 16-byte aligned, and ragged ends, take 8-byte
// loads and stores.  Bound: bytes, 1.342 GB each way at [32, 5,242,880],
// 0.814 ms at 3.35 TB/s.

#include <cuda_runtime.h>

#include <cstdint>

// launches `kernel` on `grid` blocks of `block` threads (the host test
// harness defines its own)
#ifndef KERNEL_LAUNCH
#define KERNEL_LAUNCH(kernel, grid, block, stream, ...) \
  kernel<<<grid, block, 0, stream>>>(__VA_ARGS__)
#endif

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 4 * kThreads;     // samples a block

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

__global__ void __launch_bounds__(kThreads)
mix_planar_kernel(const float* __restrict__ lo,
                  const float* __restrict__ carry,
                  const float* __restrict__ x, float* __restrict__ y,
                  long long rows, long long n) {
  const long long s0 = static_cast<long long>(blockIdx.x) * kTile +
                       4 * threadIdx.x;
  if (s0 >= n) return;
  const int cnt = static_cast<int>(min(4LL, n - s0));
  float lr[4], li[4];
  if (cnt == 4 && aligned16(lo + s0) && aligned16(lo + n + s0)) {
    const float4 a = *reinterpret_cast<const float4*>(lo + s0);
    const float4 b = *reinterpret_cast<const float4*>(lo + n + s0);
    lr[0] = a.x; lr[1] = a.y; lr[2] = a.z; lr[3] = a.w;
    li[0] = b.x; li[1] = b.y; li[2] = b.z; li[3] = b.w;
  } else {
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      lr[k] = k < cnt ? lo[s0 + k] : 0.f;
      li[k] = k < cnt ? lo[n + s0 + k] : 0.f;
    }
  }
#pragma unroll 4
  for (long long r = 0; r < rows; ++r) {
    const float cr = carry[2 * r], ci = carry[2 * r + 1];
    const float* const xr = x + 2 * r * n + s0;
    const float* const xi = xr + n;
    float* const yr = y + 2 * r * n + s0;
    float* const yi = yr + n;
    float ar[4], ai[4];
    const bool vec = cnt == 4 && aligned16(xr) && aligned16(xi) &&
                     aligned16(yr) && aligned16(yi);
    if (vec) {
      const float4 a = *reinterpret_cast<const float4*>(xr);
      const float4 b = *reinterpret_cast<const float4*>(xi);
      ar[0] = a.x; ar[1] = a.y; ar[2] = a.z; ar[3] = a.w;
      ai[0] = b.x; ai[1] = b.y; ai[2] = b.z; ai[3] = b.w;
    } else {
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        ar[k] = k < cnt ? xr[k] : 0.f;
        ai[k] = k < cnt ? xi[k] : 0.f;
      }
    }
    float outr[4], outi[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float pr = __fsub_rn(__fmul_rn(lr[k], cr), __fmul_rn(li[k], ci));
      const float pi = __fadd_rn(__fmul_rn(lr[k], ci), __fmul_rn(li[k], cr));
      outr[k] = __fsub_rn(__fmul_rn(ar[k], pr), __fmul_rn(ai[k], pi));
      outi[k] = __fadd_rn(__fmul_rn(ar[k], pi), __fmul_rn(ai[k], pr));
    }
    if (vec) {
      *reinterpret_cast<float4*>(yr) =
          make_float4(outr[0], outr[1], outr[2], outr[3]);
      *reinterpret_cast<float4*>(yi) =
          make_float4(outi[0], outi[1], outi[2], outi[3]);
    } else {
#pragma unroll
      for (int k = 0; k < 4; ++k)
        if (k < cnt) {
          yr[k] = outr[k];
          yi[k] = outi[k];
        }
    }
  }
}

// 4 complex samples from p (16-byte aligned when vec) to re, im; the
// first cnt of them where not vec
__device__ __forceinline__ void load4(const float* p, bool vec, int cnt,
                                      float (&re)[4], float (&im)[4]) {
  if (vec) {
    const float4 a = *reinterpret_cast<const float4*>(p);
    const float4 b = *reinterpret_cast<const float4*>(p + 4);
    re[0] = a.x; im[0] = a.y; re[1] = a.z; im[1] = a.w;
    re[2] = b.x; im[2] = b.y; re[3] = b.z; im[3] = b.w;
  } else {
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float2 v = k < cnt ? *reinterpret_cast<const float2*>(p + 2 * k)
                               : make_float2(0.f, 0.f);
      re[k] = v.x;
      im[k] = v.y;
    }
  }
}

__global__ void __launch_bounds__(kThreads)
mix_complex_kernel(const float* __restrict__ lo,
                   const float* __restrict__ carry,
                   const float* __restrict__ x, float* __restrict__ y,
                   long long rows, long long n) {
  const long long s0 = static_cast<long long>(blockIdx.x) * kTile +
                       4 * threadIdx.x;
  if (s0 >= n) return;
  const int cnt = static_cast<int>(min(4LL, n - s0));
  float lr[4], li[4];
  load4(lo + 2 * s0, cnt == 4 && aligned16(lo + 2 * s0), cnt, lr, li);
#pragma unroll 4
  for (long long r = 0; r < rows; ++r) {
    const float cr = carry[2 * r], ci = carry[2 * r + 1];
    const float* const xr = x + 2 * (r * n + s0);
    float* const yr = y + 2 * (r * n + s0);
    const bool vec = cnt == 4 && aligned16(xr) && aligned16(yr);
    float ar[4], ai[4];
    load4(xr, vec, cnt, ar, ai);
    float out[8];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float pr = __fsub_rn(__fmul_rn(ar[k], lr[k]),
                                 __fmul_rn(ai[k], li[k]));
      const float pi = __fadd_rn(__fmul_rn(ar[k], li[k]),
                                 __fmul_rn(ai[k], lr[k]));
      out[2 * k] = __fsub_rn(__fmul_rn(pr, cr), __fmul_rn(pi, ci));
      out[2 * k + 1] = __fadd_rn(__fmul_rn(pr, ci), __fmul_rn(pi, cr));
    }
    if (vec) {
      *reinterpret_cast<float4*>(yr) =
          make_float4(out[0], out[1], out[2], out[3]);
      *reinterpret_cast<float4*>(yr + 4) =
          make_float4(out[4], out[5], out[6], out[7]);
    } else {
#pragma unroll
      for (int k = 0; k < 4; ++k)
        if (k < cnt)
          *reinterpret_cast<float2*>(yr + 2 * k) =
              make_float2(out[2 * k], out[2 * k + 1]);
    }
  }
}

}  // namespace

// the blocks of a launch over n samples
static int grid_of(long long n, unsigned* blocks) {
  const long long b = (n + kTile - 1) / kTile;
  if (b > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  *blocks = static_cast<unsigned>(b);
  return 0;
}

// lo [2, n] f32, carry [rows, 2] f32, x [rows, 2, n] f32 -> y [rows, 2, n]
// f32.
extern "C" int launch_mix_planar(const void* lo, const void* carry,
                                 const void* x, void* y, long long rows,
                                 long long n, void* stream) {
  unsigned blocks = 0;
  const int rc = grid_of(n, &blocks);
  if (rc != 0) return rc;
  KERNEL_LAUNCH(mix_planar_kernel, blocks, kThreads,
                static_cast<cudaStream_t>(stream),
                static_cast<const float*>(lo),
                static_cast<const float*>(carry),
                static_cast<const float*>(x), static_cast<float*>(y), rows,
                n);
  return static_cast<int>(cudaGetLastError());
}

// lo [n] complex64, carry [rows] complex64, x [rows, n] complex64 -> y
// [rows, n] complex64 (each as interleaved f32 pairs).
extern "C" int launch_mix_complex(const void* lo, const void* carry,
                                  const void* x, void* y, long long rows,
                                  long long n, void* stream) {
  unsigned blocks = 0;
  const int rc = grid_of(n, &blocks);
  if (rc != 0) return rc;
  KERNEL_LAUNCH(mix_complex_kernel, blocks, kThreads,
                static_cast<cudaStream_t>(stream),
                static_cast<const float*>(lo),
                static_cast<const float*>(carry),
                static_cast<const float*>(x), static_cast<float*>(y), rows,
                n);
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
