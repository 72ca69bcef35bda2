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

#include <cuda_runtime.h>

#include <cstdint>

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

}  // namespace

// lo [2, n] f32, carry [rows, 2] f32, x [rows, 2, n] f32 -> y [rows, 2, n]
// f32.
extern "C" int launch_mix_planar(const void* lo, const void* carry,
                                 const void* x, void* y, long long rows,
                                 long long n, void* stream) {
  const long long blocks = (n + kTile - 1) / kTile;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  mix_planar_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(lo), static_cast<const float*>(carry),
      static_cast<const float*>(x), static_cast<float*>(y), rows, n);
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
