// K11: the FM demod, y[m] = angle(x[m] * conj(x[m - 1])), over rows of
// planar f32 I/Q x [rows, 2, n] (the I plane first) or complex64
// x [rows, n], with each row's carry, the sample before the block
// (carry [rows, 2] f32, or [rows] complex64), standing in for x[-1].
// Leading dimensions are batched as rows.
//
//   planar:   b = im pre - re pim,  a = re pre + im pim,  y = atan2(b, a)
//             (x[m] = (re, im), x[m - 1] = (pre, pim)); atan2 is the
//             polynomial of fm_demod.cuh (poly = 1) or atan2f
//   complex:  x[m] * conj(x[m - 1]), conj as the negated imaginary part,
//             (a + ib)(c + id) = (ac - bd) + (ad + bc)i, y = atan2f(im, re)
//
// Each product, sum and difference is one rounded f32 operation
// (__fmul_rn, __fadd_rn, __fsub_rn: no FMA contraction), in the order of
// the plain PyTorch forms (sdr_tpu_torch/ops/demod.py: fm_demod_planar,
// fm_demod), so the planar form with the polynomial equals its plain
// version bitwise; with atan2f it equals it wherever the card's
// torch.atan2 is atan2f.  The complex plain form multiplies through
// PyTorch's complex product, which the compiler may contract to FMA, so
// the two are held to an angular distance instead.  At warmup the carry
// is 0 and x[0] * conj(0) a signed zero: its angle is 0, or pi where both
// parts of x[0] are negative (the complex form and the planar atan2f),
// as in the JAX package; the negated imaginary part gives the same signs.
//
// Replaces no TPU kernel: the JAX package reads shifted views of the
// block and writes through one fusion root (sdr_tpu/ops/demod.py:70-121,
// sdr_tpu/stream/ops.py:585-617 FmDemod), one pass in XLA.  Run eagerly
// as PyTorch operators the planar form is two torch.cat copies of the
// shifted planes, four products, two sums and about 20 passes of the
// polynomial; the complex form a product, torch.angle and a cat.
//
// Bound on an H100: bytes.  Stereo's [32, 2, 655,360] planes read 167.8
// MB and write 83.9 MB: 0.075 ms at 3.35 TB/s; the polynomial's 22
// operations a sample (0.46 G) take 0.007 ms at the f32 rate.
//
// Design: one pass, no copy.  A thread takes 4 consecutive outputs of one
// row (a block of 256 threads 1,024; grid y is the row) and reads its
// samples x[m0 .. m0 + 3] with 16-byte loads (planar: one a plane;
// complex: two), and the sample before them, x[m0 - 1] of the same row,
// with a scalar load: each window starts one sample early (hazard H3, as
// in K1), so no thread waits for another, and only the row's first
// thread reads the carry.  A chunk that is not 16-byte aligned, or the
// ragged end of a row, takes scalar loads and stores.  The row's next
// carry, its last sample, stays a slice in the op.  Measured on an H100
// SXM at 700 W (chip_smoke.py): 0.088 ms at stereo's planes and at the
// exact path's complex rows, 0.85 of the bound.

#include <cuda_runtime.h>

#include <cstdint>

#include "fm_demod.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kPer = 4;                 // outputs a thread
constexpr int kTile = kThreads * kPer;  // outputs a block

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

template <bool POLY>
__device__ __forceinline__ float planar_angle(float re, float im, float pre,
                                              float pim) {
  const float b = __fsub_rn(__fmul_rn(im, pre), __fmul_rn(re, pim));
  const float a = __fadd_rn(__fmul_rn(re, pre), __fmul_rn(im, pim));
  return POLY ? fmd::poly_atan2(b, a) : atan2f(b, a);
}

__device__ __forceinline__ float complex_angle(float2 c, float2 p) {
  const float d = -p.y;                 // conj(p) = (p.x, d)
  const float re = __fsub_rn(__fmul_rn(c.x, p.x), __fmul_rn(c.y, d));
  const float im = __fadd_rn(__fmul_rn(c.x, d), __fmul_rn(c.y, p.x));
  return atan2f(im, re);
}

__device__ __forceinline__ void store_out(float* p, const float (&v)[kPer],
                                          int cnt) {
  if (cnt == kPer && aligned16(p)) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
#pragma unroll
    for (int k = 0; k < kPer; ++k)
      if (k < cnt) p[k] = v[k];
  }
}

// x [rows, 2, n], carry [rows, 2] -> y [rows, n]; grid (ceil(n / kTile),
// rows)
template <bool POLY>
__global__ void __launch_bounds__(kThreads)
fm_demod_planar_kernel(const float* __restrict__ x,
                       const float* __restrict__ carry,
                       float* __restrict__ y, long long n) {
  const long long m0 =
      (static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x) * kPer;
  if (m0 >= n) return;
  const int cnt = static_cast<int>(min(static_cast<long long>(kPer),
                                       n - m0));
  const long long row = blockIdx.y;
  const float* const xr = x + 2 * row * n;
  const float* const xi = xr + n;
  // [0] the sample before the chunk, [1 + k] its sample k
  float re[kPer + 1], im[kPer + 1];
  if (m0 == 0) {
    re[0] = carry[2 * row];
    im[0] = carry[2 * row + 1];
  } else {
    re[0] = xr[m0 - 1];
    im[0] = xi[m0 - 1];
  }
  if (cnt == kPer && aligned16(xr + m0) && aligned16(xi + m0)) {
    const float4 a = *reinterpret_cast<const float4*>(xr + m0);
    const float4 b = *reinterpret_cast<const float4*>(xi + m0);
    re[1] = a.x; re[2] = a.y; re[3] = a.z; re[4] = a.w;
    im[1] = b.x; im[2] = b.y; im[3] = b.z; im[4] = b.w;
  } else {
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      re[k + 1] = k < cnt ? xr[m0 + k] : 0.f;
      im[k + 1] = k < cnt ? xi[m0 + k] : 0.f;
    }
  }
  float out[kPer];
#pragma unroll
  for (int k = 0; k < kPer; ++k)
    out[k] = planar_angle<POLY>(re[k + 1], im[k + 1], re[k], im[k]);
  store_out(y + row * n + m0, out, cnt);
}

// x [rows, n] complex64, carry [rows] complex64 -> y [rows, n]; grid
// (ceil(n / kTile), rows)
__global__ void __launch_bounds__(kThreads)
fm_demod_complex_kernel(const float2* __restrict__ x,
                        const float2* __restrict__ carry,
                        float* __restrict__ y, long long n) {
  const long long m0 =
      (static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x) * kPer;
  if (m0 >= n) return;
  const int cnt = static_cast<int>(min(static_cast<long long>(kPer),
                                       n - m0));
  const long long row = blockIdx.y;
  const float2* const xs = x + row * n;
  float2 s[kPer + 1];                   // [0] the sample before the chunk
  s[0] = m0 == 0 ? carry[row] : xs[m0 - 1];
  if (cnt == kPer && aligned16(xs + m0)) {
    const float4 a = *reinterpret_cast<const float4*>(xs + m0);
    const float4 b = *reinterpret_cast<const float4*>(xs + m0 + 2);
    s[1] = make_float2(a.x, a.y);
    s[2] = make_float2(a.z, a.w);
    s[3] = make_float2(b.x, b.y);
    s[4] = make_float2(b.z, b.w);
  } else {
#pragma unroll
    for (int k = 0; k < kPer; ++k)
      s[k + 1] = k < cnt ? xs[m0 + k] : make_float2(0.f, 0.f);
  }
  float out[kPer];
#pragma unroll
  for (int k = 0; k < kPer; ++k) out[k] = complex_angle(s[k + 1], s[k]);
  store_out(y + row * n + m0, out, cnt);
}

int grid(long long rows, long long n, dim3* g) {
  const long long blocks = (n + kTile - 1) / kTile;
  if (blocks > 0x7fffffffLL || rows > 65535) return -1;
  *g = dim3(static_cast<unsigned>(blocks), static_cast<unsigned>(rows));
  return 0;
}

}  // namespace

// x [rows, 2, n] f32, carry [rows, 2] f32 -> y [rows, n] f32; poly = 1:
// the polynomial atan2, 0: atan2f.
extern "C" int launch_fm_demod_planar(const void* x, const void* carry,
                                      void* y, long long rows, long long n,
                                      int poly, void* stream) {
  dim3 g;
  if (grid(rows, n, &g) != 0) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* const xf = static_cast<const float*>(x);
  const float* const cf = static_cast<const float*>(carry);
  float* const yf = static_cast<float*>(y);
  if (poly)
    fm_demod_planar_kernel<true><<<g, kThreads, 0, s>>>(xf, cf, yf, n);
  else
    fm_demod_planar_kernel<false><<<g, kThreads, 0, s>>>(xf, cf, yf, n);
  return static_cast<int>(cudaGetLastError());
}

// x [rows, n] complex64, carry [rows] complex64 -> y [rows, n] f32.
extern "C" int launch_fm_demod_complex(const void* x, const void* carry,
                                       void* y, long long rows, long long n,
                                       void* stream) {
  dim3 g;
  if (grid(rows, n, &g) != 0) return static_cast<int>(cudaErrorInvalidValue);
  fm_demod_complex_kernel<<<g, kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float2*>(x), static_cast<const float2*>(carry),
      static_cast<float*>(y), n);
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
