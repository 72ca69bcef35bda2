// K6: the sequential AGC over rows of complex64 or f32 samples.
//
//   y[n] = x[n] * g[n],   g[n+1] = g[n] + mu * (reference - |y[n]|),
//
// computed on the real planes in exactly this order, every product, sum
// and square root one rounded f32 operation (no FMA contraction):
//
//   cr = re*g;  ci = im*g;  m = sqrt(cr*cr + ci*ci);  g = g + mu*(ref - m)
//
// (real input: m = |cr|), so a row's samples and final gain equal the
// plain PyTorch version (kernels/agc.py) bitwise.
//
// Replaces no TPU kernel: the JAX package runs this recurrence as a
// lax.scan over samples (sdr_tpu/ops/scans.py:agc, method='scan', the
// step at :139-142), the exact AGC where the linear form's positive-gain
// premise fails (mu*|x| > 1).  On the card a loop of PyTorch operations
// per sample would launch several kernels a sample, so it has one.
//
// Bound on an H100: the recurrence's latency, not bytes.  Each sample
// waits for the previous one's gain through two multiplies, an add, a
// square root, a subtract, a multiply and an add: some 40-80 cycles of
// dependent latency, so a row of the AM path (327,680 samples) takes
// about 7-13 ms at 1.98 GHz whatever the card's width, and its 32 rows
// run side by side.  The bytes (8 B read and 8 B written a sample) would
// take 0.1 ms over the AM path's [32, 327,680].
//
// Design: one warp a row.  The warp stages chunks of kChunk samples into
// shared memory by cp.async, the next chunk's copies in flight while one
// lane runs the recurrence over the current one with the gain in a
// register and writes y in place; then the warp stores the chunk with
// coalesced writes.  store = 0 skips y (the block-parallel sweeps need
// only each row's final gain).

#include <cuda_runtime.h>

#include "persistent.cuh"

namespace {

constexpr int kWarp = 32;
constexpr int kChunk = 1024;            // samples a staged chunk

template <bool kComplex>
__global__ void __launch_bounds__(kWarp)
agc_scan_kernel(const float* __restrict__ x, const float* __restrict__ g0,
                float* __restrict__ y, float* __restrict__ g_out,
                long long n, float mu, float ref, int store) {
  constexpr int C = kComplex ? 2 : 1;   // floats a sample
  __shared__ __align__(16) float buf[2][kChunk * C];
  const long long row = blockIdx.x;
  const int lane = threadIdx.x;
  const float* const xr = x + row * n * C;
  const long long chunks = (n + kChunk - 1) / kChunk;
  float g = g0[row];

  auto stage = [&](int b, long long c) {
    const long long base = c * kChunk * C;
    const int cnt = static_cast<int>(
        min(static_cast<long long>(kChunk * C), n * C - base));
    for (int i = lane; i < cnt; i += kWarp)
      persistent::cp_async4(&buf[b][i], xr + base + i);
  };

  if (chunks > 0) stage(0, 0);
  persistent::commit();
  for (long long c = 0; c < chunks; ++c) {
    const int b = static_cast<int>(c & 1);
    if (c + 1 < chunks) stage(b ^ 1, c + 1);
    persistent::commit();
    persistent::wait_prev();            // chunk c has landed
    __syncwarp();
    const int cnt = static_cast<int>(
        min(static_cast<long long>(kChunk), n - c * kChunk));
    if (lane == 0) {
      float* const s = buf[b];
#pragma unroll 4
      for (int i = 0; i < cnt; ++i) {
        float m;
        if constexpr (kComplex) {
          const float2 v = reinterpret_cast<const float2*>(s)[i];
          const float cr = __fmul_rn(v.x, g);
          const float ci = __fmul_rn(v.y, g);
          m = __fsqrt_rn(__fadd_rn(__fmul_rn(cr, cr), __fmul_rn(ci, ci)));
          if (store) reinterpret_cast<float2*>(s)[i] = make_float2(cr, ci);
        } else {
          const float cr = __fmul_rn(s[i], g);
          m = fabsf(cr);
          if (store) s[i] = cr;
        }
        g = __fadd_rn(g, __fmul_rn(mu, __fsub_rn(ref, m)));
      }
    }
    __syncwarp();
    if (store) {
      float* const yr = y + row * n * C + c * kChunk * C;
      for (int i = lane; i < cnt * C; i += kWarp) yr[i] = buf[b][i];
    }
    __syncwarp();                       // buffer b is refilled next
  }
  if (lane == 0) g_out[row] = g;
}

}  // namespace

// x [rows, n] complex64 (as [rows, n, 2] f32) or f32, g0 [rows] f32 ->
// y like x (unless store is 0; y may then be null), g_out [rows] f32.
extern "C" int launch_agc_scan(const void* x, const void* g0, void* y,
                               void* g_out, long long rows, long long n,
                               float mu, float ref, int is_complex,
                               int store, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned grid = static_cast<unsigned>(rows);
  if (is_complex)
    agc_scan_kernel<true><<<grid, kWarp, 0, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(g0),
        static_cast<float*>(y), static_cast<float*>(g_out), n, mu, ref,
        store);
  else
    agc_scan_kernel<false><<<grid, kWarp, 0, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(g0),
        static_cast<float*>(y), static_cast<float*>(g_out), n, mu, ref,
        store);
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
