// Probes of the card's ceilings for the roofline model
// (sdr_tpu_torch/utils/roofline.py), run by sdr_tpu_torch/measure_ceilings.py.
//
// Replaces no TPU kernel: tools/measure_ceilings.py probes the TPU's units
// with XLA operations.  Each probe here can be bound by one unit only:
//
//   copy16     device memory: a grid-stride copy, 16-byte loads and
//              stores, four of each in flight a thread;
//   ffma       the f32 CUDA cores: kChains independent FFMA chains a
//              thread, every SM full of warps;
//   spin       the SM clock: one lane spinning on clock64 for a number of
//              cycles, which the caller times by CUDA events;
//   latency    one lane running a dependent chain of one instruction
//              (FMUL, FADD, FFMA, MUFU.RSQ, __fsqrt_rn) or of K6's step
//              exactly as csrc/agc_scan.cu writes it, clock64 around it.
//
// The f32 operations are the rounded intrinsics (__fmul_rn, __fadd_rn,
// __fmaf_rn), which the compiler neither contracts nor reorders, on
// operands it cannot know, so no chain folds.

#include <cuda_runtime.h>

namespace {

constexpr int kChains = 8;      // independent FFMA chains a thread
constexpr int kUnroll = 16;     // operations a loop trip

__global__ void copy16_kernel(const int4* __restrict__ src,
                              int4* __restrict__ dst, long long n) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  for (; i + 3 * stride < n; i += 4 * stride) {
    const int4 a = src[i];
    const int4 b = src[i + stride];
    const int4 c = src[i + 2 * stride];
    const int4 d = src[i + 3 * stride];
    dst[i] = a;
    dst[i + stride] = b;
    dst[i + 2 * stride] = c;
    dst[i + 3 * stride] = d;
  }
  for (; i < n; i += stride) dst[i] = src[i];
}

__global__ void ffma_kernel(float a, float b, int iters,
                            float* __restrict__ out) {
  float x[kChains];
#pragma unroll
  for (int k = 0; k < kChains; ++k) x[k] = static_cast<float>(threadIdx.x + k);
  for (int i = 0; i < iters; ++i) {
#pragma unroll
    for (int j = 0; j < kUnroll; ++j) {
#pragma unroll
      for (int k = 0; k < kChains; ++k) x[k] = __fmaf_rn(x[k], a, b);
    }
  }
  float s = 0.0f;
#pragma unroll
  for (int k = 0; k < kChains; ++k) s += x[k];
  out[static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x] = s;
}

__global__ void spin_kernel(long long cycles, long long* out) {
  const long long t0 = clock64();
  long long t = t0;
  while (t - t0 < cycles) t = clock64();
  out[0] = t - t0;
}

// One lane: n trips of kUnroll dependent STEPs on x, clock64 around them.
#define LATENCY_PROBE(NAME, ...)                                         \
  __global__ void NAME(float x, float a, float b, float c, float d,      \
                       int n, long long* cycles, float* out) {           \
    const long long t0 = clock64();                                      \
    for (int i = 0; i < n; ++i) {                                        \
      _Pragma("unroll") for (int j = 0; j < kUnroll; ++j) { __VA_ARGS__; } \
    }                                                                    \
    const long long t1 = clock64();                                      \
    cycles[0] = t1 - t0;                                                 \
    out[0] = x;                                                          \
  }

LATENCY_PROBE(lat_fmul, x = __fmul_rn(x, a))
LATENCY_PROBE(lat_fadd, x = __fadd_rn(x, a))
LATENCY_PROBE(lat_ffma, x = __fmaf_rn(x, a, b))
LATENCY_PROBE(lat_rsqrt, asm volatile("rsqrt.approx.ftz.f32 %0, %0;"
                                      : "+f"(x)))
LATENCY_PROBE(lat_sqrt, x = __fsqrt_rn(x))
// K6's complex step (csrc/agc_scan.cu) with the gain in x: a, b the
// sample's planes, c = mu, d = ref
LATENCY_PROBE(lat_agc_step,
              const float cr = __fmul_rn(a, x);
              const float ci = __fmul_rn(b, x);
              const float m = __fsqrt_rn(
                  __fadd_rn(__fmul_rn(cr, cr), __fmul_rn(ci, ci)));
              x = __fadd_rn(x, __fmul_rn(c, __fsub_rn(d, m))))

#undef LATENCY_PROBE

using LatencyProbe = void (*)(float, float, float, float, float, int,
                              long long*, float*);
constexpr LatencyProbe kLatencyProbes[] = {lat_fmul, lat_fadd, lat_ffma,
                                           lat_rsqrt, lat_sqrt, lat_agc_step};

}  // namespace

// src, dst: n16 16-byte words each, 16-byte aligned.
extern "C" int launch_copy16(const void* src, void* dst, long long n16,
                             int blocks, int threads, void* stream) {
  copy16_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int4*>(src), static_cast<int4*>(dst), n16);
  return static_cast<int>(cudaGetLastError());
}

// out: blocks * threads floats.  2 * kChains * kUnroll * iters flops a
// thread.
extern "C" int launch_ffma(float a, float b, int iters, void* out,
                           int blocks, int threads, void* stream) {
  ffma_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      a, b, iters, static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

// out: one int64, the cycles spun.
extern "C" int launch_spin(long long cycles, void* out, void* stream) {
  spin_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      cycles, static_cast<long long*>(out));
  return static_cast<int>(cudaGetLastError());
}

// which: 0 FMUL, 1 FADD, 2 FFMA, 3 MUFU.RSQ, 4 __fsqrt_rn, 5 K6's step;
// n * kUnroll dependent operations.  cycles: one int64; out: one float.
extern "C" int launch_latency(int which, float x, float a, float b, float c,
                              float d, int n, void* cycles, void* out,
                              void* stream) {
  if (which < 0 || which >= static_cast<int>(sizeof(kLatencyProbes) /
                                             sizeof(kLatencyProbes[0])))
    return static_cast<int>(cudaErrorInvalidValue);
  kLatencyProbes[which]<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      x, a, b, c, d, n, static_cast<long long*>(cycles),
      static_cast<float*>(out));
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
