// K10: interleaved I/Q -> f32, one pass:
//
//   u8  (RTL-SDR):  y = (v - 128) / 128      i16 (BladeRF):  y = v / 2048
//
// from x [rows, 2n] (I, Q, I, Q, ...) to planar f32 [rows, 2, n] (the I
// plane first) or complex64 [rows, n].  Leading dimensions are batched as
// rows; n may be odd or 0.  One template over the input type and the
// output layout.
//
// Bitwise the plain PyTorch form (sdr_tpu_torch/ops/convert.py: a
// subtraction, then a division): v - 128 and v are integers that f32
// holds exactly, and a division by a power of two is exact, so the
// multiply by 2^-7 (0.0078125f) or 2^-11 (1/2048.f) here rounds to the
// same value, the sign of a zero included (v = 0 and v - 128 = 0 give
// +0 in both forms).
//
// Replaces no TPU kernel: the JAX package writes the converts as one
// elementwise expression (sdr_tpu/ops/convert.py:30-94: a u16 or i32
// bitcast of each pair, a mask and a shift), which XLA fuses into one
// pass (sdr_tpu/stream/ops.py:46 IqConvertU8, :77 IqConvertI16).  Run
// eagerly as PyTorch operators it is two or three passes: two strided
// subtractions and a division in place (planar), or a subtraction and a
// division (complex).
//
// Bound on an H100: bytes.  The AM and waterfall paths' batch, u8
// [32, 10,485,760] -> [32, 2, 5,242,880] f32, reads 335.5 MB and writes
// 1,342 MB: 0.501 ms at 3.35 TB/s; its one operation a sample is nothing
// beside that.
//
// Design: every load and store instruction of a warp covers one
// contiguous run.  A thread makes 4 loads of 4 input elements (2 I/Q
// pairs: one 4-byte load for u8, one 8-byte load for i16), strided by the
// block's 256 threads, all issued before any store; a block covers 4,096
// input elements.  Planar: each load's 2 I samples and 2 Q samples go out
// as one 8-byte store to each plane (a warp writes 256 contiguous bytes a
// plane); complex: its 4 floats as one 16-byte store.  Measured on an
// H100 SXM at 700 W (chip_smoke.py) this takes the AM path's u8 ->
// planar batch in 0.580 ms, 0.86 of the bound; the first design, 16
// consecutive elements a thread with 16-byte loads and stores, took 1.384
// ms: a warp's 16-byte stores 64 bytes apart cover each 32-byte sector
// in two instructions.  A load or store that is not aligned to its width
// (a row base or a plane off alignment, as n odd or a misaligned tensor
// make it), or the ragged end of a row or of the tensor, takes scalar
// ones.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kVec = 4;                 // input elements a load: 2 pairs
constexpr int kIters = 4;               // loads a thread
constexpr int kElems = kVec * kIters;   // input elements a thread

template <class T>
struct Scale;

template <>
struct Scale<uint8_t> {
  static __device__ __forceinline__ float of(uint8_t v) {
    return __fmul_rn(static_cast<float>(static_cast<int>(v) - 128),
                     0.0078125f);
  }
};

template <>
struct Scale<int16_t> {
  static __device__ __forceinline__ float of(int16_t v) {
    return __fmul_rn(static_cast<float>(v), 1.f / 2048.f);
  }
};

template <class T>
struct Word;                            // kVec elements of T as one load

template <>
struct Word<uint8_t> {
  using type = uint32_t;
};

template <>
struct Word<int16_t> {
  using type = uint2;
};

__device__ __forceinline__ bool aligned(const void* p, int bytes) {
  return (reinterpret_cast<uintptr_t>(p) & (bytes - 1)) == 0;
}

// kVec input elements from p, of which the first cnt exist, scaled: one
// load where all exist and p is aligned to the load, scalar ones otherwise
template <class T>
__device__ __forceinline__ void load4(const T* p, int cnt,
                                      float (&v)[kVec]) {
  union {
    typename Word<T>::type w;
    T e[kVec];
  } c;
  if (cnt == kVec && aligned(p, sizeof(c.w))) {
    c.w = *reinterpret_cast<const typename Word<T>::type*>(p);
  } else {
#pragma unroll
    for (int k = 0; k < kVec; ++k) c.e[k] = k < cnt ? p[k] : T(0);
  }
#pragma unroll
  for (int k = 0; k < kVec; ++k) v[k] = Scale<T>::of(c.e[k]);
}

// x [rows, 2n] -> y [rows, 2, n]; grid (ceil(n / 2,048), rows)
template <class T>
__global__ void __launch_bounds__(kThreads)
iq_planar_kernel(const T* __restrict__ x, float* __restrict__ y,
                 long long n) {
  const long long row = blockIdx.y;
  const T* const xr = x + row * 2 * n;
  float* const yi = y + row * 2 * n;
  float* const yq = yi + n;
  const long long base = static_cast<long long>(blockIdx.x) * kThreads *
                         kIters * (kVec / 2);
  float v[kIters][kVec];
  int cnt[kIters];
#pragma unroll
  for (int it = 0; it < kIters; ++it) {
    const long long p = base + (it * kThreads + threadIdx.x) * (kVec / 2);
    cnt[it] = static_cast<int>(max(0LL, min(static_cast<long long>(kVec / 2),
                                            n - p)));
    if (cnt[it] > 0) load4(xr + 2 * p, 2 * cnt[it], v[it]);
  }
#pragma unroll
  for (int it = 0; it < kIters; ++it) {
    const long long p = base + (it * kThreads + threadIdx.x) * (kVec / 2);
    if (cnt[it] == kVec / 2 && aligned(yi + p, 8) &&
        aligned(yq + p, 8)) {
      *reinterpret_cast<float2*>(yi + p) = make_float2(v[it][0], v[it][2]);
      *reinterpret_cast<float2*>(yq + p) = make_float2(v[it][1], v[it][3]);
    } else {
#pragma unroll
      for (int k = 0; k < kVec / 2; ++k)
        if (k < cnt[it]) {
          yi[p + k] = v[it][2 * k];
          yq[p + k] = v[it][2 * k + 1];
        }
    }
  }
}

// x [total] -> y [total] f32 (complex64 [total / 2]); grid
// ceil(total / 4,096)
template <class T>
__global__ void __launch_bounds__(kThreads)
iq_complex_kernel(const T* __restrict__ x, float* __restrict__ y,
                  long long total) {
  const long long base = static_cast<long long>(blockIdx.x) * kThreads *
                         kElems;
  float v[kIters][kVec];
  int cnt[kIters];
#pragma unroll
  for (int it = 0; it < kIters; ++it) {
    const long long e = base + (it * kThreads + threadIdx.x) * kVec;
    cnt[it] = static_cast<int>(max(0LL, min(static_cast<long long>(kVec),
                                            total - e)));
    if (cnt[it] > 0) load4(x + e, cnt[it], v[it]);
  }
#pragma unroll
  for (int it = 0; it < kIters; ++it) {
    const long long e = base + (it * kThreads + threadIdx.x) * kVec;
    if (cnt[it] == kVec && aligned(y + e, 16)) {
      *reinterpret_cast<float4*>(y + e) =
          make_float4(v[it][0], v[it][1], v[it][2], v[it][3]);
    } else {
#pragma unroll
      for (int k = 0; k < kVec; ++k)
        if (k < cnt[it]) y[e + k] = v[it][k];
    }
  }
}

template <class T>
int launch(const void* x, void* y, long long rows, long long n, int planar,
           cudaStream_t stream) {
  const long long per_block = static_cast<long long>(kThreads) * kElems;
  if (planar) {
    const long long blocks = (2 * n + per_block - 1) / per_block;
    if (blocks > 0x7fffffffLL || rows > 65535)
      return static_cast<int>(cudaErrorInvalidValue);
    iq_planar_kernel<T><<<dim3(static_cast<unsigned>(blocks),
                               static_cast<unsigned>(rows)),
                          kThreads, 0, stream>>>(
        static_cast<const T*>(x), static_cast<float*>(y), n);
  } else {
    const long long blocks = (rows * 2 * n + per_block - 1) / per_block;
    if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
    iq_complex_kernel<T><<<static_cast<unsigned>(blocks), kThreads, 0,
                           stream>>>(static_cast<const T*>(x),
                                     static_cast<float*>(y), rows * 2 * n);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x [rows, 2n] u8 (i16 = 0) or int16 (i16 = 1) -> y [rows, 2, n] f32
// (planar = 1) or complex64 [rows, n] (planar = 0).
extern "C" int launch_iq_convert(const void* x, void* y, long long rows,
                                 long long n, int i16, int planar,
                                 void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return i16 ? launch<int16_t>(x, y, rows, n, planar, s)
             : launch<uint8_t>(x, y, rows, n, planar, s);
}

extern "C" const char* kernel_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}

// This library links its own CUDA runtime, whose current device is not
// PyTorch's: the wrapper selects the tensors' device before each launch.
extern "C" int kernel_set_device(int device) {
  return static_cast<int>(cudaSetDevice(device));
}
