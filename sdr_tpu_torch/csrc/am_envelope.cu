// K16: AM's planar envelope, f32:
//
//   y = sqrt(re*re + im*im)
//
// over rows x [2, n] (the I and Q planes), leading dimensions batched as
// rows, into y [n] a row.  Each product, the sum and the root are one
// rounded f32 operation (affine.cuh's envelope: __fmul_rn, __fadd_rn,
// __fsqrt_rn), the order of the plain PyTorch version
// (kernels/agc_linear.py:envelope, an f32 sum and a float64 root rounded
// once), so the kernel equals it bitwise.
//
// Replaces no TPU kernel: the JAX package's planar AmDemod is
// sqrt(re**2 + im**2) (sdr_tpu/stream/ops.py:944), one XLA fusion.  The
// port ran it as four eager passes (two squares, the sum, the root).
//
// Bound on an H100: bytes.  The AM path's [32, 2, 327,680] planes are read
// once and the [32, 327,680] envelope written once: 125.8 MB, 0.0376 ms at
// 3.35 TB/s; 4 f32 operations a sample take 0.00003 ms at the FFMA rate.
//
// Design: one pass, a thread 4 consecutive samples of a row, a block's
// threads along the row and the grid's y along the rows.  Where the row's
// I, Q and output bases sit at the same offset from 16 bytes, the row's
// quads start at the first sample whose output is 16-byte aligned and
// load and store 16 bytes at a time; the samples before it, a ragged
// end and rows whose planes sit otherwise take 4-byte loads and stores.

#include <cuda_runtime.h>

#include <cstdint>

#include "affine.cuh"

// launches `kernel` on `grid` blocks of `block` threads (the host test
// harness defines its own)
#ifndef KERNEL_LAUNCH
#define KERNEL_LAUNCH(kernel, grid, block, stream, ...) \
  kernel<<<grid, block, 0, stream>>>(__VA_ARGS__)
#endif

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 4 * kThreads;     // samples a block

__device__ __forceinline__ int offset16(const void* p) {
  return static_cast<int>(reinterpret_cast<uintptr_t>(p) & 15);
}

__global__ void __launch_bounds__(kThreads)
envelope_kernel(const float* __restrict__ x, float* __restrict__ y,
                long long n) {
  const long long r = blockIdx.y;
  const float* const re = x + 2 * r * n;
  const float* const im = re + n;
  float* const out = y + r * n;
  // the samples before the first 16-byte aligned output, where the planes
  // share the output's offset (else none: every quad takes scalar loads)
  const int off = offset16(out);
  const bool vec = offset16(re) == off && offset16(im) == off &&
                   off % 4 == 0;
  const long long head = vec ? ((16 - off) & 15) / 4 : 0;
  // quad q covers samples head - 4 + 4 q .. + 3 (quad 0 the head)
  const long long i0 = head - 4 +
      4 * (static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x);
  if (i0 >= n) return;
  if (vec && i0 >= 0 && i0 + 4 <= n) {
    const float4 a = *reinterpret_cast<const float4*>(re + i0);
    const float4 b = *reinterpret_cast<const float4*>(im + i0);
    *reinterpret_cast<float4*>(out + i0) = make_float4(
        affine::envelope(a.x, b.x), affine::envelope(a.y, b.y),
        affine::envelope(a.z, b.z), affine::envelope(a.w, b.w));
    return;
  }
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const long long i = i0 + k;
    if (i >= 0 && i < n) out[i] = affine::envelope(re[i], im[i]);
  }
}

int invalid() { return static_cast<int>(cudaErrorInvalidValue); }

}  // namespace

// x [rows, 2, n] f32 -> y [rows, n] f32, rows <= 65535.
extern "C" int launch_am_envelope(const void* x, void* y, long long rows,
                                  long long n, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (rows <= 0 || rows > 65535 || n <= 0) return invalid();
  // a quad more than the row's samples, for the head
  const long long quads = (n + 3) / 4 + 1;
  const long long blocks = (quads + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return invalid();
  const dim3 grid(static_cast<unsigned>(blocks),
                  static_cast<unsigned>(rows));
  KERNEL_LAUNCH(envelope_kernel, grid, kThreads, st,
                static_cast<const float*>(x), static_cast<float*>(y), n);
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
