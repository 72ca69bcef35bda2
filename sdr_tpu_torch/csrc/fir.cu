// K3: strided FIR, f32:  y[i] = sum_j taps[j] * x[start + i*f + j],
// leading dimensions batched as rows.
//
// Replaces the TPU kernel sdr_tpu/kernels/fir_pallas.py:fir_strided
// (pl.pallas_call at :125, body _kernel :62).
//
// Bound on an H100: memory.  The FM chain's 64-tap audio filter (volume
// folded into the taps) on the block-parallel batch reads and writes 25 MB
// of f32 each: about 0.015 ms at 3.35 TB/s; 2 * 64 FLOP per output is
// about 1% of the f32 rate.
//
// Design: the TPU form tiles outputs as lane-aligned banded matmuls and
// slices the input when start >= 128 or f > 1.  Here each thread computes
// one output directly; any start is a pointer offset and any f >= 1 a
// stride, so the AM and channelizer decimators can reuse the kernel.
// Neighbouring outputs read overlapping windows, which L1 serves; the taps
// live in shared memory.  The sum runs in tap order, each product and sum
// one rounded operation (no FMA contraction), so an output does not depend
// on the grid and equals the plain PyTorch version bitwise.  No atomics.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;

__global__ void __launch_bounds__(THREADS)
fir_kernel(const float* __restrict__ x, const float* __restrict__ taps,
           float* __restrict__ y, long long n, long long num, int K, int f,
           long long start) {
  extern __shared__ float s_taps[];
  for (int k = threadIdx.x; k < K; k += THREADS) s_taps[k] = taps[k];
  __syncthreads();
  const long long m = static_cast<long long>(blockIdx.x) * THREADS +
                      threadIdx.x;
  if (m >= num) return;
  const long long row = blockIdx.y;
  const float* xr = x + row * n + start + m * f;
  float acc = 0.f;
  for (int k = 0; k < K; ++k)
    acc = __fadd_rn(acc, __fmul_rn(s_taps[k], __ldg(xr + k)));
  y[row * num + m] = acc;
}

}  // namespace

// x [rows, n] f32, taps [K] f32 -> y [rows, num] f32.  The caller checks
// start + (num - 1) * f + K <= n.
extern "C" int launch_fir(const void* x, const void* taps, void* y,
                          long long rows, long long n, long long num, int K,
                          int f, long long start, void* stream) {
  const dim3 grid(static_cast<unsigned>((num + THREADS - 1) / THREADS),
                  static_cast<unsigned>(rows));
  const size_t smem = sizeof(float) * K;
  fir_kernel<<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(taps),
      static_cast<float*>(y), n, num, K, f, start);
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
