// What the persistent, double-buffered kernels share (K1 and K4 through
// u8_window.cuh, and K3): asynchronous copies into shared memory, and the
// number of blocks that fit on the card at once.

#pragma once

#include <cuda_runtime.h>

namespace persistent {

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}

__device__ __forceinline__ void commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// wait for all but the newest committed group: the current tile's copies
__device__ __forceinline__ void wait_prev() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}

// Blocks of `kernel` (`threads` each, `smem` bytes of dynamic shared
// memory) that fit on the card at once.  The last answer is kept, so a
// launch like the one before makes no query.
template <typename Kern>
int resident_blocks(Kern kernel, int threads, long long smem, int* blocks) {
  static const void* c_kernel = nullptr;
  static int c_dev = -1, c_blocks = 0;
  static long long c_smem = -1;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess && dev == c_dev && smem == c_smem &&
      reinterpret_cast<const void*>(kernel) == c_kernel) {
    *blocks = c_blocks;
    return 0;
  }
  if (e == cudaSuccess && smem > 48 * 1024)
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  int sms = 0, per_sm = 0;
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, kernel, threads, static_cast<size_t>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  *blocks = sms * (per_sm > 0 ? per_sm : 1);
  c_kernel = reinterpret_cast<const void*>(kernel);
  c_dev = dev;
  c_smem = smem;
  c_blocks = *blocks;
  return 0;
}

}  // namespace persistent
