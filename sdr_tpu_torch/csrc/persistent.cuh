// What the persistent, double-buffered kernels share (K1 and K4 through
// u8_window.cuh, K3, and K2 and K5 through resample_tile.cuh): asynchronous
// copies into shared memory, a tile's row and origin, and the number of
// blocks that fit on the card at once.

#pragma once

#include <cuda_runtime.h>

namespace persistent {

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async8(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(gmem));
}

// 4 zero bytes, in the same group as the copies (src-size 0: gmem, a
// valid address, is not read)
__device__ __forceinline__ void cp_async4_zero(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(gmem), "r"(0));
}

__device__ __forceinline__ void commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// wait for all but the newest committed group: the current tile's copies
__device__ __forceinline__ void wait_prev() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}

// row and first output of tile it (32-bit division where the counts
// allow)
__device__ __forceinline__ void tile_origin(long long it, long long per_row,
                                            int tile, long long* row,
                                            long long* m0) {
  if (it < (1LL << 32) && per_row < (1LL << 32)) {
    const unsigned q = static_cast<unsigned>(it) /
                       static_cast<unsigned>(per_row);
    *row = q;
    *m0 = (it - static_cast<long long>(q) * per_row) * tile;
  } else {
    *row = it / per_row;
    *m0 = (it % per_row) * tile;
  }
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
