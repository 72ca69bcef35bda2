"""The port's CUDA sources compiled for the host, to test them without a
card: ``SHIM`` stands in for ``<cuda_runtime.h>`` and :func:`build`
compiles a source's device code and plan under it (its own ``csrc``
headers on the include path), with a runner that calls its kernel block
by block, thread by thread; :func:`build_source` compiles a whole source,
its C launch functions included, whose launches go through
``KERNEL_LAUNCH`` (``LAUNCH_SHIM`` runs each grid's blocks in turn, a
block's threads as std::threads); :func:`offset` places a test's input
off 16-byte alignment.

What the sources use of CUDA, on the host: a block's threads are
std::threads meeting at a std::barrier, its shared memory one buffer
(which a runner fills with NaNs, so that a read of an unstaged word
shows); the rounded intrinsics are plain f32 operations (built with
-ffp-contract=off), ``__ldg``, ``__ldcg``, ``__stcg`` and ``__stcs`` plain
loads and stores, the vector types aligned structs, the math functions
(``atan2f``, ``fabsf``, ...) the C library's.  ``__shfl_up_sync`` and
``__shfl_sync`` (any type of up to 16 bytes: float, double, float2) go
through a per-block exchange buffer between two waits at the block's
barrier, so every thread of the block must call them together, as the
sources that use them do; ``atomicAdd`` is a sequentially consistent
``__atomic`` builtin, ``__threadfence`` a sequentially consistent fence,
``__trap`` ``std::abort``, ``__nanosleep`` nothing, and
``cudaMemsetAsync`` a ``memset``, ``__fmaf_rn`` the C library's
``fmaf`` (correctly rounded).  :func:`persistent` stands in for
``persistent.cuh`` (a source's include of it replaced by a patch): its
copies synchronous, a small grid of resident blocks, so that each block
of a persistent kernel walks several tiles, and a launch with dynamic
shared memory.  Blocks run in turn, so a block takes
ticket b of an ``atomicAdd`` counter as the card's b-th block would: a
design whose blocks wait only on lower tickets runs here as there.
"""

import ctypes
import subprocess

import torch

from sdr_tpu_torch.kernels._build import CSRC

__all__ = ["SHIM", "LAUNCH_SHIM", "device_part", "build", "build_source",
           "offset", "persistent"]

SHIM = r"""
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <cmath>
#include <algorithm>
#include <atomic>
#include <barrier>
#include <thread>
#include <vector>
using std::min; using std::max;
struct uint3_ { unsigned x, y, z; };
inline thread_local uint3_ threadIdx, blockIdx;
#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __restrict__ __restrict
#define __align__(n) alignas(n)
struct alignas(16) float4 { float x, y, z, w; };
struct alignas(8) float2 { float x, y; };
struct alignas(8) uint2 { unsigned x, y; };
inline float4 make_float4(float a, float b, float c, float d) {
  return {a, b, c, d}; }
inline float2 make_float2(float a, float b) { return {a, b}; }
inline float __fmul_rn(float a, float b) { return a * b; }
inline float __fadd_rn(float a, float b) { return a + b; }
inline float __fsub_rn(float a, float b) { return a - b; }
inline float __fdiv_rn(float a, float b) { return a / b; }
inline float __fmaf_rn(float a, float b, float c) { return std::fmaf(a, b, c); }
template <class T> inline T __ldg(const T* p) { return *p; }
inline thread_local float* g_smem;
inline std::barrier<>* g_bar;
inline void __syncthreads() { g_bar->arrive_and_wait(); }
template <class T> inline T __ldcg(const T* p) { return *p; }
template <class T> inline void __stcg(T* p, T v) { *p = v; }
template <class T> inline void __stcs(T* p, T v) { *p = v; }
// a warp shuffle: every thread of the block calls it together
alignas(16) inline unsigned char g_xchg[1024 * 16];
template <class T> inline T shfl_from(T v, int src) {
  static_assert(sizeof(T) <= 16);
  std::memcpy(g_xchg + 16 * threadIdx.x, &v, sizeof(T));
  g_bar->arrive_and_wait();
  T out;
  std::memcpy(&out, g_xchg + 16 * src, sizeof(T));
  g_bar->arrive_and_wait();
  return out;
}
template <class T>
inline T __shfl_up_sync(unsigned, T v, int d, int width = 32) {
  const int t = static_cast<int>(threadIdx.x);
  return shfl_from(v, t % width >= d ? t - d : t);
}
template <class T>
inline T __shfl_sync(unsigned, T v, int src, int width = 32) {
  const int t = static_cast<int>(threadIdx.x);
  return shfl_from(v, t - t % width + src % width);
}
inline unsigned atomicAdd(unsigned* p, unsigned v) {
  return __atomic_fetch_add(p, v, __ATOMIC_SEQ_CST); }
inline int atomicAdd(int* p, int v) {
  return __atomic_fetch_add(p, v, __ATOMIC_SEQ_CST); }
inline void __threadfence() {
  std::atomic_thread_fence(std::memory_order_seq_cst); }
inline void __trap() { std::abort(); }
inline void __nanosleep(unsigned) {}
typedef int cudaError_t;
constexpr int cudaSuccess = 0;
constexpr int cudaDevAttrMaxSharedMemoryPerBlockOptin = 97;
inline int cudaGetDevice(int* d) { *d = 0; return 0; }
inline int cudaDeviceGetAttribute(int* v, int, int) {
  *v = 232448; return 0; }   // an H100's block
"""


LAUNCH_SHIM = r"""
#define __shared__ static
struct dim3 {
  unsigned x, y, z;
  dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};
inline thread_local uint3_ blockDim, gridDim;
typedef void* cudaStream_t;
constexpr int cudaErrorInvalidValue = 1;
inline int cudaGetLastError() { return 0; }
inline const char* cudaGetErrorString(int) { return "host shim"; }
inline int cudaSetDevice(int) { return 0; }
inline int cudaMemsetAsync(void* p, int v, size_t n, cudaStream_t) {
  std::memset(p, v, n);
  return 0;
}
inline float __fsqrt_rn(float a) { return std::sqrt(a); }
// Every block of `grid` in turn; a block's threads are std::threads that
// run its blocks together, meeting at a barrier after each (its static
// shared memory is reused by the next).
template <class... P, class... A>
void host_launch(void (*kern)(P...), dim3 grid, dim3 block, A... args) {
  std::barrier<> bar(block.x);
  g_bar = &bar;
  std::vector<std::thread> th;
  for (unsigned t = 0; t < block.x; ++t)
    th.emplace_back([=, &bar] {
      threadIdx = {t, 0, 0};
      blockDim = {block.x, 1, 1};
      gridDim = {grid.x, grid.y, 1};
      for (unsigned by = 0; by < grid.y; ++by)
        for (unsigned bx = 0; bx < grid.x; ++bx) {
          blockIdx = {bx, by, 0};
          kern(args...);
          bar.arrive_and_wait();
        }
    });
  for (auto& t : th) t.join();
}
#define KERNEL_LAUNCH(kernel, grid, block, stream, ...) \
  host_launch(kernel, dim3(grid), dim3(block), __VA_ARGS__)
"""


def device_part(name, cut):
    """The source's device code and plan, up to ``cut`` (its launch
    code), its CUDA header swapped for the shim."""
    src = (CSRC / f"{name}.cu").read_text()
    assert src.count("#include <cuda_runtime.h>") == 1
    assert src.count(cut) == 1
    src = src.replace("#include <cuda_runtime.h>", SHIM)
    src = src.replace("extern __shared__ __align__(16) float smem[];",
                      "float* const smem = g_smem;")
    return src[:src.index(cut)]


def build(directory, name, cut, runner):
    """``csrc/<name>.cu`` up to ``cut``, then ``runner``, compiled with
    ``g++`` into a library under ``directory`` and loaded."""
    cpp = directory / f"{name}.cpp"
    cpp.write_text(device_part(name, cut) + runner)
    so = directory / f"lib{name}.so"
    subprocess.run(["g++", "-std=c++20", "-O1", "-ffp-contract=off",
                    "-fPIC", "-shared", "-pthread", "-I", str(CSRC), "-o",
                    str(so), str(cpp)], check=True, capture_output=True)
    return ctypes.CDLL(str(so))


def build_source(directory, name, patches=(), tag=""):
    """The whole of ``csrc/<name>.cu`` under ``SHIM`` and ``LAUNCH_SHIM``,
    compiled with ``g++`` into a library under ``directory`` and loaded:
    its launch functions run on host pointers (the stream is ignored).
    ``patches`` replace snippets of the source, each found exactly once
    (``tag`` names the patched build)."""
    src = (CSRC / f"{name}.cu").read_text()
    assert src.count("#include <cuda_runtime.h>") == 1
    for old, new in patches:
        assert src.count(old) == 1, old
        src = src.replace(old, new)
    src = src.replace("#include <cuda_runtime.h>", SHIM + LAUNCH_SHIM)
    cpp = directory / f"{name}{tag}.cpp"
    cpp.write_text(src)
    so = directory / f"lib{name}{tag}.so"
    subprocess.run(["g++", "-std=c++20", "-O1", "-ffp-contract=off",
                    "-fPIC", "-shared", "-pthread", "-I", str(CSRC), "-o",
                    str(so), str(cpp)], check=True, capture_output=True)
    return ctypes.CDLL(str(so))


def persistent(blocks):
    """``persistent.cuh`` on the host, ``blocks`` resident blocks a launch
    (replace a source's ``#include "persistent.cuh"`` with it): the
    copies synchronous (a staged buffer is complete before the block's
    next barrier, as ``wait_prev`` makes it on the card), and
    ``KERNEL_LAUNCH_SMEM``, a launch with dynamic shared memory
    (``DYNAMIC_SMEM``), which it fills with NaNs before each block."""
    return r"""
#define DYNAMIC_SMEM(name) float* const name = g_smem
#define __noinline__
namespace persistent {
inline void cp_async16(void* s, const void* g) { std::memcpy(s, g, 16); }
inline void cp_async8(void* s, const void* g) { std::memcpy(s, g, 8); }
inline void cp_async4(void* s, const void* g) { std::memcpy(s, g, 4); }
inline void commit() {}
inline void wait_prev() {}
inline void tile_origin(long long it, long long per_row, int tile,
                        long long* row, long long* m0) {
  *row = it / per_row;
  *m0 = (it % per_row) * tile;
}
template <class K> int resident_blocks(K, int, long long, int* blocks) {
  *blocks = BLOCKS;
  return 0;
}
}  // namespace persistent
constexpr int cudaFuncAttributeMaxDynamicSharedMemorySize = 8;
template <class K> int cudaFuncSetAttribute(K, int, int) { return 0; }
template <class... P, class... A>
void host_launch_smem(void (*kern)(P...), dim3 grid, dim3 block,
                      long long smem, A... args) {
  const size_t nf = static_cast<size_t>(smem) / 4 + 4;
  float4* buf = new float4[nf / 4 + 1];
  float* base = reinterpret_cast<float*>(buf);
  std::barrier<> bar(block.x);
  g_bar = &bar;
  std::vector<std::thread> th;
  for (unsigned t = 0; t < block.x; ++t)
    th.emplace_back([=, &bar] {
      threadIdx = {t, 0, 0};
      blockDim = {block.x, 1, 1};
      gridDim = {grid.x, grid.y, 1};
      g_smem = base;
      for (unsigned by = 0; by < grid.y; ++by)
        for (unsigned bx = 0; bx < grid.x; ++bx) {
          if (t == 0) std::fill(base, base + nf, NAN);
          bar.arrive_and_wait();
          blockIdx = {bx, by, 0};
          kern(args...);
          bar.arrive_and_wait();
        }
    });
  for (auto& t : th) t.join();
  delete[] buf;
}
#define KERNEL_LAUNCH_SMEM(kernel, grid, block, smem, stream, ...) \
  host_launch_smem(kernel, dim3(grid), dim3(block), smem, __VA_ARGS__)
""".replace("BLOCKS", str(int(blocks)))


def offset(t, off):
    """A contiguous copy of ``t`` whose data starts ``off`` elements past
    a 16-byte boundary (a row base off the alignment a kernel's 16-byte
    loads want)."""
    buf = torch.empty(t.numel() + 16 // t.element_size() + off,
                      dtype=t.dtype)
    skip = (-buf.data_ptr() % 16) // t.element_size() + off
    out = buf[skip: skip + t.numel()].view(t.shape)
    out.copy_(t)
    return out
