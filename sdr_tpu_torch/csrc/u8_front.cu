// K4: u8 IQ -> (x - 128) -> K-tap decimate-by-f (exact int32) -> planar
// f32 I and Q:
//
//   y[c, m] = scale * sum_k Tq[k] * (v[start + 2(m*f + k) + c] - 128)
//
// over a row's stream v = concat(hist, x), c = 0 (I) and 1 (Q).
//
// Replaces the TPU kernel sdr_tpu/kernels/u8_front_pallas.py:
// u8_front_pallas (pl.pallas_call at :166, body _kernel :141, sums in
// band_acc :125).
//
// Bound on an H100: memory.  On the stereo chain's block-parallel batch
// (32 rows of 10,485,760 u8 bytes, K = 51, f = 8) it reads 335.5 MB and
// writes 167.8 MB: about 0.150 ms at 3.35 TB/s.  The integer work, 2 * K
// multiply-adds per output and plane, is far below the card's rate.
//
// Design: K1's without the demod; the window staging and the dp4a sums
// are the same code (u8_window.cuh, whose note counts the banks).
// * The TPU kernel forms the windows as a banded int8 matmul for the MXU
//   (two bands for 16-bit taps) over a reshaped input.  Here a tile is ns
//   consecutive outputs of one row (1024 for f = 8); persistent blocks
//   stage each tile's byte window in shared memory once, as s8 I and Q
//   planes, the next tile's copies in flight meanwhile, and the threads
//   sum their outputs' windows there, four taps per __dp4a.  16-bit taps
//   are a signed high and an unsigned low byte per tap, two dp4a per tap
//   word.
// * The stream is read through two pointers (history, block), and any
//   byte offset `start` moves the windows, so neither a seam split nor a
//   concatenated or sliced copy of the block is ever made; an odd offset
//   only changes which staged bytes the deinterleave calls I.
// * Every output is an independent int32 dot product and one rounded f32
//   multiply, so it equals the plain PyTorch version bitwise whatever the
//   grid.  No atomics.

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

#include "u8_window.cuh"

namespace {

using u8w::NT;

template <int NW, bool S16>
__global__ void __launch_bounds__(NT)
u8_front_kernel(const uint8_t* __restrict__ x,
                const uint8_t* __restrict__ hist,
                const int32_t* __restrict__ tw, float* __restrict__ y,
                long long rows, long long n, int H, int K, int f, int nw,
                long long start, long long num, long long ns, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  const u8w::Layout lay(ns, f, K, nw, 0);
  const u8w::Planes win{reinterpret_cast<unsigned*>(smem + 2 * lay.raw),
                        reinterpret_cast<unsigned*>(smem + 2 * lay.raw +
                                                    lay.plane)};
  const u8w::Taps<NW, S16> tp(tw, nw);
  const bool f8 = (f & 7) == 0;
  const long long per_row = (num + ns - 1) / ns;
  const long long tiles = rows * per_row;
  // tile i: outputs m0 .. m0 + nsb - 1 of row i / per_row
  auto stage = [&](long long i, unsigned char* raw) {
    const long long row = i / per_row, m0 = (i % per_row) * ns;
    const long long pb = start + 2LL * m0 * f;
    return u8w::stage_raw(
        raw, hist + row * H, x + row * n, H, pb,
        pb + 2 * u8w::plane_len(min(ns, num - m0), f, K), x, x + rows * n);
  };

  long long i = blockIdx.x;
  if (i >= tiles) return;
  int off = stage(i, smem);
  u8w::commit();
  for (int b = 0; i < tiles; i += gridDim.x, b ^= 1) {
    // the next tile's copies fly while this one is computed
    int off_next = 0;
    if (i + gridDim.x < tiles)
      off_next = stage(i + gridDim.x, smem + (b ^ 1) * lay.raw);
    u8w::commit();
    u8w::wait_prev();
    __syncthreads();
    const long long row = i / per_row, m0 = (i % per_row) * ns;
    const long long nsb = min(ns, num - m0);
    u8w::deinterleave(smem + b * lay.raw, off, u8w::plane_len(nsb, f, K),
                      win.pI, win.pQ);
    __syncthreads();
    float* yi = y + 2 * row * num + m0;
    float* yq = yi + num;
    for (int u = threadIdx.x; u < nsb; u += NT) {
      const float2 s = u8w::scaled(
          u8w::window_sums(win, static_cast<long long>(u) * f, f8, tp),
          scale);
      yi[u] = s.x;
      yq[u] = s.y;
    }
    off = off_next;
    __syncthreads();                  // planes and buffer b are reused
  }
}

template <int NW, bool S16>
struct Launch {
  int operator()(const void* x, const void* hist, const void* tw, void* y,
                 long long rows, long long n, int H, int K, int f, int nw,
                 long long start, long long num, float scale,
                 cudaStream_t stream) const {
    const long long ns = u8w::tile_samples(f, K, nw, 0);
    if (ns == 0) return static_cast<int>(cudaErrorInvalidValue);
    const long long smem = u8w::Layout(ns, f, K, nw, 0).total();
    int blocks = 0;
    const int e = persistent::resident_blocks(u8_front_kernel<NW, S16>,
                                              NT, smem, &blocks);
    if (e != 0) return e;
    const long long tiles = rows * ((num + ns - 1) / ns);
    u8_front_kernel<NW, S16><<<static_cast<unsigned>(std::min(
                                   tiles, static_cast<long long>(blocks))),
                               NT, smem, stream>>>(
        static_cast<const uint8_t*>(x), static_cast<const uint8_t*>(hist),
        static_cast<const int32_t*>(tw), static_cast<float*>(y), rows, n, H,
        K, f, nw, start, num, ns, scale);
    return static_cast<int>(cudaGetLastError());
  }
};

}  // namespace

// x [rows, n] u8, hist [rows, H] u8, tw the packed tap words ([nw] s8,
// [2, nw] for 16-bit taps: kernels/u8_front.py:pack_taps) -> y [rows, 2,
// num] f32.  The caller checks that every window lies inside
// concat(hist, x).
extern "C" int launch_u8_front(const void* x, const void* hist,
                               const void* tw, void* y, long long rows,
                               long long n, int H, int K, int f, int nw,
                               int s16, long long start, long long num,
                               float scale, void* stream) {
  return u8w::dispatch<Launch>(nw, s16 != 0, x, hist, tw, y, rows, n, H, K,
                               f, nw, start, num, scale,
                               static_cast<cudaStream_t>(stream));
}

extern "C" const char* kernel_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}

// This library links its own CUDA runtime, whose current device is not
// PyTorch's: the wrapper selects the tensors' device before each launch.
extern "C" int kernel_set_device(int device) {
  return static_cast<int>(cudaSetDevice(device));
}
