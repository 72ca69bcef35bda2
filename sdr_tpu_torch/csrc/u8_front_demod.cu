// K1: fused u8 IQ -> (x - 128) -> K-tap decimate-by-f (exact int32) ->
// FM demod (polynomial atan2 of x[m] * conj(x[m-1])).
//
// Replaces the TPU kernel sdr_tpu/kernels/u8_front_demod_pallas.py:
// u8_front_demod_pallas (pl.pallas_call at :112, body _demod_kernel :73).
//
// Bound on an H100: memory.  On the FM chain's block-parallel batch
// (32 rows of 10,485,760 u8 bytes, K = 51, f = 8) it reads 335.5 MB and
// writes 84 MB: about 0.125 ms at 3.35 TB/s.  The integer work, 2 * K
// multiply-adds per output and plane, is far below the card's rate.
//
// Design (the window staging and sums are K4's too: u8_window.cuh, whose
// note counts the shared-memory banks):
// * Tiles of ns - 1 consecutive outputs of one row (ns = 1024 samples for
//   f = 8; smaller tiles only where a window would not fit shared
//   memory), walked by persistent blocks.  A block stages a tile's window
//   once with 16-byte copies (the next tile's in flight meanwhile),
//   deinterleaves it into s8 I and Q planes, and sums each sample with
//   __dp4a, the tap words in registers: 26 dp4a a sample for 51 s8 taps
//   (52 for 16-bit taps).  The samples' (I, Q) then take the spent
//   staging buffer's place for the demod.
// * A row's stream is concat(hist, x): byte p < H comes from the row's
//   H-byte history, the rest from its block.  Reading through the two
//   pointers covers every output; no concatenated copy is ever made.
// * The TPU kernel passes the previous tile's last sample through VMEM
//   scratch, because its grid runs in order.  CUDA blocks run in no order,
//   so a tile's window starts one sample early: sample 0 is the
//   predecessor of the tile's first output, computed like every other
//   sample, round-robin over the threads; the first tile of a row takes
//   it from the carry last_iq instead.
// * Every output is an independent int32 dot product, one f32 epilogue
//   multiply and the atan2 polynomial, each step one rounded operation
//   (no FMA contraction), so a sample does not depend on the tile or grid
//   that computed it and equals the plain PyTorch version bitwise.  No
//   atomics.
// * The block that holds a row's last output writes its (I, Q) as the
//   row's next carry.
//
// What bounds it now: per output 26 dp4a (s8) and a few dozen epilogue
// instructions, about 0.03 ms of the card's integer issue rate for the
// path's 20.97 M outputs, under the 0.125 ms of its bytes.  Measured on an
// H100 SXM at 700 W it takes 0.24 ms: the copies, four barriers a tile
// and the atan2 (its division and polynomial), which
// sdr_tpu_torch/kernel_variants.py separates.

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

#include "fm_demod.cuh"
#include "u8_window.cuh"

namespace {

using u8w::NT;
using fmd::poly_atan2;   // fm_demod.cuh, shared with K11

template <int NW, bool S16>
__global__ void __launch_bounds__(NT)
u8_front_demod_kernel(const uint8_t* __restrict__ x,
                      const uint8_t* __restrict__ hist,
                      const float* __restrict__ last_iq,
                      const int32_t* __restrict__ tw,
                      float* __restrict__ y, float* __restrict__ iq_out,
                      long long rows, long long n, int H, int K, int f,
                      int nw, long long num, long long ns, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  const u8w::Layout lay(ns, f, K, nw, sizeof(float2));
  const u8w::Planes win{
      reinterpret_cast<unsigned*>(smem + 2 * lay.raw),
      reinterpret_cast<unsigned*>(smem + 2 * lay.raw + lay.plane)};
  const u8w::Taps<NW, S16> tp(tw, nw);
  const bool f8 = (f & 7) == 0;
  // tile i: outputs m0 .. m0 + nsb - 2 of row i / per_row, from samples
  // m0 - 1 .. m0 + nsb - 2 (the first is the predecessor of output m0)
  const long long per_row = (num + ns - 2) / (ns - 1);
  const long long tiles = rows * per_row;
  auto stage = [&](long long i, unsigned char* raw) {
    const long long row = i / per_row, m0 = (i % per_row) * (ns - 1);
    const long long pb = 2LL * (m0 - 1) * f;
    return u8w::stage_raw(
        raw, hist + row * H, x + row * n, H, pb,
        pb + 2 * u8w::plane_len(min(ns, num - m0 + 1), f, K), x,
        x + rows * n);
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
    const long long row = i / per_row, m0 = (i % per_row) * (ns - 1);
    const long long nsb = min(ns, num - m0 + 1);
    unsigned char* raw = smem + b * lay.raw;
    u8w::deinterleave(raw, off, u8w::plane_len(nsb, f, K), win.pI, win.pQ);
    __syncthreads();
    // the staged bytes are spent: buffer b holds the samples' (I, Q) now
    float2* s_iq = reinterpret_cast<float2*>(raw);
    for (int u = threadIdx.x; u < nsb; u += NT)
      s_iq[u] = u == 0 && m0 == 0
          ? make_float2(last_iq[2 * row], last_iq[2 * row + 1])
          : u8w::scaled(u8w::window_sums(win, static_cast<long long>(u) * f,
                                         f8, tp),
                        scale);
    __syncthreads();
    for (int u = threadIdx.x + 1; u < nsb; u += NT) {
      const float2 c = s_iq[u], p = s_iq[u - 1];
      const float bq = __fsub_rn(__fmul_rn(c.y, p.x), __fmul_rn(c.x, p.y));
      const float a = __fadd_rn(__fmul_rn(c.x, p.x), __fmul_rn(c.y, p.y));
      const long long m = m0 + u - 1;
      y[row * num + m] = poly_atan2(bq, a);
      if (m == num - 1) {
        iq_out[2 * row] = c.x;
        iq_out[2 * row + 1] = c.y;
      }
    }
    off = off_next;
    __syncthreads();                  // planes and buffer b are reused
  }
}

template <int NW, bool S16>
struct Launch {
  int operator()(const void* x, const void* hist, const void* last_iq,
                 const void* tw, void* y, void* iq_out, long long rows,
                 long long n, int H, int K, int f, int nw, long long num,
                 float scale, cudaStream_t stream) const {
    const long long ns = u8w::tile_samples(f, K, nw, sizeof(float2));
    if (ns == 0) return static_cast<int>(cudaErrorInvalidValue);
    const long long smem = u8w::Layout(ns, f, K, nw, sizeof(float2)).total();
    int blocks = 0;
    const int e = persistent::resident_blocks(u8_front_demod_kernel<NW, S16>,
                                              NT, smem, &blocks);
    if (e != 0) return e;
    const long long tiles = rows * ((num + ns - 2) / (ns - 1));
    u8_front_demod_kernel<NW, S16><<<
        static_cast<unsigned>(std::min(tiles, static_cast<long long>(blocks))),
        NT, smem, stream>>>(
        static_cast<const uint8_t*>(x), static_cast<const uint8_t*>(hist),
        static_cast<const float*>(last_iq), static_cast<const int32_t*>(tw),
        static_cast<float*>(y), static_cast<float*>(iq_out), rows, n, H, K,
        f, nw, num, ns, scale);
    return static_cast<int>(cudaGetLastError());
  }
};

}  // namespace

// x [rows, n] u8, hist [rows, H] u8, last_iq [rows, 2] f32, tw the packed
// tap words ([nw] s8, [2, nw] for 16-bit taps: kernels/u8_front.py:
// pack_taps) -> y [rows, num] f32, iq_out [rows, 2] f32.  The caller
// checks that every window lies inside concat(hist, x).
extern "C" int launch_u8_front_demod(const void* x, const void* hist,
                                     const void* last_iq, const void* tw,
                                     void* y, void* iq_out, long long rows,
                                     long long n, int H, int K, int f,
                                     int nw, int s16, long long num,
                                     float scale, void* stream) {
  return u8w::dispatch<Launch>(nw, s16 != 0, x, hist, last_iq, tw, y,
                               iq_out, rows, n, H, K, f, nw, num, scale,
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
