// K2: polyphase rational resampler over concat(hist, x), f32.
//
//   t_m = m*D - offset,  o_m = (-t_m) mod I,  i_m = (t_m + o_m) / I
//   y[m] = sum_k T[o_m, k] * v[start + i_m + k],   v = concat(hist, x)
//
// Replaces the TPU kernel sdr_tpu/kernels/resample_pallas.py:resample_band
// (pl.pallas_call at :156, body _kernel :109).
//
// Bound on an H100: memory.  At the FM chain's 3/10 stage (31 taps, 11 per
// phase) on the block-parallel batch it reads 84 MB and writes 25 MB of
// f32 (32 rows; twice that over the stereo chain's [32, 2] planes): about
// 0.033 ms at 3.35 TB/s.  The kept order (below) costs 2 * 11 separate f32
// instructions an output, 6.29 M x 22 = 1.4e8 at 3.3e13 a second (132 SMs
// x 128 lanes x 1.98 GHz), 0.004 ms: far under the bytes.
//
// Design: the TPU form is a lane-aligned banded matmul for the MXU, which
// applies only to some geometries (resample_band returns None otherwise)
// and sends ragged tails to a gather path.  Here every (K, I, D, offset,
// start, num) is covered by one kernel:
// * Tiles of P whole periods of I outputs (P = 1024 at 3/10: 3072 outputs,
//   a span of 10,248 floats), staged by resample_tile.cuh: 16-byte
//   cp.async where the span lies in x, 4-byte copies in hist and at the
//   seam, zeros past the end of the stream (as the JAX gather path pads).
//   A row's stream is read through two pointers, so no concatenated copy
//   is made.  One 64-bit origin a tile, 32-bit offsets from the period
//   table inside it.
// * Persistent, double-buffered: as many blocks as fit on the card at
//   once walk the tiles; each issues the copies of its next tile before it
//   computes the current one.
// * Register tiling: a thread computes whole periods, the paths' 3/10 with
//   11 taps a phase from an 18-float window it loads once with
//   conflict-free 8-byte reads (resample_tile.cuh).
// * Each output's sum runs in tap order, each product and sum one rounded
//   operation (no FMA contraction), so an output does not depend on the
//   tile or grid and equals the plain PyTorch version bitwise.  No atomics.
//
// Shared memory (resample_tile.cuh:plan): two staging buffers of
// buffer_floats(P) floats, the phase table (I * Kp floats) and the period
// table (2 I ints).  P is 3072 / I periods (at least 1), fewer where that
// does not fit the device's block; a table and one period that do not
// fit return kTooBig.

#include <cuda_runtime.h>

#include <algorithm>

#include "persistent.cuh"
#include "resample_tile.cuh"

namespace {

using namespace resample_tile;

// at most 128 registers: 2 blocks an SM, as the shared memory allows
__global__ void __launch_bounds__(NT, 2)
resample_kernel(const float* __restrict__ x, const float* __restrict__ hist,
                const float* __restrict__ table,
                const int* __restrict__ period, float* __restrict__ y,
                long long rows, long long n, int H, int I, int D, int Kp,
                int offset, int W, long long start, long long num, int P,
                int bf) {
  extern __shared__ __align__(16) float smem[];
  float* const buf0 = smem;                          // two staging buffers
  float* const s_table = smem + 2 * bf;
  int* const s_o = reinterpret_cast<int*>(s_table + I * Kp);
  const int* const s_di = s_o + I;
  load_tables(s_table, s_o, table, period, I, Kp);
  const Rows v{x, hist, n, H};
  const int T = I * P;
  const long long per_row = (num + T - 1) / T;
  const long long tiles = rows * per_row;

  long long it = blockIdx.x;
  if (it >= tiles) return;
  int off = stage_tile(buf0, v, it, per_row, I, D, W, P, 0, start, num);
  persistent::commit();
  for (int b = 0; it < tiles; it += gridDim.x, b ^= 1) {
    // the next tile's copies fly while this one is computed
    const long long next = it + gridDim.x;
    int off_next = 0;
    if (next < tiles)
      off_next = stage_tile(buf0 + (b ^ 1) * bf, v, next, per_row, I, D, W,
                            P, 0, start, num);
    persistent::commit();
    persistent::wait_prev();
    __syncthreads();

    long long row, t;
    persistent::tile_origin(it, per_row, 1, &row, &t);
    const long long m0 = t * T;
    const int nb = static_cast<int>(min(static_cast<long long>(T),
                                        num - m0));
    float* const yr = y + row * num + m0;
    tile_periods(buf0 + b * bf, off, (nb + I - 1) / I, I, D, Kp, offset,
                 s_table, s_o, s_di, [&](int u, float acc) {
                   if (u < nb) yr[u] = acc;
                 });
    off = off_next;
    __syncthreads();                  // buffer b is refilled next
  }
}

}  // namespace

// x [rows, n] f32, hist [rows, H] f32, table [I, Kp] f32, period [2, I]
// int32 (o_u, di_u) -> y [rows, num]
extern "C" int launch_resample(const void* x, const void* hist,
                               const void* table, const void* period, void* y,
                               long long rows, long long n, int H, int I,
                               int D, int Kp, int offset, long long start,
                               long long num, void* stream) {
  const int W = period_window(I, D, offset, Kp);
  int P = 0, bf = 0, smem = 0;
  const int p = plan(D, W, static_cast<long long>(I) * Kp + 2LL * I, 0,
                     std::max(1, 3072 / I), &P, &bf, &smem);
  if (p != 0) return p;
  int blocks = 0;
  const int e = persistent::resident_blocks(resample_kernel, NT, smem,
                                            &blocks);
  if (e != 0) return e;
  const long long T = static_cast<long long>(I) * P;
  const long long tiles = rows * ((num + T - 1) / T);
  const unsigned grid = static_cast<unsigned>(
      std::min(tiles, static_cast<long long>(blocks)));
  resample_kernel<<<grid, NT, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(hist),
      static_cast<const float*>(table), static_cast<const int*>(period),
      static_cast<float*>(y), rows, n, H, I, D, Kp, offset, W, start, num, P,
      bf);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* kernel_error_string(int e) {
  if (e == kTooBig)
    return "the phase table and one period of input do not fit a block's "
           "shared memory (at most 19,364 taps a phase at 1/1 on an H100)";
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}

// This library links its own CUDA runtime, whose current device is not
// PyTorch's: the wrapper selects the tensors' device before each launch.
extern "C" int kernel_set_device(int device) {
  return static_cast<int>(cudaSetDevice(device));
}
