// K5: fused polyphase rational resample -> FIR, f32, with the gain folded
// into the FIR taps by the caller:
//
//   t_g = g*D - offset,  o_g = (-t_g) mod I,  i_g = (t_g + o_g) / I
//   yr[g] = sum_k T[o_g, k] * v[start + i_g + k],   v = concat(hist, x)
//   y[m]  = sum_j taps[j] * yr[m + j]
//
// Replaces the TPU kernel sdr_tpu/kernels/backhalf_pallas.py:
// resample_fir_gain (pl.pallas_call at :213, body _kernel :128).
//
// Bound on an H100: memory.  On the stereo chain's block-parallel batch
// (32 rows x 2 channels of 655,360 + H f32 samples, 3/10 with 31 taps,
// 64-tap FIR) it reads 167.8 MB and writes 50.3 MB: about 0.065 ms at
// 3.35 TB/s.  The kept order (below) costs 2 * (64 + 11) separate f32
// instructions an output: 12.58 M outputs x 150 = 1.9e9 at 3.3e13 a second
// (132 SMs x 128 lanes x 1.98 GHz), 0.057 ms, just under the bytes.
//
// Design: the TPU kernel is two chained banded matmuls per row tile, its
// first stage extended past the tile so the grid needs no carry.  Here K2's
// first stage feeds K3's second, in one persistent, double-buffered block:
// * Tiles of T = I * P outputs, P = 3072 / I periods (1024 at 3/10: 3072
//   outputs, K3's tile).  A tile's input span is staged by K2's code
//   (resample_tile.cuh): 16-byte cp.async in x, 4-byte copies in hist and
//   at the seam, zeros past the end of the stream; each block issues its
//   next tile's copies before it computes the current one.
// * Stage 1 computes the tile's T + Kf - 1 resampled values (the last
//   Kf - 1 shared with the next tile: 2 % extra at T = 3072) into the
//   block's own shared buffer yr, aligned, so the intermediate never
//   reaches device memory.
// * Stage 2 runs K3's register-tiled sums (fir_tile.cuh) over yr: twelve
//   outputs a thread, one broadcast float4 of taps and one float4 of yr a
//   4-tap step; 64 taps compiled unrolled, other counts in a loop.
// Every (I <= 3072, D, offset, start, num) is covered.  Both sums run in
// tap order, each product and sum one rounded operation (no FMA
// contraction), exactly as K2 then K3 compute them, so the output equals
// the unfused pair and the plain PyTorch version bitwise, whatever the
// tile.  No atomics.
//
// Shared memory (resample_tile.cuh:plan): two staging buffers of
// buffer_floats(P + ceil((Kf - 1) / I)) floats, yr
// (fir_tile::buf_floats(Kf)), the taps padded to a multiple of 4, the
// phase table and the period table.  A launch that does not fit the
// device's block returns kTooBig, I > 3072 kBadRate.

#include <cuda_runtime.h>

#include <algorithm>

#include "fir_tile.cuh"
#include "persistent.cuh"
#include "resample_tile.cuh"

namespace {

using resample_tile::NT;
using resample_tile::Rows;

static_assert(NT == fir_tile::NT, "one block runs both stages");

constexpr int kBadRate = -2;          // launch_backhalf's code for I > 3072

// at most 128 registers: 2 blocks an SM, as the shared memory allows
__global__ void __launch_bounds__(NT, 2)
backhalf_kernel(const float* __restrict__ x, const float* __restrict__ hist,
                const float* __restrict__ table,
                const int* __restrict__ period,
                const float* __restrict__ taps, float* __restrict__ y,
                long long rows, long long n, int H, int I, int D, int Kp,
                int Kf, int offset, int W, long long start, long long num,
                int P, int bf) {
  extern __shared__ __align__(16) float smem[];
  const int kp = (Kf + 3) & ~3;
  float* const buf0 = smem;                          // two staging buffers
  float* const s_yr = smem + 2 * bf;                 // stage 1's values
  float* const s_taps = s_yr + fir_tile::buf_floats(Kf);
  float* const s_table = s_taps + kp;
  int* const s_o = reinterpret_cast<int*>(s_table + I * Kp);
  const int* const s_di = s_o + I;
  resample_tile::load_tables(s_table, s_o, table, period, I, Kp);
  for (int k = threadIdx.x; k < Kf; k += NT) s_taps[k] = taps[k];
  const Rows v{x, hist, n, H};
  const int T = I * P;
  const long long per_row = (num + T - 1) / T;
  const long long tiles = rows * per_row;

  long long it = blockIdx.x;
  if (it >= tiles) return;
  int off = resample_tile::stage_tile(buf0, v, it, per_row, I, D, W, P,
                                      Kf - 1, start, num);
  persistent::commit();
  for (int b = 0; it < tiles; it += gridDim.x, b ^= 1) {
    // the next tile's copies fly while this one is computed; buffer b ^ 1
    // was last read before the barrier between the stages
    const long long next = it + gridDim.x;
    int off_next = 0;
    if (next < tiles)
      off_next = resample_tile::stage_tile(buf0 + (b ^ 1) * bf, v, next,
                                           per_row, I, D, W, P, Kf - 1, start,
                                           num);
    persistent::commit();
    persistent::wait_prev();
    __syncthreads();                  // and yr's last reads are done

    long long row, t;
    persistent::tile_origin(it, per_row, 1, &row, &t);
    const long long m0 = t * T;
    const int nb = static_cast<int>(min(static_cast<long long>(T),
                                        num - m0));
    const int ng = nb + Kf - 1;
    resample_tile::tile_periods(buf0 + b * bf, off, (ng + I - 1) / I, I, D,
                                Kp, offset, s_table, s_o, s_di,
                                [&](int u, float acc) {
                                  if (u < ng) s_yr[u] = acc;
                                });
    __syncthreads();

    if (fir_tile::R * static_cast<int>(threadIdx.x) < nb) {
      float acc[fir_tile::G][fir_tile::R] = {};
      if (Kf == 64)
        fir_tile::tile_sums<0, 64>(acc, s_yr, s_taps, Kf);
      else
        fir_tile::tile_sums<0, 0>(acc, s_yr, s_taps, Kf);
      fir_tile::store_sums(acc, y + row * num + m0, nb);
    }
    off = off_next;
  }
}

}  // namespace

// x [rows, n] f32, hist [rows, H] f32, table [I, Kp] f32, period [2, I]
// int32 (o_u, di_u), taps [Kf] f32 -> y [rows, num] f32
extern "C" int launch_backhalf(const void* x, const void* hist,
                               const void* table, const void* period,
                               const void* taps, void* y, long long rows,
                               long long n, int H, int I, int D, int Kp,
                               int Kf, int offset, long long start,
                               long long num, void* stream) {
  const int W = resample_tile::period_window(I, D, offset, Kp);
  if (I > fir_tile::TILE) return kBadRate;
  // beside the staging buffers: yr, the taps and the two tables
  const long long fixed = fir_tile::buf_floats(Kf) + ((Kf + 3) & ~3) +
                          static_cast<long long>(I) * Kp + 2LL * I;
  int P = 0, bf = 0, smem = 0;
  const int p = resample_tile::plan(D, W, fixed, (Kf - 1 + I - 1) / I,
                                    fir_tile::TILE / I, &P, &bf, &smem);
  if (p != 0) return p;
  int blocks = 0;
  const int e = persistent::resident_blocks(backhalf_kernel, NT, smem,
                                            &blocks);
  if (e != 0) return e;
  const long long T = static_cast<long long>(I) * P;
  const long long tiles = rows * ((num + T - 1) / T);
  const unsigned grid = static_cast<unsigned>(
      std::min(tiles, static_cast<long long>(blocks)));
  backhalf_kernel<<<grid, NT, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(hist),
      static_cast<const float*>(table), static_cast<const int*>(period),
      static_cast<const float*>(taps), static_cast<float*>(y), rows, n, H, I,
      D, Kp, Kf, offset, W, start, num, P, bf);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* kernel_error_string(int e) {
  if (e == resample_tile::kTooBig)
    return "the phase table, the FIR taps and one tile do not fit a "
           "block's shared memory";
  if (e == kBadRate)
    return "interpolation above 3072 (a tile holds whole periods)";
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}

// This library links its own CUDA runtime, whose current device is not
// PyTorch's: the wrapper selects the tensors' device before each launch.
extern "C" int kernel_set_device(int device) {
  return static_cast<int>(cudaSetDevice(device));
}
