// The polyphase resampler's tile, shared by K2 (resample.cu) and K5's
// first stage (backhalf.cu):
//
//   t_m = m*D - offset,  o_m = (-t_m) mod I,  i_m = (t_m + o_m) / I
//   y[m] = sum_k T[o_m, k] * v[start + i_m + k],   v = concat(hist, x)
//
// Index math once per tile.  A tile's first output m0 is a multiple of I
// (a tile is P whole periods of I outputs), so output m0 + u has the phase
// o_u of output u and reads from start + (m0 / I) * D + (u / I) * D + di_u,
// di_u = i_u for u < I.  The wrapper builds the period table (o_u, di_u),
// u < I, once per (I, D, offset) and keeps it on the card; a tile needs one
// 64-bit origin and 32-bit offsets from there.
//
// Staging through the two pointers: a tile's span of v is copied into
// shared memory by cp.async, 16 bytes where a chunk lies inside x (the
// span is staged at x's address mod 16, OFF = 0 to 3 floats, as K3 does),
// 4 bytes where it lies in hist or across the seam, and zeros (cp.async's
// src-size 0) past the end of the stream.
//
// Sums: thread t computes whole periods p = t, t + NT, ..., each from one
// window of the staged span loaded into registers.  The paths' geometry
// (I, D, Kp) = (3, 10, 11) is compiled with its loops unrolled, one
// instantiation per offset and window parity: 3 outputs from 9 or 10
// 8-byte loads (18 floats, 19 with the parity float).  Neighbouring threads'
// windows lie D = 10 floats apart: 8-byte loads at a 40-byte stride put a
// half-warp's 16 threads on 32 distinct banks, where 4-byte loads would
// meet 2-way and 16-byte ones 2-way conflicts.  Other geometries take a
// loop over the period table in shared memory.  Each output's sum runs in
// tap order, each product and sum one rounded operation (__fmul_rn,
// __fadd_rn: no FMA contraction), from +0, so an output equals the plain
// PyTorch version bitwise, whatever the tile.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

#include "persistent.cuh"

namespace resample_tile {

constexpr int NT = 256;

// floats of the staged span that the last output of a period reads past
// its first: di_{I-1} + Kp
__host__ __device__ constexpr int period_window(int I, int D, int offset,
                                                int Kp) {
  return ((I - 1) * D - offset + I - 1) / I + Kp;
}

// floats of a staging buffer for `periods` periods: the span, OFF's up to
// 3 floats, the parity float and the chunk rounding; a multiple of 4
__host__ __device__ constexpr long long buffer_floats(long long periods,
                                                      int D, int W) {
  return ((periods - 1) * D + W + 8 + 3) & ~3LL;
}

// row r of the stream: v = concat(hist[r], x[r]), zeros past its end
struct Rows {
  const float* x;
  const float* hist;
  long long n;
  int H;
};

// Issue the copies of v[a, a + len) of row `row` into xs, staged from
// xs[off] on, off being the span's offset from a 16-byte boundary of x;
// returns off.
__device__ __forceinline__ int stage(float* xs, const Rows& v, long long row,
                                     long long a, int len) {
  const float* xr = v.x + row * v.n;
  const float* hr = v.hist + row * v.H;
  // v[p] lies at xr + (p - H) for p >= H
  const long long at = static_cast<long long>(
      reinterpret_cast<uintptr_t>(xr)) + 4 * (a - v.H);
  const int off = static_cast<int>((at >> 2) & 3);
  const long long p0 = a - off;                      // v[p0] at xs[0]
  const long long end = v.H + v.n;
  const int chunks = (off + len + 3) / 4;
  for (int c = threadIdx.x; c < chunks; c += NT) {
    const long long p = p0 + 4 * c;
    float* s = xs + 4 * c;
    if (p >= v.H && p + 4 <= end) {
      persistent::cp_async16(s, xr + (p - v.H));
    } else {
      for (int i = 0; i < 4; ++i) {
        const long long q = p + i;
        if (q < 0) continue;                         // before v: never read
        if (q < v.H)
          persistent::cp_async4(s + i, hr + q);
        else if (q < end)
          persistent::cp_async4(s + i, xr + (q - v.H));
        else
          persistent::cp_async4_zero(s + i, xr);
      }
    }
  }
  return off;
}

// Issue the copies of tile it's span into xs; returns the staging offset.
// A tile is P periods (T = I * P outputs) of a row; the block needs its
// outputs and `tail` more past them (K5's FIR reaches Kf - 1 further).
__device__ __forceinline__ int stage_tile(float* xs, const Rows& v,
                                          long long it, long long per_row,
                                          int I, int D, int W, int P,
                                          int tail, long long start,
                                          long long num) {
  long long row, t;
  persistent::tile_origin(it, per_row, 1, &row, &t);
  const long long m0 = t * I * P;
  const int nb = static_cast<int>(
      min(static_cast<long long>(I) * P, num - m0));
  const int np = (nb + tail + I - 1) / I;
  return stage(xs, v, row, start + t * P * D, (np - 1) * D + W);
}

constexpr int kTooBig = -1;           // the launch functions' code for
                                      // tables and taps that do not fit

// (periods a tile, floats a staging buffer, shared-memory bytes) of a
// launch whose block holds `fixed` floats beside two staging buffers and
// needs `extra` periods past a tile; at most `most_periods` a tile.
// kTooBig (or a CUDA error) when one period does not fit the device's
// block.
inline int plan(int D, int W, long long fixed, long long extra,
                int most_periods, int* P, int* bf, int* smem) {
  int dev = 0, most = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&most, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  const long long avail = ((most / 4 - fixed) / 2) & ~3LL;  // a buffer
  if (avail - 8 - W - extra * D < 0) return kTooBig;
  const long long fit = (avail - 8 - W) / D - extra + 1;
  *P = static_cast<int>(std::min<long long>(most_periods, fit));
  *bf = static_cast<int>(buffer_floats(*P + extra, D, W));
  *smem = static_cast<int>(4 * (2LL * *bf + fixed));
  return 0;
}

// The compiled geometry at this offset: the input steps di_u, u < I, and
// the period's window W
template <int I, int D, int KP, int OFFSET>
struct Fixed {
  __host__ __device__ static constexpr int di(int u) {
    return (u * D - OFFSET + I - 1) / I;
  }
  static constexpr int W = period_window(I, D, OFFSET, KP);
};

// The periods p < np of a tile staged from xs[off] on (off's parity PAR):
// out(u, y) for the I outputs u = p*I .. p*I + I - 1 of each.  The table's
// rows go to registers once a tile, in the order of the period.
template <int I, int D, int KP, int OFFSET, int PAR, class Out>
__device__ __forceinline__ void periods_fixed(const float* xs, int off,
                                              int np, const float* s_table,
                                              const int* s_o, Out out) {
  using F = Fixed<I, D, KP, OFFSET>;
  constexpr int NF2 = (PAR + F::W + 1) / 2;          // 8-byte loads
  float c[I][KP];
#pragma unroll
  for (int u = 0; u < I; ++u)
#pragma unroll
    for (int k = 0; k < KP; ++k) c[u][k] = s_table[s_o[u] * KP + k];
  for (int p = threadIdx.x; p < np; p += NT) {
    const float2* w2 =
        reinterpret_cast<const float2*>(xs + off - PAR + p * D);
    float w[2 * NF2];
#pragma unroll
    for (int j = 0; j < NF2; ++j) {
      const float2 t = w2[j];
      w[2 * j] = t.x;
      w[2 * j + 1] = t.y;
    }
#pragma unroll
    for (int u = 0; u < I; ++u) {
      float acc = 0.f;
#pragma unroll
      for (int k = 0; k < KP; ++k)
        acc = __fadd_rn(acc, __fmul_rn(c[u][k], w[PAR + F::di(u) + k]));
      out(p * I + u, acc);
    }
  }
}

// Any geometry: the same periods, phases and steps from the period table
template <class Out>
__device__ __forceinline__ void periods_any(const float* xs, int off, int np,
                                            int I, int D, int Kp,
                                            const float* s_table,
                                            const int* s_o, const int* s_di,
                                            Out out) {
  for (int p = threadIdx.x; p < np; p += NT) {
    const float* w = xs + off + p * D;
    for (int u = 0; u < I; ++u) {
      const float* T = s_table + s_o[u] * Kp;
      const float* wu = w + s_di[u];
      float acc = 0.f;
      for (int k = 0; k < Kp; ++k)
        acc = __fadd_rn(acc, __fmul_rn(T[k], wu[k]));
      out(p * I + u, acc);
    }
  }
}

// the np periods of a staged tile, the paths' 3/10 with 11 taps a phase
// compiled, every other geometry through the loop
template <class Out>
__device__ __forceinline__ void tile_periods(const float* xs, int off, int np,
                                             int I, int D, int Kp,
                                             int offset,
                                             const float* s_table,
                                             const int* s_o, const int* s_di,
                                             Out out) {
  if (I == 3 && D == 10 && Kp == 11) {
    // D is even: every window of the tile has the parity of off
    switch (2 * offset + (off & 1)) {
      case 0: periods_fixed<3, 10, 11, 0, 0>(xs, off, np, s_table, s_o, out);
        return;
      case 1: periods_fixed<3, 10, 11, 0, 1>(xs, off, np, s_table, s_o, out);
        return;
      case 2: periods_fixed<3, 10, 11, 1, 0>(xs, off, np, s_table, s_o, out);
        return;
      case 3: periods_fixed<3, 10, 11, 1, 1>(xs, off, np, s_table, s_o, out);
        return;
      case 4: periods_fixed<3, 10, 11, 2, 0>(xs, off, np, s_table, s_o, out);
        return;
      default: periods_fixed<3, 10, 11, 2, 1>(xs, off, np, s_table, s_o, out);
        return;
    }
  }
  periods_any(xs, off, np, I, D, Kp, s_table, s_o, s_di, out);
}

// the phase table [I, Kp] and the period table [2, I] into shared memory
__device__ __forceinline__ void load_tables(float* s_table, int* s_period,
                                            const float* table,
                                            const int* period, int I,
                                            int Kp) {
  for (int k = threadIdx.x; k < I * Kp; k += NT) s_table[k] = table[k];
  for (int k = threadIdx.x; k < 2 * I; k += NT) s_period[k] = period[k];
}

}  // namespace resample_tile
