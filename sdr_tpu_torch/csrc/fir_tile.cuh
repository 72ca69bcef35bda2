// K3's register-tiled sums over a staged tile, shared by K3 (fir.cu, the
// strided FIR at f == 1) and K5's second stage (backhalf.cu, the FIR over
// the resampled values a block keeps in shared memory).
//
// A tile is TILE = G * R * NT consecutive outputs.  Thread t computes G
// groups of R = 4 consecutive outputs, 4(t + g NT) .. 4(t + g NT) + 3.  Per
// 4 taps it reads one float4 of taps (the same address for every thread: a
// broadcast) and one new float4 of input per group, and keeps a ring of
// three input float4s per group in registers, so each of the 48 products
// of a step costs 4/48 shared-memory reads instead of 2, and twelve
// independent sums hide the add latency.  Neighbouring threads read
// neighbouring 16-byte words: a quarter-warp's 8 threads cover 128
// contiguous bytes, one pass, no bank conflict.  Each output's sum runs in
// tap order, each product and sum one rounded operation (__fmul_rn,
// __fadd_rn: no FMA contraction), from +0, so an output does not depend on
// the tile and equals the plain PyTorch version bitwise.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace fir_tile {

constexpr int NT = 256;
constexpr int R = 4;                  // consecutive outputs per group
constexpr int G = 3;                  // groups per thread, NT * R apart
constexpr int TILE = G * R * NT;      // outputs of a tile

// floats of a tile's input buffer for K taps: alignment slack, the span of
// TILE + K - 1, and the ring's read past it
__host__ __device__ constexpr int buf_floats(int K) {
  return TILE + ((K + 3) & ~3) + 8;
}

// one 4-tap step of the 4 outputs: taps tp (the first nj of them) over the
// 12 staged inputs a, b, c, of which output r, tap jj reads OFF + jj + r
template <int OFF>
__device__ __forceinline__ void step(float (&acc)[R], float4 tp, float4 a,
                                     float4 b, float4 c, int nj) {
  const float w[12] = {a.x, a.y, a.z, a.w, b.x, b.y,
                       b.z, b.w, c.x, c.y, c.z, c.w};
  const float tj[4] = {tp.x, tp.y, tp.z, tp.w};
#pragma unroll
  for (int jj = 0; jj < 4; ++jj)
    if (jj < nj) {
#pragma unroll
      for (int r = 0; r < R; ++r)
        acc[r] = __fadd_rn(acc[r], __fmul_rn(tj[jj], w[OFF + jj + r]));
    }
}

// outputs 4(t + g NT) .. 4(t + g NT) + 3 of the tile, g < G, the span
// staged from xs[OFF] on; KC > 0 fixes the tap count at compile time
template <int OFF, int KC>
__device__ __forceinline__ void tile_sums(float (&acc)[G][R],
                                          const float* xs,
                                          const float* s_taps, int K_rt) {
  const int K = KC > 0 ? KC : K_rt;
  const float4* x4 = reinterpret_cast<const float4*>(xs) + threadIdx.x;
  const float4* t4 = reinterpret_cast<const float4*>(s_taps);
  const int full = K / 4;
  float4 c0[G], c1[G], c2[G];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    c0[g] = x4[g * NT];
    c1[g] = x4[g * NT + 1];
  }
  int s = 0;
  // a ring of three chunks, so the unrolled group moves no registers
#pragma unroll
  for (; s + 3 <= full; s += 3) {
    const float4 ta = t4[s], tb = t4[s + 1], tc = t4[s + 2];
#pragma unroll
    for (int g = 0; g < G; ++g) {
      c2[g] = x4[g * NT + s + 2];
      step<OFF>(acc[g], ta, c0[g], c1[g], c2[g], 4);
      c0[g] = x4[g * NT + s + 3];
      step<OFF>(acc[g], tb, c1[g], c2[g], c0[g], 4);
      c1[g] = x4[g * NT + s + 4];
      step<OFF>(acc[g], tc, c2[g], c0[g], c1[g], 4);
    }
  }
#pragma unroll
  for (; s < full; ++s) {
    const float4 ta = t4[s];
#pragma unroll
    for (int g = 0; g < G; ++g) {
      c2[g] = x4[g * NT + s + 2];
      step<OFF>(acc[g], ta, c0[g], c1[g], c2[g], 4);
      c0[g] = c1[g];
      c1[g] = c2[g];
    }
  }
  if (K % 4) {
#pragma unroll
    for (int g = 0; g < G; ++g)
      step<OFF>(acc[g], t4[s], c0[g], c1[g], x4[g * NT + s + 2], K % 4);
  }
}

// the tile's sums for the staging offset off: the paths' tap counts (64,
// 65) compiled with their loops unrolled, others with a loop
template <int KC>
__device__ __forceinline__ void sums_at(float (&acc)[G][R], const float* xs,
                                        const float* s_taps, int K,
                                        int off) {
  switch (off) {
    case 0: tile_sums<0, KC>(acc, xs, s_taps, K); break;
    case 1: tile_sums<1, KC>(acc, xs, s_taps, K); break;
    case 2: tile_sums<2, KC>(acc, xs, s_taps, K); break;
    default: tile_sums<3, KC>(acc, xs, s_taps, K); break;
  }
}

// the first nb outputs of the thread's groups to yr (the tile's first
// output): a float4 where four are due and yr is 16-byte aligned there
__device__ __forceinline__ void store_sums(const float (&acc)[G][R],
                                           float* yr, int nb) {
#pragma unroll
  for (int g = 0; g < G; ++g) {
    const int u0 = R * (threadIdx.x + g * NT);
    float* y = yr + u0;
    if (u0 + R <= nb && (reinterpret_cast<uintptr_t>(y) & 15) == 0) {
      *reinterpret_cast<float4*>(y) =
          make_float4(acc[g][0], acc[g][1], acc[g][2], acc[g][3]);
    } else {
#pragma unroll
      for (int r = 0; r < R; ++r)
        if (u0 + r < nb) y[r] = acc[g][r];
    }
  }
}

}  // namespace fir_tile
