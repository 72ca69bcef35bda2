// The u8 IQ front end's window loading and exact integer sums, shared by
// K1 (u8_front_demod.cu) and K4 (u8_front.cu).
//
// A row's stream is concat(hist, x): byte p < H comes from the row's
// H-byte history, the rest from its block.  Output m of a tile reads the
// K (I, Q) byte pairs from byte w_m on; a CUDA block copies the bytes of
// its tile's windows into shared memory once and every thread then reads
// its own window there, I and Q as one 16-bit word (low byte I).
//
// The sums are int32 and exact: sum_k Tq[k] * (byte - 128) for each
// plane, then one rounded f32 multiply by the plan's scale, so a sample
// does not depend on the tile or grid that computed it.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace u8w {

__host__ __device__ constexpr long long align16(long long v) {
  return (v + 15) / 16 * 16;
}

// bytes [pb, pe) of the row's stream concat(hist, x) -> s_win[0, pe - pb)
__device__ __forceinline__ void load_window(unsigned char* s_win,
                                            const uint8_t* __restrict__ hr,
                                            const uint8_t* __restrict__ xr,
                                            int H, long long pb,
                                            long long pe) {
  for (long long p = pb + threadIdx.x; p < pe; p += blockDim.x)
    s_win[p - pb] = p < H ? hr[p] : xr[p - H];
}

// decimated (I, Q) of the output whose window starts at w
__device__ __forceinline__ float2 front_sample(const unsigned short* w,
                                               const int32_t* taps, int K,
                                               float scale) {
  int ai = 0, aq = 0;
  for (int k = 0; k < K; ++k) {
    const unsigned short v = w[k];
    const int tk = taps[k];
    ai += tk * (static_cast<int>(v & 0xff) - 128);
    aq += tk * (static_cast<int>(v >> 8) - 128);
  }
  return make_float2(__fmul_rn(__int2float_rn(ai), scale),
                     __fmul_rn(__int2float_rn(aq), scale));
}

}  // namespace u8w
