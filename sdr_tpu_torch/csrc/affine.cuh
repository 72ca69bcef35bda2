// What K12 (agc_linear.cu), K15 (affine_prefix.cu) and K16
// (am_envelope.cu) share: the composition of two affine maps y -> a*y + b
// and the envelope of an I/Q sample, each product, sum and root one
// rounded f32 operation (no FMA contraction), the order of their plain
// PyTorch versions (kernels/affine_prefix.py:compose,
// kernels/agc_linear.py:envelope).  Included after <cuda_runtime.h>.

#pragma once

namespace affine {

// the map `late` composed after `early`: (la*ea, la*eb + lb)
__device__ __forceinline__ float2 compose(float2 late, float2 early) {
  return make_float2(__fmul_rn(late.x, early.x),
                     __fadd_rn(__fmul_rn(late.x, early.y), late.y));
}

// |x| of an I/Q sample, sqrt(re*re + im*im), the root correctly rounded
__device__ __forceinline__ float envelope(float re, float im) {
  return __fsqrt_rn(__fadd_rn(__fmul_rn(re, re), __fmul_rn(im, im)));
}

}  // namespace affine
