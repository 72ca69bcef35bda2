// The FM demod's polynomial atan2, shared by K1 (u8_front_demod.cu) and
// K11 (fm_demod.cu): sdr_tpu/ops/demod.py:fast_atan2, atan(z) = z P(z^2)
// on [0, 1] (degree 6, max error 5.8e-7 rad), branch-matched to atan2 in
// every quadrant, atan2(0, 0) = 0.  Each step is one rounded f32
// operation (no FMA contraction) in the order of the plain PyTorch form
// (sdr_tpu_torch/ops/demod.py:fast_atan2), so a kernel that computes its
// arguments in that form's order equals it bitwise.  The coefficients are
// rounded to f32 as numpy rounds them (double literal, then float).
//
// Device code only, with no include of its own: nvcc's CUDA headers
// declare what it uses (and the host tests' shim stands in for them).

#pragma once

namespace fmd {

__device__ __forceinline__ float poly_atan2(float b, float a) {
  const float ab = fabsf(b), aa = fabsf(a);
  const float hi = fmaxf(aa, ab);
  const float z = __fdiv_rn(fminf(aa, ab), hi == 0.f ? 1.f : hi);
  const float z2 = __fmul_rn(z, z);
  float p = static_cast<float>(0.00809729493);
  p = __fadd_rn(__fmul_rn(p, z2), static_cast<float>(-0.0377517076));
  p = __fadd_rn(__fmul_rn(p, z2), static_cast<float>(0.0847596977));
  p = __fadd_rn(__fmul_rn(p, z2), static_cast<float>(-0.135376751));
  p = __fadd_rn(__fmul_rn(p, z2), static_cast<float>(0.198950258));
  p = __fadd_rn(__fmul_rn(p, z2), static_cast<float>(-0.33327976));
  p = __fadd_rn(__fmul_rn(p, z2), static_cast<float>(0.999999715));
  float r = __fmul_rn(p, z);
  if (ab > aa) r = __fsub_rn(static_cast<float>(1.5707963267948966), r);
  if (a < 0.f) r = __fsub_rn(static_cast<float>(3.141592653589793), r);
  return b < 0.f ? -r : r;
}

}  // namespace fmd
