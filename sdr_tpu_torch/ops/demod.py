"""FM demodulation (counterpart of sdr_tpu/ops/demod.py).

``y[n] = atan2(x[n] * conj(x[n-1]))`` on planar-complex input, with the
previous block's last sample carried.  Each product, sum and polynomial
step below is one rounded f32 operation, in the order the CUDA kernel
(csrc/u8_front_demod.cu) performs them, so the two agree bitwise on the
card.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["fast_atan2", "fm_demod_planar"]

# atan(z) = z * P(z^2) on [0, 1]: degree-6 fit, max error 5.8e-7 rad
# (the same coefficients as the JAX package and the CUDA kernel).
_ATAN_P = (0.00809729493, -0.0377517076, 0.0847596977, -0.135376751,
           0.198950258, -0.33327976, 0.999999715)


def fast_atan2(b: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    """Polynomial atan2(b, a) in f32, branch-matched to ``torch.atan2``
    in every quadrant; atan2(0, 0) = 0.  Max error 5.8e-7 rad."""
    ab, aa = b.abs(), a.abs()
    hi = torch.maximum(aa, ab)
    z = torch.minimum(aa, ab) / torch.where(hi == 0, torch.ones_like(hi), hi)
    z2 = z * z
    p = torch.full_like(z, float(np.float32(_ATAN_P[0])))
    for c in _ATAN_P[1:]:
        p = p * z2 + float(np.float32(c))
    r = p * z
    r = torch.where(ab > aa, float(np.float32(np.pi / 2)) - r, r)
    r = torch.where(a < 0, float(np.float32(np.pi)) - r, r)
    return torch.where(b < 0, -r, r)


def fm_demod_planar(x: torch.Tensor, last: torch.Tensor | None = None):
    """Planar-complex ``x[..., 2, n]`` (real plane first) ->
    ``(y[..., n], new_last[..., 2])`` with the polynomial atan2.

    ``last`` is the previous block's final ``(re, im)`` sample (zeros at
    stream start: atan2(0, 0) = 0)."""
    if last is None:
        last = torch.zeros(x.shape[:-2] + (2,), dtype=x.dtype,
                           device=x.device)
    re, im = x[..., 0, :], x[..., 1, :]
    pre = torch.cat([last[..., 0:1], re[..., :-1]], dim=-1)
    pim = torch.cat([last[..., 1:2], im[..., :-1]], dim=-1)
    y = fast_atan2(im * pre - re * pim, re * pre + im * pim)
    return y, x[..., :, -1].clone()
