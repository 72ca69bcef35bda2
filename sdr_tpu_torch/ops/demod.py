"""FM and AM demodulation (counterpart of sdr_tpu/ops/demod.py).

FM: ``y[n] = angle(x[n] * conj(x[n-1]))``, with the previous block's last
sample carried, on complex64 input (``fm_demod``, exact ``torch.angle``)
or planar-complex input (``fm_demod_planar``).  In the planar form each
product, sum and polynomial step is one rounded f32 operation, in the
order the CUDA kernel (csrc/u8_front_demod.cu) performs them, so the two
agree bitwise on the card.  AM: the envelope ``|x|``.

FM modulation (``fm_mod``, the transmit side): the phase is the
cumulative sum of ``sensitivity * x`` (:func:`cumsum`, in the JAX
package's order on the CPU), carried across blocks mod 2*pi.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["fast_atan2", "fm_demod", "fm_demod_planar", "am_demod",
           "cumsum", "fm_mod"]

_TWO_PI = float(np.float32(2 * np.pi))
CUMSUM_RUN = 16

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


def fm_demod_planar(x: torch.Tensor, last: torch.Tensor | None = None,
                    atan2: str = "poly"):
    """Planar-complex ``x[..., 2, n]`` (real plane first) ->
    ``(y[..., n], new_last[..., 2])``.

    ``last`` is the previous block's final ``(re, im)`` sample (zeros at
    stream start: atan2(0, 0) = 0).  ``atan2``: 'poly' (:func:`fast_atan2`)
    or 'exact' (``torch.atan2``)."""
    if atan2 not in ("poly", "exact"):
        raise ValueError(f"atan2 must be 'poly' or 'exact', got {atan2!r}")
    at2 = fast_atan2 if atan2 == "poly" else torch.atan2
    if last is None:
        last = torch.zeros(x.shape[:-2] + (2,), dtype=x.dtype,
                           device=x.device)
    re, im = x[..., 0, :], x[..., 1, :]
    pre = torch.cat([last[..., 0:1], re[..., :-1]], dim=-1)
    pim = torch.cat([last[..., 1:2], im[..., :-1]], dim=-1)
    y = at2(im * pre - re * pim, re * pre + im * pim)
    return y, x[..., :, -1].clone()


def fm_demod(x: torch.Tensor, last: torch.Tensor | None = None):
    """Complex ``x[..., n]`` -> ``(y[..., n], new_last[...])``, ``y[n] =
    angle(x[n] * conj(x[n-1]))``.  ``last`` is the previous block's final
    sample, 0 at stream start (the first output is then the angle of
    ``x[0] * conj(0)``, a signed zero: 0, or pi where both parts of
    ``x[0]`` are negative, as in the JAX package)."""
    if last is None:
        last = torch.zeros(x.shape[:-1], dtype=x.dtype, device=x.device)
    y0 = torch.angle(x[..., :1] * last[..., None].conj())
    y = torch.angle(x[..., 1:] * x[..., :-1].conj())
    return torch.cat([y0, y], dim=-1), x[..., -1].clone()


def am_demod(x: torch.Tensor) -> torch.Tensor:
    """AM envelope ``|x|`` of complex ``x``; stateless."""
    return x.abs()


def cumsum(x: torch.Tensor) -> torch.Tensor:
    """Inclusive f32 cumulative sum over the last axis in one fixed order:
    each run of CUMSUM_RUN samples summed from its start, the runs' totals
    summed the same way (recursively), and each run then offset by the
    total of the runs before it.

    It is the order the JAX package's ``jnp.cumsum`` takes on the CPU (its
    windowed reduction is rewritten into runs of 16), so the two agree
    bitwise there.  Every step is one f32 add over whole rows (no
    per-sample loop), so the card gives the CPU's sums bit for bit, where
    ``torch.cumsum`` sums in double on the CPU and in another order on
    the card.  Each sum passes through at most 15 adds a level and
    ``log16(n)`` levels, so its rounding grows with ``log(n)``, not
    ``n``."""
    L = CUMSUM_RUN
    lead, n = x.shape[:-1], x.shape[-1]
    if n <= 1:
        return x.clone()
    m = -(-n // L)
    runs = torch.nn.functional.pad(x, (0, m * L - n))
    # [L, *lead, m]: step k adds one contiguous row to the next
    t = runs.reshape(lead + (m, L)).movedim(-1, 0).contiguous()
    for k in range(1, L):
        t[k] += t[k - 1]
    totals = cumsum(t[L - 1])
    t[:, ..., 1:] += totals[..., :-1]
    return t.movedim(0, -1).reshape(lead + (m * L,))[..., :n]


def fm_mod(x: torch.Tensor, sensitivity: float, phase=0.0,
           amplitude: float = 1.0):
    """FM-modulate a real signal ``x[..., n]`` to complex64 baseband, the
    transmit-side inverse of :func:`fm_demod`:

        phi[n] = phi[n-1] + sensitivity * x[n],   y[n] = A * e^{j phi[n]}

    ``sensitivity`` is radians a sample per unit input (2*pi*deviation /
    fs), ``phase`` the phase before the block (a number or ``[...]``).
    Returns ``(y, final_phase)``, the final phase ``phi[..., -1]`` mod 2*pi
    (f32, in [0, 2*pi)) for the next block.  Every step is f32 in the JAX
    function's order: the product, the cumulative sum, the phase added,
    then ``A*cos`` and ``A*sin``."""
    x = x.to(torch.float32)
    if not isinstance(phase, torch.Tensor):
        phase = torch.full(x.shape[:-1], float(np.float32(phase)),
                           dtype=torch.float32, device=x.device)
    phi = cumsum(x * float(np.float32(sensitivity))) + phase[..., None]
    a = float(np.float32(amplitude))
    y = torch.complex(a * torch.cos(phi), a * torch.sin(phi))
    r = torch.fmod(phi[..., -1], _TWO_PI)
    return y, torch.where(r < 0, r + _TWO_PI, r)
