"""Per-sample first-order recurrences: the DC blocker and the AGC
(counterpart of sdr_tpu/ops/scans.py).

DC blocker (the reference's filter.c:152-161):

    y[n] = x[n] - x[n-1] + alpha * y[n-1],   alpha = 0.997,

carrying ``(last_sample, last_output)``: the IIR section ``b = (1, -1)``,
``a = (alpha,)``, on the card kernel K13 (kernels/iir.py; its plain
version the blocked closed form of ops/iir.py, ``linear_recurrence``).

AGC (the reference's Util.hs:329-348):

    y[n] = x[n] * g[n],   g[n+1] = g[n] + mu * (reference - |y[n]|).

With a nonnegative gain ``|x*g| = |x|*g``, so ``g[n+1] = g[n] * (1 -
mu*|x[n]|) + mu*reference``: a first-order linear recurrence with a
time-varying coefficient, evaluated by :func:`linear_scan` (the gains) and
:func:`affine_reduce` (a block's whole map), on the card kernel K12
(kernels/agc_linear.py).  The premise fails only at loop gains
``mu*|x| > 1``, where the true AGC is unstable anyway (the JAX package's
module docstring has the argument).  ``method='scan'`` runs the literal
sequential recurrence instead, the oracle and the form for ``mu*|x| >
1``: a loop over samples, on the card kernel K6 (kernels/agc.py).
"""

from __future__ import annotations

import numpy as np
import torch

from sdr_tpu_torch.kernels import agc_linear
from sdr_tpu_torch.kernels import iir as iir_kernel
from sdr_tpu_torch.kernels.agc import agc_scan

__all__ = ["linear_scan", "affine_reduce", "dc_blocker", "agc_affine",
           "agc_gains", "agc"]

_F32 = torch.float32


def _f32(v) -> float:
    return float(np.float32(v))


def _state(v, lead, device) -> torch.Tensor:
    """A carried state ``[...lead]`` from a tensor or a number; a number
    becomes a fill on ``device``, not a host-to-device copy (which would
    wait for the card)."""
    if isinstance(v, torch.Tensor):
        return v.to(_F32).expand(lead)
    return torch.full(tuple(lead), _f32(v), dtype=_F32, device=device)


def linear_scan(a: torch.Tensor, b: torch.Tensor, y0=0.0) -> torch.Tensor:
    """``y[n] = a[n] * y[n-1] + b[n]`` with ``y[-1] = y0``, for ``a``,
    ``b`` ``[..., N]`` and ``y0`` broadcastable to ``[...]``: chunks of
    128 samples composed by doubling (K12's plain version,
    kernels/agc_linear.py)."""
    return agc_linear.linear_scan(a, b, _state(y0, b.shape[:-1], b.device))


def affine_reduce(a: torch.Tensor, b: torch.Tensor):
    """The composition of the maps ``y -> a[n]*y + b[n]`` over the last
    axis, ``(A, B)`` with ``y[N-1] = A * y[-1] + B``, by a pairwise tree
    (K12's plain version, kernels/agc_linear.py)."""
    return agc_linear.affine_reduce(a, b)


def dc_blocker(x: torch.Tensor, last_sample=0.0, last_output=0.0,
               alpha: float = 0.997, store: bool = True):
    """DC blocking filter; returns ``(y, (new_last_sample,
    new_last_output))``, each carry a new tensor (``y`` None unless
    ``store``: only the carries)."""
    x = x.to(_F32).contiguous()
    lead = x.shape[:-1]
    last_sample = _state(last_sample, lead, x.device)
    xin = torch.stack([torch.zeros_like(last_sample), last_sample], dim=-1)
    s0 = _state(last_output, lead, x.device)[..., None].contiguous()
    y, s = iir_kernel.iir_section(x, (1.0, -1.0), (alpha,), xin, s0, store)
    return y, (x[..., -1].clone(), s[..., 0])


def agc_affine(x: torch.Tensor, mu: float, reference: float):
    """A block's affine reduction of the (positive-gain) AGC recurrence:
    ``(A, B)`` with ``g_out = A * g_in + B``, the carry algebra of
    block-parallel runs (composed over blocks by
    ``exclusive_affine_prefix``)."""
    return agc_linear.agc_affine(x.abs().to(_F32).contiguous(), mu,
                                 reference)


def agc_gains(m: torch.Tensor, mu: float, reference: float, state=1.0):
    """The linear-form AGC gains from real envelopes ``m = |x|``:
    ``(g, final)``, ``g[n]`` the gain applied to sample n and ``final``
    the gain entering the next block.  All-real: the planar chain's
    form."""
    state = _state(state, m.shape[:-1], m.device).contiguous()
    return agc_linear.agc_gains(m.contiguous(), mu, reference, state)


def agc(x: torch.Tensor, mu: float, reference: float, state=1.0,
        method: str = "linear", store: bool = True):
    """Automatic gain control; returns ``(y, final_gain)``.  Complex or
    real ``x``; the gain is real and starts at ``state`` (1 in the
    reference).  ``method='linear'`` evaluates the recurrence as a linear
    scan (exact under the positive-gain premise); ``'scan'`` is the
    literal sequential form, ``|y|`` taken from the real planes
    (kernels/agc.py), with ``store=False`` returning only the final
    gain (``y`` None)."""
    if method == "scan":
        return agc_scan(x.contiguous(), mu, reference,
                        _state(state, x.shape[:-1], x.device).contiguous(),
                        store)
    if method != "linear":
        raise ValueError(f"unknown agc method {method!r}")
    g, final = agc_gains(x.abs().to(_F32), mu, reference, state)
    return x * g, final
