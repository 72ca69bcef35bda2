"""Per-sample first-order recurrences: the DC blocker and the AGC
(counterpart of sdr_tpu/ops/scans.py).

DC blocker (the reference's filter.c:152-161):

    y[n] = x[n] - x[n-1] + alpha * y[n-1],   alpha = 0.997,

carrying ``(last_sample, last_output)``.  Its coefficient is constant, so
it runs on the blocked closed form of ops/iir.py (``linear_recurrence``).

AGC (the reference's Util.hs:329-348):

    y[n] = x[n] * g[n],   g[n+1] = g[n] + mu * (reference - |y[n]|).

With a nonnegative gain ``|x*g| = |x|*g``, so ``g[n+1] = g[n] * (1 -
mu*|x[n]|) + mu*reference``: a first-order linear recurrence with a
time-varying coefficient, evaluated by :func:`linear_scan`.  The premise
fails only at loop gains ``mu*|x| > 1``, where the true AGC is unstable
anyway (the JAX package's module docstring has the argument).
``method='scan'`` runs the literal sequential recurrence instead, the
oracle and the form for ``mu*|x| > 1``: a loop over samples, on the card
kernel K6 (kernels/agc.py).
"""

from __future__ import annotations

import numpy as np
import torch

from sdr_tpu_torch.kernels.agc import agc_scan
from sdr_tpu_torch.ops.iir import linear_recurrence
from sdr_tpu_torch.parallel.halo import exclusive_affine_prefix

__all__ = ["linear_scan", "affine_reduce", "dc_blocker", "agc_affine",
           "agc_gains", "agc"]

CHUNK = 128
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
    ``b`` ``[..., N]`` and ``y0`` broadcastable to ``[...]``.

    Each sample's map ``y -> a*y + b`` is composed with those before it in
    chunks of CHUNK samples: the exclusive prefix inside every chunk and
    then over the chunks' whole maps, each by the doubling of
    ``exclusive_affine_prefix`` (log2 steps of whole-tensor ops, no
    per-sample loop)."""
    lead, n = b.shape[:-1], b.shape[-1]
    y0 = _state(y0, lead, b.device)
    if n == 0:
        return b.clone()
    L = CHUNK
    nc = -(-n // L)
    a = torch.nn.functional.pad(a, (0, nc * L - n), value=1.0)
    b = torch.nn.functional.pad(b, (0, nc * L - n))
    ac = a.reshape(lead + (nc, L))
    bc = b.reshape(lead + (nc, L))
    # inside each chunk: the maps of the samples before each sample
    EA, EB = (t.movedim(0, -1) for t in exclusive_affine_prefix(
        ac.movedim(-1, 0), bc.movedim(-1, 0)))
    # each chunk's whole map, and the state entering each chunk
    CA = ac[..., -1] * EA[..., -1]
    CB = ac[..., -1] * EB[..., -1] + bc[..., -1]
    PA, PB = exclusive_affine_prefix(CA.movedim(-1, 0), CB.movedim(-1, 0))
    enter = (PA * y0 + PB).movedim(0, -1)                    # [..., nc]
    y = ac * (EA * enter[..., None] + EB) + bc
    return y.reshape(lead + (nc * L,))[..., :n]


def affine_reduce(a: torch.Tensor, b: torch.Tensor):
    """The composition of the maps ``y -> a[n]*y + b[n]`` over the last
    axis, ``(A, B)`` with ``y[N-1] = A * y[-1] + B``: a pairwise tree,
    halving the maps each step (about 2N map compositions, where
    :func:`linear_scan` would make all N outputs to keep one)."""
    while a.shape[-1] > 1:
        if a.shape[-1] % 2:
            a = torch.nn.functional.pad(a, (0, 1), value=1.0)
            b = torch.nn.functional.pad(b, (0, 1))
        # the earlier map of each pair first, then the later one
        a, b = a[..., 1::2] * a[..., 0::2], a[..., 1::2] * b[..., 0::2] \
            + b[..., 1::2]
    return a[..., 0], b[..., 0]


def dc_blocker(x: torch.Tensor, last_sample=0.0, last_output=0.0,
               alpha: float = 0.997):
    """DC blocking filter; returns ``(y, (new_last_sample,
    new_last_output))``, each carry a new tensor."""
    x = x.to(_F32)
    lead = x.shape[:-1]
    last_sample = _state(last_sample, lead, x.device)
    last_output = _state(last_output, lead, x.device)
    u = x - torch.cat([last_sample[..., None], x[..., :-1]], dim=-1)
    y = linear_recurrence(np.array([alpha], dtype=np.float32), u,
                          last_output[..., None])
    return y, (x[..., -1].clone(), y[..., -1].clone())


def agc_affine(x: torch.Tensor, mu: float, reference: float):
    """A block's affine reduction of the (positive-gain) AGC recurrence:
    ``(A, B)`` with ``g_out = A * g_in + B``, the carry algebra of
    block-parallel runs (composed over blocks by
    ``exclusive_affine_prefix``)."""
    a = 1.0 - _f32(mu) * x.abs().to(_F32)
    return affine_reduce(a, torch.full_like(
        a, _f32(np.float32(mu) * np.float32(reference))))


def agc_gains(m: torch.Tensor, mu: float, reference: float, state=1.0):
    """The linear-form AGC gains from real envelopes ``m = |x|``:
    ``(g, final)``, ``g[n]`` the gain applied to sample n and ``final``
    the gain entering the next block.  All-real: the planar chain's
    form."""
    state = _state(state, m.shape[:-1], m.device)
    a = 1.0 - _f32(mu) * m
    h = linear_scan(a, torch.full_like(a, _f32(np.float32(mu)
                                               * np.float32(reference))),
                    state)
    # h[n] = g[n+1]; sample n takes g[n] = (state, h[:-1])
    g = torch.cat([state[..., None], h[..., :-1]], dim=-1)
    return g, h[..., -1].clone()


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
