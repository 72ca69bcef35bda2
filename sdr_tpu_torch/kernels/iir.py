"""K13: one IIR section, the DC blocker's and ``Iir``'s (csrc/iir.cu).

No TPU kernel has this role: the JAX package evaluates the recurrence
with ``jax.lax.associative_scan`` (sdr_tpu/ops/iir.py:30-65
``linear_recurrence``, sdr_tpu/ops/scans.py:64-80 ``dc_blocker``), one
XLA op.  Over rows ``x [..., n]`` f32, with each row's entering inputs
``xin [..., 2]`` (``x[-2], x[-1]``) and entering state ``s0 [..., p]``
(``y[-1], ..., y[-p]``):

    u[n] = b0*x[n] + b1*x[n-1] (+ b2*x[n-2])
    y[n] = u[n] + a_1*y[n-1] (+ a_2*y[n-2]),     p = 1 or 2.

The DC blocker is the section ``b = (1, -1)``, ``a = (alpha,)``;
``Iir``'s biquads are ``(b0, b1, b2)``, ``(-a1, -a2)``.  It returns ``y``
(unless ``store`` is False) and the state after the row.

The plain version is the drive in f32 and ``ops.iir.linear_recurrence``
(the blocked closed form in f32 matrix products).  The kernel rounds the
drive the same way but runs the recurrence in float64 and rounds each
output once, so the two agree within 1e-5 of each row's peak |y| (H7's
limit), not bitwise.  The kernel's order of composition is fixed by the
geometry, so two launches agree bitwise and the final-state launch
(``store=False``) gives the full launch's state; its float64 powers of
the companion matrix come from :func:`_params`, copied to each device
once (:func:`_powers`).
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from sdr_tpu_torch.kernels._build import Kernel, cuda_rows, ptr
from sdr_tpu_torch.ops.iir import companion, linear_recurrence
from sdr_tpu_torch.utils.graphs import keep

__all__ = ["KERNEL", "SPAN", "TILE", "iir_section", "iir_section_reference",
           "scratch_doubles"]

SPAN = 32                       # samples a thread runs in turn
TILE = 128 * SPAN               # samples a block
POWERS = 33                     # C^(SPAN k) and C^(TILE k), k = 0..32
_F32 = torch.float32

_P, _LL, _I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
KERNEL = Kernel("iir", {
    "launch_iir_section": [_P, _P, _P, _P, _P, _P, _LL, _LL, _LL, _I, _P,
                           _P, _I],
})


def _taps(b, coeffs):
    """``b`` as f32 values (a tuple of 2 or 3), ``coeffs`` as an f32
    array of 1 or 2."""
    b = tuple(float(np.float32(v)) for v in b)
    coeffs = np.asarray(coeffs, dtype=np.float32).reshape(-1)
    if len(b) not in (2, 3):
        raise ValueError(f"b must hold 2 or 3 taps, not {len(b)}")
    if coeffs.shape[0] not in (1, 2):
        raise ValueError(f"the section's order must be 1 or 2, not "
                         f"{coeffs.shape[0]}")
    return b, coeffs


def _check(x, xin, s0, p: int):
    for name, t in (("x", x), ("xin", xin), ("s0", s0)):
        if t.dtype != _F32:
            raise ValueError(f"{name} must be float32, not {t.dtype}")
        if t.device != x.device:
            raise ValueError("x, xin and s0 must share a device")
    lead = x.shape[:-1]
    if xin.shape != lead + (2,):
        raise ValueError(f"xin {tuple(xin.shape)} must be x's leading dims "
                         f"{tuple(lead)} + (2,)")
    if s0.shape != lead + (p,):
        raise ValueError(f"s0 {tuple(s0.shape)} must be x's leading dims "
                         f"{tuple(lead)} + ({p},)")


def iir_section_reference(x: torch.Tensor, b, coeffs, xin: torch.Tensor,
                          s0: torch.Tensor, store: bool = True):
    """Plain PyTorch version of :func:`iir_section`: the drive over
    ``cat(xin, x)``, then ``linear_recurrence``."""
    b, coeffs = _taps(b, coeffs)
    p = coeffs.shape[0]
    _check(x, xin, s0, p)
    xp = torch.cat([xin, x], dim=-1)
    u = b[0] * xp[..., 2:] + b[1] * xp[..., 1:-1]
    if len(b) == 3:
        u = u + b[2] * xp[..., :-2]
    y = linear_recurrence(coeffs, u, s0)
    s_out = torch.cat([s0.flip(-1), y], dim=-1)[..., -p:].flip(-1)
    return (y if store else None), s_out


@functools.lru_cache(maxsize=64)
def _params(b: tuple, coeffs: tuple) -> np.ndarray:
    """The launch's float64 parameters: b0, b1, b2, the taps used, a_1,
    a_2, then the powers C^(SPAN k) and C^(TILE k) of the companion
    matrix for k = 0..32, 4 entries each (p x p in the first p*p), each
    from float64 by repeated products."""
    C = companion(coeffs)
    p = C.shape[0]
    out = np.zeros(6 + 2 * POWERS * 4)
    out[:len(b)] = b
    out[3] = len(b)
    out[4:4 + p] = coeffs
    for t, step in enumerate((SPAN, TILE)):
        M, Mk = np.linalg.matrix_power(C, step), np.eye(p)
        for k in range(POWERS):
            at = 6 + (t * POWERS + k) * 4
            out[at:at + p * p] = Mk.ravel()
            Mk = Mk @ M
    return out


@functools.lru_cache(maxsize=64)
def _powers(b: tuple, coeffs: tuple, device: torch.device) -> torch.Tensor:
    """:func:`_params`' power tables on ``device``, made once (the kernel
    reads them per lane)."""
    return torch.from_numpy(_params(b, coeffs)[6:]).to(device)


def scratch_doubles(rows: int, n: int, p: int) -> int:
    """The launch's scratch: each tile's end state and entering state,
    then the counters (a ticket, each row's completion count and ready
    flag) in ``rows + 1`` doubles."""
    return 2 * rows * -(-n // TILE) * p + rows + 1


def iir_section(x: torch.Tensor, b, coeffs, xin: torch.Tensor,
                s0: torch.Tensor, store: bool = True):
    """One IIR section over rows ``x [..., n]`` f32: feed-forward taps
    ``b`` (2 or 3), feedback ``coeffs`` (``a_1``, or ``a_1, a_2``) on the
    state, entering inputs ``xin [..., 2]`` (``x[-2], x[-1]``) and state
    ``s0 [..., p]`` (``y[-1], ..., y[-p]``).  Returns ``(y, s_out)``:
    ``y [..., n]`` (None unless ``store``) and the state after the row
    ``[..., p]``.  Launches K13 for CUDA tensors; CPU tensors take the
    plain version."""
    if x.device.type == "cpu":
        return iir_section_reference(x, b, coeffs, xin, s0, store)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    b, coeffs = _taps(b, coeffs)
    p = coeffs.shape[0]
    _check(x, xin, s0, p)
    rows = cuda_rows(x=x, xin=xin, s0=s0)
    n = x.shape[-1]
    y = torch.empty_like(x) if store else None
    s_out = torch.empty_like(s0)
    if n == 0 or rows == 0:
        s_out.copy_(s0)
        return y, s_out
    key = (b, tuple(float(c) for c in coeffs))
    params, powers = _params(*key), keep(_powers(*key, x.device))
    doubles = scratch_doubles(rows, n, p)
    scratch = torch.empty(doubles, dtype=torch.float64, device=x.device)
    KERNEL.launch("launch_iir_section", x.device, ptr(x), ptr(xin), ptr(s0),
                  ptr(y) if store else ctypes.c_void_p(0), ptr(s_out),
                  ptr(scratch), doubles, rows, n, p,
                  params.ctypes.data_as(ctypes.c_void_p), ptr(powers),
                  int(store))
    return y, s_out
