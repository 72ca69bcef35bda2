"""K6: the sequential AGC (csrc/agc_scan.cu).

No TPU kernel has this role: the JAX package runs the recurrence as a
``lax.scan`` over samples (sdr_tpu/ops/scans.py:agc, ``method='scan'``).
Over rows of complex64 or f32 samples ``x[..., n]``, with the gain
entering each row ``g0[...]``:

    cr = re*g;  ci = im*g;  m = sqrt(cr*cr + ci*ci);  g = g + mu*(ref - m)

(real rows: ``m = |cr|``), each product, sum and square root one rounded
f32 operation (IEEE round to nearest), ``mu`` and ``ref`` rounded to f32
first.  The output is ``y = (cr, ci)`` and the gain after the row.
Taking ``|y|`` from the planes rather than the complex ``abs`` keeps one
formula on the host and the card (the complex ``abs`` is ``hypot`` on the
CPU and another formula on the card), so the kernel equals the plain
version bitwise; both equal the JAX package's ``jnp.abs`` form within f32
rounding.

PyTorch's f32 ``sqrt`` on the CPU is not correctly rounded (some results
are an ulp off), so the plain version takes the square root in float64
and rounds it to f32: that is the correctly rounded f32 square root (a
float64 root within a few of its ulps cannot cross an f32 rounding
boundary), the one the kernel's ``__fsqrt_rn`` gives.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from sdr_tpu_torch.kernels._build import Kernel, cuda_rows, ptr

__all__ = ["KERNEL", "agc_scan", "agc_scan_reference"]

_P, _LL, _I, _F = (ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                   ctypes.c_float)
KERNEL = Kernel("agc_scan", {
    "launch_agc_scan": [_P, _P, _P, _P, _LL, _LL, _F, _F, _I, _I],
})


def _check(x: torch.Tensor, g0: torch.Tensor):
    if x.dtype not in (torch.complex64, torch.float32):
        raise ValueError(f"x must be complex64 or float32, not {x.dtype}")
    if g0.dtype != torch.float32 or g0.device != x.device:
        raise ValueError("g0 must be float32 on x's device")
    if g0.shape != x.shape[:-1]:
        raise ValueError(f"g0 {tuple(g0.shape)} must be x's leading dims "
                         f"{tuple(x.shape[:-1])}")


def agc_scan_reference(x: torch.Tensor, mu: float, reference: float,
                       g0: torch.Tensor, store: bool = True):
    """Plain PyTorch version of :func:`agc_scan`: a loop over samples,
    vectorised over the rows."""
    _check(x, g0)
    mu, ref = float(np.float32(mu)), float(np.float32(reference))
    lead, n = x.shape[:-1], x.shape[-1]
    g = g0.reshape(-1).clone()
    planes = (x.real, x.imag) if x.is_complex() else (x,)
    # [n, rows]: each step reads and writes one contiguous row
    planes = [p.reshape(-1, n).t().contiguous() for p in planes]
    outs = [torch.empty_like(p) for p in planes] if store else None
    for i in range(n):
        c = [p[i] * g for p in planes]
        if len(c) == 2:
            s = c[0] * c[0] + c[1] * c[1]
            m = torch.sqrt(s.double()).float()
        else:
            m = c[0].abs()
        if store:
            for o, v in zip(outs, c):
                o[i] = v
        g = g + mu * (ref - m)
    y = None
    if store:
        outs = [o.t().reshape(lead + (n,)) for o in outs]
        y = torch.complex(*outs) if x.is_complex() else outs[0]
    return y, g.reshape(lead)


def agc_scan(x: torch.Tensor, mu: float, reference: float,
             g0: torch.Tensor, store: bool = True):
    """The sequential AGC over rows ``x[..., n]`` (complex64 or f32) from
    the gains ``g0[...]``: returns ``(y, final_gain)``, ``y`` like ``x``
    (None when ``store`` is False: only the final gains).  Launches K6 for
    CUDA tensors; CPU tensors take the plain version."""
    _check(x, g0)
    if x.device.type == "cpu":
        return agc_scan_reference(x, mu, reference, g0, store)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    n = x.shape[-1]
    rows = cuda_rows(x=x, g0=g0)
    y = torch.empty_like(x) if store else None
    g = torch.empty_like(g0)
    if n == 0 or rows == 0:
        g.copy_(g0)
        return y, g
    KERNEL.launch("launch_agc_scan", x.device, ptr(x), ptr(g0),
                  ptr(y) if store else ctypes.c_void_p(0),
                  ptr(g), rows, n, float(np.float32(mu)),
                  float(np.float32(reference)), int(x.is_complex()),
                  int(store))
    return y, g
