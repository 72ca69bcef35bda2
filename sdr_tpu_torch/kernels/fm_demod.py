"""K11: the FM demod (csrc/fm_demod.cu).

No TPU kernel has this role: the JAX package's ``FmDemod``
(sdr_tpu/stream/ops.py:585-617) reads shifted views of the block and
writes through one fusion root (sdr_tpu/ops/demod.py:29-44, 70-121), one
pass in XLA.  ``y[m] = angle(x[m] * conj(x[m - 1]))`` with each row's
carry as ``x[-1]``, over planar f32 I/Q ``x [..., 2, n]`` (carry ``[...,
2]``; the polynomial atan2 or ``atan2f``) or complex64 ``x [..., n]``
(carry ``[...]``).  The kernel reads ``x[m]`` and ``x[m - 1]`` straight
from the block, with no concatenated copy.

The planar form with the polynomial equals its plain version
(ops/demod.py:fm_demod_planar) bitwise; with ``atan2f`` it equals it where
the card's ``torch.atan2`` is ``atan2f``.  The complex plain version
(ops/demod.py:fm_demod) multiplies through PyTorch's complex product,
which may contract to FMA on the card, so the two agree to an angular
distance (2e-6 rad), not bitwise.  Both wrappers return ``(y,
new_last)`` as the plain versions do; an empty block passes its carry
through.
"""

from __future__ import annotations

import ctypes

import torch

from sdr_tpu_torch.kernels._build import Kernel, cuda_rows, ptr
from sdr_tpu_torch.ops import demod

__all__ = ["KERNEL", "fm_demod_planar", "fm_demod_planar_reference",
           "fm_demod_complex", "fm_demod_complex_reference"]

_P, _LL, _I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
KERNEL = Kernel("fm_demod", {
    "launch_fm_demod_planar": [_P, _P, _P, _LL, _LL, _I],
    "launch_fm_demod_complex": [_P, _P, _P, _LL, _LL],
})


def _check(x, last, planar: bool, atan2: str = "exact"):
    want = torch.float32 if planar else torch.complex64
    for name, t in (("x", x), ("last", last)):
        if t.dtype != want:
            raise ValueError(f"{name} must be {want}, not {t.dtype}")
    if last.device != x.device:
        raise ValueError("x and last must share a device")
    if planar:
        if x.ndim < 2 or x.shape[-2] != 2:
            raise ValueError(f"x {tuple(x.shape)} must be planar [..., 2, n]")
        lead = x.shape[:-2] + (2,)
        if atan2 not in ("poly", "exact"):
            raise ValueError(f"atan2 must be 'poly' or 'exact', got "
                             f"{atan2!r}")
    else:
        if x.ndim < 1:
            raise ValueError("x must have a time axis")
        lead = x.shape[:-1]
    if last.shape != lead:
        raise ValueError(f"last {tuple(last.shape)} must be {tuple(lead)}")


def fm_demod_planar_reference(x: torch.Tensor, last: torch.Tensor,
                              atan2: str = "poly"):
    """Plain PyTorch version of :func:`fm_demod_planar`:
    ops/demod.py:fm_demod_planar."""
    _check(x, last, True, atan2)
    if x.shape[-1] == 0:
        return x.new_empty(x.shape[:-2] + (0,)), last.clone()
    return demod.fm_demod_planar(x, last, atan2=atan2)


def fm_demod_complex_reference(x: torch.Tensor, last: torch.Tensor):
    """Plain PyTorch version of :func:`fm_demod_complex`:
    ops/demod.py:fm_demod."""
    _check(x, last, False)
    if x.shape[-1] == 0:
        return x.new_empty(x.shape, dtype=torch.float32), last.clone()
    return demod.fm_demod(x, last)


def fm_demod_planar(x: torch.Tensor, last: torch.Tensor,
                    atan2: str = "poly"):
    """Planar I/Q ``x [..., 2, n]`` and each row's previous sample ``last
    [..., 2]`` -> ``(y [..., n], new_last [..., 2])``; ``atan2`` 'poly' (the
    polynomial of ops/demod.py) or 'exact' (``atan2f``).  Launches K11
    for CUDA tensors; CPU tensors take the plain version."""
    if x.device.type == "cpu":
        return fm_demod_planar_reference(x, last, atan2)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    _check(x, last, True, atan2)
    rows = cuda_rows(last=last, x=x)
    n = x.shape[-1]
    y = torch.empty(x.shape[:-2] + (n,), dtype=torch.float32,
                    device=x.device)
    if n == 0 or rows == 0:
        return y, last.clone()
    KERNEL.launch("launch_fm_demod_planar", x.device, ptr(x), ptr(last),
                  ptr(y), rows, n, int(atan2 == "poly"))
    return y, x[..., :, -1].clone()


def fm_demod_complex(x: torch.Tensor, last: torch.Tensor):
    """complex64 ``x [..., n]`` and each row's previous sample ``last
    [...]`` -> ``(y [..., n], new_last [...])``.  Launches K11 for CUDA
    tensors; CPU tensors take the plain version."""
    if x.device.type == "cpu":
        return fm_demod_complex_reference(x, last)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    _check(x, last, False)
    n = x.shape[-1]
    rows = cuda_rows(x=x, last=last.unsqueeze(-1))
    y = torch.empty(x.shape, dtype=torch.float32, device=x.device)
    if n == 0 or rows == 0:
        return y, last.clone()
    KERNEL.launch("launch_fm_demod_complex", x.device, ptr(x), ptr(last),
                  ptr(y), rows, n)
    return y, x[..., -1].clone()
