"""K16: AM's planar envelope (csrc/am_envelope.cu).

No TPU kernel has this role: the JAX package's planar ``AmDemod`` is
``sqrt(re**2 + im**2)`` over planar I/Q (sdr_tpu/stream/ops.py:944), one
XLA fusion.  Over rows ``x [..., 2, n]`` f32 it writes ``y [..., n]``,
each product, the sum and the root one rounded f32 operation.  The plain
version is K12's (``kernels/agc_linear.py:envelope``: the sum in f32, the
root in float64 rounded once, which is the kernel's correctly rounded
``__fsqrt_rn``; PyTorch's f32 ``sqrt`` on the CPU is not), so the kernel
equals it bitwise.
"""

from __future__ import annotations

import ctypes

import torch

from sdr_tpu_torch.kernels._build import Kernel, cuda_rows, ptr
from sdr_tpu_torch.kernels.agc_linear import envelope

__all__ = ["KERNEL", "am_envelope", "envelope"]

_P, _LL = ctypes.c_void_p, ctypes.c_longlong
KERNEL = Kernel("am_envelope", {
    "launch_am_envelope": [_P, _P, _LL, _LL],
})


def _check(x: torch.Tensor) -> None:
    if x.dtype != torch.float32:
        raise ValueError(f"x must be float32, not {x.dtype}")
    if x.ndim < 2 or x.shape[-2] != 2:
        raise ValueError(f"x {tuple(x.shape)} must be planar [..., 2, n]")


def _launch(x: torch.Tensor) -> torch.Tensor:
    """K16 over ``x`` (checked, contiguous): the launch's own code."""
    n = x.shape[-1]
    rows = cuda_rows(x=x.view(x.shape[:-2] + (2 * n,)))
    y = torch.empty(x.shape[:-2] + (n,), dtype=x.dtype, device=x.device)
    if n == 0 or rows == 0:
        return y
    KERNEL.launch("launch_am_envelope", x.device, ptr(x), ptr(y), rows, n)
    return y


def am_envelope(x: torch.Tensor) -> torch.Tensor:
    """``sqrt(re*re + im*im)`` of planar I/Q ``x [..., 2, n]``: ``[...,
    n]``.  Launches K16 for CUDA tensors; CPU tensors take the plain
    version (:func:`envelope`)."""
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {x.device}")
    _check(x)
    if x.device.type == "cpu":
        return envelope(x)
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")
    return _launch(x)
