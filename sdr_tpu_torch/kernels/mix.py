"""K8: the oscillator mix, planar and complex (csrc/mix.cu).

No TPU kernel has this role: the JAX package writes the planar ``Mix`` as
two planar rotations (sdr_tpu/stream/ops.py:1148-1154), which XLA fuses
into one pass.  Over rows of planar I/Q ``x [..., 2, n]`` f32, with the
oscillator's table ``lo [2, n]`` (cos, sin) shared by every row and each
row's unit phasor ``carry [..., 2]``:

    pr = lo_r*c_r - lo_i*c_i      pi = lo_r*c_i + lo_i*c_r
    y_r = x_r*pr - x_i*pi         y_i = x_r*pi + x_i*pr

each product, sum and difference one rounded f32 operation, so the kernel
equals the plain version bitwise.  The phasor's advance between blocks
works on ``[..., 2]`` and stays in the stream op.

The complex form (:func:`mix_complex`) replaces the complex ``Mix``'s
``x * lo * carry`` (sdr_tpu/stream/ops.py:1163, one XLA fusion): over
interleaved complex64 rows ``x [..., n]``, the table ``lo [n]`` and each
row's phasor ``carry [...]``, in that order,

    p = x*lo:    p_r = x_r*lo_r - x_i*lo_i    p_i = x_r*lo_i + x_i*lo_r
    y = p*c:     y_r = p_r*c_r - p_i*c_i      y_i = p_r*c_i + p_i*c_r

each step one rounded f32 operation.  Its plain version spells these out
over ``torch.view_as_real`` (PyTorch's complex multiply may contract to
FMA on the card), so the kernel equals it bitwise.
"""

from __future__ import annotations

import ctypes

import torch

from sdr_tpu_torch.kernels._build import Kernel, cuda_rows, ptr

__all__ = ["KERNEL", "mix_complex", "mix_complex_reference", "mix_planar",
           "mix_planar_reference"]

_P, _LL = ctypes.c_void_p, ctypes.c_longlong
KERNEL = Kernel("mix", {
    "launch_mix_planar": [_P, _P, _P, _P, _LL, _LL],
    "launch_mix_complex": [_P, _P, _P, _P, _LL, _LL],
})


def _check(lo, carry, x):
    for name, t in (("lo", lo), ("carry", carry), ("x", x)):
        if t.dtype != torch.float32:
            raise ValueError(f"{name} must be float32, not {t.dtype}")
        if t.device != x.device:
            raise ValueError("lo, carry and x must share a device")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if x.ndim < 2 or x.shape[-2] != 2:
        raise ValueError(f"x {tuple(x.shape)} must be planar [..., 2, n]")
    if tuple(lo.shape) != (2, x.shape[-1]):
        raise ValueError(f"lo {tuple(lo.shape)} must be [2, {x.shape[-1]}]")
    if carry.shape != x.shape[:-2] + (2,):
        raise ValueError(f"carry {tuple(carry.shape)} must be x's leading "
                         f"dims {tuple(x.shape[:-2])} + (2,)")


def mix_planar_reference(lo: torch.Tensor, carry: torch.Tensor,
                         x: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of :func:`mix_planar`: the table rotated by
    each row's phasor into two planes, then the block rotated by them."""
    _check(lo, carry, x)
    cr, ci = carry[..., 0, None], carry[..., 1, None]
    pr = lo[0] * cr - lo[1] * ci
    pi = lo[0] * ci + lo[1] * cr
    xr, xi = x[..., 0, :], x[..., 1, :]
    y = torch.empty_like(x)             # the planes written in place
    torch.sub(xr * pr, xi * pi, out=y[..., 0, :])
    torch.add(xr * pi, xi * pr, out=y[..., 1, :])
    return y


def mix_planar(lo: torch.Tensor, carry: torch.Tensor,
               x: torch.Tensor) -> torch.Tensor:
    """``x [..., 2, n]`` rotated by the table ``lo [2, n]`` times each
    row's phasor ``carry [..., 2]``.  Launches K8 for CUDA tensors; CPU
    tensors take the plain version."""
    if x.device.type == "cpu":
        return mix_planar_reference(lo, carry, x)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    _check(lo, carry, x)
    rows = cuda_rows(carry=carry)
    y = torch.empty_like(x)
    if x.shape[-1] == 0 or rows == 0:
        return y
    KERNEL.launch("launch_mix_planar", x.device, ptr(lo), ptr(carry),
                  ptr(x), ptr(y), rows, x.shape[-1])
    return y


def _check_complex(lo, carry, x):
    for name, t in (("lo", lo), ("carry", carry), ("x", x)):
        if t.dtype != torch.complex64:
            raise ValueError(f"{name} must be complex64, not {t.dtype}")
        if t.device != x.device:
            raise ValueError("lo, carry and x must share a device")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if x.ndim < 1:
        raise ValueError("x must have a time axis")
    if tuple(lo.shape) != (x.shape[-1],):
        raise ValueError(f"lo {tuple(lo.shape)} must be [{x.shape[-1]}]")
    if carry.shape != x.shape[:-1]:
        raise ValueError(f"carry {tuple(carry.shape)} must be x's leading "
                         f"dims {tuple(x.shape[:-1])}")


def mix_complex_reference(lo: torch.Tensor, carry: torch.Tensor,
                          x: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of :func:`mix_complex`: ``(x * lo) * carry``
    in explicit real operations."""
    _check_complex(lo, carry, x)
    a, b = torch.view_as_real(x), torch.view_as_real(lo)
    pr = a[..., 0] * b[..., 0] - a[..., 1] * b[..., 1]
    pi = a[..., 0] * b[..., 1] + a[..., 1] * b[..., 0]
    c = torch.view_as_real(carry)[..., None, :]
    y = torch.empty_like(x)
    yv = torch.view_as_real(y)          # the parts written in place
    torch.sub(pr * c[..., 0], pi * c[..., 1], out=yv[..., 0])
    torch.add(pr * c[..., 1], pi * c[..., 0], out=yv[..., 1])
    return y


def mix_complex(lo: torch.Tensor, carry: torch.Tensor,
                x: torch.Tensor) -> torch.Tensor:
    """``(x [..., n] * lo [n]) * carry [..., None]``, complex64.  Launches
    K8's complex form for CUDA tensors; CPU tensors take the plain
    version."""
    if x.device.type == "cpu":
        return mix_complex_reference(lo, carry, x)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    _check_complex(lo, carry, x)
    rows = cuda_rows(x=x)
    y = torch.empty_like(x)
    if x.shape[-1] == 0 or rows == 0:
        return y
    KERNEL.launch("launch_mix_complex", x.device, ptr(lo), ptr(carry),
                  ptr(x), ptr(y), rows, x.shape[-1])
    return y
