"""K10: the interleaved-IQ convert (csrc/iq_convert.cu).

No TPU kernel has this role: the JAX package writes ``IqConvertU8`` and
``IqConvertI16`` (sdr_tpu/stream/ops.py:46, :77) as one elementwise
expression each (sdr_tpu/ops/convert.py:30-94), which XLA fuses into one
pass.  Interleaved I/Q ``x [..., 2n]``, unsigned bytes (RTL-SDR, ``(v -
128) / 128``) or int16 (BladeRF, ``v / 2048``), becomes planar f32
``[..., 2, n]`` (the I plane first) or complex64 ``[..., n]``.  Both
scales are powers of two and every ``v`` is exact in f32, so the kernel
equals the plain version (ops/convert.py) bitwise.
"""

from __future__ import annotations

import ctypes

import torch

from sdr_tpu_torch.kernels._build import Kernel, cuda_rows, ptr
from sdr_tpu_torch.ops import convert

__all__ = ["KERNEL", "iq_convert", "iq_convert_reference"]

_P, _LL, _I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
KERNEL = Kernel("iq_convert", {
    "launch_iq_convert": [_P, _P, _LL, _LL, _I, _I],
})

# input dtype -> (planar form, complex form) of the plain version
_PLAIN = {
    torch.uint8: (convert.iq_u8_to_planar, convert.iq_u8_to_cfloat),
    torch.int16: (convert.iq_i16_to_planar, convert.iq_i16_to_cfloat),
}


def _check(x):
    if x.dtype not in _PLAIN:
        raise ValueError(f"x must be uint8 or int16 interleaved IQ, not "
                         f"{x.dtype}")
    if x.ndim < 1 or x.shape[-1] % 2:
        raise ValueError("interleaved IQ needs an even trailing dimension")


def _out_shape(x, planar: bool):
    n = x.shape[-1] // 2
    return x.shape[:-1] + ((2, n) if planar else (n,))


def iq_convert_reference(x: torch.Tensor, planar: bool) -> torch.Tensor:
    """Plain PyTorch version of :func:`iq_convert`: ops/convert.py's
    conversion for ``x``'s dtype."""
    _check(x)
    return _PLAIN[x.dtype][0 if planar else 1](x)


def iq_convert(x: torch.Tensor, planar: bool) -> torch.Tensor:
    """Interleaved u8 or int16 I/Q ``x [..., 2n]`` -> planar f32 ``[..., 2,
    n]`` (``planar``) or complex64 ``[..., n]``.  Launches K10 for CUDA
    tensors; CPU tensors take the plain version."""
    if x.device.type == "cpu":
        return iq_convert_reference(x, planar)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    _check(x)
    rows = cuda_rows(x=x)
    y = torch.empty(_out_shape(x, planar), device=x.device,
                    dtype=torch.float32 if planar else torch.complex64)
    n = x.shape[-1] // 2
    if n == 0 or rows == 0:
        return y
    KERNEL.launch("launch_iq_convert", x.device, ptr(x), ptr(y), rows, n,
                  int(x.dtype == torch.int16), int(bool(planar)))
    return y
