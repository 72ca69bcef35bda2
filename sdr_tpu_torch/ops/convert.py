"""Sample-format conversion and scaling (counterpart of
sdr_tpu/ops/convert.py).

Radio hardware delivers interleaved I/Q: RTL-SDR unsigned bytes, BladeRF
signed 12-bit words in int16.  These are plain elementwise PyTorch ops
(the JAX package leaves them to XLA too).  Each conversion is exact in f32
((v - 128) / 128 and v / 2048 divide by powers of two), so a sample equals
the JAX package's bit for bit.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["iq_u8_to_cfloat", "iq_u8_to_planar", "iq_i16_to_cfloat",
           "iq_i16_to_planar", "cfloat_to_iq_i16", "scale", "cplx_map"]


def _pairs(x: torch.Tensor) -> torch.Tensor:
    """Interleaved ``x[..., 2n]`` as a ``[..., n, 2]`` view of its (I, Q)
    pairs."""
    if x.shape[-1] % 2:
        raise ValueError("interleaved IQ needs an even trailing dimension")
    return x.reshape(x.shape[:-1] + (x.shape[-1] // 2, 2))


def _to_planar(x: torch.Tensor, zero: float, div: float) -> torch.Tensor:
    # an integer tensor minus a float scalar is f32 in one pass
    v = _pairs(x)
    out = torch.empty(v.shape[:-2] + (2, v.shape[-2]), dtype=torch.float32,
                      device=x.device)
    torch.sub(v[..., 0], zero, out=out[..., 0, :])
    torch.sub(v[..., 1], zero, out=out[..., 1, :])
    return out.div_(div)


def _to_cfloat(x: torch.Tensor, zero: float, div: float) -> torch.Tensor:
    # complex64 is interleaved (re, im) in memory, as the input is
    return torch.view_as_complex(torch.sub(_pairs(x), zero).div_(div))


def iq_u8_to_planar(x: torch.Tensor) -> torch.Tensor:
    """Interleaved unsigned-byte I/Q (RTL-SDR) -> planar f32 ``[..., 2, n]``
    (real plane first): ``(v - 128) / 128`` per component."""
    return _to_planar(x, 128.0, 128.0)


def iq_u8_to_cfloat(x: torch.Tensor) -> torch.Tensor:
    """Interleaved unsigned-byte I/Q -> complex64 ``[..., n]``."""
    return _to_cfloat(x, 128.0, 128.0)


def iq_i16_to_planar(x: torch.Tensor) -> torch.Tensor:
    """Interleaved signed 16-bit I/Q (BladeRF) -> planar f32
    ``[..., 2, n]``: ``v / 2048`` per component."""
    return _to_planar(x.to(torch.int16), 0.0, 2048.0)


def iq_i16_to_cfloat(x: torch.Tensor) -> torch.Tensor:
    """Interleaved signed 16-bit I/Q -> complex64 ``[..., n]``."""
    return _to_cfloat(x.to(torch.int16), 0.0, 2048.0)


def cfloat_to_iq_i16(x: torch.Tensor) -> torch.Tensor:
    """complex64 ``[..., n]`` -> interleaved int16 I/Q ``[..., 2n]`` for
    transmission: scale by 2048, round half to even, clamp to
    [-2048, 2047]."""
    def q16(v):
        return torch.clamp(torch.round(v * 2048.0), -2048, 2047).to(
            torch.int16)
    pairs = torch.stack([q16(x.real), q16(x.imag)], dim=-1)
    return pairs.reshape(x.shape[:-1] + (2 * x.shape[-1],))


def scale(factor, x: torch.Tensor) -> torch.Tensor:
    """``y = factor * x``, the factor rounded to f32 first."""
    return x * float(np.float32(factor))


def cplx_map(f, x: torch.Tensor) -> torch.Tensor:
    """Apply ``f`` to the real and imaginary parts independently."""
    return torch.complex(f(x.real), f(x.imag))
