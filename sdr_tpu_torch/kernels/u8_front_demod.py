"""K1: fused u8 IQ front end + FM demod (csrc/u8_front_demod.cu).

Counterpart of sdr_tpu/kernels/u8_front_demod_pallas.py:
u8_front_demod_pallas.  A row's stream is ``concat(hist, x)``: output m
reads the bytes ``2(m*f + k) + c`` of it, so a streaming caller passes its
history and block as they are and no seam split is needed.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from sdr_tpu_torch.kernels._build import Kernel, cuda_rows, ptr
from sdr_tpu_torch.ops.demod import fm_demod_planar
from sdr_tpu_torch.ops.quantized import front_acc

__all__ = ["KERNEL", "u8_front_demod", "u8_front_demod_reference"]

_P, _LL, _I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
KERNEL = Kernel("u8_front_demod", {
    "launch_u8_front_demod": [_P, _P, _P, _P, _P, _P, _LL, _LL, _I, _I, _I,
                              _LL, ctypes.c_float],
})


def _check(taps, factor, x, hist, last_iq, num):
    if taps.dtype != torch.int32 or taps.ndim != 1:
        raise ValueError("taps must be a 1-D int32 tensor (u8_front_plan)")
    if x.dtype != torch.uint8 or hist.dtype != torch.uint8:
        raise ValueError("x and hist must be uint8")
    if last_iq.dtype != torch.float32:
        raise ValueError("last_iq must be float32")
    lead = x.shape[:-1]
    if hist.shape[:-1] != lead or last_iq.shape != lead + (2,):
        raise ValueError(f"shapes disagree: x {tuple(x.shape)}, hist "
                         f"{tuple(hist.shape)}, last_iq "
                         f"{tuple(last_iq.shape)}")
    if len({t.device for t in (taps, x, hist, last_iq)}) != 1:
        raise ValueError("taps, x, hist and last_iq must share a device")
    K, f = taps.shape[0], int(factor)
    have = hist.shape[-1] + x.shape[-1]
    if num < 1 or 2 * ((num - 1) * f + K) > have:
        raise ValueError(f"{num} outputs of {K} taps at factor {f} need more "
                         f"than the {have} bytes of concat(hist, x)")


def u8_front_demod_reference(taps, scale: float, factor: int,
                             x: torch.Tensor, hist: torch.Tensor,
                             last_iq: torch.Tensor, num: int):
    """Plain PyTorch version of :func:`u8_front_demod`."""
    _check(taps, factor, x, hist, last_iq, num)
    acc = front_acc(taps.tolist(), factor, torch.cat([hist, x], dim=-1), num)
    iq = acc.to(torch.float32) * float(np.float32(scale))
    return fm_demod_planar(iq, last_iq)


def u8_front_demod(taps, scale: float, factor: int, x: torch.Tensor,
                   hist: torch.Tensor, last_iq: torch.Tensor,
                   num: int | None = None):
    """u8 IQ ``x[..., n]`` after history ``hist[..., H]`` -> FM demod
    ``y[..., num]`` and the last decimated ``(I, Q)`` sample ``[..., 2]``.

    ``y[m] = atan2(s[m] * conj(s[m-1]))`` with
    ``s[m] = scale * sum_k taps[k] (v[2(m f + k) + c] - 128)``,
    ``v = concat(hist, x)`` and ``s[-1] = last_iq``.  ``taps`` are the
    int32 quantized taps of ``ops.quantized.u8_front_plan``.  Launches K1
    for CUDA tensors; CPU tensors take the plain version."""
    if num is None:
        num = (hist.shape[-1] + x.shape[-1] - 2 * taps.shape[0]) \
            // (2 * factor) + 1
    num = int(num)
    if x.device.type == "cpu":
        return u8_front_demod_reference(taps, scale, factor, x, hist,
                                        last_iq, num)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    _check(taps, factor, x, hist, last_iq, num)
    rows = cuda_rows(x=x, hist=hist, last_iq=last_iq, taps=taps)
    y = torch.empty(x.shape[:-1] + (num,), dtype=torch.float32,
                    device=x.device)
    iq = torch.empty(x.shape[:-1] + (2,), dtype=torch.float32,
                     device=x.device)
    if rows == 0:
        return y, iq
    KERNEL.launch("launch_u8_front_demod", x.device, ptr(x), ptr(hist),
                  ptr(last_iq), ptr(taps), ptr(y), ptr(iq), rows,
                  x.shape[-1], hist.shape[-1], taps.shape[0], int(factor),
                  num, float(scale))
    return y, iq
