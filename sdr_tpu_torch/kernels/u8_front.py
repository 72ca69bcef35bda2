"""K4: u8 IQ front end, planar I/Q out (csrc/u8_front.cu).

Counterpart of sdr_tpu/kernels/u8_front_pallas.py:u8_front_pallas: K1's
convert + exact-integer decimate without the demod.  A row's stream is
``concat(hist, x)``: output m, plane c reads the bytes
``start + 2(m*f + k) + c`` of it, so a streaming caller passes its history
and block as they are, and a byte offset needs no sliced copy.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from sdr_tpu_torch.kernels._build import Kernel, cuda_rows, ptr
from sdr_tpu_torch.ops.quantized import front_acc

__all__ = ["KERNEL", "u8_front", "u8_front_reference"]

_P, _LL, _I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
KERNEL = Kernel("u8_front", {
    "launch_u8_front": [_P, _P, _P, _P, _LL, _LL, _I, _I, _I, _LL, _LL,
                        ctypes.c_float],
})


def _check(taps, factor, x, hist, num, start):
    if taps.dtype != torch.int32 or taps.ndim != 1:
        raise ValueError("taps must be a 1-D int32 tensor (u8_front_plan)")
    if x.dtype != torch.uint8 or hist.dtype != torch.uint8:
        raise ValueError("x and hist must be uint8")
    if hist.shape[:-1] != x.shape[:-1]:
        raise ValueError(f"shapes disagree: x {tuple(x.shape)}, hist "
                         f"{tuple(hist.shape)}")
    if taps.device != x.device or hist.device != x.device:
        raise ValueError("taps, x and hist must share a device")
    K, f = taps.shape[0], int(factor)
    if f < 1 or start < 0 or num < 0:
        raise ValueError(f"bad geometry factor={f} start={start} num={num}")
    have = hist.shape[-1] + x.shape[-1]
    if num and start + 2 * ((num - 1) * f + K) > have:
        raise ValueError(f"{num} outputs of {K} taps at factor {f} from byte "
                         f"{start} need more than the {have} bytes of "
                         "concat(hist, x)")


def u8_front_reference(taps, scale: float, factor: int, x: torch.Tensor,
                       hist: torch.Tensor, num: int,
                       start: int = 0) -> torch.Tensor:
    """Plain PyTorch version of :func:`u8_front`."""
    _check(taps, factor, x, hist, num, start)
    acc = front_acc(taps.tolist(), factor, torch.cat([hist, x], dim=-1), num,
                    start)
    return acc.to(torch.float32) * float(np.float32(scale))


def u8_front(taps, scale: float, factor: int, x: torch.Tensor,
             hist: torch.Tensor, num: int | None = None,
             start: int = 0) -> torch.Tensor:
    """u8 IQ ``x[..., n]`` after history ``hist[..., H]`` -> planar
    ``y[..., 2, num]``, ``y[c, m] = scale * sum_k taps[k] (v[start +
    2(m f + k) + c] - 128)`` with ``v = concat(hist, x)``.  ``taps`` are
    the int32 quantized taps of ``ops.quantized.u8_front_plan`` (s8 or
    s16).  Launches K4 for CUDA tensors; CPU tensors take the plain
    version."""
    start = int(start)
    if num is None:
        num = (hist.shape[-1] + x.shape[-1] - start - 2 * taps.shape[0]) \
            // (2 * factor) + 1
    num = int(num)
    if x.device.type == "cpu":
        return u8_front_reference(taps, scale, factor, x, hist, num, start)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    _check(taps, factor, x, hist, num, start)
    rows = cuda_rows(x=x, hist=hist, taps=taps)
    y = torch.empty(x.shape[:-1] + (2, num), dtype=torch.float32,
                    device=x.device)
    if num == 0 or rows == 0:
        return y
    KERNEL.launch("launch_u8_front", x.device, ptr(x), ptr(hist), ptr(taps),
                  ptr(y), rows, x.shape[-1], hist.shape[-1], taps.shape[0],
                  int(factor), start, num, float(scale))
    return y
