"""K4: u8 IQ front end, planar I/Q out (csrc/u8_front.cu).

Counterpart of sdr_tpu/kernels/u8_front_pallas.py:u8_front_pallas: K1's
convert + exact-integer decimate without the demod.  A row's stream is
``concat(hist, x)``: output m, plane c reads the bytes
``start + 2(m*f + k) + c`` of it, so a streaming caller passes its history
and block as they are, and a byte offset needs no sliced copy.

The kernel sums four taps per ``__dp4a``: :func:`pack_taps` packs the
integer taps into int32 words, and :func:`tap_words` keeps the words of
each taps tensor on its device, so only the first launch with a taps
tensor copies to the host and back.
"""

from __future__ import annotations

import ctypes
import weakref

import numpy as np
import torch

from sdr_tpu_torch.kernels._build import Kernel, cuda_rows, ptr
from sdr_tpu_torch.ops.quantized import front_acc
from sdr_tpu_torch.utils.graphs import keep

__all__ = ["KERNEL", "pack_taps", "tap_words", "u8_front",
           "u8_front_reference"]

_P, _LL, _I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
KERNEL = Kernel("u8_front", {
    "launch_u8_front": [_P, _P, _P, _P, _LL, _LL, _I, _I, _I, _I, _I, _LL,
                        _LL, ctypes.c_float],
})


def pack_taps(tq) -> np.ndarray:
    """The integer taps as the kernels' ``__dp4a`` words: int32 ``[1, nw]``
    for taps in int8 range (four s8 taps to a word, tap 4w + i in byte i),
    ``[2, nw]`` otherwise (16-bit taps ``T = 256*Th + Tl``: a row of the
    signed high bytes ``Th``, a row of the unsigned low bytes ``Tl``).
    ``nw = 2*ceil(K/8)``: zero taps pad K to whole 8-byte reads."""
    t = np.asarray(tq, dtype=np.int64).reshape(-1)
    if t.size == 0 or t.min() < -32768 or t.max() > 32767:
        raise ValueError("taps must be a non-empty sequence of int16 values")
    nw = 2 * -(-t.size // 8)
    pad = np.zeros(4 * nw, dtype=np.int64)
    pad[:t.size] = t
    rows = [pad] if -128 <= t.min() and t.max() <= 127 else \
        [pad >> 8, pad & 0xFF]
    return np.stack([(r & 0xFF).astype(np.uint8).view("<i4")
                     for r in rows])


_WORDS: dict = {}                      # id(taps) -> (ref, version, words)
_WORDS_KEPT = 16


def tap_words(taps: torch.Tensor) -> torch.Tensor:
    """:func:`pack_taps` of the int32 taps tensor ``taps``, on its device.
    The words are kept for the tensor as long as it lives and is not
    modified in place, so a stream op's launches reuse them."""
    hit = _WORDS.get(id(taps))
    if hit is not None and hit[0]() is taps and hit[1] == taps._version:
        return keep(hit[2])
    words = torch.as_tensor(pack_taps(taps.tolist()), device=taps.device)
    if len(_WORDS) >= _WORDS_KEPT:
        _WORDS.pop(next(iter(_WORDS)))
    _WORDS[id(taps)] = (weakref.ref(taps), taps._version, words)
    return keep(words)


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
    packed = tap_words(taps)
    y = torch.empty(x.shape[:-1] + (2, num), dtype=torch.float32,
                    device=x.device)
    if num == 0 or rows == 0:
        return y
    KERNEL.launch("launch_u8_front", x.device, ptr(x), ptr(hist),
                  ptr(packed), ptr(y), rows, x.shape[-1], hist.shape[-1],
                  taps.shape[0], int(factor), packed.shape[1],
                  int(packed.shape[0] == 2), start, num, float(scale))
    return y

