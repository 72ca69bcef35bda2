"""K2: polyphase rational resampler (csrc/resample.cu).

Counterpart of sdr_tpu/kernels/resample_pallas.py:resample_band, for every
geometry: output m of a row reads ``v[start + i_m + k]``, ``v = concat(hist,
x)``, with the closed form of ops/fir.py.  The kernel plans its own tiles
and shared memory; a phase table too large for a block's shared memory
raises from the launch.

The kernel's tiles hold whole periods of ``I`` outputs, so within a tile
output ``u`` has the phase ``o_u`` and the input step ``di_u`` of output
``u mod I`` of the stream's first period (:func:`period_table`);
:func:`period_words` keeps that table on the card for each geometry.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from sdr_tpu_torch.kernels._build import Kernel, cuda_rows, ptr
from sdr_tpu_torch.utils.graphs import keep

__all__ = ["KERNEL", "period_table", "period_words", "resample",
           "resample_reference"]

_P, _LL, _I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
KERNEL = Kernel("resample", {
    "launch_resample": [_P, _P, _P, _P, _P, _LL, _LL, _I, _I, _I, _I, _I,
                        _LL, _LL],
})


def period_table(I: int, D: int, offset: int) -> np.ndarray:
    """int32 ``[2, I]``: the phase ``o_u`` and the input step ``di_u = i_u``
    of outputs ``u < I`` (``t_u = u*D - offset``, ``o_u = (-t_u) mod I``,
    ``i_u = (t_u + o_u) / I``).  Output ``m0 + u`` with ``m0`` a multiple
    of ``I`` reads from ``start + (m0 / I + u // I) * D + di[u % I]`` at
    phase ``o[u % I]``."""
    t = np.arange(I, dtype=np.int64) * D - offset
    o = (-t) % I
    return np.stack([o, (t + o) // I]).astype(np.int32)


_PERIODS: dict = {}                    # (I, D, offset, device) -> tensor
_PERIODS_KEPT = 16


def period_words(I: int, D: int, offset: int,
                 device: torch.device) -> torch.Tensor:
    """:func:`period_table` on ``device``, made once per geometry and
    device (a few are kept), so a stream op's launches reuse it."""
    key = (I, D, offset, str(device))
    words = _PERIODS.get(key)
    if words is None:
        words = torch.as_tensor(period_table(I, D, offset), device=device)
        if len(_PERIODS) >= _PERIODS_KEPT:
            _PERIODS.pop(next(iter(_PERIODS)))
        _PERIODS[key] = words
    return keep(words)


def _check(table, I, D, x, hist, offset, num, start):
    if table.dtype != torch.float32 or table.ndim != 2 \
            or table.shape[0] != I:
        raise ValueError(f"table must be float32 [I={I}, Kp]")
    if x.dtype != torch.float32 or hist.dtype != torch.float32:
        raise ValueError("x and hist must be float32")
    if hist.shape[:-1] != x.shape[:-1]:
        raise ValueError(f"shapes disagree: x {tuple(x.shape)}, hist "
                         f"{tuple(hist.shape)}")
    if len({t.device for t in (table, x, hist)}) != 1:
        raise ValueError("table, x and hist must share a device")
    if I < 1 or D < 1 or not 0 <= offset < I or start < 0 or num < 0:
        raise ValueError(f"bad geometry I={I} D={D} offset={offset} "
                         f"start={start} num={num}")


def resample_reference(table, I: int, D: int, x: torch.Tensor,
                       hist: torch.Tensor, offset: int, num: int,
                       start: int = 0) -> torch.Tensor:
    """Plain PyTorch version of :func:`resample`."""
    _check(table, I, D, x, hist, offset, num, start)
    Kp = table.shape[1]
    v = torch.cat([hist, x], dim=-1)
    t = torch.arange(num, dtype=torch.int64, device=x.device) * D - offset
    o = torch.remainder(-t, I)
    idx = start + torch.div(t + o, I, rounding_mode="floor")
    need = (int(idx[-1]) + Kp) if num else 0
    if need > v.shape[-1]:      # reads past the stream read zeros
        v = torch.nn.functional.pad(v, (0, need - v.shape[-1]))
    rows = table[o]                                     # [num, Kp]
    acc = torch.zeros(x.shape[:-1] + (num,), dtype=torch.float32,
                      device=x.device)
    for k in range(Kp):
        acc = acc + rows[:, k] * v[..., idx + k]
    return acc


def resample(table, I: int, D: int, x: torch.Tensor, hist: torch.Tensor,
             offset: int, num: int, start: int = 0) -> torch.Tensor:
    """``y[..., m] = sum_k table[o_m, k] * v[..., start + i_m + k]`` over
    ``v = concat(hist, x)``, with ``t_m = m*D - offset``,
    ``o_m = (-t_m) mod I`` and ``i_m = (t_m + o_m) / I``.  Launches K2 for
    CUDA tensors; CPU tensors take the plain version."""
    I, D, offset, num, start = int(I), int(D), int(offset), int(num), \
        int(start)
    _check(table, I, D, x, hist, offset, num, start)
    if x.device.type == "cpu":
        return resample_reference(table, I, D, x, hist, offset, num, start)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    rows = cuda_rows(x=x, hist=hist, table=table)
    y = torch.empty(x.shape[:-1] + (num,), dtype=torch.float32,
                    device=x.device)
    if num == 0 or rows == 0:
        return y
    period = period_words(I, D, offset, x.device)
    KERNEL.launch("launch_resample", x.device, ptr(x), ptr(hist), ptr(table),
                  ptr(period), ptr(y), rows, x.shape[-1], hist.shape[-1], I,
                  D, table.shape[1], offset, start, num)
    return y
