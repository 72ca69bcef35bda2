"""K5: fused polyphase resample -> FIR (csrc/backhalf.cu).

Counterpart of sdr_tpu/kernels/backhalf_pallas.py:resample_fir_gain, for
every geometry with ``I <= 3072``: the resampled intermediate (K2's
output) stays in shared memory and feeds the FIR (K3's) directly.  The
caller folds the gain into the FIR taps, as ``ResampleFirScale`` does for
the unfused pair.  The kernel plans its own tiles and shared memory; a
launch whose tables and taps do not fit a block's shared memory raises.
"""

from __future__ import annotations

import ctypes

import torch

from sdr_tpu_torch.kernels._build import Kernel, cuda_rows, ptr
from sdr_tpu_torch.kernels.fir import fir_strided_reference
from sdr_tpu_torch.kernels.resample import _check as _check_resample
from sdr_tpu_torch.kernels.resample import period_words, resample_reference

__all__ = ["KERNEL", "resample_fir", "resample_fir_reference"]

_P, _LL, _I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
KERNEL = Kernel("backhalf", {
    "launch_backhalf": [_P, _P, _P, _P, _P, _P, _LL, _LL, _I, _I, _I, _I,
                        _I, _I, _LL, _LL],
})


def _check(table, I, D, taps, x, hist, offset, num, start):
    _check_resample(table, I, D, x, hist, offset, num, start)
    if taps.dtype != torch.float32 or taps.ndim != 1 or taps.numel() < 1:
        raise ValueError("taps must be a non-empty 1-D float32 tensor")
    if taps.device != x.device:
        raise ValueError("taps and x must share a device")


def resample_fir_reference(table, I: int, D: int, taps, x: torch.Tensor,
                           hist: torch.Tensor, offset: int, num: int,
                           start: int = 0) -> torch.Tensor:
    """Plain PyTorch version of :func:`resample_fir`: the plain resample,
    then the plain FIR."""
    _check(table, I, D, taps, x, hist, offset, num, start)
    yr = resample_reference(table, I, D, x, hist, offset,
                            num + taps.shape[0] - 1, start)
    return fir_strided_reference(taps, yr, num)


def resample_fir(table, I: int, D: int, taps, x: torch.Tensor,
                 hist: torch.Tensor, offset: int, num: int,
                 start: int = 0) -> torch.Tensor:
    """``y[..., m] = sum_j taps[j] * yr[..., m + j]`` with ``yr`` the
    resample of :func:`~sdr_tpu_torch.kernels.resample.resample` (same
    ``table, I, D, offset, start`` over ``v = concat(hist, x)``).
    Launches K5 for CUDA tensors; CPU tensors take the plain version."""
    I, D, offset, num, start = int(I), int(D), int(offset), int(num), \
        int(start)
    _check(table, I, D, taps, x, hist, offset, num, start)
    if x.device.type == "cpu":
        return resample_fir_reference(table, I, D, taps, x, hist, offset,
                                      num, start)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    rows = cuda_rows(x=x, hist=hist, table=table, taps=taps)
    y = torch.empty(x.shape[:-1] + (num,), dtype=torch.float32,
                    device=x.device)
    if num == 0 or rows == 0:
        return y
    period = period_words(I, D, offset, x.device)
    KERNEL.launch("launch_backhalf", x.device, ptr(x), ptr(hist), ptr(table),
                  ptr(period), ptr(taps), ptr(y), rows, x.shape[-1],
                  hist.shape[-1], I, D, table.shape[1], taps.shape[0],
                  offset, start, num)
    return y
