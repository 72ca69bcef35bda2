"""K3: strided FIR (csrc/fir.cu).

Counterpart of sdr_tpu/kernels/fir_pallas.py:fir_strided, for any
``start >= 0`` and ``factor >= 1``.
"""

from __future__ import annotations

import ctypes

import torch

from sdr_tpu_torch.kernels._build import Kernel, cuda_rows, ptr

__all__ = ["KERNEL", "fir_strided", "fir_strided_reference"]

_P, _LL, _I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
KERNEL = Kernel("fir", {
    "launch_fir": [_P, _P, _P, _LL, _LL, _LL, _I, _I, _LL],
})


def _check(taps, x, num, factor, start):
    if taps.dtype != torch.float32 or taps.ndim != 1:
        raise ValueError("taps must be a 1-D float32 tensor")
    if x.dtype != torch.float32:
        raise ValueError("x must be float32")
    if taps.device != x.device:
        raise ValueError("taps and x must share a device")
    if factor < 1 or start < 0 or num < 0:
        raise ValueError(f"bad geometry factor={factor} start={start} "
                         f"num={num}")
    if num and start + (num - 1) * factor + taps.shape[0] > x.shape[-1]:
        raise ValueError(f"{num} outputs of {taps.shape[0]} taps at stride "
                         f"{factor} from {start} read past {x.shape[-1]} "
                         "inputs")


def fir_strided_reference(taps, x: torch.Tensor, num: int, factor: int = 1,
                          start: int = 0) -> torch.Tensor:
    """Plain PyTorch version of :func:`fir_strided`."""
    _check(taps, x, num, factor, start)
    acc = torch.zeros(x.shape[:-1] + (num,), dtype=torch.float32,
                      device=x.device)
    span = (num - 1) * factor + 1
    for j, t in enumerate(taps.tolist()):
        lo = start + j
        acc = acc + t * x[..., lo: lo + span: factor]
    return acc


def fir_strided(taps, x: torch.Tensor, num: int, factor: int = 1,
                start: int = 0) -> torch.Tensor:
    """``y[..., i] = sum_j taps[j] * x[..., start + i*factor + j]``.
    Launches K3 for CUDA tensors; CPU tensors take the plain version."""
    num, factor, start = int(num), int(factor), int(start)
    if x.device.type == "cpu":
        return fir_strided_reference(taps, x, num, factor, start)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    _check(taps, x, num, factor, start)
    rows = cuda_rows(x=x, taps=taps)
    if taps.numel() * 4 > 48 * 1024:
        raise ValueError(f"{taps.numel()} taps exceed the kernel's 48 KB "
                         "of shared memory")
    y = torch.empty(x.shape[:-1] + (num,), dtype=torch.float32,
                    device=x.device)
    if num == 0 or rows == 0:
        return y
    KERNEL.launch("launch_fir", x.device, ptr(x), ptr(taps), ptr(y), rows,
                  x.shape[-1], num, taps.shape[0], factor, start)
    return y
