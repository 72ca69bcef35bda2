"""K3: strided FIR (csrc/fir.cu).

Counterpart of sdr_tpu/kernels/fir_pallas.py:fir_strided, for any
``start >= 0`` and ``factor >= 1``.  The kernel plans its own branch,
tiles and shared memory from the taps and the factor before it launches
(:func:`plan` reads that plan):

* factor 1: register-tiled sums over staged 3072-output tiles;
* factor > 1, the staged polyphase branch: tiles of ``8192 // factor``
  outputs (at most 1024) staged once, split into ``factor`` phase rows in
  shared memory and summed in tap order; it takes every tap count whose
  buffers fit a block, on an H100 up to 14,520 taps at factor 2, 14,496
  at 8 and 14,493 at 16 (so ``ceil(taps / factor) <= 897``, the TPU
  kernel's range, at every factor up to 16);
* factor > 1 past that switch: one thread an output, up to 58,112 taps.

A launch whose taps do not fit a block's shared memory (more than 17,316
taps at factor 1, 58,112 above, on an H100) raises.
"""

from __future__ import annotations

import ctypes

import torch

from sdr_tpu_torch.kernels._build import Kernel, cuda_rows, ptr

__all__ = ["KERNEL", "fir_strided", "fir_strided_reference", "plan"]

_P, _LL, _I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
KERNEL = Kernel("fir", {
    "launch_fir": [_P, _P, _P, _LL, _LL, _LL, _I, _I, _LL],
})


BRANCHES = ("factor 1", "staged", "per output")


def plan(n_taps: int, factor: int, device=None) -> dict:
    """The kernel's own plan for a launch of ``n_taps`` taps at
    ``factor`` on a CUDA device: ``{"branch": one of BRANCHES, "tile":
    outputs of a tile, "smem": shared-memory bytes of a block}``.  Raises
    where the taps do not fit, as the launch would."""
    device = torch.device("cuda") if device is None else torch.device(device)
    if device.type != "cuda":
        raise ValueError(f"the plan is the CUDA kernel's, not {device}'s")
    lib = KERNEL.lib()
    index = torch.cuda.current_device() if device.index is None else \
        device.index
    lib.fir_plan.argtypes = [_I, _I, *[ctypes.POINTER(_I)] * 3]
    out = [_I() for _ in range(3)]
    rc = lib.kernel_set_device(index)
    if rc == 0:
        rc = lib.fir_plan(int(n_taps), int(factor),
                          *(ctypes.byref(v) for v in out))
    if rc != 0:
        raise RuntimeError(f"fir plan failed: "
                           f"{lib.kernel_error_string(rc).decode()}")
    branch, tile, smem = (v.value for v in out)
    return {"branch": BRANCHES[branch], "tile": tile, "smem": smem}


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
    y = torch.empty(x.shape[:-1] + (num,), dtype=torch.float32,
                    device=x.device)
    if num == 0 or rows == 0:
        return y
    KERNEL.launch("launch_fir", x.device, ptr(x), ptr(taps), ptr(y), rows,
                  x.shape[-1], num, taps.shape[0], factor, start)
    return y
