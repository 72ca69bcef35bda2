"""K7: the channelizer's branch filter (csrc/channelize.cu).

No TPU kernel has this role: the JAX package writes the polyphase
filterbank's branch filter as a P-term stencil over the row-major reshape
of the stream (sdr_tpu/ops/channelize.py:108-114), which XLA fuses into
one pass.  Over rows of complex64 samples, with ``z = cat(hist, x)``
along the last axis and the tap rows ``hb [P, C]`` f32:

    v[..., m, r] = sum_{p=0..P-1} hb[p, r] * z[..., (m + p) * C + r]

for ``m < num``, ``r < C``.  Each product is rounded, then the products
are summed p = 0..P-1 from the first one, each add rounded: the order of
the plain loop ``v = x2[0:num] * hb[0]; v += x2[p:p + num] * hb[p]``.  The
kernel reads ``hist`` and ``x`` through two pointers, so a stream op
makes no concatenated copy of its block.

PyTorch multiplies by ``hb`` promoted to complex, adding a product with a
zero imaginary part, so the kernel may differ from the plain version in
the sign of a zero and nowhere else: compare them by the largest absolute
difference (0), not by bit patterns.  A geometry whose staged rows do not
fit a block's shared memory raises (``(P + 3) * 2C + P * C`` floats at
most 58,112 on an H100; :func:`plan`).
"""

from __future__ import annotations

import ctypes

import torch

from sdr_tpu_torch.kernels._build import Kernel, cuda_rows, ptr

__all__ = ["KERNEL", "branch_filter", "branch_filter_reference", "plan"]

_P, _LL, _I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
KERNEL = Kernel("channelize", {
    "launch_branch_filter": [_P, _P, _P, _P, _LL, _LL, _LL, _LL, _I, _I],
})


def plan(n_channels: int, taps_per_branch: int, num: int,
         device=None) -> dict:
    """The kernel's own plan for ``num`` output rows at C channels and P
    taps a branch on a CUDA device: ``{"tile": output rows a block,
    "smem": shared-memory bytes a block}``.  Raises where no tile fits, as
    the launch would."""
    device = torch.device("cuda") if device is None else torch.device(device)
    if device.type != "cuda":
        raise ValueError(f"the plan is the CUDA kernel's, not {device}'s")
    lib = KERNEL.lib()
    index = torch.cuda.current_device() if device.index is None else \
        device.index
    lib.branch_filter_plan.argtypes = [_I, _I, _LL, ctypes.POINTER(_I),
                                       ctypes.POINTER(_I)]
    tile, smem = _I(), _I()
    rc = lib.kernel_set_device(index)
    if rc == 0:
        rc = lib.branch_filter_plan(int(n_channels), int(taps_per_branch),
                                    int(num), ctypes.byref(tile),
                                    ctypes.byref(smem))
    if rc != 0:
        raise RuntimeError(f"branch filter plan failed: "
                           f"{lib.kernel_error_string(rc).decode()}")
    return {"tile": tile.value, "smem": smem.value}


def _check(hb, hist, x, num):
    if hb.dtype != torch.float32 or hb.ndim != 2 or 0 in hb.shape:
        raise ValueError("hb must be a [P, C] float32 tensor, P, C >= 1")
    if x.dtype != torch.complex64 or hist.dtype != torch.complex64:
        raise ValueError("hist and x must be complex64")
    if hb.device != x.device or hist.device != x.device:
        raise ValueError("hb, hist and x must share a device")
    if hist.shape[:-1] != x.shape[:-1]:
        raise ValueError(f"hist {tuple(hist.shape)} and x {tuple(x.shape)} "
                         "must share their leading dims")
    for name, t in (("hb", hb), ("hist", hist), ("x", x)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    P, C = hb.shape
    if num < 0 or (num + P - 1) * C > hist.shape[-1] + x.shape[-1]:
        raise ValueError(f"{num} output rows of {P} taps a branch at C = {C} "
                         f"read past {hist.shape[-1]} + {x.shape[-1]} "
                         "samples")


def branch_filter_reference(hb: torch.Tensor, hist: torch.Tensor,
                            x: torch.Tensor, num: int) -> torch.Tensor:
    """Plain PyTorch version of :func:`branch_filter`: the row-major
    reshape of ``cat(hist, x)`` read as P shifted views weighted by the
    tap rows, summed p = 0..P-1."""
    num = int(num)
    _check(hb, hist, x, num)
    P, C = hb.shape
    z = torch.cat([hist, x], dim=-1) if hist.shape[-1] else x
    m_total = z.shape[-1] // C
    x2 = z[..., : m_total * C].reshape(z.shape[:-1] + (m_total, C))
    v = x2[..., 0:num, :] * hb[0]
    for p in range(1, P):
        v += x2[..., p:p + num, :] * hb[p]
    return v


def branch_filter(hb: torch.Tensor, hist: torch.Tensor, x: torch.Tensor,
                  num: int) -> torch.Tensor:
    """``v[..., m, r] = sum_p hb[p, r] * z[..., (m + p) * C + r]`` over
    ``z = cat(hist, x)``, complex64 ``[..., num, C]``.  Launches K7 for
    CUDA tensors; CPU tensors take the plain version."""
    num = int(num)
    if x.device.type == "cpu":
        return branch_filter_reference(hb, hist, x, num)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    _check(hb, hist, x, num)
    P, C = hb.shape
    rows = cuda_rows(x=x, hist=hist)
    for name, t in (("hist", hist), ("x", x)):
        if t.numel() and t.data_ptr() % 8:
            raise ValueError(f"{name} must be 8-byte aligned")
    v = torch.empty(x.shape[:-1] + (num, C), dtype=torch.complex64,
                    device=x.device)
    if num == 0 or rows == 0:
        return v
    KERNEL.launch("launch_branch_filter", x.device, ptr(hb), ptr(hist),
                  ptr(x), ptr(v), rows, hist.shape[-1], x.shape[-1], num, C,
                  P)
    return v
