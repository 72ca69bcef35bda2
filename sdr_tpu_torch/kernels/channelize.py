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

K7 + DFT (:func:`branch_dft`, the second launch of the same source) is the
filterbank in one launch: K7's sums, then the C-point DFT across the
branches in the block, ``Y[..., m, k] = sum_r v[..., m, r] exp(-2 pi i k
r / C)``, complex64 ``[..., num, C]``, so ``Y.transpose(-1, -2)`` is the
channel-major view K3's complex form reads in place.  The JAX package runs
the stencil, XLA's FFT and a transpose (sdr_tpu/ops/channelize.py:108-116).
The DFT is K9's (``csrc/dft.cuh``, the twiddles of
``fft_stream.twiddles``), so the launch agrees with its plain version
(:func:`branch_dft_reference`: K7's plain version, then ``torch.fft``)
within 1e-5 of each output row's peak ``|Y|``; a row's output depends on
its inputs alone, so split calls equal one call bitwise.  It takes C a
power of two from 64 to 1,024 whose tile fits a block (:func:`dft_plan`);
:func:`dft_route` sends every other shape to K7 and cuFFT.
"""

from __future__ import annotations

import ctypes

import torch

from sdr_tpu_torch.kernels import fft_stream
from sdr_tpu_torch.kernels._build import Kernel, cuda_rows, ptr

__all__ = ["DFT_SIZES", "KERNEL", "branch_dft", "branch_dft_reference",
           "branch_filter", "branch_filter_reference", "dft_plan",
           "dft_route", "plan"]

_P, _LL, _I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
KERNEL = Kernel("channelize", {
    "launch_branch_filter": [_P, _P, _P, _P, _LL, _LL, _LL, _LL, _I, _I],
    "launch_branch_dft": [_P, _P, _P, _P, _P, _LL, _LL, _LL, _LL, _I, _I],
})

DFT_SIZES = tuple(1 << k for k in range(6, 11))     # 64 .. 1,024
SMEM_LIMIT = 232_448        # an H100's shared memory a block (opt-in)
_KR = 4                     # output rows a thread sums
_DFT_ROWS = 4_096           # C x tile rows at most


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


def _dft_smem(C: int, P: int, T: int) -> int:
    """Shared-memory bytes of a fused tile of T rows: the staged rows and
    taps, or the DFT's two padded planes where they take more."""
    return 4 * max((T + P - 1) * 2 * C + P * C, 2 * T * (C + C // 32))


def dft_plan(n_channels: int, taps_per_branch: int,
             num: int | None = None) -> dict:
    """The fused launch's plan (``csrc/channelize.cu:dft_plan``) for
    ``num`` output rows (None: as many as a tile takes): ``{"tile":
    output rows a block, "smem": shared-memory bytes a block}``.  The tile
    is 4,096 / C rows, fewer where ``num`` ends first or while the staged
    rows and taps exceed an H100's block (``SMEM_LIMIT``).
    Raises for C not a power of two from 64 to 1,024, and where not even a
    tile of 4 rows fits."""
    C, P = int(n_channels), int(taps_per_branch)
    if C not in DFT_SIZES:
        raise ValueError(f"the fused branch DFT takes C a power of two from "
                         f"64 to 1,024, not {C}")
    if P < 1:
        raise ValueError(f"{P} taps a branch")
    T = _DFT_ROWS // C
    if num is not None:
        T = max(_KR, min(T, -(-int(num) // _KR) * _KR))
    while T > _KR and _dft_smem(C, P, T) > SMEM_LIMIT:
        T -= _KR
    smem = _dft_smem(C, P, T)
    if smem > SMEM_LIMIT:
        raise ValueError(f"the fused branch DFT's staged rows and taps do "
                         f"not fit a block at C = {C}, P = {P} ({smem} "
                         f"bytes, {SMEM_LIMIT} at most)")
    return {"tile": T, "smem": smem}


def dft_route(n_channels: int, taps_per_branch: int) -> str:
    """``"fused"`` where :func:`dft_plan` takes the shape, else
    ``"k7+fft"``: the route ``channelize_rows`` takes, chosen by shape
    before any launch."""
    try:
        dft_plan(n_channels, taps_per_branch)
    except ValueError:
        return "k7+fft"
    return "fused"


def _check_dft(hb, hist, x, num):
    _check(hb, hist, x, num)
    dft_plan(hb.shape[1], hb.shape[0], num)


def branch_dft_reference(hb: torch.Tensor, hist: torch.Tensor,
                         x: torch.Tensor, num: int) -> torch.Tensor:
    """Plain PyTorch version of :func:`branch_dft`: K7's plain version,
    then ``torch.fft.fft`` across the branches."""
    num = int(num)
    _check_dft(hb, hist, x, num)
    return torch.fft.fft(branch_filter_reference(hb, hist, x, num), dim=-1)


def branch_dft(hb: torch.Tensor, hist: torch.Tensor, x: torch.Tensor,
               num: int) -> torch.Tensor:
    """The filterbank's ``Y[..., m, k] = sum_r v[..., m, r] exp(-2 pi i k r
    / C)`` over K7's ``v``, complex64 ``[..., num, C]``.  Launches K7 + DFT
    for CUDA tensors (a failed build or launch raises); CPU tensors take
    the plain version.  Raises for a shape :func:`dft_plan` refuses."""
    num = int(num)
    if x.device.type == "cpu":
        return branch_dft_reference(hb, hist, x, num)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    _check_dft(hb, hist, x, num)
    P, C = hb.shape
    rows = cuda_rows(x=x, hist=hist)
    for name, t in (("hist", hist), ("x", x)):
        if t.numel() and t.data_ptr() % 8:
            raise ValueError(f"{name} must be 8-byte aligned")
    y = torch.empty(x.shape[:-1] + (num, C), dtype=torch.complex64,
                    device=x.device)
    if num == 0 or rows == 0:
        return y
    tw = fft_stream.twiddles(C, x.device)
    KERNEL.launch("launch_branch_dft", x.device, ptr(hb), ptr(hist), ptr(x),
                  ptr(tw), ptr(y), rows, hist.shape[-1], x.shape[-1], num, C,
                  P)
    return y
