"""K9: the waterfall's FFT stream in one pass (csrc/fft_stream.cu).

No TPU kernel has this role: the JAX package frames, windows, transforms
and takes ``|X|`` and the shift inside XLA fusions
(sdr_tpu/stream/ops.py:1268-1295), on a TPU with its own matrix-unit DFT
(``fft_mxu_planar``).  Over rows of ``z = cat(hist, x)`` along the last
axis, planar f32 ``[..., 2, n]`` (the plane axis consumed) or complex64
``[..., n]``, and a window ``w [N]`` f32:

    frame f = z[f hop : f hop + N] * w        (each component one rounded
                                               f32 product)
    X_f = DFT(frame f)                        (unnormalised, forward)
    out[..., f, :] = |X_f| (f32) or X_f (complex64), fftshifted if shift

for ``f < (H + n - N) // hop + 1``.  The kernel reads ``hist`` and ``x``
through two pointers, so neither the concatenated copy nor the planes'
complex64 rebuild is made.  Its FFT is its own (Stockham radix-32 passes
in registers, twiddles from a float64 table rounded to f32 once), so it
agrees with the plain version (cuFFT on the card, pocketfft on the CPU)
within rounding: 1e-5 of each frame's peak.  A frame's output depends on
its N samples alone, so the planar and complex forms, and a streamed run
and the block-parallel call, are bitwise equal.

Sizes: the powers of two from 64 to 16,384 (:func:`plan`); on the card
``FftStream`` takes any other size to cuFFT (:func:`kernel_route`).
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from sdr_tpu_torch.kernels._build import Kernel, ptr
from sdr_tpu_torch.ops import fftops
from sdr_tpu_torch.utils.graphs import keep

__all__ = ["KERNEL", "SIZES", "fft_stream", "fft_stream_reference",
           "kernel_route", "plan", "twiddles"]

_P, _LL, _I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
KERNEL = Kernel("fft_stream", {
    "launch_fft_stream": [_P, _P, _P, _P, _P, _LL, _LL, _LL, _LL, _I, _I,
                          _I, _I, _I, _I, _I, _I],
})

SIZES = tuple(1 << k for k in range(6, 15))     # 64 .. 16,384
_TARGET_THREADS = 256
_TWIDDLES: dict = {}


def _log2_elems(size: int) -> int:
    """log2 of the elements a thread holds (csrc/fft_stream.cu's
    ``log2_elems``): the radix of every pass but the last."""
    return min(size.bit_length() - 1, 5)


def radices(size: int) -> list:
    """The kernel's passes: radix 32 while it divides, then the rest."""
    log2n, log2e = size.bit_length() - 1, _log2_elems(size)
    rest = log2n % log2e
    return [1 << log2e] * (log2n // log2e) + ([1 << rest] if rest else [])


def plan(size: int, hop: int | None = None) -> dict:
    """K9's launch at frame size ``size``: ``{"frames": frames a block,
    "threads": threads a block, "smem": shared-memory bytes a block,
    "elems": elements a thread, "radices": the passes}``.  Raises for a
    size that is not a power of two from 64 to 16,384 or a hop outside
    [1, size].  (The launch refuses a plan past the device's shared
    memory; on an H100 each of these sizes fits.)"""
    size = int(size)
    if size not in SIZES:
        raise ValueError(f"K9 takes a power-of-two size from 64 to 16,384, "
                         f"not {size}")
    if hop is not None and not 1 <= int(hop) <= size:
        raise ValueError(f"hop {hop} must be in [1, {size}]")
    elems = 1 << _log2_elems(size)
    per_frame = size // elems
    frames = max(1, _TARGET_THREADS // per_frame)
    # the exchanged planes of every frame, a word of padding every 32
    # (the staged span fits inside them)
    smem = 4 * 2 * frames * (size + size // 32)
    return {"frames": frames, "threads": frames * per_frame, "smem": smem,
            "elems": elems, "radices": radices(size)}


def kernel_route(size: int) -> str:
    """``"k9"`` for the sizes K9 takes, else ``"cufft"``: the route
    ``FftStream`` takes on the card, chosen by shape before any launch."""
    return "k9" if int(size) in SIZES else "cufft"


def twiddles(size: int, device) -> torch.Tensor:
    """K9's twiddle table at ``size``, ``[size, 2]`` f32 on ``device``,
    computed in float64 and rounded once, cached per size and device.
    Pass p (radix R after radices of product Ns > 1) reads
    ``exp(-2 pi i k r / (Ns R))`` at ``Ns - 1 + (r - 1) Ns + k`` for
    ``1 <= r < R``, ``k < Ns``."""
    device = torch.device(device)
    key = (int(size), device)
    if key not in _TWIDDLES:
        table = np.zeros(size, dtype=np.complex128)
        table[0] = 1
        ns = 1
        for R in radices(size):
            if ns > 1:
                r = np.arange(1, R)[:, None]
                k = np.arange(ns)[None, :]
                table[ns - 1: ns * R - 1] = np.exp(
                    -2j * np.pi * (k * r) / (ns * R)).ravel()
            ns *= R
        pairs = np.stack([table.real, table.imag], axis=-1)
        _TWIDDLES[key] = torch.as_tensor(pairs.astype(np.float32),
                                         device=device)
    return keep(_TWIDDLES[key])


def _check(hist, x, window, hop):
    if x.dtype not in (torch.float32, torch.complex64):
        raise ValueError(f"x must be planar float32 [..., 2, n] or "
                         f"complex64 [..., n], not {x.dtype}")
    if hist.dtype != x.dtype:
        raise ValueError("hist and x must share a dtype")
    if window.dtype != torch.float32 or window.ndim != 1 or \
            window.numel() == 0:
        raise ValueError("window must be a [size] float32 tensor")
    if hist.device != x.device or window.device != x.device:
        raise ValueError("hist, x and window must share a device")
    planar = x.dtype == torch.float32
    if planar and (x.ndim < 2 or x.shape[-2] != 2):
        raise ValueError(f"planar x {tuple(x.shape)} must be [..., 2, n]")
    if hist.shape[:-1] != x.shape[:-1]:
        raise ValueError(f"hist {tuple(hist.shape)} and x {tuple(x.shape)} "
                         "must share their leading dims")
    if not 1 <= hop <= window.numel():
        raise ValueError(f"hop {hop} must be in [1, {window.numel()}]")
    return planar


def fft_stream_reference(hist: torch.Tensor, x: torch.Tensor,
                         window: torch.Tensor, hop: int,
                         magnitude: bool = True,
                         shift: bool = True) -> torch.Tensor:
    """Plain PyTorch version of :func:`fft_stream`: ``cat(hist, x)``
    (planes made complex64), framed and windowed by ``fftops.frame``, one
    batched ``torch.fft`` call, then ``abs`` and ``fftshift``."""
    hop = int(hop)
    planar = _check(hist, x, window, hop)
    xext = torch.cat([hist, x], dim=-1)
    if planar:
        xext = torch.complex(xext[..., 0, :], xext[..., 1, :])
    # each intermediate is dropped as soon as the next exists: the
    # frames of a 32 x 10 MiB batch take 2.7 GB
    frames = fftops.frame(xext, window.numel(), hop, window)
    del xext
    F = fftops.fft(frames)
    del frames
    if magnitude:
        F = F.abs()
    if shift:
        F = torch.fft.fftshift(F, dim=-1)
    return F


def fft_stream(hist: torch.Tensor, x: torch.Tensor, window: torch.Tensor,
               hop: int, magnitude: bool = True,
               shift: bool = True) -> torch.Tensor:
    """The windowed frames of ``cat(hist, x)`` at ``window.numel()`` and
    ``hop``, transformed: ``[..., nf, size]`` f32 ``|X|`` (``magnitude``)
    or complex64 ``X``, DC-centred when ``shift``.  Launches K9 for CUDA
    tensors (raising for a size :func:`plan` refuses); CPU tensors take
    the plain version."""
    hop = int(hop)
    if x.device.type == "cpu":
        return fft_stream_reference(hist, x, window, hop, magnitude, shift)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    planar = _check(hist, x, window, hop)
    size = window.numel()
    p = plan(size, hop)
    for name, t in (("hist", hist), ("x", x), ("window", window)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    lead = x.shape[:-2] if planar else x.shape[:-1]
    H, n = hist.shape[-1], x.shape[-1]
    if H + n < size:
        raise ValueError("input shorter than one frame")
    nf = (H + n - size) // hop + 1
    out = torch.empty(lead + (nf, size), device=x.device,
                      dtype=torch.float32 if magnitude else torch.complex64)
    rows = int(np.prod(lead, dtype=np.int64))
    if rows == 0:
        return out
    tw = twiddles(size, x.device)
    KERNEL.launch("launch_fft_stream", x.device, ptr(hist), ptr(x),
                  ptr(window), ptr(tw), ptr(out), rows, H, n, nf, size, hop,
                  p["frames"], p["threads"], p["smem"], int(planar),
                  int(bool(magnitude)), int(bool(shift)))
    return out
