"""Plain DSP pieces the references are written in.

Whole streams, no blocks, no kernels: each function is a sum written out
over shifted views of one tensor, in any real float dtype (float64 for
the references, a lower one for the control).  A complex stream is a
pair ``(re, im)`` of real tensors, so the same code runs in bfloat16,
which has no complex type.  Nothing here imports the program.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

__all__ = ["remez", "hamming", "windowed_sinc", "quantize", "u8_planes",
           "fir", "resample", "resampler_history", "fm_demod",
           "one_pole", "dft_rows"]


def remez(numtaps: int, bands, desired, fs: float = 2.0) -> np.ndarray:
    """Parks-McClellan taps, held in float32 as the chain states them."""
    from scipy.signal import remez as _remez
    return _remez(numtaps, bands, desired, fs=fs).astype(np.float32)


def hamming(size: int) -> np.ndarray:
    n = np.arange(size)
    return (0.54 - 0.46 * np.cos(2 * np.pi * n / (size - 1))).astype(
        np.float32)


def windowed_sinc(size: int, cutoff: float) -> np.ndarray:
    """Hamming-windowed sinc low-pass, centred at ``(size - 1) // 2``,
    float32."""
    k = (size - 1) // 2 - np.arange(size)
    safe = np.where(k == 0, 1, k)
    s = np.where(k == 0, float(cutoff),
                 np.sin(np.pi * cutoff * k) / (safe * np.pi))
    return (s.astype(np.float32) * hamming(size)).astype(np.float32)


def quantize(taps: np.ndarray, qmax: float):
    """Integer taps ``round(t / max|t| * qmax)`` (half to even, in float32
    as the taps are held) and the scale that undoes them and the u8
    convert's 1/128: ``max|t| / qmax / 128``."""
    taps = np.asarray(taps, dtype=np.float32)
    maxabs = float(np.abs(taps).max()) or 1.0
    tq = np.round(taps / maxabs * qmax).astype(np.int64)
    return tq, maxabs / qmax / 128.0


def u8_planes(raw: torch.Tensor, dtype):
    """Interleaved u8 I/Q -> ``(v[0::2] - 128, v[1::2] - 128)`` in
    ``dtype`` (whole numbers, exact in every float type here)."""
    v = raw.to(torch.int16) - 128
    return v[..., 0::2].to(dtype), v[..., 1::2].to(dtype)


def fir(x: torch.Tensor, taps, step: int = 1, delay: int = 0,
        num: int | None = None) -> torch.Tensor:
    """``y[g] = sum_k taps[k] * x[g * step + k - delay]`` over the last
    axis, ``x`` zero before its start; ``num`` outputs (default: every
    one the input holds).  Sums run in tap order in ``x``'s dtype."""
    taps = [float(t) for t in np.asarray(taps, dtype=np.float64).ravel()]
    K = len(taps)
    if delay:
        x = F.pad(x, (delay, 0))
    n = x.shape[-1]
    if num is None:
        num = (n - K) // step + 1
    if num < 0 or (num > 0 and (num - 1) * step + K > n):
        raise ValueError(f"{num} outputs of {K} taps at step {step} need "
                         f"more than {n} samples")
    acc = torch.zeros(x.shape[:-1] + (num,), dtype=x.dtype, device=x.device)
    span = (num - 1) * step + 1
    for k, t in enumerate(taps):
        if t:
            acc.add_(x[..., k:k + span:step], alpha=t)
    return acc


def resampler_history(n_taps: int, up: int, down: int, offset: int,
                      n_in: int) -> int:
    """Input samples a block of ``n_in`` needs ahead of its own for the
    rational resampler ``y[m] = sum_j t[j] u[m * down - offset + j]`` (``u``
    the block's history and samples, zero-stuffed by ``up``): how far its
    last outputs read past the block's end, which the stream's alignment
    places before the block instead."""
    if (n_in * up) % down:
        raise ValueError(f"block {n_in} does not give whole outputs at "
                         f"{up}/{down}")
    if up == 1:
        return max(0, n_taps - down)
    n_out = n_in * up // down
    last = 0
    for m in range(max(0, n_out - up), n_out):
        t = m * down - offset
        o = (-t) % up
        i = (t + o) // up
        reads = -(-(n_taps - o) // up)
        last = max(last, i + reads - 1)
    return max(0, last - n_in + 1)


def resample(x: torch.Tensor, taps, up: int, down: int, shift: int,
             num: int) -> torch.Tensor:
    """Rational resampler over the whole stream: ``x`` zero-stuffed by
    ``up`` into ``u``, then ``y[g] = sum_j taps[j] * u[g * down - shift +
    j]`` (``u`` zero before its start)."""
    u = torch.zeros(x.shape[:-1] + (x.shape[-1] * up,), dtype=x.dtype,
                    device=x.device)
    u[..., ::up] = x
    return fir(u, taps, step=down, delay=shift, num=num)


def fm_demod(re: torch.Tensor, im: torch.Tensor,
             signed_zero: bool) -> torch.Tensor:
    """``angle(z[n] * conj(z[n - 1]))`` with ``z[-1] = 0``, the product
    written out as ``(re*pre - im*(-pim), re*(-pim) + im*pre)``.  Where it
    is zero (the stream's first sample) the angle is 0, or with
    ``signed_zero`` the IEEE angle of the signed zeros that product gives
    (pi where both parts of ``z[0]`` are negative)."""
    pre = F.pad(re[..., :-1], (1, 0))
    pim = F.pad(im[..., :-1], (1, 0))
    d = -pim
    a = re * pre - im * d
    b = re * d + im * pre
    if a.dtype in (torch.float32, torch.float64):
        y = torch.atan2(b, a)
    else:       # atan2 of the lower type's values, rounded back to it
        y = torch.atan2(b.float(), a.float()).to(a.dtype)
    if not signed_zero:
        y = torch.where((a == 0) & (b == 0), torch.zeros_like(y), y)
    return y


def one_pole(x: torch.Tensor, b0: float, b1: float, pole: float,
             floor: float = 1e-18) -> torch.Tensor:
    """``y[n] = b0 x[n] + b1 x[n-1] + pole * y[n-1]`` from rest, as the
    sum of its impulse response ``pole^k`` over the drive, cut where
    ``|pole|^k`` falls under ``floor`` (below float64's rounding)."""
    drive = fir(x, [b1, b0], delay=1, num=x.shape[-1])
    L = int(math.ceil(math.log(floor) / math.log(abs(pole))))
    return fir(drive, [pole ** (L - 1 - k) for k in range(L)],
               delay=L - 1, num=x.shape[-1])


def dft_rows(re: torch.Tensor, im: torch.Tensor):
    """``Y[..., c] = sum_r exp(-2 pi i c r / C) * v[..., r]`` over the last
    axis (C = its size), by a product with the transform's cosine and
    sine tables in the inputs' dtype."""
    C = re.shape[-1]
    k = np.arange(C)
    ang = 2 * np.pi * np.outer(k, k) / C
    cos = torch.as_tensor(np.cos(ang), dtype=re.dtype, device=re.device)
    sin = torch.as_tensor(np.sin(ang), dtype=re.dtype, device=re.device)
    return re @ cos.T + im @ sin.T, im @ cos.T - re @ sin.T
