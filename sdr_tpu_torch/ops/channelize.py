"""Polyphase DFT-filterbank channelizer (counterpart of
sdr_tpu/ops/channelize.py).

Channel c of C is "mix down by c/C, low-pass, decimate by C":

    y_c[m] = sum_r w^{-cr} * v[r, m],        w = e^{2*pi*i/C}
    v[r, m] = sum_p h[pC + r] * x[(m + p)C + r]

that is, split x into C polyphase branches, filter branch r with the
taps ``h[r::C]``, then one FFT across the branches.  The branch filter
is the JAX package's stencil form: the row-major view ``x2[..., m, r] =
x[..., mC + r]`` read as P shifted views weighted by the tap rows,
summed in the order p = 0..P-1, so the branch axis is the contiguous
last one for the FFT; one transpose gives ``[..., C, M]``.  On the card
the stencil and the FFT are one launch, K7 + DFT, where C is a power of
two from 64 to 1,024 whose tile fits a block (``kernels/channelize.py``,
``dft_route``); any other C takes the stencil on K7, then ``torch.fft``
(cuFFT).
Not ported: the JAX package's ``'gather'`` form, its differential oracle
(the tests hold this form against both).
"""

from __future__ import annotations

import numpy as np
import torch

from sdr_tpu_torch.kernels.channelize import (branch_dft, branch_filter,
                                              dft_route)
from sdr_tpu_torch.ops import design

__all__ = ["branch_taps", "channelize_rows", "channelizer_taps",
           "polyphase_channelize"]


def channelizer_taps(n_channels: int, taps_per_branch: int = 8,
                     cutoff_scale: float = 1.0) -> np.ndarray:
    """Prototype low-pass for a C-channel filterbank: a Hamming windowed
    sinc with cutoff 1/C (scaled), ``C * taps_per_branch`` taps."""
    n = n_channels * taps_per_branch
    return design.windowed_sinc(n, cutoff_scale / n_channels,
                                design.hamming) * n_channels


def branch_taps(taps, n_channels: int, device=None) -> torch.Tensor:
    """The prototype's tap rows ``hb[p, r] = h[p*C + r]``, f32 ``[P, C]``
    on ``device``, zero-padded to a multiple of C."""
    C = int(n_channels)
    taps = torch.as_tensor(taps, dtype=torch.float32, device=device)
    P = -(-taps.shape[0] // C)
    return torch.nn.functional.pad(
        taps, (0, C * P - taps.shape[0])).view(P, C).contiguous()


def channelize_rows(hb: torch.Tensor, hist: torch.Tensor, x: torch.Tensor,
                    num: int) -> torch.Tensor:
    """The filterbank over ``cat(hist, x)`` with the tap rows ``hb``:
    ``num`` samples a channel, ``[..., C, num]`` (a transposed view of the
    DFT's output).  One launch, K7 + DFT, where ``dft_route`` says
    ``"fused"``; else K7, then ``torch.fft``.  Both read ``hist`` and
    ``x`` through two pointers; CPU tensors take the plain versions."""
    P, C = hb.shape
    if dft_route(C, P) == "fused":
        return branch_dft(hb, hist, x, num).transpose(-1, -2)
    v = branch_filter(hb, hist, x, num)                    # [..., m, r]
    return torch.fft.fft(v, dim=-1).transpose(-1, -2)      # [..., C, num]


def polyphase_channelize(taps, n_channels: int, x: torch.Tensor,
                         num: int | None = None) -> torch.Tensor:
    """Complex wideband ``[..., N]`` -> channel streams ``[..., C, M]``
    (a transposed view of the FFT's output).

    ``taps``: the prototype low-pass (an array, or an f32 tensor on
    ``x``'s device), zero-padded to a multiple of C.  Channel c is centred
    at +c/C cycles a sample.  ``num`` limits the samples a channel
    (default: all computable, ``M = N // C - P + 1`` with P taps a
    branch)."""
    hb = branch_taps(taps, n_channels, x.device)
    P, C = hb.shape
    if num is None:
        num = x.shape[-1] // C - P + 1
    num = int(num)
    if num < 1:
        raise ValueError("input shorter than one filterbank window")
    x = x.contiguous()
    return channelize_rows(hb, x.new_empty(x.shape[:-1] + (0,)), x, num)
