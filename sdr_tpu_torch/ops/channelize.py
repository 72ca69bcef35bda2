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
last one for the FFT; one transpose gives ``[..., C, M]``.  Plain
PyTorch elementwise work and ``torch.fft``, as the JAX package leaves
them to XLA.  Not ported: the JAX package's ``'gather'`` form, its
differential oracle (the tests hold this form against both).
"""

from __future__ import annotations

import numpy as np
import torch

from sdr_tpu_torch.ops import design

__all__ = ["channelizer_taps", "polyphase_channelize"]


def channelizer_taps(n_channels: int, taps_per_branch: int = 8,
                     cutoff_scale: float = 1.0) -> np.ndarray:
    """Prototype low-pass for a C-channel filterbank: a Hamming windowed
    sinc with cutoff 1/C (scaled), ``C * taps_per_branch`` taps."""
    n = n_channels * taps_per_branch
    return design.windowed_sinc(n, cutoff_scale / n_channels,
                                design.hamming) * n_channels


def polyphase_channelize(taps, n_channels: int, x: torch.Tensor,
                         num: int | None = None) -> torch.Tensor:
    """Complex wideband ``[..., N]`` -> channel streams ``[..., C, M]``
    (a transposed view of the FFT's output).

    ``taps``: the prototype low-pass (an array, or an f32 tensor on
    ``x``'s device, which a stream op keeps there), zero-padded to a
    multiple of C.  Channel c is centred at +c/C cycles a sample.
    ``num`` limits the samples a channel (default: all computable,
    ``M = N // C - P + 1`` with P taps a branch)."""
    C = int(n_channels)
    taps = torch.as_tensor(taps, dtype=torch.float32, device=x.device)
    P = -(-taps.shape[0] // C)
    hb = torch.nn.functional.pad(taps, (0, C * P - taps.shape[0])).view(P, C)
    m_total = x.shape[-1] // C
    x = x[..., : m_total * C]
    if num is None:
        num = m_total - P + 1
    num = int(num)
    if num < 1:
        raise ValueError("input shorter than one filterbank window")
    x2 = x.reshape(x.shape[:-1] + (m_total, C))           # [..., m, r]
    v = x2[..., 0:num, :] * hb[0]
    for p in range(1, P):
        v += x2[..., p:p + num, :] * hb[p]
    return torch.fft.fft(v, dim=-1).transpose(-1, -2)      # [..., C, num]
