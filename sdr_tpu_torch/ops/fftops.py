"""Spectral analysis: FFTs, windowed frames, spectrogram and waterfall
image (counterpart of sdr_tpu/ops/fftops.py).

The FFTs here are ``torch.fft`` (cuFFT on the card, pocketfft on the
CPU), as the JAX package's are XLA's FFT call; frames of every block are
batched into one transform, which keeps them in order.  The waterfall's
``FftStream`` does not come here on the card: at a power-of-two frame
size from 64 to 16,384 it runs K9 (``kernels/fft_stream.py``), the port's
own FFT fused with the framing, window, ``|X|`` and shift; at any other
size it comes back to ``frame`` and ``fft`` (cuFFT).  ``spectrogram``
is the next user K9 could take (ROADMAP).  Not ported:
``fft_mxu``, ``fft_mxu_planar``, ``fft_precision`` and their crossover
policy, which exist for the TPU's matrix unit.
"""

from __future__ import annotations

import numpy as np
import torch

from sdr_tpu_torch.ops import design

__all__ = ["fft", "rfft", "frame", "spectrogram", "waterfall_image"]


def fft(x: torch.Tensor, axis: int = -1) -> torch.Tensor:
    """Complex-to-complex DFT (unnormalised forward, FFTW convention),
    batched over the other axes."""
    return torch.fft.fft(x, dim=axis)


def rfft(x: torch.Tensor, axis: int = -1) -> torch.Tensor:
    """Real-to-complex DFT, ``n // 2 + 1`` bins."""
    return torch.fft.rfft(x, dim=axis)


def frame(x: torch.Tensor, size: int, hop: int | None = None,
          window=None) -> torch.Tensor:
    """Slice ``[..., N]`` into overlapping frames ``[..., num, size]``,
    ``num = (N - size) // hop + 1``; ``hop`` defaults to ``size``.
    ``window`` (``[size]``, an array or a tensor on ``x``'s device, which
    a stream op keeps there so no call copies from the host) tapers every
    frame, which makes the frames a new tensor; without it they are a
    view of ``x``."""
    if hop is None:
        hop = size
    if (x.shape[-1] - size) // hop + 1 < 1:
        raise ValueError("input shorter than one frame")
    frames = x.unfold(-1, size, hop)
    if window is not None:
        frames = frames * torch.as_tensor(window, dtype=torch.float32,
                                          device=x.device)
    return frames


def spectrogram(x: torch.Tensor, size: int, hop: int | None = None,
                window=None, shift: bool = True) -> torch.Tensor:
    """Windowed overlapping FFT magnitude frames ``[..., num, size]``
    (``|X|``), DC-centred when ``shift``; the window defaults to Hann."""
    if window is None:
        window = design.hanning(size)
    F = fft(frame(x, size, hop, window))
    if shift:
        F = torch.fft.fftshift(F, dim=-1)
    return F.abs()


def waterfall_image(rows, filename: str, db: bool = True,
                    ylabel: str = "frame") -> None:
    """Save a spectrogram ``[frames, bins]`` as a PNG waterfall
    (matplotlib, imported here), whatever ``filename``'s suffix."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    rows = np.asarray(rows)
    if db:
        rows = 20 * np.log10(np.maximum(rows, 1e-12))
    fig, ax = plt.subplots(figsize=(10, 6))
    ax.imshow(rows, aspect="auto", origin="lower", cmap="viridis")
    ax.set_xlabel("frequency bin")
    ax.set_ylabel(ylabel)
    fig.savefig(filename, dpi=100, format="png")
    plt.close(fig)
