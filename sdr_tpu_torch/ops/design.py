"""FIR filter design (host-side numpy; counterpart of sdr_tpu/ops/design.py).

The sinc prototype, the Hann, Hamming and Blackman windows, windowed
sinc (Hann by default, as in the JAX package), the square-root raised
cosine, scipy's Parks-McClellan ``remez``, and a linear-phase FIR's
magnitude response (``frequency_response``, ``plot_frequency``).  The
arithmetic is the JAX package's, step for step, so the windows and
``fm_taps`` are bitwise the same.

Every design the chains run (``remez``, scipy's import included, and
``windowed_sinc``) is the set-up span ``design``, counted in
``profiling.totals()``.
"""

from __future__ import annotations

import numpy as np

from sdr_tpu_torch.utils.profiling import setup

__all__ = ["sinc", "hanning", "hamming", "blackman", "windowed_sinc",
           "srrc", "remez", "frequency_response", "plot_frequency"]


def sinc(size: int, cutoff: float) -> np.ndarray:
    """Sampled sinc low-pass prototype; ``size`` should be odd.  Value at
    the centre is ``cutoff``; elsewhere ``sin(pi*cutoff*k)/(k*pi)``."""
    k = (size - 1) // 2 - np.arange(size)
    out = np.where(k == 0, float(cutoff),
                   np.sin(np.pi * cutoff * k) / (np.where(k == 0, 1, k) * np.pi))
    return out.astype(np.float32)


def hanning(size: int) -> np.ndarray:
    """Hann window."""
    n = np.arange(size)
    return (0.5 * (1 - np.cos(2 * np.pi * n / (size - 1)))).astype(np.float32)


def hamming(size: int) -> np.ndarray:
    """Hamming window."""
    n = np.arange(size)
    return (0.54 - 0.46 * np.cos(2 * np.pi * n / (size - 1))).astype(np.float32)


def blackman(size: int) -> np.ndarray:
    """Blackman window."""
    n = np.arange(size)
    return (0.42 - 0.5 * np.cos(2 * np.pi * n / (size - 1))
            + 0.08 * np.cos(4 * np.pi * n / (size - 1))).astype(np.float32)


def windowed_sinc(size: int, cutoff: float, window=hanning) -> np.ndarray:
    """Windowed-sinc FIR design."""
    with setup("design"):
        return (sinc(size, cutoff) * window(size)).astype(np.float32)


def remez(numtaps: int, bands, desired, fs: float = 2.0) -> np.ndarray:
    """Parks-McClellan equiripple design (scipy.signal.remez conventions)."""
    with setup("design"):
        from scipy.signal import remez as _remez
        return _remez(numtaps, bands, desired, fs=fs).astype(np.float32)


def srrc(n: int, ts: int, beta: float) -> np.ndarray:
    """Square-root raised cosine pulse over [-n, n] at ``ts`` samples a
    symbol and roll-off ``beta``, with the limits at x = 0 and at
    |x| = ts / (4 beta)."""
    xs = np.arange(-n, n + 1, dtype=np.float64)
    out = np.empty_like(xs)
    for i, x in enumerate(xs):
        if x == 0:
            out[i] = 1 - beta + 4 * beta / np.pi
        elif abs(abs(x) - ts / (4 * beta)) < 0.001:
            out[i] = (beta / np.sqrt(2)) * (
                (1 + 2 / np.pi) * np.sin(np.pi / (4 * beta))
                + (1 - 2 / np.pi) * np.cos(np.pi / (4 * beta)))
        else:
            xd = x / ts
            out[i] = (np.sin(np.pi * xd * (1 - beta))
                      + 4 * beta * xd * np.cos(np.pi * xd * (1 + beta))) / (
                np.pi * xd * (1 - (4 * beta * xd) ** 2))
    return out.astype(np.float32)


def frequency_response(taps, n: int = 512):
    """``(freqs, |H|)`` of a linear-phase FIR at ``n`` frequencies in
    [0, 1) of Nyquist, the taps rotated about their centre."""
    taps = np.asarray(taps, dtype=np.float64)
    w = np.linspace(0, np.pi, n, endpoint=False)
    idx = np.arange(len(taps)) - (len(taps) - 1) / 2
    H = (taps[None, :] * np.exp(-1j * w[:, None] * idx)).sum(axis=1)
    return w / np.pi, np.abs(H)


def plot_frequency(taps, filename: str) -> None:
    """Save a PNG of the filter's magnitude response (matplotlib, imported
    only here: hosts without it can design filters all the same)."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    f, mag = frequency_response(taps)
    fig, ax = plt.subplots(figsize=(8, 4.5))
    ax.plot(f, mag)
    ax.set_title("Frequency Response")
    ax.set_xlabel("frequency (fraction of Nyquist)")
    ax.set_ylabel("|H|")
    fig.savefig(filename, dpi=100)
    plt.close(fig)
