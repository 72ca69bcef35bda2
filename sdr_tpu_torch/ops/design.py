"""FIR filter design (host-side numpy; counterpart of sdr_tpu/ops/design.py).

What the receive chains need: the sinc prototype, the Hann, Hamming and
Blackman windows, windowed sinc (Hann by default, as in the JAX package)
and scipy's Parks-McClellan ``remez``.  The arithmetic is the JAX
package's, step for step, so the windows and ``fm_taps`` are bitwise the
same.
"""

from __future__ import annotations

import numpy as np

__all__ = ["sinc", "hanning", "hamming", "blackman", "windowed_sinc",
           "remez"]


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
    return (sinc(size, cutoff) * window(size)).astype(np.float32)


def remez(numtaps: int, bands, desired, fs: float = 2.0) -> np.ndarray:
    """Parks-McClellan equiripple design (scipy.signal.remez conventions)."""
    from scipy.signal import remez as _remez
    return _remez(numtaps, bands, desired, fs=fs).astype(np.float32)
