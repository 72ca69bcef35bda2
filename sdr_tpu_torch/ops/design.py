"""FIR filter design (host-side numpy; counterpart of sdr_tpu/ops/design.py).

Only what the broadcast-FM chain needs: the sinc prototype, the Hamming
window, windowed sinc and scipy's Parks-McClellan ``remez``.  The
arithmetic is the JAX package's, step for step, so ``fm_taps`` gives
bitwise the same taps.
"""

from __future__ import annotations

import numpy as np

__all__ = ["sinc", "hamming", "windowed_sinc", "remez"]


def sinc(size: int, cutoff: float) -> np.ndarray:
    """Sampled sinc low-pass prototype; ``size`` should be odd.  Value at
    the centre is ``cutoff``; elsewhere ``sin(pi*cutoff*k)/(k*pi)``."""
    k = (size - 1) // 2 - np.arange(size)
    out = np.where(k == 0, float(cutoff),
                   np.sin(np.pi * cutoff * k) / (np.where(k == 0, 1, k) * np.pi))
    return out.astype(np.float32)


def hamming(size: int) -> np.ndarray:
    """Hamming window."""
    n = np.arange(size)
    return (0.54 - 0.46 * np.cos(2 * np.pi * n / (size - 1))).astype(np.float32)


def windowed_sinc(size: int, cutoff: float, window) -> np.ndarray:
    """Windowed-sinc FIR design."""
    return (sinc(size, cutoff) * window(size)).astype(np.float32)


def remez(numtaps: int, bands, desired, fs: float = 2.0) -> np.ndarray:
    """Parks-McClellan equiripple design (scipy.signal.remez conventions)."""
    from scipy.signal import remez as _remez
    return _remez(numtaps, bands, desired, fs=fs).astype(np.float32)
