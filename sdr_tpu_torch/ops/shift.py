"""Frequency shifting (counterpart of sdr_tpu/ops/shift.py).

``half_band_up`` / ``quarter_band_up`` shift a spectrum by fs/2 and fs/4;
``oscillator`` is the general local oscillator of a mixer.  The tables
are made on the host in float64 and cast, as the JAX package makes them,
so they are bitwise the JAX package's; ``device`` places them (the card
unless the caller names the CPU).
"""

from __future__ import annotations

import numpy as np
import torch

from sdr_tpu_torch.utils.device import resolve_device

__all__ = ["half_band_up", "quarter_band_up", "mix", "oscillator",
           "oscillator_planar"]


def half_band_up(size: int, dtype=torch.float32, device="cuda"):
    """``[1, -1, 1, -1, ...]``: multiply to shift up by fs/2."""
    v = np.ones(size, dtype=np.float32)
    v[1::2] = -1.0
    return torch.as_tensor(v, device=resolve_device(device)).to(dtype)


def quarter_band_up(size: int, dtype=torch.complex64, device="cuda"):
    """``[1, i, -1, -i, ...]``: multiply to shift up by fs/4."""
    v = np.zeros(size, dtype=np.complex64)
    v[0::4], v[1::4], v[2::4], v[3::4] = 1, 1j, -1, -1j
    return torch.as_tensor(v, device=resolve_device(device)).to(dtype)


def _angles(size: int, freq: float, phase: float) -> np.ndarray:
    return 2 * np.pi * freq * np.arange(size, dtype=np.float64) + phase


def oscillator(size: int, freq: float, phase: float = 0.0, device="cuda"):
    """complex64 ``exp(j*(2*pi*freq*n + phase))`` for n in [0, size);
    ``freq`` in cycles/sample."""
    v = np.exp(1j * _angles(size, freq, phase)).astype(np.complex64)
    return torch.as_tensor(v, device=resolve_device(device))


def oscillator_planar(size: int, freq: float, phase: float = 0.0,
                      device="cuda"):
    """The planar form of :func:`oscillator`: ``[2, size]`` f32 rows
    ``(cos, sin)``."""
    ang = _angles(size, freq, phase)
    v = np.stack([np.cos(ang), np.sin(ang)]).astype(np.float32)
    return torch.as_tensor(v, device=resolve_device(device))


def mix(x: torch.Tensor, lo: torch.Tensor) -> torch.Tensor:
    """Multiply a block by a local-oscillator vector (frequency shift)."""
    return x * lo
