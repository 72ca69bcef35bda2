"""Seeded wideband capture of a band of FM stations: complex64.

``channels`` stations, station ``c`` at ``+c / channels`` cycles a sample
of the wideband rate, each an FM broadcast of its own seeded programme
(signals/_tones.py: ``tones`` tones and ``band`` weaker cosines at up to
``deviation_hz``), ``amplitude`` in full scale, over seeded complex
Gaussian noise of ``noise`` a part.  Each station's carrier phase is exact:
``c (k mod channels) / channels`` turns at sample ``k``.

Traffic keys read: ``blocks``, ``block_len`` (one call's capture),
``tones``, ``band``, ``deviation_hz``, ``amplitude``, ``noise``; the
configuration's ``fs_in`` and ``bank.channels``.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench.signals._tones import Programme, audio, seeds

__all__ = ["make", "programme"]

CHUNK = 1 << 16


def programme(traffic: dict, channels: int, seed: int) -> Programme:
    rng = seeds(seed, 3)
    p = Programme()
    for _ in range(channels):
        p.add(*audio(rng, traffic["tones"], traffic["band"]))
    return p


def make(traffic: dict, cfg: dict, seed: int, rank: int = 0,
         world: int = 1, device="cuda") -> torch.Tensor:
    """Rank ``rank``'s capture for one call: ``blocks * block_len``
    complex64 samples on ``device``."""
    C = cfg["bank"]["channels"]
    fs = float(cfg["fs_in"])
    tables = programme(traffic, C, seed).tables(device)
    n = traffic["blocks"] * traffic["block_len"]
    if n % C or CHUNK % C:
        raise ValueError(f"{n} samples are not whole frames of {C}")
    r = np.arange(C)
    carrier = torch.as_tensor(2 * np.pi * np.outer(r, r) / C,
                              device=device)[:, None, :]   # [c, 1, k mod C]
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seeds(seed, 4, rank).integers(1 << 62)))
    out = torch.empty(n, 2, dtype=torch.float32, device=device)
    amp, noise = float(traffic["amplitude"]), float(traffic["noise"])
    base = rank * n
    for s in range(0, n, CHUNK):
        m = min(CHUNK, n - s)
        t = torch.arange(base + s, base + s + m, dtype=torch.float64,
                         device=device) / fs
        phi = Programme.phase(tables, t, traffic["deviation_hz"], C)
        ang = phi.view(C, m // C, C).add_(carrier)      # [c, frame, k mod C]
        iq = torch.stack([torch.cos(ang).sum(0), torch.sin(ang).sum(0)],
                         -1).view(m, 2).mul_(amp)
        iq.add_(torch.randn(m, 2, generator=gen, dtype=torch.float64,
                            device=device), alpha=noise)
        out[s:s + m] = iq
    return torch.view_as_complex(out)
