"""Seeded RTL-SDR capture of one FM broadcast: u8 interleaved I/Q.

The station's programme comes from the seed (signals/_tones.py): mono,
a set of tones and a band of weaker cosines at up to 75 kHz deviation;
stereo, the pilot-tone multiplex of ITU-R BS.450 built from two such
programmes L and R,

    0.9 * ((L + R) / 2 + (L - R) / 2 * cos(2 (w_p t + th_p))) + 0.1 * cos(w_p t + th_p)

with ``w_p`` the 19 kHz pilot, and one run of ``mono_blocks`` consecutive
blocks, placed by the seed, where the station sends mono (pilot and L-R
off).  The carrier is ``amplitude`` in full scale with seeded Gaussian
noise, quantised as an RTL-SDR does: ``clamp(round(v * 128 + 128))``.

Traffic keys read: ``blocks``, ``block_bytes`` (one call's recording),
``multiplex`` ('mono' or 'stereo'), ``tones``, ``band``,
``deviation_hz``, ``amplitude``, ``noise``, ``mono_blocks``, and
``fs_in`` from the configuration.  Rank ``r`` of ``world`` makes samples
``[r n, (r + 1) n)`` of one recording of ``world * n``.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench.signals._tones import Programme, audio, seeds

__all__ = ["make", "programme"]

CHUNK = 1 << 17
PILOT_HZ = 19_000.0


def programme(traffic: dict, fs: float, seed: int,
              world: int = 1) -> Programme:
    rng = seeds(seed, 1)
    p = Programme()
    tones, band = traffic["tones"], traffic["band"]
    if traffic["multiplex"] == "mono":
        p.add(*audio(rng, tones, band))
        return p
    if traffic["multiplex"] != "stereo":
        raise ValueError(f"unknown multiplex {traffic['multiplex']!r}")
    (al, fl, tl), (ar, fr, tr) = (audio(rng, tones, band),
                                  audio(rng, tones, band))
    th = rng.uniform(0, 2 * np.pi)
    block_s = traffic["block_bytes"] / 2 / fs
    total = traffic["blocks"] * world
    k = traffic["mono_blocks"]
    start = int(rng.integers(1, total - k + 1))
    off = (start * block_s, (start + k) * block_s)
    p.add(0.45 * al, fl, tl)
    p.add(0.45 * ar, fr, tr)
    p.add(0.1, PILOT_HZ, th, off)
    for a, f, t in ((al, fl, tl), (-ar, fr, tr)):
        p.add(0.225 * a, 2 * PILOT_HZ + f, 2 * th + t, off)
        p.add(0.225 * a, 2 * PILOT_HZ - f, 2 * th - t, off)
    return p


def make(traffic: dict, cfg: dict, seed: int, rank: int = 0,
         world: int = 1, device="cuda") -> torch.Tensor:
    """Rank ``rank``'s recording for one call: ``blocks * block_bytes``
    u8 bytes on ``device``."""
    fs = float(cfg["fs_in"])
    prog = programme(traffic, fs, seed, world)
    tables = prog.tables(device)
    n = traffic["blocks"] * traffic["block_bytes"] // 2
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seeds(seed, 2, rank).integers(1 << 62)))
    raw = torch.empty(n, 2, dtype=torch.uint8, device=device)
    amp, noise = float(traffic["amplitude"]), float(traffic["noise"])
    for s in range(0, n, CHUNK):
        m = min(CHUNK, n - s)
        t = torch.arange(rank * n + s, rank * n + s + m,
                         dtype=torch.float64, device=device) / fs
        phi = Programme.phase(tables, t, traffic["deviation_hz"])[0]
        iq = torch.stack([torch.cos(phi), torch.sin(phi)], -1).mul_(amp)
        iq.add_(torch.randn(m, 2, generator=gen, dtype=torch.float64,
                            device=device), alpha=noise)
        raw[s:s + m] = iq.mul_(128).add_(128).round_().clamp_(0, 255).to(
            torch.uint8)
    return raw.view(-1)
