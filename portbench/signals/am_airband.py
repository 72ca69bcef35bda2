"""Seeded RTL-SDR capture of the VHF airband: u8 interleaved I/Q.

Every carrier is double-sideband AM,

    s_c(n) = key_c(n) A_c (1 + m_c a_c(n / fs)) exp(j (2 pi f_c n + phi_c))

with ``a_c`` a voice-band programme (signals/_tones.py ``audio``: weights
summing to 1, so ``|a_c| <= 1``), ``m_c`` its depth, ``key_c`` its
push-to-talk keying (:func:`keying`) and ``phi_c`` a seeded phase.

* The wanted station: ``f = +0.25`` cycles a sample (a quarter band off
  the dongle's centre), ``A = amplitude``, ``m`` seeded in ``am_depth``,
  ``tones`` tones and ``band`` weaker cosines in ``audio_hz``.  Its keying
  is anchored to the blocks: one burst ends exactly on a block seam and
  the gap after it outlasts a block (a whole block unkeyed), and a later
  gap ends exactly on a seam (a key-up on a seam).
* ``interferers`` other stations on the ``raster_hz`` raster, each at
  least ``interferer_min_offset_hz`` from the wanted one and within 0.45
  of the sample rate of the centre, each with its own ``tones`` tones,
  amplitude in ``interferer_amplitude``, depth in ``interferer_depth``
  and keying.
* Complex Gaussian noise of ``noise`` a part.

Every carrier's frequency is a ratio ``p / q`` of the sample rate, so its
phase at sample ``n`` is ``2 pi ((p n) mod q) / q + phi`` exactly, and the
programmes are cosines of ``n / fs`` in float64: any span of the
recording is made from the absolute sample index alone, and a rank makes
its own span of a longer recording.  Quantised as an RTL-SDR does,
``clamp(round(v * 128 + 128))``: the carriers at full modulation plus 4
sigma of noise must stay under full scale (raises otherwise), and a
recording in which a sample was clamped raises.

Traffic keys read: ``blocks``, ``block_bytes``, ``amplitude``, ``tones``,
``band``, ``audio_hz``, ``am_depth``, ``keying`` (``"bursts 1-8 s, gaps
1-6 s"``), ``interferers``, ``interferer_amplitude``, ``interferer_depth``,
``raster_hz``, ``interferer_min_offset_hz``, ``noise``; ``fs_in`` from the
configuration.  Ranges are ``"lo-hi"``.  Rank ``r`` of ``world`` makes
samples ``[r n, (r + 1) n)`` of one recording of ``world * n``.
"""

from __future__ import annotations

import math
import re
from fractions import Fraction

import numpy as np
import torch

from portbench.signals._tones import audio, seeds

__all__ = ["make", "stations", "keying", "FULL_SCALE"]

CHUNK = 1 << 17
WANTED = Fraction(1, 4)         # cycles a sample
EDGE = 0.45                     # the carriers' limit, a share of fs
FULL_SCALE = 127 / 128          # the largest sample v that round() keeps


def _range(text: str) -> tuple:
    lo, hi = (float(v) for v in str(text).split("-"))
    return lo, hi


def _keying_spec(text: str, fs: float) -> tuple:
    """``"bursts a-b s, gaps c-d s"`` -> ((a, b), (c, d)) in samples."""
    got = re.fullmatch(r"\s*bursts\s+([\d.]+)-([\d.]+)\s*s,\s*gaps\s+"
                       r"([\d.]+)-([\d.]+)\s*s\s*", text)
    if got is None:
        raise ValueError(f"keying {text!r} is not 'bursts a-b s, gaps c-d s'")
    v = [round(float(g) * fs) for g in got.groups()]
    return (v[0], v[1]), (v[2], v[3])


def keying(rng, spec: tuple, block: int, total: int,
           anchored: bool) -> list:
    """The spans ``[start, end)`` of samples in which a carrier is on,
    alternating with gaps from a seeded first state until ``total``: each
    burst and gap of a seeded length in ``spec`` = ((burst lo, hi), (gap
    lo, hi)) samples.

    ``anchored``: burst 0 or 1 (seeded) ends on the first block seam at
    least a shortest burst after its start, the gap after it lasts longer
    than a block (so the block from that seam is wholly unkeyed), and the
    first or second gap after that (seeded) ends on the first seam at
    least a shortest gap after its start: a key-down and a key-up on
    seams, each length still in its range.  Raises where the blocks are
    too long for that, or the anchors fall past ``total``."""
    (b_lo, b_hi), (g_lo, g_hi) = spec
    if anchored and not block <= min(b_hi - b_lo, g_hi - g_lo):
        raise ValueError(f"a block of {block} samples is longer than the "
                         f"bursts' or gaps' range ({spec}) allows: no seam "
                         "anchors, no whole block unkeyed")
    down = int(rng.integers(2))         # the burst that ends on a seam
    up = 1 + int(rng.integers(2))       # the gap after the long one
    on = bool(rng.integers(2))
    t, bursts, after, spans = 0, 0, None, []
    anchors = []

    def seam_after(u):
        return -(-u // block) * block

    while t < total:
        if on:
            if anchored and bursts == down:
                end = seam_after(t + b_lo)
                anchors.append(end)
                after = 0
            else:
                end = t + int(rng.integers(b_lo, b_hi + 1))
            spans.append((t, end))
            bursts += 1
        elif after == 0:                # the long gap
            end = t + int(rng.integers(block + 1, g_hi + 1))
            after = 1
        elif after is not None and after == up:
            end = seam_after(t + g_lo)
            anchors.append(end)
            after = None
        else:
            end = t + int(rng.integers(g_lo, g_hi + 1))
            if after is not None:
                after += 1
        t, on = end, not on
    if anchored and (len(anchors) < 2 or anchors[1] >= total):
        raise ValueError("the keying's seam anchors fall past the "
                         f"recording of {total} samples")
    return spans


def stations(traffic: dict, cfg: dict, seed: int, world: int = 1) -> list:
    """The carriers, the wanted one first: dicts of ``freq`` (a Fraction
    of fs), ``amp``, ``depth``, ``phase``, ``programme`` ``(amp, freq,
    theta)`` and ``keying`` (on spans over the ``world`` ranks'
    recording)."""
    fs = float(cfg["fs_in"])
    rng = seeds(seed, 6)
    block = traffic["block_bytes"] // 2
    total = traffic["blocks"] * block * world
    spec = _keying_spec(traffic["keying"], fs)
    f_lo, f_hi = _range(traffic["audio_hz"])
    out = [{"freq": WANTED, "amp": float(traffic["amplitude"]),
            "depth": float(rng.uniform(*_range(traffic["am_depth"]))),
            "phase": float(rng.uniform(0, 2 * np.pi)),
            "programme": audio(rng, traffic["tones"], traffic["band"],
                               f_lo, f_hi),
            "keying": keying(rng, spec, block, total, anchored=True)}]
    step = Fraction(int(traffic["raster_hz"])) / Fraction(int(fs))
    least = math.ceil(traffic["interferer_min_offset_hz"]
                      / traffic["raster_hz"])
    reach = int(1 / step)
    allowed = [k for k in range(-reach, reach + 1) if abs(k) >= least
               and abs(float(WANTED + k * step)) <= EDGE]
    for k in rng.choice(allowed, traffic["interferers"], replace=False):
        out.append({
            "freq": WANTED + int(k) * step,
            "amp": float(rng.uniform(*_range(
                traffic["interferer_amplitude"]))),
            "depth": float(rng.uniform(*_range(
                traffic["interferer_depth"]))),
            "phase": float(rng.uniform(0, 2 * np.pi)),
            "programme": audio(rng, traffic["tones"], 0, f_lo, f_hi),
            "keying": keying(rng, spec, block, total, anchored=False)})
    return out


def _spans(spans, device) -> tuple:
    return tuple(torch.as_tensor([sp[i] for sp in spans], dtype=torch.int64,
                                 device=device) for i in (0, 1))


def _key(starts: torch.Tensor, ends: torch.Tensor,
         n: torch.Tensor) -> torch.Tensor:
    """1 where sample ``n`` lies in an on span ``[starts, ends)``, else 0
    (float64)."""
    i = torch.searchsorted(starts, n, right=True) - 1
    on = (i >= 0) & (n < ends[i.clamp(min=0)])
    return on.to(torch.float64)


def make(traffic: dict, cfg: dict, seed: int, rank: int = 0,
         world: int = 1, device="cuda") -> torch.Tensor:
    """Rank ``rank``'s recording for one call: ``blocks * block_bytes``
    u8 bytes on ``device``."""
    fs = float(cfg["fs_in"])
    carriers = stations(traffic, cfg, seed, world)
    noise = float(traffic["noise"])
    worst = sum(c["amp"] * (1 + c["depth"]) for c in carriers) + 4 * noise
    if worst > FULL_SCALE:
        raise ValueError(f"the carriers at full modulation with 4 sigma of "
                         f"noise reach {worst:.4f} of full scale: the "
                         "recording would clip")
    C = len(carriers)
    rows = [(ci, a, 2 * np.pi * f, th) for ci, c in enumerate(carriers)
            for a, f, th in zip(*c["programme"])]
    mix = torch.zeros(C, len(rows), dtype=torch.float64)
    for r, (ci, a, _, _) in enumerate(rows):
        mix[ci, r] = a
    mix = mix.to(device)
    w = torch.as_tensor([r[2] for r in rows], dtype=torch.float64,
                        device=device)[:, None]
    th = torch.as_tensor([r[3] for r in rows], dtype=torch.float64,
                         device=device)[:, None]
    amp, depth, phase = (torch.as_tensor([c[k] for c in carriers],
                                         dtype=torch.float64,
                                         device=device)[:, None]
                         for k in ("amp", "depth", "phase"))
    q = [c["freq"].denominator for c in carriers]
    p = torch.as_tensor([c["freq"].numerator % d for c, d in
                         zip(carriers, q)], dtype=torch.int64,
                        device=device)[:, None]
    q = torch.as_tensor(q, dtype=torch.int64, device=device)[:, None]
    keys = [_spans(c["keying"], device) for c in carriers]
    n_all = traffic["blocks"] * traffic["block_bytes"] // 2
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seeds(seed, 7, rank).integers(1 << 62)))
    raw = torch.empty(n_all, 2, dtype=torch.uint8, device=device)
    clamped = torch.zeros((), dtype=torch.int64, device=device)
    base = rank * n_all
    for s in range(0, n_all, CHUNK):
        m = min(CHUNK, n_all - s)
        n = torch.arange(base + s, base + s + m, dtype=torch.int64,
                         device=device)
        t = n.to(torch.float64) / fs
        prog = mix @ torch.addcmul(th, w, t[None, :]).cos_()     # [C, m]
        key = torch.stack([_key(*k, n) for k in keys])
        env = amp * (1 + depth * prog) * key
        ang = ((p * n[None, :]) % q).to(torch.float64) * (2 * np.pi / q) \
            + phase
        iq = torch.stack([(env * torch.cos(ang)).sum(0),
                          (env * torch.sin(ang)).sum(0)], -1)
        iq.add_(torch.randn(m, 2, generator=gen, dtype=torch.float64,
                            device=device), alpha=noise)
        v = iq.mul_(128).add_(128).round_()
        clamped += ((v < 0) | (v > 255)).sum()
        raw[s:s + m] = v.clamp_(0, 255).to(torch.uint8)
    if int(clamped):
        raise ValueError(f"{int(clamped)} samples of the recording clipped")
    return raw.view(-1)
