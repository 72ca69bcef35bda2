"""Closed-form FM phase of a programme made of cosines.

A programme is a sum of cosines ``A cos(2 pi f t + theta)``; its FM phase
is ``2 pi dev`` times its integral, a sum of ``(A / w) sin(w t + theta)``,
so any span of a recording is made from the absolute sample index alone
and a rank makes its own span of a longer recording.  A cosine may be
switched off over ``[t_off, t_on)``: its integral then holds still there,
``(A / w) (sin(w t + theta) - sin(w clamp(t, t_off, t_on) + theta))``,
one more row of the table with the time clamped.

The phase is evaluated on the card in float64, a chunk of samples at a
time for all cosines at once.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["Programme", "audio", "seeds"]


def seeds(seed: int, *stream: int):
    """A numpy generator for ``(seed, *stream)``: any whole seed, each
    stream of draws its own."""
    return np.random.default_rng([int(seed) % (1 << 64), *stream])


def audio(rng, tones: int, band: int, f_lo: float = 50.0,
          f_hi: float = 15_000.0):
    """``(amp, freq, theta)`` of an audio programme: ``tones`` tones at
    log-uniform frequencies, weights from 0.5 to 1, and ``band`` weaker
    cosines spread uniformly over the band (a stand-in for band-limited
    noise, 0.3 of the tones' weight in all), scaled so that the amplitudes
    sum to 1: the programme never leaves [-1, 1]."""
    f = np.concatenate([np.exp(rng.uniform(np.log(f_lo), np.log(f_hi),
                                           tones)),
                        rng.uniform(f_lo, f_hi, band)])
    a = np.concatenate([rng.uniform(0.5, 1.0, tones),
                        np.full(band, 0.3 * 0.75 * tones / max(band, 1))])
    return a / a.sum(), f, rng.uniform(0, 2 * np.pi, f.size)


class Programme:
    """Rows of ``coef = amp / w``, ``w``, ``theta``, an off span and
    whether the row's time is clamped to it."""

    def __init__(self):
        self.rows = []

    def add(self, amp, freq, theta, off=None):
        """Cosines ``amp cos(2 pi freq t + theta)`` (arrays alike), off
        over ``off = (t_off, t_on)`` seconds where given."""
        amp, freq, theta = np.broadcast_arrays(
            *(np.atleast_1d(np.asarray(v, dtype=np.float64))
              for v in (amp, freq, theta)))
        if np.any(freq <= 0):
            raise ValueError("every cosine needs a frequency above 0")
        w = 2 * np.pi * freq
        for a, wk, th in zip(amp, w, theta):
            self.rows.append((a / wk, wk, th, 0.0, 0.0, False))
            if off is not None:
                self.rows.append((-a / wk, wk, th, off[0], off[1], True))

    def tables(self, device):
        cols = list(zip(*self.rows))
        t = [torch.as_tensor(np.asarray(c, dtype=np.float64),
                             device=device)[:, None] for c in cols[:5]]
        return (*t, torch.as_tensor(np.asarray(cols[5]),
                                    device=device)[:, None])

    @staticmethod
    def phase(tables, t: torch.Tensor, deviation_hz: float,
              groups: int = 1) -> torch.Tensor:
        """FM phase ``[groups, len(t)]`` at the times ``t`` (seconds,
        float64); the rows split into ``groups`` equal runs, one a
        group."""
        coef, w, theta, t_off, t_on, clamped = tables
        tt = t[None, :].expand(coef.shape[0], -1)
        if bool(clamped.any()):
            tt = torch.where(clamped, torch.minimum(
                torch.maximum(tt, t_off), t_on), tt)
        s = torch.addcmul(theta, w, tt).sin_()
        per = coef.shape[0] // groups
        phi = torch.bmm(coef.view(groups, 1, per),
                        s.view(groups, per, -1))[:, 0]
        return phi.mul_(2 * np.pi * deviation_hz)
