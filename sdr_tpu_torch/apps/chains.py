"""Receive-chain constructors (counterpart of sdr_tpu/apps/chains.py).

The broadcast-FM receiver as the JAX package runs it on an accelerator:
the fused front (convert + decimate + demod in one kernel) or the
quantized front (convert + decimate in one kernel, then the demod), an
optional stereo decoder, the fused back (resample -> FIR -> volume) and
optional de-emphasis.  Other chain options raise ``NotImplementedError``
naming the slice that brings them.
"""

from __future__ import annotations

import numpy as np

from sdr_tpu_torch.ops import design
from sdr_tpu_torch.ops.iir import deemphasis_taps
from sdr_tpu_torch.stream.ops import (FmDemod, Iir, ResampleFirScale, Scale,
                                      StereoDecode, U8FrontDemod, U8FrontEnd)

__all__ = ["fm_taps", "fm_chain"]


def fm_taps():
    """(rf_decim 51, audio_resamp 31, audio_filter 64) tap sets for the
    broadcast-FM chain, designed as the JAX package designs them (bitwise
    the same taps)."""
    try:
        rf = design.remez(51, [0, 0.08, 0.125, 1.0], [1, 0])
        ars = design.remez(31, [0, 0.1, 0.3, 1.0], [1, 0])
        afl = design.remez(64, [0, 0.3125, 0.39, 1.0], [1, 0])
    except ImportError:   # scipy unavailable: the JAX package's fallback
        rf = design.windowed_sinc(51, 0.1, design.hamming)
        ars = design.windowed_sinc(31, 0.2, design.hamming)
        afl = design.windowed_sinc(64, 0.35, design.hamming)
    return rf, ars, afl


def fm_chain(volume: float = 0.2, front: str = "auto",
             front_precision: str = "s8", stereo: bool = False, fs_in: float = 1_280_000.0,
             deemphasis: float | None = None, deemphasis_mode: str = "iir",
             fuse_back="auto", device="cuda"):
    """Broadcast FM receiver ops: u8 IQ at ``fs_in`` (1.28 MS/s) ->
    decimate 8 -> FM demod (160 kS/s) -> 3/10 resample -> 64-tap audio FIR
    -> volume, 48 kS/s audio: mono ``[n]``, or ``[2, n]`` L/R with
    ``stereo=True``.

    ``front``: 'auto' or 'fused' (convert + decimate + demod in kernel K1)
    or 'quantized' (convert + decimate in K4, then ``FmDemod`` with the
    polynomial atan2).  ``front_precision``: the taps quantized to 's8' (the
    default) or 's16'.  ``stereo=True`` puts a ``StereoDecode`` after the
    demod; the back half batches over its [2] L/R axis.  ``deemphasis``:
    the RC time constant in seconds (75e-6 in the Americas, 50e-6 in
    Europe) of a single-pole ``Iir`` at the audio rate, before the volume.
    ``fuse_back``: 'auto' or True (``ResampleFirScale``).  The ops hold
    their taps on ``device`` (default the card; raises without a GPU)."""
    if front not in ("auto", "fused", "quantized"):
        raise NotImplementedError(
            f"front={front!r} (the f32 'exact' stages, the Fir stream op) "
            "waits for the exact-front slice of the port")
    if fuse_back not in ("auto", True):
        raise NotImplementedError(
            "fuse_back=False (the separate Fir and Scale stages, the Fir "
            "stream op) waits for the exact-front slice of the port")
    if deemphasis is not None and deemphasis_mode != "iir":
        if deemphasis_mode == "fir":
            raise NotImplementedError(
                "deemphasis_mode='fir' (a 64-tap Fir stage) waits for the "
                "exact-front slice of the port")
        raise ValueError(f"unknown deemphasis_mode {deemphasis_mode!r}")
    rf, ars, afl = fm_taps()
    if deemphasis is None:
        back = [ResampleFirScale(ars, 3, 10, afl, volume, device=device)]
    else:
        b, a = deemphasis_taps(fs_in / 8 * 3 / 10, deemphasis)
        back = [ResampleFirScale(ars, 3, 10, afl, 1.0, device=device),
                Iir(np.concatenate([b, a]), device=device),
                Scale(volume, device=device)]
    if stereo:
        back = [StereoDecode(fs=fs_in / 8, device=device), *back]
    if front == "quantized":
        return [U8FrontEnd(rf, 8, precision=front_precision, device=device),
                FmDemod(atan2="poly", device=device), *back]
    return [U8FrontDemod(rf, 8, precision=front_precision, device=device),
            *back]
