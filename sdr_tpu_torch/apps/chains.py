"""Receive-chain constructors (counterpart of sdr_tpu/apps/chains.py).

``fm_chain``: the broadcast-FM receiver, with one of three fronts: the
fused front (convert + decimate + demod in one kernel, the accelerator
path and the default), the quantized front (convert + decimate in one
kernel, then the demod), or the exact f32 stages (convert, decimating
``Fir``, demod: the front the JAX package picks on any device that is not
a TPU); an optional stereo decoder; the fused back (resample -> FIR ->
volume) or the three separate stages; optional de-emphasis.

``am_chain``: the AM/airband receiver (mix to DC, decimating channel
filter, AGC, envelope, DC block, volume).

``waterfall_chain``: u8 IQ -> windowed overlapping FFT magnitude rows.
``channelizer_chain``: the 64-channel FM bank, per-channel basebands or
one wideband stream split by the polyphase filterbank first.  The JAX
package's ``method`` argument (its FIR method zoo) has no counterpart.
"""

from __future__ import annotations

import numpy as np
import torch

from sdr_tpu_torch.ops import design
from sdr_tpu_torch.ops.channelize import channelizer_taps
from sdr_tpu_torch.ops.iir import biquad, deemphasis_taps
from sdr_tpu_torch.stream.ops import (Agc, AmDemod, Channelize, DcBlocker,
                                      FftStream, Fir, FmDemod, Iir,
                                      IqConvertU8, Mix, ResampleFirScale,
                                      Scale, StereoDecode, U8FrontDemod,
                                      U8FrontEnd)

__all__ = ["fm_taps", "fm_chain", "am_chain", "waterfall_chain",
           "channelizer_chain"]


def fm_taps():
    """(rf_decim 51, audio_resamp 31, audio_filter 64) tap sets for the
    broadcast-FM chain, designed as the JAX package designs them (bitwise
    the same taps), with its windowed-sinc fallback when the design
    fails for any reason (scipy missing, remez not converging)."""
    try:
        rf = design.remez(51, [0, 0.08, 0.125, 1.0], [1, 0])
        ars = design.remez(31, [0, 0.1, 0.3, 1.0], [1, 0])
        afl = design.remez(64, [0, 0.3125, 0.39, 1.0], [1, 0])
    except Exception:   # the JAX package's fallback, on the same condition
        rf = design.windowed_sinc(51, 0.1, design.hamming)
        ars = design.windowed_sinc(31, 0.2, design.hamming)
        afl = design.windowed_sinc(64, 0.35, design.hamming)
    return rf, ars, afl


def fm_chain(volume: float = 0.2, front: str = "auto",
             front_precision: str = "s8", planar: bool = False,
             stereo: bool = False,
             fs_in: float = 1_280_000.0, deemphasis: float | None = None,
             deemphasis_mode: str = "iir", fuse_back="auto", device="cuda"):
    """Broadcast FM receiver ops: u8 IQ at ``fs_in`` (1.28 MS/s) ->
    decimate 8 -> FM demod (160 kS/s) -> 3/10 resample -> 64-tap audio FIR
    -> volume, 48 kS/s audio: mono ``[n]``, or ``[2, n]`` L/R with
    ``stereo=True``.

    ``front``: 'auto' or 'fused' (convert + decimate + demod in kernel K1,
    the accelerator path), 'quantized' (convert + decimate in K4, then
    ``FmDemod`` with the polynomial atan2) or 'exact' (``IqConvertU8``,
    the 51-tap f32 ``Fir.decimator`` on K3, ``FmDemod``: the JAX package's
    choice off a TPU).  ``front_precision``: the fused and quantized
    fronts' taps quantized to 's8' (the default) or 's16'.  ``planar``
    (exact front): the complex segment in planar f32 I/Q instead of
    complex64, its demod with the polynomial atan2 (the complex demod is
    exact), as in the JAX package.  ``stereo=True`` puts a ``StereoDecode`` after the
    demod; the back half batches over its [2] L/R axis.

    ``fuse_back``: 'auto' or True (``ResampleFirScale``: K2 -> K3 with the
    volume in the FIR taps), or False (``Fir.resampler``, ``Fir.filter``,
    ``Scale``, the same samples).  ``deemphasis``: the RC time constant
    in seconds (75e-6 in the Americas, 50e-6 in Europe), before the
    volume at the audio rate: a single-pole ``Iir`` (``deemphasis_mode=
    'iir'``) or the 64-tap FIR of its truncated impulse response
    ('fir').  The ops hold their taps on ``device`` (default the card;
    raises without a GPU)."""
    if front not in ("auto", "fused", "quantized", "exact"):
        raise ValueError(f"unknown front {front!r}")
    if deemphasis is not None and deemphasis_mode not in ("iir", "fir"):
        raise ValueError(f"unknown deemphasis_mode {deemphasis_mode!r}")
    rf, ars, afl = fm_taps()
    if fuse_back in ("auto", True):
        gain = 1.0 if deemphasis is not None else volume
        back = [ResampleFirScale(ars, 3, 10, afl, gain, device=device)]
        if deemphasis is not None:
            back.append(Scale(volume, device=device))
    elif fuse_back is False:
        back = [Fir.resampler(ars, 3, 10, device=device),
                Fir.filter(afl, device=device), Scale(volume, device=device)]
    else:
        raise ValueError(f"unknown fuse_back {fuse_back!r}")
    if deemphasis is not None:
        b, a = deemphasis_taps(fs_in / 8 * 3 / 10, deemphasis)
        if deemphasis_mode == "iir":
            stage = Iir(np.concatenate([b, a]), device=device)
        else:
            impulse = torch.zeros(64)
            impulse[0] = 1.0
            stage = Fir.filter(biquad(b, a, impulse).numpy(), device=device)
        back.insert(len(back) - 1, stage)        # just before the volume
    if stereo:
        back = [StereoDecode(fs=fs_in / 8, device=device), *back]
    if front == "exact":
        return [IqConvertU8(planar=planar, device=device),
                Fir.decimator(rf, 8, device=device),
                FmDemod(planar=planar, atan2="poly" if planar else "exact",
                        device=device), *back]
    if front == "quantized":
        return [U8FrontEnd(rf, 8, precision=front_precision, device=device),
                FmDemod(planar=True, atan2="poly", device=device), *back]
    return [U8FrontDemod(rf, 8, precision=front_precision, device=device),
            *back]


def am_chain(if_freq: float = 0.25, decim: int = 16, agc_mu: float = 0.005,
             volume: float = 0.5, agc_approx: int | None = None,
             planar: bool | None = None, device="cuda"):
    """AM/airband receiver ops (BASELINE config #4): u8 IQ -> mix the
    carrier at ``if_freq`` (cycles/sample) to DC -> 64-tap decimating
    channel filter (``decim``, K3) -> AGC -> envelope -> DC block ->
    volume.

    ``planar`` (default: True unless ``agc_approx`` is given): the chain
    in planar f32 I/Q, the AGC's gains from the all-real envelope; False:
    complex64 up to the envelope.  The AGC is the linear form, exact
    block-parallel.  ``agc_approx=R`` selects the literal sequential AGC
    (K6 on the card; complex form only) with R sweeps of approximate
    block-parallel carries, the fallback where ``mu*|x| > 1``."""
    if planar is None:
        planar = agc_approx is None
    if planar and agc_approx is not None:
        raise ValueError("agc_approx (the sequential-AGC fallback) is "
                         "complex-form only; pass planar=False")
    chan = design.windowed_sinc(64, 1.0 / decim, design.hamming)
    agc = (Agc(agc_mu, 1.0, planar=planar, device=device)
           if agc_approx is None else
           Agc(agc_mu, 1.0, method="scan", approx_time_sharding=agc_approx,
               device=device))
    return [IqConvertU8(planar=planar, device=device),
            Mix(-if_freq, planar=planar, device=device),
            Fir.decimator(chan, decim, device=device),
            agc,
            AmDemod(planar=planar, device=device),
            DcBlocker(device=device),
            Scale(volume, device=device)]


def waterfall_chain(fft_size: int = 1024, hop: int = 512,
                    planar: bool = True, device="cuda"):
    """Spectral waterfall ops (BASELINE config #3): u8 IQ -> Blackman
    windowed overlapping FFT magnitude rows ``[frames, fft_size]``,
    DC-centred.  ``planar`` (the default) keeps the chain in planar f32
    I/Q, False goes through complex64; the same rows."""
    window = design.blackman(fft_size)
    return [IqConvertU8(planar=planar, device=device),
            FftStream(fft_size, hop, window=window, planar=planar,
                      device=device)]


def channelizer_chain(n_channels: int = 64, wideband: bool = False,
                      device="cuda"):
    """Multi-channel FM bank (BASELINE config #5): per channel, the 51-tap
    decimate-by-8 ``Fir`` (K3), the complex ``FmDemod``, the 3/10
    resampler (K2), the 64-tap audio FIR (K3) and the volume, batched over
    the channel axis.

    ``wideband=False``: the input is ``[n_channels, N]`` complex baseband,
    a row per tuned channel.  ``wideband=True``: the input is one wideband
    complex stream at ``n_channels`` times the channel rate, split first by
    the polyphase DFT filterbank (``Channelize``, 12 taps a branch) into
    ``[n_channels, N / n_channels]``."""
    rf, ars, afl = fm_taps()
    per_channel = [Fir.decimator(rf, 8, device=device),
                   FmDemod(device=device),
                   Fir.resampler(ars, 3, 10, device=device),
                   Fir.filter(afl, device=device),
                   Scale(0.2, device=device)]
    if wideband:
        return [Channelize(channelizer_taps(n_channels, 12), n_channels,
                           device=device), *per_channel]
    return per_channel
