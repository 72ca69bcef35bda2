"""Receive-chain constructors (counterpart of sdr_tpu/apps/chains.py).

This slice of the port carries the broadcast-FM receiver as the JAX
package runs it on an accelerator: fused front (convert + decimate + demod
in one kernel) and fused back (resample -> FIR -> volume).  Other chain
options raise ``NotImplementedError`` naming the slice that brings them.
"""

from __future__ import annotations

from sdr_tpu_torch.ops import design
from sdr_tpu_torch.stream.ops import ResampleFirScale, U8FrontDemod

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


def fm_chain(volume: float = 0.2, front: str = "auto", stereo: bool = False,
             deemphasis: float | None = None, fuse_back="auto",
             device="cuda"):
    """Broadcast FM receiver ops: u8 IQ at 1.28 MS/s -> decimate 8 -> FM
    demod (160 kS/s) -> 3/10 resample -> 64-tap audio FIR -> volume, 48 kS/s
    mono audio.

    ``front``: 'auto' or 'fused' (the only front of this slice; its taps
    are quantized to 8 bits, the JAX package's default).  ``fuse_back``:
    'auto' or True.  The ops hold their taps on ``device`` (default the
    card; raises without a GPU)."""
    if front not in ("auto", "fused"):
        raise NotImplementedError(
            f"front={front!r} (the f32 'exact' stages and the 'quantized' "
            "front end, kernel K4) waits for a later slice of the port")
    if fuse_back not in ("auto", True):
        raise NotImplementedError(
            "fuse_back=False (the separate Fir and Scale stages) waits for "
            "a later slice of the port")
    if stereo:
        raise NotImplementedError(
            "stereo decoding waits for the stereo/de-emphasis slice")
    if deemphasis is not None:
        raise NotImplementedError(
            "de-emphasis waits for the stereo/de-emphasis slice")
    rf, ars, afl = fm_taps()
    return [U8FrontDemod(rf, 8, precision="s8", device=device),
            ResampleFirScale(ars, 3, 10, afl, volume, device=device)]
