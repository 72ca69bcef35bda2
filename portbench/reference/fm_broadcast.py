"""Plain reference of the broadcast FM receiver (configs/fm_broadcast.json).

The whole recording is one stream from rest: every filter's history is
zero (a u8 byte of 128) before the first sample, the demodulator's
previous sample is 0, the stereo pilot lock starts unlocked and the
de-emphasis at rest.  The taps are designed here from the deployment's
bands; nothing of the program is read.

Mono: u8 I/Q -> 51-tap decimate-by-8 with the taps quantized to 8 bits
(an exact integer sum, then one scale) -> FM demodulation -> 31-tap 3/10
polyphase resampler -> 64-tap audio FIR -> volume.  Stereo: the same
front and demodulation, the pilot-tone multiplex decoder (per-block pilot
lock), the resampler and audio FIR on L and R, the one-pole de-emphasis,
the volume.

Where the stream is cut into blocks only the stereo lock sees it: each
block's lock decision reads the pilot power over the block and the
decoder's history before it.  Every other stage's output is that of the
uncut stream, with the alignment the chain states: output ``g`` of a
decimate-by-``f`` front reads input ``g f + k - (K - f)``, the resampler
reads the zero-stuffed stream at ``g D - I H + j`` (``H`` the samples its
last output of a block reads past the block, :func:`resampler_history`),
and a filter reads ``g + k - (K - 1)``.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench.reference._dsp import (fir, fm_demod, one_pole, quantize,
                                      remez, resample, resampler_history,
                                      u8_planes)

__all__ = ["run", "stereo_decode"]


def _taps(spec: dict, fs: float = 2.0) -> np.ndarray:
    ny = fs / 2
    bands = [ny if b == "nyquist" else b for b in spec["bands"]]
    return remez(spec["taps"], bands, spec["desired"], fs=fs)


def front(cfg: dict, raw: torch.Tensor, dtype):
    """u8 I/Q -> the decimated I/Q pair: the quantized taps' exact sums
    times one scale."""
    fr = cfg["front"]
    f = fr["factor"]
    tq, scale = quantize(_taps(fr), fr["qmax"])
    re, im = u8_planes(raw, dtype)
    n = re.shape[-1] // f
    delay = len(tq) - f
    return (fir(re, tq, f, delay, n) * scale,
            fir(im, tq, f, delay, n) * scale)


def back(cfg: dict, x: torch.Tensor, block: int, gain: float):
    """3/10 resampler -> audio FIR -> ``gain``, over the last axis; ``block``
    is the composite samples a block of the stream holds."""
    rs, au = cfg["resampler"], cfg["audio_fir"]
    up, down = rs["up"], rs["down"]
    H = resampler_history(rs["taps"], up, down, 0, block)
    m = x.shape[-1] * up // down
    y = resample(x, _taps(rs), up, down, up * H, m)
    afl = _taps(au)
    return fir(y, afl, 1, len(afl) - 1, m) * float(gain)


def stereo_decode(sd: dict, fs: float, c: torch.Tensor, block: int):
    """The composite ``c [N]`` -> ``[2, N]`` L/R, as the decoder states it:
    the 19 kHz pilot bandpassed and squared, the 38 kHz carrier bandpassed
    from it and normalised by the squared pilot's 65-sample mean, the
    difference demodulated and lowpassed, the mono sum lowpassed, both
    lagging the composite by 96 samples.  Each block of ``block`` samples
    decides the pilot lock from ``r = mean(pilot^2) / mean(x^2)`` over its
    window (the 192 samples before it and its own): locked above
    ``lock_hi``, unlocked below ``lock_lo``, held between; unlocked, the
    difference is off."""
    K, hist = sd["taps"], sd["history"]
    bp19 = _taps(sd["pilot"], fs)
    bp38 = _taps(sd["carrier"], fs)
    lp15 = _taps(sd["audio"], fs)
    d = K - 1
    N = c.shape[-1]
    if N % block:
        raise ValueError(f"{N} composite samples are not whole blocks of "
                         f"{block}")
    xs = torch.nn.functional.pad(c, (hist, 0))
    sq = fir(xs, bp19) ** 2                                 # [N + hist - d]
    car = fir(sq, bp38)                                     # [N + hist - 2d]
    norm = fir(sq, np.full(K, 1.0 / K))
    floor2 = float(sd["pilot_floor"]) ** 2
    prod = xs[d:d + car.shape[-1]] * (car * norm / (norm * norm + floor2))
    diff = fir(prod, lp15, num=N)
    mono = fir(xs[d:], lp15, num=N)
    # the lock: one decision a block over its window [hist | block]
    B = N // block
    nsq, nx = block + hist - d, block + hist
    idx = torch.arange(B, device=c.device) * block
    csq = torch.nn.functional.pad(torch.cumsum(sq, -1), (1, 0))
    cx2 = torch.nn.functional.pad(torch.cumsum(xs * xs, -1), (1, 0))
    psq = (csq[idx + nsq] - csq[idx]) / nsq
    px2 = (cx2[idx + nx] - cx2[idx]) / nx
    r = (psq / (px2 + 1e-12)).double().cpu().numpy()
    gate, lock = np.zeros(B), 0.0
    for b in range(B):
        if r[b] > sd["lock_hi"]:
            lock = 1.0
        elif r[b] < sd["lock_lo"]:
            lock = 0.0
        gate[b] = lock
    gates = torch.as_tensor(np.repeat(gate, block), dtype=c.dtype,
                            device=c.device)
    s = diff * float(sd["separation_gain"]) * gates
    return torch.stack([mono + s, mono - s])


def run(cfg: dict, programme: dict, raw: torch.Tensor, block_bytes: int,
        dtype=torch.float64) -> torch.Tensor:
    """The receiver's output over the recording ``raw`` (u8 I/Q, one
    stream from rest, cut into blocks of ``block_bytes``): ``[M]`` audio,
    or ``[2, M]`` L/R for the stereo programme, in ``dtype``."""
    kw = programme["kwargs"]
    f = cfg["front"]["factor"]
    block = block_bytes // 2 // f               # composite samples a block
    re, im = front(cfg, raw, dtype)
    c = fm_demod(re, im, signed_zero=False)
    del re, im
    if not kw.get("stereo"):
        return back(cfg, c, block, cfg["volume"])
    fs = cfg["fs_in"] / f
    lr = stereo_decode(cfg["stereo_decoder"], fs, c, block)
    del c
    lr = back(cfg, lr, block, 1.0)
    tau = float(kw["deemphasis"])
    k = 2 * fs * cfg["resampler"]["up"] / cfg["resampler"]["down"] * tau
    b0, a1 = 1.0 / (1 + k), (1 - k) / (1 + k)
    return one_pole(lr, b0, b0, -a1) * float(cfg["volume"])
