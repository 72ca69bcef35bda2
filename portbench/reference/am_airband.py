"""Plain reference of the AM airband receiver (configs/am_airband.json).

The whole recording is one stream from rest, every stage written out from
the deployment's blocks in adamwalker/sdr; nothing of the program is read:

1. u8 I/Q -> ``(u - 128) / 128`` per component (``Util.hs:91-138``; the
   program's ``IqConvertU8`` uses the same constants);
2. the quarter-band shift: sample ``n`` times ``(-j)^n`` over the absolute
   index, exactly (``quarterBandUp``, ``Util.hs:264-285``; ``Mix(-0.25)``
   in the program), for ``if_freq`` 0.25 only;
3. the decimating FIR: a Hamming-windowed sinc designed here from
   ``channel_filter``, output ``g`` reading input ``g f + k - (K - f)``
   (zero before the stream);
4. ``agcPipe`` (``Util.hs:329-348``): ``y[n] = g[n] x[n]``, ``g[n+1] =
   g[n] + mu (reference - |x[n] g[n]|)`` from ``g[0] = initial``
   (:func:`agc_gains`);
5. the envelope ``|y|``;
6. ``dcBlockingFilter`` (``Filter.hs:729-739``): ``y[n] = x[n] - x[n-1]
   + alpha y[n-1]`` from rest, through ``one_pole(x, 1, -1, alpha)``;
7. the volume.

Every stage runs in ``dtype`` (float64 for the comparison, a lower type
for the control).  The reference assumes the recording starts at the
stream's sample 0, or at a multiple of 4 samples: the shift's phase.
"""

from __future__ import annotations

import torch

from portbench.reference._dsp import fir, one_pole, u8_planes, windowed_sinc

__all__ = ["run", "taps", "quarter_shift", "agc_gains", "CHUNK"]

CHUNK = 1024            # samples a cumulative product of the AGC spans


def taps(cfg: dict):
    """The channel filter, designed from the configuration (float32)."""
    cf = cfg["channel_filter"]
    if cf["window"] != "hamming":
        raise ValueError(f"unknown window {cf['window']!r}")
    return windowed_sinc(cf["taps"], cf["cutoff"])


def quarter_shift(re: torch.Tensor, im: torch.Tensor):
    """``(re + j im) * (-j)^n`` over the last axis, exactly: per four
    samples ``(re, im)``, ``(im, -re)``, ``(-re, -im)``, ``(-im, re)``."""
    n = re.shape[-1]
    if n % 4:
        raise ValueError(f"{n} samples are not whole periods of 4")
    r, i = re.reshape(-1, 4), im.reshape(-1, 4)
    out_r = torch.stack([r[:, 0], i[:, 1], -r[:, 2], -i[:, 3]], -1)
    out_i = torch.stack([i[:, 0], -r[:, 1], -i[:, 2], r[:, 3]], -1)
    return out_r.reshape(re.shape), out_i.reshape(im.shape)


def agc_gains(m: torch.Tensor, mu: float, reference: float,
              initial: float) -> torch.Tensor:
    """The gains ``g[n]`` of ``agcPipe`` over the envelope ``m = |x|``
    (``[N]``, in its dtype): ``g[n+1] = g[n] + mu (reference - m[n]
    g[n])``.

    Where ``g >= 0``, ``|x g| = |x| g`` and the recurrence is ``g[n+1] =
    a[n] g[n] + c`` with ``a = 1 - mu m`` and ``c = mu reference``, whose
    closed form over a chunk of samples entered with gain ``G`` is ``g[j]
    = P[j] (G + c sum_{i<j} 1 / P[i+1])``, ``P[j]`` the product of ``a``
    before ``j``.  The chunks are ``CHUNK`` samples (cumulative products
    of at most that many factors, each at least ``1 - mu max m``), chained
    one after the other on the host.  Raises where ``mu m >= 1`` or ``g <
    0`` on any sample: there the closed form is not ``agcPipe``."""
    if bool((mu * m >= 1).any()):
        raise ValueError("mu * |x| >= 1 on some sample: the gain may turn "
                         "negative, and the closed form is not agcPipe")
    N = m.shape[-1]
    L = CHUNK
    nc = -(-N // L)
    a = torch.nn.functional.pad(1 - mu * m, (0, nc * L - N),
                                value=1.0).view(nc, L)
    c = mu * reference
    P = torch.cumprod(a, -1)                         # inclusive
    S = torch.cumsum(1 / P, -1)
    # each chunk's map G -> A G + B, chained in order on the host
    A, B = P[:, -1], c * P[:, -1] * S[:, -1]
    A, B = A.cpu(), B.cpu()
    enter = torch.empty(nc, dtype=m.dtype)
    g = torch.tensor(initial, dtype=m.dtype)
    for k in range(nc):
        enter[k] = g
        g = A[k] * g + B[k]
    enter = enter.to(m.device)[:, None]
    P_ex = torch.nn.functional.pad(P[:, :-1], (1, 0), value=1.0)
    S_ex = torch.nn.functional.pad(S[:, :-1], (1, 0))
    gains = (P_ex * (enter + c * S_ex)).reshape(-1)[:N]
    if not bool((gains >= 0).all()):
        raise ValueError("a gain below 0: the closed form is not agcPipe")
    return gains


def run(cfg: dict, programme: dict, raw: torch.Tensor, block_bytes: int,
        dtype=torch.float64) -> torch.Tensor:
    """The receiver's ``[M]`` audio over the recording ``raw`` (u8 I/Q,
    one stream from rest), in ``dtype``.  No stage sees the blocks."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kw = programme["kwargs"]
    cf = cfg["channel_filter"]
    if kw["if_freq"] != 0.25 or kw["decim"] != cf["factor"] or \
            kw["agc_mu"] != cfg["agc"]["mu"] or kw["volume"] != cfg["volume"]:
        raise ValueError(f"the programme {kw} is not the deployment's "
                         "quarter-band shift, filter, AGC and volume")
    re, im = u8_planes(raw, dtype)
    re, im = re / 128, im / 128
    re, im = quarter_shift(re, im)
    h, f = taps(cfg), cf["factor"]
    n = re.shape[-1] // f
    re = fir(re, h, f, len(h) - f, n)
    im = fir(im, h, f, len(h) - f, n)
    spec = cfg["agc"]
    g = agc_gains(torch.sqrt(re * re + im * im), spec["mu"],
                  spec["reference"], spec["initial"])
    re, im = re * g, im * g                     # agcPipe's y = g x
    env = torch.sqrt(re * re + im * im)
    del re, im, g
    return one_pole(env, 1.0, -1.0, cfg["dc_blocker"]["alpha"]) * \
        float(cfg["volume"])
