"""Plain reference of the 64-station FM bank (configs/channelizer_64.json).

One wideband complex stream, from rest, split by the polyphase DFT
filterbank: channel ``c`` of ``C`` is the stream mixed down by ``c / C``
cycles a sample, low-passed by the prototype and decimated by ``C``,

    v[r, m] = sum_p h[p C + r] * x[(m + p - P + 1) C + r]
    y_c[m]  = sum_r exp(-2 pi i c r / C) * v[r, m]

(``P`` taps a branch, the first ``(P - 1) C`` samples of history zero).
Each channel then runs the broadcast receiver's f32 chain: the 51-tap
decimate-by-8 in float taps, the exact complex FM demodulation (its first
sample the angle of the signed zeros ``z[0] * conj(0)`` gives), the 3/10
resampler, the 64-tap audio FIR and the volume, aligned as in
reference/fm_broadcast.py.  The prototype and the receiver's taps are
designed here; nothing of the program is read.
"""

from __future__ import annotations

import torch

from portbench.reference._dsp import dft_rows, fir, fm_demod, windowed_sinc
from portbench.reference.fm_broadcast import _taps, back

__all__ = ["run", "channelize"]


def channelize(bank: dict, re: torch.Tensor, im: torch.Tensor):
    """``x [N]`` (a pair) -> ``[C, N / C]`` channel streams (a pair)."""
    C, P = bank["channels"], bank["taps_per_branch"]
    h = windowed_sinc(C * P, bank["cutoff"] / C) * bank["gain"]
    hb = torch.as_tensor(h.reshape(P, C), dtype=re.dtype, device=re.device)
    M = re.shape[-1] // C
    out = []
    for x in (re, im):
        xv = torch.nn.functional.pad(x, ((P - 1) * C, 0)).view(M + P - 1, C)
        v = torch.zeros(M, C, dtype=x.dtype, device=x.device)
        for p in range(P):
            v.add_(xv[p:p + M] * hb[p])
        out.append(v)
        del xv
    yr, yi = dft_rows(*out)
    return yr.T.contiguous(), yi.T.contiguous()


def run(cfg: dict, programme: dict, x: torch.Tensor, block_len: int,
        dtype=torch.float64) -> torch.Tensor:
    """The bank's audio ``[C, M]`` from the wideband capture ``x``
    (complex64, one stream from rest, cut into blocks of ``block_len``
    samples), in ``dtype``."""
    bank, fr = cfg["bank"], cfg["decimator"]
    C, f = bank["channels"], fr["factor"]
    re, im = channelize(bank, x.real.to(dtype), x.imag.to(dtype))
    rf = _taps(fr)
    n = re.shape[-1] // f
    delay = len(rf) - f
    dr, di = fir(re, rf, f, delay, n), fir(im, rf, f, delay, n)
    del re, im
    c = fm_demod(dr, di, signed_zero=True)
    return back(cfg, c, block_len // C // f, cfg["volume"])
