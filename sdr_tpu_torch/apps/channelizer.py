"""Multi-channel FM channelizer CLI (BASELINE config #5; counterpart of
sdr_tpu/apps/channelizer.py):

    python -m sdr_tpu_torch.apps.channelizer --channels 64 --synthetic \\
        --seconds 1 --out-prefix chan

Demodulates N FM channels at once.  Input: a raw complex64 file of
``[channels, N]`` rows (one baseband row per tuned channel), or with
``--wideband`` one wideband stream at ``channels * rate`` that the
polyphase DFT filterbank splits first; ``--synthetic`` (or no ``--in``)
makes the JAX app's synthetic input.  One card runs the whole input as
one block-parallel block (``run_time_batched(chain, x, 1)``), the samples
the JAX app's channel or time sharding gives.  Writes one WAV a channel
with ``--out-prefix``.  Runs on the card; ``--device cpu`` runs the plain
PyTorch versions.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from sdr_tpu_torch.apps.chains import channelizer_chain
from sdr_tpu_torch.io.files import wav_sink
from sdr_tpu_torch.parallel.sharded import run_time_batched
from sdr_tpu_torch.utils import parse_size, resolve_device

_F64 = torch.float64


def synthesize(n_channels: int, n: int, fs: float, device="cuda"):
    """``[n_channels, n]`` complex64 FM basebands, channel c carrying a
    tone of ``200 + 150 c`` Hz at 75 kHz deviation: the JAX app's formula
    (a cumulative sum of the tone for the phase), in float64 on
    ``device``."""
    device = resolve_device(device)
    tones = 200.0 + 150.0 * torch.arange(n_channels, dtype=_F64,
                                         device=device)
    t = torch.arange(n, dtype=_F64, device=device) / fs
    audio = torch.sin(2 * np.pi * tones[:, None] * t)
    phase = 2 * np.pi * 75e3 * torch.cumsum(audio, dim=-1) / fs
    del audio
    return (0.9 * torch.exp(1j * phase)).to(torch.complex64)


def stack_wideband(x: torch.Tensor) -> torch.Tensor:
    """The JAX app's wideband synthetic: channel c's baseband
    zero-stuffed by C and mixed up to +c/C cycles a sample, summed in
    complex64 in channel order.  The images of the zero-stuffing fall on
    every channel centre, so each channel of the filterbank's output
    carries the sum of all the stations (the reference's fault, kept so
    the port's output stays the JAX app's)."""
    C, n = x.shape
    k = torch.arange(n, dtype=_F64, device=x.device) * C   # the nonzeros
    acc = torch.zeros(n, dtype=torch.complex64, device=x.device)
    for c in range(C):
        acc += x[c] * torch.exp(2j * np.pi * (c / C) * k).to(torch.complex64)
    wide = torch.zeros(C * n, dtype=torch.complex64, device=x.device)
    wide[::C] = acc
    return wide


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--in", dest="inp", help="raw c64 file: [channels, N] "
                    "rows, or one wideband stream with --wideband")
    ap.add_argument("--synthetic", action="store_true")
    ap.add_argument("--wideband", action="store_true",
                    help="input is one wideband stream at channels*rate; "
                    "split with the polyphase DFT filterbank first")
    ap.add_argument("--channels", type=int, default=64)
    ap.add_argument("--rate", default="1280K", type=parse_size,
                    help="per-channel sample rate")
    ap.add_argument("--seconds", type=float, default=0.5)
    ap.add_argument("--out-prefix", default=None,
                    help="write per-channel WAVs with this prefix")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default: the card; 'cpu' runs the "
                         "plain PyTorch versions)")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    C = args.channels
    if args.synthetic or not args.inp:
        n = int(args.rate * args.seconds) // 80 * 80
        x = synthesize(C, n, args.rate, device)
        if args.wideband:
            x = stack_wideband(x)
    else:
        x = torch.from_numpy(np.fromfile(args.inp, dtype=np.complex64))
        if args.wideband:
            x = x[: len(x) // (C * 80) * C * 80]
        else:
            x = x[: len(x) // C // 80 * 80 * C].reshape(C, -1)
    chain = channelizer_chain(C, wideband=args.wideband, device=device)
    y = run_time_batched(chain, x, 1, device=device).cpu().numpy()
    audio_rate = args.rate // 8 * 3 // 10
    print(f"demodulated {y.shape[0]} channels x {y.shape[1]} samples "
          f"at {audio_rate} Hz on 1 devices")
    if args.out_prefix:
        for c in range(y.shape[0]):
            write, close = wav_sink(f"{args.out_prefix}{c:03d}.wav",
                                    audio_rate)
            try:
                write(y[c])
            finally:
                close()
        print(f"wrote {y.shape[0]} WAV files")
    return 0


if __name__ == "__main__":
    sys.exit(main())
