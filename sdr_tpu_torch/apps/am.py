"""AM/airband receiver CLI over a recorded u8 IQ file (BASELINE config
#4; counterpart of sdr_tpu/apps/am.py):

    python -m sdr_tpu_torch.apps.am --in capture.iq --out audio.wav \\
        --rate 1280K --if-freq 0.2 --decim 16

Mixes the carrier at ``--if-freq`` (cycles/sample) to DC, decimates by
``--decim`` through a 64-tap channel filter, and writes the AGC'd,
DC-blocked envelope as WAV at ``rate // decim``.  Runs on the card;
``--device cpu`` runs the plain PyTorch versions.
"""

from __future__ import annotations

import argparse
import sys

from sdr_tpu_torch.apps.chains import am_chain
from sdr_tpu_torch.io.files import iq_file_source, wav_sink
from sdr_tpu_torch.stream import Pipeline
from sdr_tpu_torch.utils import parse_size


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--in", dest="inp", required=True,
                    help="input raw u8 interleaved IQ file")
    ap.add_argument("--out", default="audio.wav", help="output WAV file")
    ap.add_argument("--rate", default="1280K", type=parse_size,
                    help="input sample rate (complex S/s), e.g. 1280K")
    ap.add_argument("--block", default="1048576", type=parse_size,
                    help="u8 items per block (must keep chain rates integral)")
    ap.add_argument("--if-freq", type=float, default=0.25,
                    help="carrier offset in cycles/sample to mix to DC")
    ap.add_argument("--decim", type=int, default=16)
    ap.add_argument("--volume", type=float, default=0.5)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default: the card; 'cpu' runs the "
                         "plain PyTorch versions)")
    args = ap.parse_args(argv)

    audio_rate = args.rate // args.decim
    pipe = Pipeline(am_chain(args.if_freq, args.decim, volume=args.volume,
                             device=args.device),
                    block_in=args.block, device=args.device)
    write, close = wav_sink(args.out, audio_rate)
    n = 0
    try:
        for y in pipe.run(iq_file_source(args.inp, args.block)):
            write(y.cpu().numpy())
            n += y.shape[-1]
    finally:
        close()
    print(f"wrote {n} audio samples at {audio_rate} Hz to {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
