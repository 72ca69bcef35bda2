"""Broadcast FM receiver CLI over a recorded u8 IQ file (counterpart of
sdr_tpu/apps/fm.py):

    python -m sdr_tpu_torch.apps.fm --in capture.iq --out audio.wav \\
        --rate 1280K --block 1310720

Reads RTL-SDR-format u8 interleaved IQ (1.28 MS/s by default) and writes
WAV at 3/80 of the input rate (48 kHz): mono, or L/R with ``--stereo``
(multiplex decode), optionally de-emphasised (``--deemphasis 75e-6``):

    python -m sdr_tpu_torch.apps.fm --in capture.iq --out audio.wav \\
        --front quantized --stereo --deemphasis 75e-6

The front is the fused kernel unless ``--front`` names the quantized one
or the exact f32 stages (``--front exact``).  Runs on the card;
``--device cpu`` runs the plain PyTorch versions.  Live radio (rtl_tcp),
the native ring loader and live audio wait for later slices of the port.
"""

from __future__ import annotations

import argparse
import itertools
import sys

from sdr_tpu_torch.apps.chains import fm_chain
from sdr_tpu_torch.io.files import iq_file_source, wav_sink
from sdr_tpu_torch.stream import Pipeline, rate as rate_meter
from sdr_tpu_torch.utils import parse_size


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--in", dest="inp", required=True,
                    help="input raw u8 interleaved IQ file")
    ap.add_argument("--out", default="audio.wav", help="output WAV file")
    ap.add_argument("--rate", default="1280K", type=parse_size,
                    help="input sample rate (complex S/s), e.g. 1280K")
    ap.add_argument("--block", default="1310720", type=parse_size,
                    help="u8 items per block (must keep chain rates integral)")
    ap.add_argument("--volume", type=float, default=0.2)
    ap.add_argument("--front", default="auto",
                    choices=["auto", "fused", "quantized", "exact"],
                    help="front end: convert + decimate + demod in one "
                         "kernel (auto, fused), convert + decimate, then "
                         "the demod (quantized), or the f32 convert, "
                         "decimating FIR and demod stages (exact)")
    ap.add_argument("--stereo", action="store_true",
                    help="decode the stereo multiplex (L/R WAV out)")
    ap.add_argument("--deemphasis", type=float, default=None,
                    metavar="TAU",
                    help="broadcast de-emphasis time constant in seconds "
                         "(75e-6 Americas, 50e-6 Europe; default off)")
    ap.add_argument("--batched", type=int, default=0, metavar="B",
                    help="process B blocks block-parallel per step "
                         "(0 = stream block by block)")
    ap.add_argument("--max-blocks", type=int, default=0,
                    help="stop after N input blocks (0 = until EOF)")
    ap.add_argument("--meter", action="store_true",
                    help="print throughput while running")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default: the card; 'cpu' runs the "
                         "plain PyTorch versions)")
    args = ap.parse_args(argv)

    pipe = Pipeline(fm_chain(args.volume, front=args.front,
                             stereo=args.stereo, fs_in=float(args.rate),
                             deemphasis=args.deemphasis, device=args.device),
                    block_in=args.block, device=args.device)
    # block_in counts u8 items: two per complex sample
    audio_rate = 2 * args.rate * pipe.block_out // pipe.block_in
    write, close = wav_sink(args.out, audio_rate,
                            channels=2 if args.stereo else 1)
    source = iq_file_source(args.inp, args.block)
    if args.max_blocks:
        source = itertools.islice(source, args.max_blocks)
    if args.batched:
        blocks = pipe.run_batched(source, args.batched)
    else:
        blocks = pipe.run(source)
    if args.meter:
        blocks = rate_meter(blocks, pipe.block_out * max(1, args.batched))
    n = 0
    try:
        for y in blocks:
            write(y.cpu().numpy())
            n += y.shape[-1]
    finally:
        close()
    print(f"wrote {n} audio samples at {audio_rate} Hz to {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
