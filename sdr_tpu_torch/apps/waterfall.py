"""Spectral waterfall CLI over a recorded u8 IQ file (BASELINE config #3;
counterpart of sdr_tpu/apps/waterfall.py).  One-shot render:

    python -m sdr_tpu_torch.apps.waterfall --in capture.iq \\
        --out waterfall.png --fft 1024 --hop 512

Live follow of a growing capture: tail the file, push rows into the
scrolling window and atomically rewrite the PNG every ``--refresh-rows``
rows; ``--term`` also prints each row to the terminal as text:

    python -m sdr_tpu_torch.apps.waterfall --in live.iq --follow --term \\
        --idle-timeout 5

The PNG needs matplotlib.  Runs on the card; ``--device cpu`` runs the
plain PyTorch versions.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

from sdr_tpu_torch.apps.chains import waterfall_chain
from sdr_tpu_torch.io.files import follow_iq_file, iq_file_source
from sdr_tpu_torch.io.plot import Waterfall
from sdr_tpu_torch.ops.fftops import waterfall_image
from sdr_tpu_torch.stream import Pipeline
from sdr_tpu_torch.utils import parse_size


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--in", dest="inp", required=True,
                    help="input raw u8 interleaved IQ file")
    ap.add_argument("--out", default="waterfall.png", help="output PNG")
    ap.add_argument("--fft", type=int, default=1024)
    ap.add_argument("--hop", type=int, default=512)
    ap.add_argument("--block", default="1048576", type=parse_size,
                    help="u8 items per block")
    ap.add_argument("--max-rows", type=int, default=2048)
    ap.add_argument("--follow", action="store_true",
                    help="tail a growing file; rewrite --out continuously")
    ap.add_argument("--refresh-rows", type=int, default=64,
                    help="rewrite the PNG every N new rows (follow mode)")
    ap.add_argument("--idle-timeout", type=float, default=None,
                    help="stop following after N quiet seconds "
                         "(default: follow forever)")
    ap.add_argument("--term", action="store_true",
                    help="also print text rows to the terminal (follow)")
    ap.add_argument("--term-cols", type=int, default=80)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default: the card; 'cpu' runs the "
                         "plain PyTorch versions)")
    args = ap.parse_args(argv)

    # the complex form: the planar form's rows bit for bit, without its
    # rebuild of complex64 from the planes ahead of the FFT
    pipe = Pipeline(waterfall_chain(args.fft, args.hop, planar=False,
                                    device=args.device),
                    block_in=args.block, device=args.device)

    if args.follow:
        wf = Waterfall(args.fft, rows=min(args.max_rows, 512))
        source = follow_iq_file(args.inp, args.block,
                                idle_timeout=args.idle_timeout)
        pending = written = 0
        try:
            for y in pipe.run(source):
                rows = y.cpu().numpy()
                wf.push(rows)
                if args.term:
                    for line in wf.ansi_rows(rows, cols=args.term_cols):
                        print(line, flush=True)
                pending += rows.shape[0]
                if pending >= args.refresh_rows:
                    wf.save(args.out, atomic=True)
                    written += pending
                    pending = 0
        except KeyboardInterrupt:
            pass
        wf.save(args.out, atomic=True)
        written += pending
        print(f"followed {written} rows into {args.out}")
        return 0

    rows, total = [], 0
    for y in pipe.run(iq_file_source(args.inp, args.block)):
        rows.append(y.cpu().numpy())
        total += rows[-1].shape[0]
        if total >= args.max_rows:
            break
    img = np.concatenate(rows, axis=0)[: args.max_rows]
    waterfall_image(img, args.out)
    print(f"wrote {img.shape[0]}x{img.shape[1]} waterfall to {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
