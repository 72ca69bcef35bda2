"""FM transmitter CLI: WAV audio -> FM-modulated interleaved-i16 IQ file
(counterpart of sdr_tpu/apps/fm_tx.py):

    python -m sdr_tpu_torch.apps.fm_tx --in audio.wav --out tx.iq \\
        --deviation 75K

The transmit-side complement of apps/fm.py: mono audio (48 kHz) is
upsampled x80/3 to 1.28 MS/s in two polyphase stages (10/3 with 31 taps,
then 8/1 with 51, both on kernel K2), FM-modulated with the phase carried
across blocks, and written as BladeRF-format i16 interleaved IQ.  Runs on
the card; ``--device cpu`` runs the plain PyTorch versions.
"""

from __future__ import annotations

import argparse
import sys
import wave

import numpy as np
import torch

from sdr_tpu_torch.io.files import write_iq_file
from sdr_tpu_torch.ops import design
from sdr_tpu_torch.ops.convert import cfloat_to_iq_i16
from sdr_tpu_torch.stream import Fir, FmMod, Pipeline
from sdr_tpu_torch.utils import parse_size


def tx_chain(audio_rate: int, deviation: float, device="cuda"):
    """The transmitter's ops: 10/3 and 8/1 interpolating resamplers (taps
    cut off at the audio band's edge, gain I) and ``FmMod`` at
    ``deviation`` Hz, amplitude 0.9."""
    up1 = design.windowed_sinc(31, 0.1 * 3, design.hamming) * 10 / 3
    up2 = design.windowed_sinc(51, 0.1, design.hamming) * 8
    sens = 2 * np.pi * deviation / (audio_rate * 80 / 3)
    return [Fir.resampler(up1, 10, 3, device=device),
            Fir.resampler(up2, 8, 1, device=device),
            FmMod(float(sens), amplitude=0.9, device=device)]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--in", dest="inp", required=True, help="input WAV")
    ap.add_argument("--out", default="tx.iq")
    ap.add_argument("--rate", default="1280K", type=parse_size,
                    help="output IQ sample rate")
    ap.add_argument("--deviation", default="75K", type=parse_size)
    ap.add_argument("--block", default="46080", type=parse_size,
                    help="audio samples per block")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default: the card; 'cpu' runs the "
                         "plain PyTorch versions)")
    args = ap.parse_args(argv)

    with wave.open(args.inp) as wf:
        if wf.getnchannels() != 1:
            print("mono WAV required", file=sys.stderr)
            return 1
        audio_rate = wf.getframerate()
        pcm = np.frombuffer(wf.readframes(wf.getnframes()), dtype="<i2")
    audio = (pcm / 32768.0).astype(np.float32)

    if args.rate * 3 != audio_rate * 80:
        print(f"note: chain is fixed at x80/3 ({audio_rate} -> "
              f"{audio_rate * 80 // 3})", file=sys.stderr)

    pipe = Pipeline(tx_chain(audio_rate, args.deviation, args.device),
                    block_in=args.block, in_dtype=torch.float32,
                    device=args.device)
    n = (len(audio) // args.block) * args.block
    if n == 0:
        print("input shorter than one block", file=sys.stderr)
        return 1
    _, iq = pipe.process(audio[:n])
    raw = cfloat_to_iq_i16(iq)          # on the card; one copy to the host
    write_iq_file(args.out, raw)
    print(f"wrote {raw.shape[-1] // 2} IQ samples at "
          f"{audio_rate * 80 // 3} Hz to {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
