"""Broadcast FM receiver CLI (counterpart of sdr_tpu/apps/fm.py).

Recorded capture:

    python -m sdr_tpu_torch.apps.fm --in capture.iq --out audio.wav \\
        --rate 1280K --block 1310720

Live radio through an rtl_tcp server (``--gain`` in tenths of dB, the
hardware AGC without it; ``--ppm`` the frequency correction):

    python -m sdr_tpu_torch.apps.fm --in rtl_tcp://radiohost:1234 \\
        --freq 90.2M --gain 496 --ppm 1

Reads RTL-SDR-format u8 interleaved IQ (1.28 MS/s by default) and writes
WAV at 3/80 of the input rate (48 kHz): mono, or L/R with ``--stereo``
(multiplex decode), optionally de-emphasised (``--deemphasis 75e-6``):

    python -m sdr_tpu_torch.apps.fm --in capture.iq --out audio.wav \\
        --front quantized --stereo --deemphasis 75e-6

Blocks run through the compiled step (``Pipeline.run``: a CUDA graph
captured at the second block and replayed after).  A live input first
runs the chain twice on blocks of silence (``prime``), so the card's
start-up and the capture are paid before the radio streams.  ``--audio``
plays the audio live through the optional ``sounddevice`` package
instead (and fails without it); ``--native`` reads a recording through
the C++ ring-buffer loader (built with g++ on first use).  The
front is the fused kernel unless ``--front`` names the quantized one or
the exact f32 stages (``--front exact``).  Runs on the card; ``--device
cpu`` runs the plain PyTorch versions.
"""

from __future__ import annotations

import argparse
import itertools
import sys

import numpy as np

from sdr_tpu_torch.apps.chains import fm_chain
from sdr_tpu_torch.io.files import iq_file_source, wav_sink
from sdr_tpu_torch.stream import Pipeline, rate as rate_meter
from sdr_tpu_torch.utils import parse_size


def prime(pipe: Pipeline, block: int, batched: int) -> None:
    """Run the chain twice, in the form the stream will take, on blocks of
    silence (u8 0x80), and wait for the result: the card's lazy start-up
    (module loads, library handles, the kernels' caches) in the first
    call and the capture of the compiled call (``Pipeline.run``'s step,
    or ``run_batched``'s group) in the second are then paid before a live
    radio streams, which cannot wait for them, so the first live block
    replays.  The stream itself starts
    from fresh carries, so its output is unchanged."""
    silence = np.full(block, 0x80, np.uint8)
    ys = (pipe.run_batched([silence] * 2 * batched, batched) if batched
          else pipe.run([silence] * 2))
    for y in ys:
        y.cpu()


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--in", dest="inp", required=True,
                    help="input raw u8 interleaved IQ file, or "
                         "rtl_tcp://host:port for a live radio")
    ap.add_argument("--out", default="audio.wav", help="output WAV file")
    ap.add_argument("--rate", default="1280K", type=parse_size,
                    help="input sample rate (complex S/s), e.g. 1280K")
    ap.add_argument("--freq", type=parse_size, default="90200K",
                    help="centre frequency for rtl_tcp sources, e.g. 90.2M")
    ap.add_argument("--gain", type=int, default=None,
                    help="tuner gain in tenths of dB (rtl_tcp; default: "
                         "the hardware AGC)")
    ap.add_argument("--ppm", type=int, default=0,
                    help="frequency correction in ppm (rtl_tcp)")
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
    ap.add_argument("--audio", action="store_true",
                    help="play live via sounddevice instead of a WAV")
    ap.add_argument("--native", action="store_true",
                    help="read the recording through the C++ ring-buffer "
                         "loader")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default: the card; 'cpu' runs the "
                         "plain PyTorch versions)")
    args = ap.parse_args(argv)

    # the pipeline first: without a GPU it raises before a radio is opened
    pipe = Pipeline(fm_chain(args.volume, front=args.front,
                             stereo=args.stereo, fs_in=float(args.rate),
                             deemphasis=args.deemphasis, device=args.device),
                    block_in=args.block, device=args.device)
    # block_in counts u8 items: two per complex sample
    audio_rate = 2 * args.rate * pipe.block_out // pipe.block_in
    channels = 2 if args.stereo else 1
    if args.audio:
        from sdr_tpu_torch.io.audio import audio_sink
        write, close = audio_sink(audio_rate, channels=channels)
    else:
        write, close = wav_sink(args.out, audio_rate, channels=channels)
    radio = None
    n = 0
    try:
        if args.inp.startswith("rtl_tcp://"):
            from sdr_tpu_torch.io.rtl_tcp import RtlTcpParams, rtl_tcp_source
            prime(pipe, args.block, args.batched)
            radio = rtl_tcp_source(
                args.inp, RtlTcpParams(args.freq, args.rate,
                                       freq_correction=args.ppm,
                                       tuner_gain=args.gain), args.block)
            source = iter(radio)
        elif args.native:
            from sdr_tpu_torch.io.native import native_file_source
            source = native_file_source(args.inp, args.block)
        else:
            source = iq_file_source(args.inp, args.block)
        if args.max_blocks:
            source = itertools.islice(source, args.max_blocks)
        if args.batched:
            blocks = pipe.run_batched(source, args.batched)
        else:
            blocks = pipe.run(source)
        if args.meter:
            blocks = rate_meter(blocks, pipe.block_out * max(1, args.batched))
        for y in blocks:
            write(y.cpu().numpy())
            n += y.shape[-1]
    finally:
        close()
        if radio is not None:
            radio.close()
            if radio.dropped:
                print(f"radio dropped {radio.dropped} blocks",
                      file=sys.stderr)
    dest = "audio device" if args.audio else args.out
    print(f"wrote {n} audio samples at {audio_rate} Hz to {dest}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
