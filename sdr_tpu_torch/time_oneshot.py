"""Wall time of the calls a user makes once, where a compiled call's
capture cannot pay for itself over later calls:

* the transmitter CLI (``apps.fm_tx``) on a TX_SECONDS, 1 kHz WAV at
  48 kHz, and the AM CLI (``apps.am``) on AM_SECONDS of a seeded AM
  recording: each as a command (``python -m``, its whole wall time) and
  its ``main`` in this process (the pipeline built anew at every call,
  as a command builds it; the process's lazy start-up paid by a call
  before the timed ones);
* in this process, each on a fresh ``Pipeline(fm_chain())``:
  ``process(parallel_blocks=GROUP)`` on a recording of one group (GROUP
  x 1,310,720 bytes), then the same call again on the same pipeline,
  and ``process()`` over SHORT_BLOCKS blocks.

Every call is timed by the host's clock around it, with the card
synchronised after it; each figure is the median of ``--reps`` calls.
It uses only the port's public entry points, so it times any tree of the
port: copy it into that tree's ``sdr_tpu_torch/`` and run it from the
tree's root (a parent commit's and a change's, in turns, in one session
on one card)::

    python -m sdr_tpu_torch.time_oneshot [--reps 3] [--out times.json]

Prints the card's name and power limit and one JSON line.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time
import wave
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
TX_SECONDS, TX_RATE = 60, 48_000
AM_SECONDS, AM_BLOCK = 10, 1_048_576
FM_BLOCK = 1_310_720
GROUP = 8
SHORT_BLOCKS = 4


def write_tone_wav(path: str) -> None:
    t = np.arange(TX_SECONDS * TX_RATE) / TX_RATE
    pcm = (0.5 * 32767 * np.sin(2 * np.pi * 1000.0 * t)).astype("<i2")
    with wave.open(path, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(TX_RATE)
        w.writeframes(pcm.tobytes())


def am_recording(seed: int) -> np.ndarray:
    """u8 IQ of a carrier at 0.25 cycles/sample, 80 % modulated by 500
    Hz, at 1.28 MS/s, with seeded noise: whole AM_BLOCK blocks."""
    n = AM_SECONDS * 1_280_000 // (AM_BLOCK // 2) * (AM_BLOCK // 2)
    k = np.arange(n)
    v = 0.5 * (1 + 0.8 * np.sin(2 * np.pi * 500 / 1_280_000 * k)) * np.exp(
        0.5j * np.pi * k)
    rng = np.random.default_rng(seed)
    v += 0.01 * (rng.standard_normal(n) + 1j * rng.standard_normal(n))
    raw = np.empty(2 * n, np.uint8)
    raw[0::2] = np.clip(np.round(v.real * 128 + 128), 0, 255)
    raw[1::2] = np.clip(np.round(v.imag * 128 + 128), 0, 255)
    return raw


def fm_recording(n_bytes: int, seed: int) -> torch.Tensor:
    """u8 IQ of an FM broadcast (a 1 kHz tone, 75 kHz deviation) on the
    card."""
    n = n_bytes // 2
    t = np.arange(n) / 1_280_000
    iq = 0.9 * np.exp(1j * 2 * np.pi * 75e3 * np.cumsum(
        np.sin(2 * np.pi * 1e3 * t)) / 1_280_000)
    iq += 0.01 * np.random.default_rng(seed).standard_normal(n)
    raw = np.empty(2 * n, np.uint8)
    raw[0::2] = np.clip(np.round(iq.real * 128 + 128), 0, 255)
    raw[1::2] = np.clip(np.round(iq.imag * 128 + 128), 0, 255)
    return torch.from_numpy(raw).cuda()


def timed(fn) -> float:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def median_s(fn, reps: int) -> float:
    return statistics.median(timed(fn) for _ in range(reps))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", type=Path, default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("time_oneshot: no CUDA GPU available", file=sys.stderr)
        return 1
    from sdr_tpu_torch.apps import am, fm_tx
    from sdr_tpu_torch.apps.chains import fm_chain
    from sdr_tpu_torch.kernels import KERNELS
    from sdr_tpu_torch.kernels._build import build_all
    from sdr_tpu_torch.stream import Pipeline

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(card)
    build_all(KERNELS)
    rec = {"tree": str(ROOT), "card": card, "reps": args.reps}
    with tempfile.TemporaryDirectory() as tmp:
        wav, iq = os.path.join(tmp, "tone.wav"), os.path.join(tmp, "am.iq")
        write_tone_wav(wav)
        am_recording(args.seed).tofile(iq)
        clis = {"fm_tx": (fm_tx.main, ["--in", wav, "--out",
                                       os.path.join(tmp, "tx.iq")]),
                "am": (am.main, ["--in", iq, "--out",
                                 os.path.join(tmp, "am.wav")])}
        for name, (entry, argv_) in clis.items():
            entry(argv_)                    # the process's lazy start-up
            rec[f"{name}_main_s"] = median_s(lambda: entry(argv_), args.reps)
            rec[f"{name}_command_s"] = median_s(lambda: subprocess.run(
                [sys.executable, "-m", f"sdr_tpu_torch.apps.{name}",
                 *argv_], cwd=ROOT, check=True, capture_output=True),
                args.reps)

    one_group = fm_recording(GROUP * FM_BLOCK, args.seed)
    short = one_group[:SHORT_BLOCKS * FM_BLOCK]

    def fresh():
        return Pipeline(fm_chain(), block_in=FM_BLOCK)

    fresh().process(one_group, parallel_blocks=GROUP)     # start-up
    rec["process_one_group_fresh_s"] = median_s(
        lambda: fresh().process(one_group, parallel_blocks=GROUP), args.reps)
    pipe = fresh()
    pipe.process(one_group, parallel_blocks=GROUP)
    pipe.process(one_group, parallel_blocks=GROUP)
    rec["process_one_group_again_s"] = median_s(
        lambda: pipe.process(one_group, parallel_blocks=GROUP), args.reps)
    rec["process_short_fresh_s"] = median_s(
        lambda: fresh().process(short), args.reps)
    rec.update(group_bytes=GROUP * FM_BLOCK, short_blocks=SHORT_BLOCKS,
               tx_seconds=TX_SECONDS, am_seconds=AM_SECONDS)
    line = json.dumps(rec)
    print(line)
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        with open(args.out, "a") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
