"""Multi-channel FM channelizer CLI (BASELINE config #5; counterpart of
sdr_tpu/apps/channelizer.py):

    python -m sdr_tpu_torch.apps.channelizer --channels 64 --synthetic \\
        --seconds 1 --out-prefix chan
    torchrun --nproc-per-node 4 -m sdr_tpu_torch.apps.channelizer \\
        --channels 64 --synthetic --wideband --out-prefix chan

Demodulates N FM channels at once.  Input: a raw complex64 file of
``[channels, N]`` rows (one baseband row per tuned channel), or with
``--wideband`` one wideband stream at ``channels * rate`` that the
polyphase DFT filterbank splits first; ``--synthetic`` (or no ``--in``)
makes the JAX app's synthetic input.  Writes one WAV a channel with
``--out-prefix``.

Under ``torchrun`` the ranks shard the work as the JAX app shards it over
its devices: the channels over the ranks (``run_channel_sharded``, each
rank its share of the channels from warmup), or with ``--wideband`` the
wideband stream's time over the largest number of ranks that divides it
(``run_time_sharded``, the seams' halos between ranks).  Each rank runs
on ``cuda:LOCAL_RANK``; an explicit ``--device`` pins every rank to that
device (NCCL refuses two ranks on one card, gloo takes them).  Rank 0
joins the outputs and writes the WAVs.  One process runs the whole input
as one block-parallel block (``run_time_batched(chain, x, 1)``), the same
samples.  Runs on the card; ``--device cpu`` runs the plain PyTorch
versions (with ``--backend gloo`` under ``torchrun``).
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np
import torch
import torch.distributed as dist

from sdr_tpu_torch.apps.chains import channelizer_chain
from sdr_tpu_torch.io.files import wav_sink
from sdr_tpu_torch.parallel import (gather_time_sharded, init_distributed,
                                    local_time_span, make_mesh,
                                    run_channel_sharded, run_time_batched,
                                    run_time_sharded)
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
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card, cuda:LOCAL_RANK "
                         "under torchrun; 'cpu' runs the plain PyTorch "
                         "versions)")
    ap.add_argument("--backend", default="nccl",
                    help="torch.distributed backend under torchrun: nccl "
                         "(default) or gloo")
    args = ap.parse_args(argv)

    init_distributed(args.backend)
    world = dist.get_world_size() if dist.is_initialized() else 1
    try:
        return _run(args, world)
    finally:
        if world > 1:
            dist.destroy_process_group()


def _run(args, world: int) -> int:
    device = args.device
    if device is None:
        device = f"cuda:{os.environ['LOCAL_RANK']}" if world > 1 else "cuda"
    device = resolve_device(device)
    if device.type == "cuda" and device.index is not None:  # cuda:N
        torch.cuda.set_device(device)
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
    if world == 1:
        y, n_dev = run_time_batched(chain, x, 1, device=device), 1
    else:
        y, n_dev = _sharded(chain, x, C, args.wideband, world, device)
    if y is None:                       # not rank 0: rank 0 writes
        return 0
    y = y.cpu().numpy()
    audio_rate = args.rate // 8 * 3 // 10
    print(f"demodulated {y.shape[0]} channels x {y.shape[1]} samples "
          f"at {audio_rate} Hz on {n_dev} devices")
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


def _sharded(chain, x, C: int, wideband: bool, world: int, device):
    """This rank's share of the bank, run sharded and joined on rank 0:
    ``(y, ranks used)`` on rank 0, ``(None, ranks used)`` elsewhere.  The
    JAX app's mesh sizes: time over the largest rank count whose spans
    keep whole 80-sample blocks a channel, or channels over the largest
    rank count that divides them."""
    if wideband:
        n = world
        while (len(x) // C) % (n * 80) or len(x) % n:
            n -= 1
        mesh = make_mesh((n,), ("t",), device.type)
        if mesh.get_coordinate() is None:     # a rank past the mesh
            return None, n
        off, length = local_time_span(mesh, len(x))
        y = run_time_sharded(chain, mesh, x[off:off + length],
                             device=device)
        return gather_time_sharded(y, mesh, "t"), n
    n = min(world, C)
    while C % n:
        n -= 1
    mesh = make_mesh((n,), ("c",), device.type)
    if mesh.get_coordinate() is None:
        return None, n
    per = C // n
    c0 = mesh.get_local_rank("c") * per
    y = run_channel_sharded(chain, mesh, x[c0:c0 + per], device=device)
    return gather_time_sharded(y, mesh, "c", dim=-2), n


if __name__ == "__main__":
    sys.exit(main())
