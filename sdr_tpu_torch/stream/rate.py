"""Throughput metering (counterpart of sdr_tpu/stream/rate.py): the
``rate`` passthrough and the ``Timer`` context manager.  Card work is
asynchronous, so both wait for it before reading the clock; otherwise
they would time the enqueue, not the work."""

from __future__ import annotations

import time
from typing import Iterable

import torch

from sdr_tpu_torch.utils.device import resolve_device

__all__ = ["rate", "Timer"]


def rate(blocks: Iterable, samples_per_block: int, every: int = 10,
         sink=print):
    """Passthrough generator printing the streaming rate every ``every``
    blocks; waits for a CUDA block's work before reading the clock."""
    start = time.perf_counter()
    for i, blk in enumerate(blocks, start=1):
        if isinstance(blk, torch.Tensor) and blk.is_cuda:
            torch.cuda.synchronize(blk.device)
        if i % every == 0:
            dt = time.perf_counter() - start
            sink(f"{i * samples_per_block / dt:.3e} samples/sec")
        yield blk


class Timer:
    """Context manager measuring wall time in ``seconds``, waiting on exit
    for the work queued on ``device`` (``torch.cuda.synchronize``).
    Raises without a GPU unless ``device='cpu'``, which has nothing to
    wait for."""

    def __init__(self, device="cuda"):
        self.device = resolve_device(device)

    def __enter__(self):
        self.start = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.seconds = time.perf_counter() - self.start
        return False
