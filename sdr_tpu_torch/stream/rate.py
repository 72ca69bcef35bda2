"""Throughput meter (counterpart of sdr_tpu/stream/rate.py:rate)."""

from __future__ import annotations

import time
from typing import Iterable

import torch

__all__ = ["rate"]


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
