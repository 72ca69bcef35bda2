"""Tracing and timing helpers on ``torch.profiler`` (counterpart of
sdr_tpu/utils/profiling.py).

``trace`` names a region in a profile, ``profile`` records one around a
block of code and writes it under a directory (open it in Perfetto or
``chrome://tracing``), and ``timed`` reports a region's wall time after
waiting for the card.
"""

from __future__ import annotations

import contextlib
import os
import time
from pathlib import Path
from typing import Iterator

import torch

from sdr_tpu_torch.utils.device import resolve_device

__all__ = ["trace", "profile", "timed"]


@contextlib.contextmanager
def trace(name: str) -> Iterator[None]:
    """A named region in the profile (``torch.profiler.record_function``)."""
    with torch.profiler.record_function(name):
        yield


@contextlib.contextmanager
def profile(logdir, device="cuda") -> Iterator[torch.profiler.profile]:
    """Record a ``torch.profiler`` trace of the block, the card's kernels
    included (``device='cpu'``: the host only), and write it on exit as
    ``trace-<pid>-<ns>.json`` under ``logdir``.  Raises without a GPU
    unless ``device='cpu'``."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if resolve_device(device).type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    out = Path(logdir)
    out.mkdir(parents=True, exist_ok=True)
    prof = torch.profiler.profile(activities=acts)
    with prof:
        yield prof
    prof.export_chrome_trace(
        str(out / f"trace-{os.getpid()}-{time.time_ns()}.json"))


@contextlib.contextmanager
def timed(label: str, sink=print, device="cuda") -> Iterator[None]:
    """Report ``label: <seconds>s`` to ``sink`` after the block, waiting
    first for the work queued on ``device``.  Raises without a GPU unless
    ``device='cpu'``."""
    dev = resolve_device(device)
    t0 = time.perf_counter()
    try:
        yield
    finally:
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        sink(f"{label}: {time.perf_counter() - t0:.4f}s")
