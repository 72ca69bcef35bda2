"""Synthetic block producers and host-side stream combinators
(counterpart of sdr_tpu/stream/sources.py), numpy at the I/O boundary.

* ``stream_string`` / ``stream_random``: bit producers encoding 1/0 as
  float +-1 (the reference's SDR/Util.hs:288-323), for transmit testing.
* ``fork`` / ``combine`` / ``devnull`` / ``print_sink``: the pipe topology
  and instrumentation combinators (SDR/PipeUtils.hs:16-37) over block
  iterators on the host; on the card a fan-out is one output used twice.
* ``tone`` / ``noise`` / ``fm_mod``: signal generators for synthetic runs
  and tests.

Random blocks come from ``np.random.default_rng(seed)``, so a seed gives
the JAX package's blocks bit for bit.
"""

from __future__ import annotations

import itertools
from typing import Iterable, Iterator

import numpy as np

__all__ = ["stream_string", "stream_random", "fork", "combine", "devnull",
           "print_sink", "tone", "noise", "fm_mod"]


def stream_string(data: bytes, block: int) -> Iterator[np.ndarray]:
    """Endlessly stream the bits of ``data`` (LSB first in each byte) as
    f32 blocks of +-1, wrapping to the first bit after the last."""
    bits = np.unpackbits(np.frombuffer(data, dtype=np.uint8),
                         bitorder="little").astype(np.float32) * 2 - 1
    n = len(bits)
    if n == 0:
        raise ValueError("empty bit string")
    pos = 0
    while True:
        out = np.empty(block, dtype=np.float32)
        filled = 0
        while filled < block:
            take = min(block - filled, n - pos)
            out[filled:filled + take] = bits[pos:pos + take]
            filled += take
            pos = (pos + take) % n
        yield out


def stream_random(block: int, seed: int = 0) -> Iterator[np.ndarray]:
    """Endless random bit blocks as f32 +-1."""
    rng = np.random.default_rng(seed)
    while True:
        yield rng.integers(0, 2, block).astype(np.float32) * 2 - 1


def fork(blocks: Iterable, *consumers) -> None:
    """Drive several consumers (callables taking a block) from one
    producer."""
    for blk in blocks:
        for c in consumers:
            c(blk)


combine = fork   # the reference's combine is fork seen from the consumers


def devnull(blocks: Iterable) -> int:
    """Consume and discard; returns the number of blocks."""
    n = 0
    for _ in blocks:
        n += 1
    return n


def print_sink(blocks: Iterable, limit: int = 10) -> None:
    """Print the first ``limit`` blocks to stdout."""
    for blk in itertools.islice(blocks, limit):
        print(np.asarray(blk))


def tone(freq: float, n: int, fs: float = 1.0, amplitude: float = 1.0,
         dtype=np.complex64) -> np.ndarray:
    """Complex tone at ``freq`` Hz sampled at ``fs``."""
    t = np.arange(n) / fs
    return (amplitude * np.exp(2j * np.pi * freq * t)).astype(dtype)


def noise(n: int, scale: float = 1.0, seed: int = 0,
          complex_: bool = True) -> np.ndarray:
    """Gaussian noise of standard deviation ``scale`` (complex64, the
    power split over I and Q, or f32)."""
    rng = np.random.default_rng(seed)
    if complex_:
        return (scale * (rng.normal(size=n) + 1j * rng.normal(size=n))
                / np.sqrt(2)).astype(np.complex64)
    return (scale * rng.normal(size=n)).astype(np.float32)


def fm_mod(audio: np.ndarray, deviation: float, fs: float,
           amplitude: float = 0.9) -> np.ndarray:
    """FM-modulate audio to complex64 baseband in float64 on the host (test
    vectors; the stream op is ``stream.FmMod``)."""
    phase = 2 * np.pi * deviation * np.cumsum(audio) / fs
    return (amplitude * np.exp(1j * phase)).astype(np.complex64)
