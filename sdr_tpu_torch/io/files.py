"""Recorded-signal file sources and sinks (counterpart of
sdr_tpu/io/files.py): raw interleaved IQ in the common SDR formats
(``IQ_DTYPES``: u8 by default), whole or block by block, and a WAV sink.
Writers take numpy arrays or tensors (a CUDA tensor is copied to the host
once)."""

from __future__ import annotations

import time
import wave
from typing import Iterator

import numpy as np
import torch

__all__ = ["IQ_DTYPES", "iq_file_source", "follow_iq_file", "read_iq_file",
           "write_iq_file", "block_sink", "wav_sink"]

# raw interleaved formats of common SDR hardware and tools
IQ_DTYPES = {
    "u8": np.uint8,       # RTL-SDR
    "i16": np.int16,      # BladeRF
    "f32": np.float32,    # GNU Radio float IQ
    "c64": np.complex64,
}


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def read_iq_file(path, fmt: str = "u8", count: int = -1,
                 offset: int = 0) -> np.ndarray:
    """A whole raw IQ recording (or ``count`` items from byte ``offset``)
    as a flat array of ``fmt`` items."""
    return np.fromfile(path, dtype=IQ_DTYPES[fmt], count=count,
                       offset=offset)


def iq_file_source(path, block: int, fmt: str = "u8",
                   repeat: bool = False) -> Iterator[np.ndarray]:
    """Yield fixed-size blocks of ``block`` items of ``fmt`` (u8: RTL-SDR
    interleaved IQ) from a raw file; drops the trailing partial block.
    ``repeat=True`` rewinds at the end and goes on for ever (a file with
    no whole block yields nothing)."""
    dtype = IQ_DTYPES[fmt]
    with open(path, "rb") as fh:
        while True:
            whole = 0
            while True:
                b = np.fromfile(fh, dtype=dtype, count=block)
                if b.shape[0] < block:
                    break
                whole += 1
                yield b
            if not repeat or whole == 0:
                return
            fh.seek(0)


def follow_iq_file(path, block: int, fmt: str = "u8", poll: float = 0.2,
                   idle_timeout: float | None = None,
                   from_end: bool = False) -> Iterator[np.ndarray]:
    """Tail a growing raw IQ file, yielding each complete block of
    ``block`` items of ``fmt`` as it lands; a trailing partial block waits
    for the rest.  ``idle_timeout``: stop after that many seconds without
    growth (None: follow forever).  ``from_end=True`` starts at the last
    whole block boundary before the current end of file (``tail -f``)."""
    dtype = IQ_DTYPES[fmt]
    nbytes = block * np.dtype(dtype).itemsize
    with open(path, "rb") as fh:
        if from_end:
            fh.seek(0, 2)
            fh.seek(fh.tell() // nbytes * nbytes)
        idle = 0.0
        buf = bytearray()        # a writable block, handed over whole
        while True:
            chunk = fh.read(nbytes - len(buf))
            if chunk:
                idle = 0.0
                buf += chunk
                if len(buf) == nbytes:
                    yield np.frombuffer(buf, dtype=dtype)
                    buf = bytearray()
                continue
            if idle_timeout is not None and idle >= idle_timeout:
                return
            time.sleep(poll)
            idle += poll


def write_iq_file(path, x, fmt: str | None = None) -> None:
    """Write an array or tensor as a raw IQ file, in ``fmt``'s type or
    its own."""
    x = _host(x)
    if fmt is not None:
        x = x.astype(IQ_DTYPES[fmt])
    x.tofile(path)


def block_sink(path, fmt: str | None = None):
    """A consumer appending blocks (arrays or tensors) to a raw file, in
    ``fmt``'s type or their own.  Returns ``(write, close)``."""
    fh = open(path, "wb")

    def write(block):
        b = _host(block)
        if fmt is not None:
            b = b.astype(IQ_DTYPES[fmt])
        b.tofile(fh)

    return write, fh.close


def wav_sink(path, sample_rate: int = 48000, channels: int = 1):
    """A consumer writing 16-bit WAV.  Returns (write, close); ``write``
    takes float blocks in [-1, 1]: mono ``[n]``, or planar
    ``[channels, n]`` (the stereo chain's L/R), interleaved on write."""
    wf = wave.open(str(path), "wb")
    wf.setnchannels(channels)
    wf.setsampwidth(2)
    wf.setframerate(sample_rate)

    def write(block):
        b = np.asarray(block, dtype=np.float64)
        if channels > 1:
            if b.ndim != 2 or b.shape[0] != channels:
                raise ValueError(f"expected [{channels}, n] block, got "
                                 f"{b.shape}")
            b = b.T.reshape(-1)  # interleave frames
        elif b.ndim != 1:
            raise ValueError("mono sink got a multi-channel block: pass "
                             "channels= to wav_sink")
        pcm = np.clip(np.round(b * 32767), -32768, 32767).astype("<i2")
        wf.writeframes(pcm.tobytes())

    return write, wf.close
