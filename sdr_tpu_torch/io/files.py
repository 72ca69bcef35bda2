"""Recorded-signal file sources and WAV sink (counterpart of
sdr_tpu/io/files.py: iq_file_source, follow_iq_file, wav_sink), u8 items
(RTL-SDR interleaved IQ)."""

from __future__ import annotations

import time
import wave
from typing import Iterator

import numpy as np

__all__ = ["iq_file_source", "follow_iq_file", "wav_sink"]


def iq_file_source(path, block: int) -> Iterator[np.ndarray]:
    """Yield fixed-size blocks of u8 items (RTL-SDR interleaved IQ) from a
    raw file; drops the trailing partial block."""
    with open(path, "rb") as fh:
        while True:
            b = np.fromfile(fh, dtype=np.uint8, count=block)
            if b.shape[0] < block:
                return
            yield b


def follow_iq_file(path, block: int, poll: float = 0.2,
                   idle_timeout: float | None = None,
                   from_end: bool = False) -> Iterator[np.ndarray]:
    """Tail a growing raw u8 IQ file, yielding each complete block of
    ``block`` items as it lands; a trailing partial block waits for the
    rest.  ``idle_timeout``: stop after that many seconds without growth
    (None: follow forever).  ``from_end=True`` starts at the last whole
    block boundary before the current end of file (``tail -f``)."""
    with open(path, "rb") as fh:
        if from_end:
            fh.seek(0, 2)
            fh.seek(fh.tell() // block * block)
        idle = 0.0
        buf = bytearray()        # a writable block, handed over whole
        while True:
            chunk = fh.read(block - len(buf))
            if chunk:
                idle = 0.0
                buf += chunk
                if len(buf) == block:
                    yield np.frombuffer(buf, dtype=np.uint8)
                    buf = bytearray()
                continue
            if idle_timeout is not None and idle >= idle_timeout:
                return
            time.sleep(poll)
            idle += poll


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
