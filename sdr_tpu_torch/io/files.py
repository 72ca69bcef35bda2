"""Recorded-signal file source and WAV sink (counterpart of
sdr_tpu/io/files.py: iq_file_source, wav_sink)."""

from __future__ import annotations

import wave
from typing import Iterator

import numpy as np

__all__ = ["iq_file_source", "wav_sink"]


def iq_file_source(path, block: int) -> Iterator[np.ndarray]:
    """Yield fixed-size blocks of u8 items (RTL-SDR interleaved IQ) from a
    raw file; drops the trailing partial block."""
    with open(path, "rb") as fh:
        while True:
            b = np.fromfile(fh, dtype=np.uint8, count=block)
            if b.shape[0] < block:
                return
            yield b


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
