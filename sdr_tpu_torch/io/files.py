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


def wav_sink(path, sample_rate: int = 48000):
    """A consumer writing 16-bit mono WAV.  Returns (write, close);
    ``write`` takes float blocks ``[n]`` in [-1, 1]."""
    wf = wave.open(str(path), "wb")
    wf.setnchannels(1)
    wf.setsampwidth(2)
    wf.setframerate(sample_rate)

    def write(block):
        b = np.asarray(block, dtype=np.float64)
        if b.ndim != 1:
            raise ValueError("mono sink got a multi-channel block")
        pcm = np.clip(np.round(b * 32767), -32768, 32767).astype("<i2")
        wf.writeframes(pcm.tobytes())

    return write, wf.close
