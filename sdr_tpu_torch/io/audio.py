"""Live audio sink over the optional ``sounddevice`` package (PortAudio),
the counterpart of sdr_tpu/io/audio.py.

Playback runs on its own thread behind a bounded queue, so a slow audio
device holds the producer back at the queue, not inside the DSP chain.
Hosts with the card are usually headless and lack the package:
:func:`audio_available` says so, and :func:`audio_sink` raises.  Nothing
here installs it, and nothing writes a WAV in its place (``wav_sink`` in
io/files.py is the recorded sink).
"""

from __future__ import annotations

import queue
import threading

import numpy as np

from sdr_tpu_torch.io.files import _host

__all__ = ["audio_available", "audio_sink"]


def _import_sd():
    try:
        import sounddevice  # type: ignore
    except (ImportError, OSError):  # absent, or PortAudio fails to load
        return None
    return sounddevice


def audio_available() -> bool:
    """True if the optional ``sounddevice`` backend imports."""
    return _import_sd() is not None


def audio_sink(sample_rate: int = 48000, queue_blocks: int = 2,
               channels: int = 1):
    """``(write, close)`` playing float blocks in [-1, 1]: mono ``[n]`` or
    planar ``[channels, n]`` (the stereo chain's L/R), as arrays or
    tensors.  ``queue_blocks``: the queue's depth between the producer and
    the playback thread.  Raises ``RuntimeError`` naming ``sounddevice``
    when the backend is absent."""
    sd = _import_sd()
    if sd is None:
        raise RuntimeError(
            "live audio needs the sounddevice package, which is not "
            "installed; write a WAV with sdr_tpu_torch.io.wav_sink instead")
    q: queue.Queue = queue.Queue(maxsize=queue_blocks)
    stream = sd.OutputStream(samplerate=sample_rate, channels=channels,
                             dtype="float32")
    stream.start()
    done = object()

    def run():
        while True:
            blk = q.get()
            if blk is done:
                break
            stream.write(blk)
        stream.stop()
        stream.close()

    t = threading.Thread(target=run, daemon=True)
    t.start()

    def write(block):
        b = np.asarray(_host(block), dtype=np.float32)
        if channels > 1:
            b = b.T                      # [channels, n] -> frames
        q.put(np.ascontiguousarray(b.reshape(-1, channels)))

    def close():
        q.put(done)
        t.join(timeout=10)

    return write, close
