"""Block (de)serialization (counterpart of sdr_tpu/io/serialize.py).

Raw blocks are their little-endian sample bytes; a framed block adds a
12-byte header (the magic ``b"SDRB"``, then ``<II``: a dtype code and the
item count) so a stream of blocks survives reblocking and truncation on a
byte channel.  The frames are byte for byte the JAX package's, so either
package reads what the other wrote.  Writers take numpy arrays or
tensors (a CUDA tensor is copied to the host once); readers return numpy.
"""

from __future__ import annotations

import struct
from typing import Iterator

import numpy as np

from sdr_tpu_torch.io.files import _host

__all__ = ["to_bytes", "from_bytes", "write_framed", "read_framed",
           "frame_blocks", "unframe_blocks"]

_MAGIC = b"SDRB"
# the JAX package's codes; a frame names its dtype by one of them
_DTYPES = {0: np.uint8, 1: np.int16, 2: np.float32, 3: np.complex64,
           4: np.float64, 5: np.int32}
_CODES = {np.dtype(v): k for k, v in _DTYPES.items()}


def to_bytes(block) -> bytes:
    """A block's raw little-endian sample bytes."""
    return np.ascontiguousarray(_host(block)).tobytes()


def from_bytes(data: bytes, dtype) -> np.ndarray:
    """Raw sample bytes as a (read-only) array of ``dtype``."""
    return np.frombuffer(data, dtype=dtype)


def frame_blocks(block) -> bytes:
    """One block with its 12-byte header: magic, dtype code, item count.
    Raises ``KeyError`` for a dtype without a code."""
    b = np.ascontiguousarray(_host(block))
    return _MAGIC + struct.pack("<II", _CODES[b.dtype], b.size) + b.tobytes()


def unframe_blocks(stream) -> Iterator[np.ndarray]:
    """The blocks of a byte stream (a file-like object) of frames, flat.
    A truncated trailing frame ends the stream; a bad magic raises
    ``ValueError``."""
    while True:
        hdr = stream.read(12)
        if len(hdr) < 12:
            return
        if hdr[:4] != _MAGIC:
            raise ValueError("bad frame magic")
        code, count = struct.unpack("<II", hdr[4:])
        dtype = np.dtype(_DTYPES[code])
        payload = stream.read(count * dtype.itemsize)
        if len(payload) < count * dtype.itemsize:
            return
        yield np.frombuffer(payload, dtype=dtype)


def write_framed(path, blocks) -> int:
    """Write an iterable of blocks to ``path`` as frames; returns the
    number of blocks."""
    n = 0
    with open(path, "wb") as fh:
        for b in blocks:
            fh.write(frame_blocks(b))
            n += 1
    return n


def read_framed(path) -> Iterator[np.ndarray]:
    """The blocks of a file of frames."""
    with open(path, "rb") as fh:
        yield from unframe_blocks(fh)
