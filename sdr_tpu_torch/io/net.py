"""UDP block streaming (counterpart of sdr_tpu/io/net.py), wire-compatible
with the JAX package's: one block a datagram, its raw little-endian sample
bytes, no framing.  A datagram holds at most 65,507 bytes, which caps a
block's size."""

from __future__ import annotations

import socket
from typing import Iterator, Optional, Tuple

import numpy as np

from sdr_tpu_torch.io.files import _host

__all__ = ["udp_source", "udp_sink"]

_MAX_DGRAM = 65507


def udp_source(bind: Tuple[str, int], block: int, dtype=np.uint8,
               timeout: Optional[float] = None) -> Iterator[np.ndarray]:
    """Yield the blocks of ``block`` items of ``dtype`` received as single
    datagrams on ``bind`` (host, port).  A datagram shorter than a block
    is dropped, a longer one cut to the block.  ``timeout``: end after
    that many seconds without a datagram (None: wait forever)."""
    dtype = np.dtype(dtype)
    nbytes = block * dtype.itemsize
    if nbytes > _MAX_DGRAM:
        raise ValueError(f"block of {nbytes} bytes exceeds UDP datagram max")
    sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    sock.setsockopt(socket.SOL_SOCKET, socket.SO_RCVBUF, 1 << 22)
    sock.bind(bind)
    if timeout is not None:
        sock.settimeout(timeout)
    try:
        while True:
            try:
                data, _ = sock.recvfrom(nbytes)
            except socket.timeout:
                return
            if len(data) < nbytes:
                continue
            yield np.frombuffer(data[:nbytes], dtype=dtype).copy()
    finally:
        sock.close()


def udp_sink(dest: Tuple[str, int]):
    """``(send, close)``: ``send`` transmits one block (an array or a
    tensor) as one datagram to ``dest``; a block over the datagram limit
    raises ``ValueError``."""
    sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    sock.setsockopt(socket.SOL_SOCKET, socket.SO_SNDBUF, 1 << 22)

    def send(block):
        b = np.ascontiguousarray(_host(block))
        if b.nbytes > _MAX_DGRAM:
            raise ValueError(
                f"block of {b.nbytes} bytes exceeds UDP datagram max")
        sock.sendto(b.tobytes(), dest)

    return send, sock.close
