"""rtl_tcp client: live RTL-SDR ingestion over the network (counterpart of
sdr_tpu/io/rtl_tcp.py).

``rtl_tcp`` (shipped with librtlsdr) serves an RTL-SDR dongle over TCP
with a small public protocol:

* server -> client on connect: 12 bytes, the magic ``b"RTL0"``, then the
  big-endian u32 tuner type and u32 count of tuner gains;
* client -> server: 5-byte commands ``struct.pack(">BI", cmd, arg)``
  (0x01 frequency [Hz], 0x02 sample rate [Hz], 0x03 manual gain mode,
  0x04 tuner gain [tenths of dB], 0x05 frequency correction [ppm], 0x08
  RTL AGC);
* then a continuous stream of interleaved u8 IQ.

:class:`RtlTcpSource` sends the JAX client's commands in its order, then
a reader thread drains the socket into a bounded mailbox of whole blocks.
When the consumer falls behind the radio, the oldest block is dropped and
counted (:attr:`RtlTcpSource.dropped`): a live radio cannot be held back.
Its blocks feed the FM chain as recorded ones do (``apps/fm.py --in
rtl_tcp://host:port``).
"""

from __future__ import annotations

import socket
import struct
import threading
from collections import deque
from dataclasses import dataclass
from typing import Iterator, Optional, Tuple

import numpy as np

__all__ = ["RtlTcpParams", "RtlTcpSource", "rtl_tcp_source",
           "parse_rtl_tcp_url", "TUNER_NAMES"]

# command bytes of the rtl_tcp protocol
CMD_SET_FREQ = 0x01
CMD_SET_SAMPLE_RATE = 0x02
CMD_SET_GAIN_MODE = 0x03
CMD_SET_GAIN = 0x04
CMD_SET_FREQ_CORRECTION = 0x05
CMD_SET_AGC_MODE = 0x08

#: tuner type codes of the connect header (rtlsdr_get_tuner_type)
TUNER_NAMES = {0: "UNKNOWN", 1: "E4000", 2: "FC0012", 3: "FC0013",
               4: "FC2580", 5: "R820T", 6: "R828D"}


@dataclass
class RtlTcpParams:
    """The radio's settings: centre frequency and sample rate in Hz, the
    frequency correction in ppm, and the tuner gain in tenths of dB
    (``None``: the hardware AGC)."""

    center_freq: int
    sample_rate: int
    freq_correction: int = 0
    tuner_gain: Optional[int] = None


def parse_rtl_tcp_url(url: str) -> Tuple[str, int]:
    """'rtl_tcp://host:port' (or 'host:port') -> (host, port); raises
    ``ValueError`` otherwise."""
    rest = url[len("rtl_tcp://"):] if url.startswith("rtl_tcp://") else url
    host, _, port = rest.rpartition(":")
    if not host or not port.isdigit():
        raise ValueError(f"expected rtl_tcp://host:port, got {url!r}")
    return host, int(port)


class RtlTcpSource:
    """A connected rtl_tcp client: configures the radio, then iterates u8
    IQ blocks of exactly ``block`` items.

    A reader thread drains the socket into a mailbox of at most
    ``n_buffers`` whole blocks; on overrun the oldest is dropped and
    counted (:attr:`dropped`).  Iteration ends when the server closes the
    connection (a trailing partial block is dropped) or after
    :meth:`close`.  A server that does not answer with the magic raises
    ``ConnectionError``."""

    def __init__(self, host: str, port: int, params: RtlTcpParams,
                 block: int, n_buffers: int = 8,
                 connect_timeout: float = 10.0):
        if block <= 0 or block % 2:
            raise ValueError("block must be a positive even item count")
        self.block = int(block)
        self.params = params
        self._sock = socket.create_connection((host, port),
                                              timeout=connect_timeout)
        header = self._recv_exact(12)
        self._sock.settimeout(None)
        if header is None or header[:4] != b"RTL0":
            self._sock.close()
            raise ConnectionError(
                f"{host}:{port} is not an rtl_tcp server (bad magic)")
        self.tuner_type, self.tuner_gain_count = struct.unpack(
            ">II", header[4:])
        self._configure(params)
        self._mailbox: deque = deque()
        self._lock = threading.Lock()
        self._avail = threading.Semaphore(0)
        self._dropped = 0
        self._closed = False
        self._eof = False
        self._n_buffers = int(n_buffers)
        self._reader = threading.Thread(target=self._read_loop, daemon=True)
        self._reader.start()

    # -- control channel ---------------------------------------------------

    def _cmd(self, cmd: int, arg: int) -> None:
        self._sock.sendall(struct.pack(">BI", cmd, arg & 0xFFFFFFFF))

    def _configure(self, p: RtlTcpParams) -> None:
        """Sample rate, frequency, correction (when nonzero), then the gain:
        the hardware AGC, or manual mode and the gain."""
        self._cmd(CMD_SET_SAMPLE_RATE, p.sample_rate)
        self._cmd(CMD_SET_FREQ, p.center_freq)
        if p.freq_correction:
            self._cmd(CMD_SET_FREQ_CORRECTION, p.freq_correction)
        if p.tuner_gain is None:
            self._cmd(CMD_SET_GAIN_MODE, 0)
            self._cmd(CMD_SET_AGC_MODE, 1)
        else:
            self._cmd(CMD_SET_GAIN_MODE, 1)
            self._cmd(CMD_SET_GAIN, p.tuner_gain)

    def set_frequency(self, hz: int) -> None:
        """Retune while streaming."""
        self._cmd(CMD_SET_FREQ, hz)

    # -- data path ---------------------------------------------------------

    def _recv_exact(self, n: int) -> Optional[bytearray]:
        """``n`` bytes, or None at the end of the connection.  A bytearray:
        the block made of it is writable, as a tensor wants it."""
        buf = bytearray()
        while len(buf) < n:
            try:
                chunk = self._sock.recv(n - len(buf))
            except OSError:
                return None
            if not chunk:
                return None
            buf.extend(chunk)
        return buf

    def _read_loop(self) -> None:
        while not self._closed:
            data = self._recv_exact(self.block)
            if data is None:
                break
            blk = np.frombuffer(data, dtype=np.uint8)
            with self._lock:
                if len(self._mailbox) >= self._n_buffers:
                    self._mailbox.popleft()
                    self._dropped += 1
                    # the dropped block's permit goes with it, keeping
                    # permits == blocks in the mailbox
                    self._avail.acquire(blocking=False)
                self._mailbox.append(blk)
            self._avail.release()
        self._eof = True
        self._avail.release()          # wake a waiting consumer for the end

    @property
    def dropped(self) -> int:
        """Blocks discarded because the consumer fell behind."""
        return self._dropped

    def __iter__(self) -> Iterator[np.ndarray]:
        while True:
            self._avail.acquire()
            with self._lock:
                blk = self._mailbox.popleft() if self._mailbox else None
            if blk is not None:
                yield blk
            elif self._eof or self._closed:
                return
            # else a permit a drop raced for: wait again

    def close(self) -> None:
        """Shut the connection; the reader thread ends with it."""
        if not self._closed:
            self._closed = True
            try:
                self._sock.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            self._sock.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


def rtl_tcp_source(url: str, params: RtlTcpParams, block: int,
                   n_buffers: int = 8) -> RtlTcpSource:
    """Open ``rtl_tcp://host:port``, configure the radio and return the
    block source."""
    host, port = parse_rtl_tcp_url(url)
    return RtlTcpSource(host, port, params, block, n_buffers)
