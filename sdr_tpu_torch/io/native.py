"""ctypes bindings for the native block loader (counterpart of
sdr_tpu/io/native.py), built from the port's copy of its source,
``sdr_tpu_torch/native/sdr_loader.cpp``.

A C++ producer thread fills page-aligned block buffers in a bounded ring
with no interpreter lock involved: a file read ahead (and looped with
``repeat``) under backpressure, or UDP datagrams dropped and counted when
the ring is full.  The Python side copies each filled buffer out as an
array and releases its slot.

The library is built with ``g++`` on first use into ``build/native/`` at
the repository root, named by a digest of the source and the flags (an
edited source is rebuilt), and never beside the source.  Without ``g++``
the loader raises: nothing switches quietly to the Python readers
(``io/files.py``, ``io/net.py``).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Iterator, Optional

import numpy as np

__all__ = ["NativeLoader", "native_file_source", "native_udp_source",
           "build_native", "native_available"]

SOURCE = Path(__file__).resolve().parent.parent / "native" / "sdr_loader.cpp"
BUILD = Path(__file__).resolve().parents[2] / "build" / "native"
GXX_FLAGS = ["-O2", "-fPIC", "-shared", "-std=c++17", "-pthread"]

_lock = threading.Lock()
_lib = None


def library_path() -> Path:
    """Where the library for today's source and flags lives."""
    h = hashlib.sha1(SOURCE.read_bytes())
    h.update(" ".join(GXX_FLAGS).encode())
    return BUILD / f"libsdr_loader-{h.hexdigest()[:12]}.so"


def build_native(force: bool = False) -> Path:
    """Compile the loader with ``g++`` unless its library exists (or
    ``force``); returns the library's path.  Raises ``RuntimeError``
    without ``g++`` or when it fails."""
    out = library_path()
    if out.exists() and not force:
        return out
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError(f"native loader: no g++ on PATH to build "
                           f"{SOURCE.name}")
    BUILD.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run([gxx, *GXX_FLAGS, str(SOURCE), "-o", str(tmp)],
                          capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed for {SOURCE.name} (rc "
                           f"{proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, out)
    return out


def _load():
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(str(build_native()))
        lib.loader_open_file.restype = ctypes.c_void_p
        lib.loader_open_file.argtypes = [ctypes.c_char_p, ctypes.c_uint64,
                                         ctypes.c_int, ctypes.c_int]
        lib.loader_open_udp.restype = ctypes.c_void_p
        lib.loader_open_udp.argtypes = [ctypes.c_int, ctypes.c_uint64,
                                        ctypes.c_int]
        lib.loader_pop.restype = ctypes.c_int
        lib.loader_pop.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.POINTER(ctypes.c_uint8)),
            ctypes.POINTER(ctypes.c_uint64), ctypes.c_double]
        lib.loader_release.argtypes = [ctypes.c_void_p]
        lib.loader_dropped.restype = ctypes.c_int64
        lib.loader_dropped.argtypes = [ctypes.c_void_p]
        lib.loader_close.argtypes = [ctypes.c_void_p]
        _lib = lib
        return lib


def native_available() -> bool:
    """True if the loader builds (or is built) and loads here."""
    try:
        _load()
    except (RuntimeError, OSError, subprocess.SubprocessError):
        return False
    return True


class NativeLoader:
    """Iterator over the blocks the native ring produces, each a writable
    array of ``block`` items of ``dtype``.  ``timeout``: end the
    iteration after that many seconds without a block (None: wait until
    the producer ends)."""

    def __init__(self, handle, lib, block: int, dtype,
                 timeout: Optional[float] = None):
        self._h = handle
        self._lib = lib
        self.block = block
        self.dtype = np.dtype(dtype)
        self.timeout = -1.0 if timeout is None else float(timeout)
        self._closed = False

    @property
    def dropped(self) -> int:
        """Blocks dropped because the consumer fell behind (UDP only)."""
        return int(self._lib.loader_dropped(self._h))

    def __iter__(self) -> Iterator[np.ndarray]:
        nbytes = self.block * self.dtype.itemsize
        ptr = ctypes.POINTER(ctypes.c_uint8)()
        got = ctypes.c_uint64()
        while not self._closed:
            slot = self._lib.loader_pop(self._h, ctypes.byref(ptr),
                                        ctypes.byref(got), self.timeout)
            if slot < 0:                # -1 the end, -2 the timeout
                break
            try:
                # one copy out of the ring; the slot is then free to refill
                buf = np.ctypeslib.as_array(ptr, shape=(nbytes,)).copy()
            finally:
                self._lib.loader_release(self._h)
            yield buf.view(self.dtype)
        self.close()

    def close(self):
        """Stop the producer and free the ring."""
        if not self._closed:
            self._closed = True
            self._lib.loader_close(self._h)

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


def native_file_source(path, block: int, dtype=np.uint8, n_buffers: int = 4,
                       repeat: bool = False) -> NativeLoader:
    """Blocks of ``block`` items of ``dtype`` read from a file by the
    native thread (a trailing partial block dropped).  ``repeat=True``
    loops over the file for ever, a block wrapping from its end to its
    start."""
    lib = _load()
    nbytes = block * np.dtype(dtype).itemsize
    h = lib.loader_open_file(str(path).encode(), nbytes, n_buffers,
                             int(repeat))
    if not h:
        raise OSError(f"loader_open_file failed for {path}")
    return NativeLoader(h, lib, block, dtype)


def native_udp_source(port: int, block: int, dtype=np.uint8,
                      n_buffers: int = 8,
                      timeout: Optional[float] = None) -> NativeLoader:
    """Blocks of ``block`` items of ``dtype`` received as datagrams on
    ``port`` (every interface) by the native thread; datagrams shorter
    than a block are dropped, and so are (counted) blocks that find the
    ring full.  ``timeout``: end after that many seconds without one."""
    lib = _load()
    nbytes = block * np.dtype(dtype).itemsize
    h = lib.loader_open_udp(port, nbytes, n_buffers)
    if not h:
        raise OSError(f"loader_open_udp failed on port {port}")
    return NativeLoader(h, lib, block, dtype, timeout)
