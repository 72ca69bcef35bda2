"""Build and bind the hand-written CUDA kernels.

Each ``csrc/<name>.cu`` exposes plain C launch functions.  On first use it
is compiled with ``nvcc -gencode arch=compute_90a,code=sm_90a`` into a
shared library under ``build/kernels/`` at the repository root (named by
a digest of source and flags, so an edited source is rebuilt), and loaded
with ``ctypes``.  Every launch function takes the CUDA stream last and
returns ``cudaGetLastError()``; a nonzero code raises here.  Each library
links its own CUDA runtime, so every launch first selects the tensors'
device in it (``kernel_set_device``).  A launch
function never synchronises and allocates nothing: wrappers allocate
outputs with ``torch.empty`` and validate shapes before calling.

Nothing here runs at import: the CPU tests import every module, on hosts
that have no ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

__all__ = ["Kernel", "build_all", "cuda_rows", "ptr"]

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    return os.path.join(home, "bin", "nvcc")


def ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def cuda_rows(**tensors) -> int:
    """Rows of a launch (the product of the first tensor's leading dims);
    raises unless every tensor is contiguous and the rows fit the grid."""
    for name, t in tensors.items():
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    lead = next(iter(tensors.values())).shape[:-1]
    rows = 1
    for d in lead:
        rows *= d
    if rows > 65535:
        raise ValueError(f"{rows} rows exceed the kernel grid")
    return rows


class Kernel:
    """One CUDA source, its ctypes bindings and its launch count.

    ``functions`` maps each exported launch function to its argument
    types, the stream excluded.  ``launches`` counts successful launches
    made through :meth:`launch` and nothing else."""

    def __init__(self, name: str, functions: dict):
        self.name = name
        self.source = CSRC / f"{name}.cu"
        self.functions = functions
        self.launches = 0
        self.build_log = ""
        self._lib = None

    def library_path(self) -> Path:
        h = hashlib.sha1(self.source.read_bytes())
        h.update(" ".join(NVCC_FLAGS).encode())
        return BUILD / f"lib{self.name}-{h.hexdigest()[:12]}.so"

    def start_build(self):
        """Start nvcc for this source unless its library exists; returns
        the running process (or None) and the temporary output path."""
        out = self.library_path()
        if out.exists():
            return None, out
        BUILD.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(self.source)]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        return proc, tmp

    def finish_build(self, proc, tmp) -> None:
        if proc is None:
            return
        self.build_log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed for {self.source.name} (rc {proc.returncode}):"
                f"\n{self.build_log}")
        os.replace(tmp, self.library_path())

    def lib(self):
        if self._lib is None:
            self.finish_build(*self.start_build())
            lib = ctypes.CDLL(str(self.library_path()))
            for fn, argtypes in self.functions.items():
                f = getattr(lib, fn)
                f.argtypes = [*argtypes, ctypes.c_void_p]
                f.restype = ctypes.c_int
            lib.kernel_error_string.argtypes = [ctypes.c_int]
            lib.kernel_error_string.restype = ctypes.c_char_p
            lib.kernel_set_device.argtypes = [ctypes.c_int]
            lib.kernel_set_device.restype = ctypes.c_int
            self._lib = lib
        return self._lib

    def launch(self, fn: str, device: torch.device, *args) -> None:
        lib = self.lib()
        index = device.index
        if index is None:
            index = torch.cuda.current_device()
        rc = lib.kernel_set_device(index)
        if rc == 0:
            stream = torch.cuda.current_stream(device).cuda_stream
            rc = getattr(lib, fn)(*args, ctypes.c_void_p(stream))
        if rc != 0:
            msg = lib.kernel_error_string(rc).decode()
            raise RuntimeError(f"{self.name}.{fn} launch failed: {msg}")
        self.launches += 1


def build_all(kernels) -> None:
    """Build every kernel's library at once: one nvcc per source, all
    started together, then waited for."""
    started = [(k, *k.start_build()) for k in kernels]
    errors = []
    for k, proc, tmp in started:
        try:
            k.finish_build(proc, tmp)
        except RuntimeError as e:   # wait for every nvcc before raising
            errors.append(str(e))
    if errors:
        raise RuntimeError("\n".join(errors))
