"""K3: strided FIR (csrc/fir.cu).

Counterpart of sdr_tpu/kernels/fir_pallas.py:fir_strided, for any
``start >= 0`` and ``factor >= 1``.  The kernel plans its own branch,
tiles and shared memory from the taps and the factor before it launches
(:func:`plan` reads that plan):

* factor 1: register-tiled sums over staged 3072-output tiles;
* factor > 1, the staged polyphase branch: tiles of ``8192 // factor``
  outputs (at most 1024) staged once, split into ``factor`` phase rows in
  shared memory and summed in tap order; it takes every tap count whose
  buffers fit a block, on an H100 up to 14,520 taps at factor 2, 14,496
  at 8 and 14,493 at 16 (so ``ceil(taps / factor) <= 897``, the TPU
  kernel's range, at every factor up to 16);
* factor > 1 past that switch: one thread an output, up to 58,112 taps.

A launch whose taps do not fit a block's shared memory (more than 17,316
taps at factor 1, 58,112 above, on an H100) raises.

Complex64 ``x`` takes the complex form, ``y`` complex64: each output's
real and imaginary sums are the real form's over the I and the Q values,
in the same order, so the output is bitwise the real form over the
``[..., 2, n]`` planes (the JAX package's ``_dispatch``).  It reads ``x``
where it lies, in one of two layouts (:func:`complex_layout`), and any
other layout raises:

* ``"rows"``: the last axis has stride 1 and the leading axes fold into
  rows at one stride (the exact front's convert, the complex ``Mix``, the
  narrowband basebands).  At factor > 1 the staged branch over the
  interleaved floats: tiles of ``8192 // factor`` outputs halved until
  they fit two blocks an SM (512 at 51 taps and factor 8, 256 at 64 taps
  and factor 16), split into ``2 * factor`` phase rows; on an H100 it
  takes up to 8,293 taps at factor 2, 8,280 at 8 and 8,229 at 16.
* ``"channel-major"``: the last two axes are a transpose of a contiguous
  ``[..., n, C]`` (strides ``(1, C)``; ``Channelize``'s output), at any
  factor: tiles of 32 channels x up to 64 outputs staged a time sample
  at a time (21 outputs at 51 taps and factor 8, 10 at 64 taps and
  factor 16); up to 449 taps at any factor.
* anything else of either layout (factor 1 rows, taps past the staged
  branches): one thread an output, up to 58,112 taps.

``out=`` (complex form only) takes a complex64 view of ``y``'s shape
whose rows lie at any stride, its last axis contiguous; the launch
writes there and allocates nothing.
"""

from __future__ import annotations

import ctypes
import math

import torch

from sdr_tpu_torch.kernels._build import Kernel, cuda_rows, ptr

__all__ = ["KERNEL", "LAYOUTS", "complex_layout", "fir_strided",
           "fir_strided_reference", "plan"]

_P, _LL, _I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
KERNEL = Kernel("fir", {
    "launch_fir": [_P, _P, _P, _LL, _LL, _LL, _I, _I, _LL],
    "launch_fir_complex": [_P, _P, _P, _LL, _LL, _LL, _I, _LL, _LL, _LL, _I,
                           _I, _LL],
})


BRANCHES = ("factor 1", "staged", "per output", "channel tile")
LAYOUTS = ("rows", "channel-major")


def plan(n_taps: int, factor: int, device=None,
         layout: str | None = None) -> dict:
    """The kernel's own plan for a launch of ``n_taps`` taps at
    ``factor`` on a CUDA device, of the real form or (``layout`` one of
    LAYOUTS) the complex form: ``{"branch": one of BRANCHES, "tile":
    outputs of a tile, "smem": shared-memory bytes of a block}``.  Raises
    where the taps do not fit, as the launch would."""
    device = torch.device("cuda") if device is None else torch.device(device)
    if device.type != "cuda":
        raise ValueError(f"the plan is the CUDA kernel's, not {device}'s")
    lib = KERNEL.lib()
    index = torch.cuda.current_device() if device.index is None else \
        device.index
    out = [_I() for _ in range(3)]
    refs = [ctypes.byref(v) for v in out]
    rc = lib.kernel_set_device(index)
    if rc == 0 and layout is None:
        lib.fir_plan.argtypes = [_I, _I, *[ctypes.POINTER(_I)] * 3]
        rc = lib.fir_plan(int(n_taps), int(factor), *refs)
    elif rc == 0:
        lib.fir_plan_complex.argtypes = [_I, _I, _I,
                                         *[ctypes.POINTER(_I)] * 3]
        rc = lib.fir_plan_complex(int(n_taps), int(factor),
                                  LAYOUTS.index(layout), *refs)
    if rc != 0:
        raise RuntimeError(f"fir plan failed: "
                           f"{lib.kernel_error_string(rc).decode()}")
    branch, tile, smem = (v.value for v in out)
    return {"branch": BRANCHES[branch], "tile": tile, "smem": smem}


def _fold(shape, strides):
    """The one stride at which the axes ``shape`` (with ``strides``) fold
    into consecutive rows, or None where they do not (size-1 axes take
    any stride)."""
    stride, inner = None, 1
    for d, s in zip(reversed(shape), reversed(strides)):
        if d != 1:
            if stride is None:
                stride = s
            elif s != stride * inner:
                return None
        inner *= d
    return 0 if stride is None else stride


def complex_layout(x: torch.Tensor):
    """``(layout, batch, channels, batch_stride)`` of a complex ``x`` as
    the complex form reads it in place (strides in complex elements), or
    None where it takes neither layout: ``"rows"`` (``channels`` 1), the
    last axis contiguous and the leading axes folding into ``batch`` rows
    ``batch_stride`` apart; ``"channel-major"``, the last two axes
    ``[C, n]`` at strides ``(1, C)`` and the axes before them folding
    into ``batch`` rows."""
    shape, strides = tuple(x.shape), x.stride()
    n = shape[-1] if shape else 1
    if shape and (n == 1 or strides[-1] == 1):
        bs = _fold(shape[:-1], strides[:-1])
        if bs is not None:
            return "rows", math.prod(shape[:-1]), 1, bs
    if len(shape) >= 2:
        C = shape[-2]
        if (C == 1 or strides[-2] == 1) and (n == 1 or strides[-1] == C):
            bs = _fold(shape[:-2], strides[:-2])
            if bs is not None:
                return "channel-major", math.prod(shape[:-2]), C, bs
    return None


def _check(taps, x, num, factor, start, out=None):
    if taps.dtype != torch.float32 or taps.ndim != 1:
        raise ValueError("taps must be a 1-D float32 tensor")
    if x.dtype not in (torch.float32, torch.complex64):
        raise ValueError(f"x must be float32 or complex64, not {x.dtype}")
    if taps.device != x.device:
        raise ValueError("taps and x must share a device")
    if x.is_complex() and complex_layout(x) is None:
        raise ValueError(f"the complex form reads rows (last stride 1) or "
                         f"channel-major [..., C, n] (strides (1, C)), not "
                         f"shape {tuple(x.shape)} at strides {x.stride()}")
    if out is not None:
        if not x.is_complex():
            raise ValueError("out= is the complex form's")
        if out.dtype != torch.complex64 or out.device != x.device:
            raise ValueError("out must be complex64 on x's device")
        if tuple(out.shape) != tuple(x.shape[:-1]) + (num,):
            raise ValueError(f"out has shape {tuple(out.shape)}, not "
                             f"{tuple(x.shape[:-1]) + (num,)}")
        lay = complex_layout(out)
        if lay is None or lay[0] != "rows":
            raise ValueError(f"out's rows need a contiguous last axis and "
                             f"one row stride, not strides {out.stride()}")
    if factor < 1 or start < 0 or num < 0:
        raise ValueError(f"bad geometry factor={factor} start={start} "
                         f"num={num}")
    if num and start + (num - 1) * factor + taps.shape[0] > x.shape[-1]:
        raise ValueError(f"{num} outputs of {taps.shape[0]} taps at stride "
                         f"{factor} from {start} read past {x.shape[-1]} "
                         "inputs")


def _sums(taps, x, num, factor, start):
    acc = torch.zeros(x.shape[:-1] + (num,), dtype=torch.float32,
                      device=x.device)
    span = (num - 1) * factor + 1
    for j, t in enumerate(taps.tolist()):
        lo = start + j
        acc = acc + t * x[..., lo: lo + span: factor]
    return acc


def fir_strided_reference(taps, x: torch.Tensor, num: int, factor: int = 1,
                          start: int = 0, out: torch.Tensor | None = None
                          ) -> torch.Tensor:
    """Plain PyTorch version of :func:`fir_strided`: complex ``x`` sums its
    real and imaginary views in the same tap order, so it is bitwise the
    real form over the ``[..., 2, n]`` planes."""
    _check(taps, x, num, factor, start, out)
    if not x.is_complex():
        return _sums(taps, x, num, factor, start)
    y = torch.complex(_sums(taps, x.real, num, factor, start),
                      _sums(taps, x.imag, num, factor, start))
    if out is None:
        return y
    return out.copy_(y)


def fir_strided(taps, x: torch.Tensor, num: int, factor: int = 1,
                start: int = 0, out: torch.Tensor | None = None
                ) -> torch.Tensor:
    """``y[..., i] = sum_j taps[j] * x[..., start + i*factor + j]``, f32 or
    complex64 (then into ``out`` if given, which it returns).  Launches
    K3 for CUDA tensors; CPU tensors take the plain version."""
    num, factor, start = int(num), int(factor), int(start)
    if x.device.type == "cpu":
        return fir_strided_reference(taps, x, num, factor, start, out)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    _check(taps, x, num, factor, start, out)
    if x.is_complex():
        return _launch_complex(taps, x, num, factor, start, out)
    rows = cuda_rows(x=x, taps=taps)
    y = torch.empty(x.shape[:-1] + (num,), dtype=torch.float32,
                    device=x.device)
    if num == 0 or rows == 0:
        return y
    KERNEL.launch("launch_fir", x.device, ptr(x), ptr(taps), ptr(y), rows,
                  x.shape[-1], num, taps.shape[0], factor, start)
    return y


def _launch_complex(taps, x, num, factor, start, out):
    if not taps.is_contiguous():
        raise ValueError("taps must be contiguous")
    layout, batch, C, bs = complex_layout(x)
    y = out if out is not None else torch.empty(
        x.shape[:-1] + (num,), dtype=torch.complex64, device=x.device)
    if num == 0 or batch * C == 0:
        return y
    ys = complex_layout(y)[3]
    KERNEL.launch("launch_fir_complex", x.device, ptr(x), ptr(taps), ptr(y),
                  batch, C, bs, LAYOUTS.index(layout), x.shape[-1], ys, num,
                  taps.shape[0], factor, start)
    return y
