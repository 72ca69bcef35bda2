"""K14: the stereo decoder's pilot lock and cascade (csrc/stereo_decode.cu).

``StereoDecode``'s pilot, carrier, difference and mono filters and glue.

No TPU kernel has this role: the JAX package runs the decoder's five
65-tap filters through its FIR dispatch (the Pallas ``fir_strided`` or
XLA's conv) and the glue as XLA fusions (sdr_tpu/stream/ops.py:732-795).
Over rows of the composite ``x [..., n]`` with each row's history
``hist [..., 192]`` (``xe = [hist | x]``, read through two pointers), and
``fir(t, v)[i] = sum_j t[j] * v[i + j]``:

    pilot = fir(bp19, xe), sq = pilot^2
    car = fir(bp38, sq), norm = avg[0] * sum(sq[k: k + 65])
    prod = xe[64:] * (car * norm / (norm * norm + pilot_floor^2))
    diff = fir(lp15, prod)[:n], m = fir(lp15, xe)[64: 64 + n]
    s = diff * gain * gate,  y = [m + s, m - s]          (L, R)

Two launches: :func:`pilot_lock` (launch A) sums ``sq`` and ``xe * xe``
over each row in an order fixed by the geometry and gives ``r =
mean(sq) / (mean(xe * xe) + 1e-12)``, the new lock state and the row's
affine map ``(a, b)`` on the lock, and writes ``sq`` where it is given a
``[..., n + 128]`` buffer; :func:`stereo_decode` (launch B) stages that
``sq`` and runs the rest of the cascade tile by tile in shared memory,
gated by the lock on the device, and writes the L and R planes.
:func:`decode` runs both as ``StereoDecode.apply`` needs them;
``StereoDecode.shard_carry`` runs launch A alone.

Numbers.  Each 65-tap sum runs in tap order from +0, each step one
fused multiply-add rounded once (the card's ``__fmaf_rn``); the moving
average is the boxcar ``avg[0] * S``, ``S[k]`` the sum of ``sq[k .. k +
64]`` built from the partial sums each quad of outputs shares, in the
order the source writes down; the elementwise steps are one rounded f32
operation each, in the decoder's order.  The plain versions
(``*_reference``) take each FMA exactly (:func:`fma_f32`, in float64 with
a round to odd: :func:`fir_fma_reference`), the boxcar in the kernel's
quad order (:func:`boxcar_reference`) and the row sums in the kernel's
order (:func:`row_sum`), so they equal the kernels bitwise, ``r`` and the
lock included.  They differ from the decoder's former composition on
K3's plain version (a product and a sum rounded apiece, the average as a
fourth filter) by rounding only.
"""

from __future__ import annotations

import ctypes
import weakref

import numpy as np
import torch

from sdr_tpu_torch.kernels._build import Kernel, ptr
from sdr_tpu_torch.kernels._fma import fma_f32
from sdr_tpu_torch.kernels.fir import _fold

__all__ = ["KERNEL", "HISTORY", "TAPS", "TILE", "OUT_TILE",
           "boxcar_reference", "decode", "fir_fma_reference", "pilot_lock",
           "pilot_lock_reference", "row_sum", "scratch_floats",
           "stereo_decode", "stereo_decode_reference"]

TAPS = 65                       # every filter's taps
HISTORY = 3 * (TAPS - 1)        # 192 composite samples carried
THREADS, GROUPS, RUN = 256, 3, 4    # the row sums: threads, groups, runs
TILE = THREADS * GROUPS * RUN   # launch A's tile: 3072 pilot outputs
OUT_TILE = TILE - 2 * (TAPS - 1)    # launch B's tile: 2944 outputs
_F32 = torch.float32

_P, _LL, _F = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_float
KERNEL = Kernel("stereo_decode", {
    "launch_pilot_power": [_P, _LL, _P, _LL, _LL, _LL, _P, _P, _F, _F, _P,
                           _P, _P, _P, _LL, _P],
    "launch_stereo_cascade": [_P, _LL, _P, _LL, _LL, _LL, _P, _P, _F, _F,
                              _P, _P],
})


def scratch_floats(rows: int, n: int) -> int:
    """Floats of launch A's scratch: each tile's two sums, then each row's
    completion count."""
    tiles = -(-(n + HISTORY) // TILE)
    return 2 * rows * tiles + rows


def row_sum(v: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis in launch A's order: tiles of TILE values;
    a thread's 12 values of a tile (u = 4 (t + 256 g) + j, g then j) in
    turn from +0; a pairwise tree over the 256 threads (at each level
    entry t adds entry t + half); the tiles in index order from +0."""
    n = v.shape[-1]
    tiles = max(-(-n // TILE), 1)
    v = torch.nn.functional.pad(v, (0, tiles * TILE - n))
    v = v.reshape(v.shape[:-1] + (tiles, GROUPS, THREADS, RUN))
    part = torch.zeros(v.shape[:-3] + (THREADS,), dtype=_F32,
                       device=v.device)
    for g in range(GROUPS):
        for j in range(RUN):
            part = part + v[..., g, :, j]
    half = THREADS
    while half > 1:
        half //= 2
        part = part[..., :half] + part[..., half:2 * half]
    part = part[..., 0]
    total = torch.zeros(part.shape[:-1], dtype=_F32, device=v.device)
    for k in range(tiles):
        total = total + part[..., k]
    return total


def fir_fma_reference(taps, v, num: int, start: int = 0) -> torch.Tensor:
    """``sum_j taps[j] * v[..., start + i + j]`` for ``i < num``, as K14
    sums it: tap order from +0, each step one exact f32 FMA."""
    t = taps.to(torch.float64)
    v = v.to(torch.float64)
    acc = torch.zeros(v.shape[:-1] + (num,), dtype=_F32, device=v.device)
    for j in range(t.shape[0]):
        acc = fma_f32(t[j], v[..., start + j: start + j + num], acc)
    return acc


def boxcar_reference(sq, num: int, scale) -> torch.Tensor:
    """``scale * S[k]`` for ``k < num``, ``S[k]`` the sum of ``sq[...,
    k: k + 65]`` in launch B's order: for each quad ``k = 4m .. 4m + 3``,
    ``C`` the 62 shared terms ``sq[4m + 3 .. 4m + 64]`` left to right, then
    ``L2 = sq[4m + 2] + C``, ``L1 = sq[4m + 1] + L2`` and ``S = (sq[4m] +
    L1, L1 + sq[4m + 65], (L2 + sq[4m + 65]) + sq[4m + 66], ((C + sq[4m +
    65]) + sq[4m + 66]) + sq[4m + 67])``.  ``scale`` is an f32 tensor."""
    quads = -(-num // 4)
    v = torch.nn.functional.pad(
        sq, (0, max(4 * quads + TAPS + 3 - sq.shape[-1], 0)))

    def at(o):
        return v[..., o: o + 4 * quads: 4]
    c = at(3)
    for o in range(4, TAPS):
        c = c + at(o)
    l2 = at(2) + c
    l1 = at(1) + l2
    s = torch.stack([at(0) + l1, l1 + at(65), (l2 + at(65)) + at(66),
                     ((c + at(65)) + at(66)) + at(67)], dim=-1)
    return scale * s.flatten(-2)[..., :num]


def _check(hist, x, lead_of):
    for name, t in (("hist", hist), ("x", x)):
        if t.dtype != _F32:
            raise ValueError(f"{name} must be float32, not {t.dtype}")
        if t.device != x.device:
            raise ValueError("hist and x must share a device")
    if hist.shape != x.shape[:-1] + (HISTORY,):
        raise ValueError(f"hist {tuple(hist.shape)} must be x's leading "
                         f"dims {tuple(x.shape[:-1])} + ({HISTORY},)")
    for name, t in lead_of.items():
        if t is not None and (t.shape != x.shape[:-1] or t.dtype != _F32
                              or t.device != x.device):
            raise ValueError(f"{name} must be float32 of x's leading dims "
                             f"{tuple(x.shape[:-1])} on x's device")


def _sq_like(x):
    """Launch A's squared pilot for ``x``: ``[..., n + 128]`` f32."""
    return torch.empty(x.shape[:-1] + (x.shape[-1] + 2 * (TAPS - 1),),
                       dtype=_F32, device=x.device)


def _check_sq(sq, x):
    want = x.shape[:-1] + (x.shape[-1] + 2 * (TAPS - 1),)
    if (sq is None or sq.dtype != _F32 or sq.device != x.device
            or not sq.is_contiguous() or sq.shape != want):
        raise ValueError(f"sq must be contiguous float32 {list(want)} on "
                         "x's device")


def _taps_of(taps, x, rows):
    if taps.dtype != _F32 or tuple(taps.shape) != rows:
        raise ValueError(f"taps must be float32 {list(rows)}, not "
                         f"{taps.dtype} {list(taps.shape)}")
    if taps.device != x.device:
        raise ValueError("taps and x must share a device")


_BOXCARS: dict = {}     # id(taps) -> (ref, version) of checked taps
_BOXCARS_KEPT = 16


def _check_boxcar(taps):
    """Refuses ``taps [4, 65]`` whose avg row is not one constant: launch B
    and its plain version run it as the boxcar ``avg[0] * S``.  A tensor is
    checked once (one read back to the host) for as long as it lives and
    is not modified in place."""
    hit = _BOXCARS.get(id(taps))
    if hit is not None and hit[0]() is taps and hit[1] == taps._version:
        return
    if not bool((taps[2] == taps[2, 0]).all()):
        raise ValueError("taps[2] (avg) must be one constant: launch B "
                         "runs it as a boxcar scaled by its first tap")
    if len(_BOXCARS) >= _BOXCARS_KEPT:
        _BOXCARS.pop(next(iter(_BOXCARS)))
    _BOXCARS[id(taps)] = (weakref.ref(taps), taps._version)


def _rows(t: torch.Tensor):
    """``(t, row stride)``: ``t`` read in place where its last axis is
    contiguous and its leading axes fold into rows at one stride, else a
    contiguous copy."""
    if t.shape[-1] <= 1 or t.stride(-1) == 1:
        s = _fold(tuple(t.shape[:-1]), t.stride()[:-1])
        if s is not None:
            return t, s
    t = t.contiguous()
    return t, t.shape[-1]


def pilot_lock_reference(bp19, hist, x, lock, lock_hi: float,
                         lock_lo: float, sq: torch.Tensor | None = None):
    """Plain PyTorch version of :func:`pilot_lock`."""
    _check(hist, x, {"lock": lock})
    _taps_of(bp19, x, (TAPS,))
    if sq is not None:
        _check_sq(sq, x)
    xe = torch.cat([hist, x], dim=-1)
    nt = xe.shape[-1]
    pilot = fir_fma_reference(bp19, xe, nt - (TAPS - 1))
    p2 = pilot * pilot
    if sq is not None:
        sq.copy_(p2)
    r = (row_sum(p2) / (nt - (TAPS - 1))) / (row_sum(xe * xe) / nt + 1e-12)
    hi, lo = r > lock_hi, r < lock_lo
    new = None
    if lock is not None:
        new = torch.where(hi, torch.ones_like(lock),
                          torch.where(lo, torch.zeros_like(lock), lock))
    return new, (~(hi | lo)).to(_F32), hi.to(_F32)


def pilot_lock(bp19, hist, x, lock, lock_hi: float, lock_lo: float,
               sq: torch.Tensor | None = None):
    """Launch A: ``(new_lock, a, b)`` of each row of ``[hist | x]``, each
    ``[...]`` f32.  ``r > lock_hi`` locks (``a, b = 0, 1``), ``r <
    lock_lo`` unlocks (``0, 0``), otherwise the entering ``lock`` holds
    (``1, 0``); ``new_lock`` is None where ``lock`` is.  ``sq [..., n +
    128]`` (optional) takes the squared pilot.  Launches K14's first
    kernel for CUDA tensors; CPU tensors take the plain version."""
    if x.device.type == "cpu":
        return pilot_lock_reference(bp19, hist, x, lock, lock_hi, lock_lo,
                                    sq)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    _check(hist, x, {"lock": lock})
    _taps_of(bp19, x, (TAPS,))
    if sq is not None:
        _check_sq(sq, x)
    n = x.shape[-1]
    rows = int(np.prod(x.shape[:-1], dtype=np.int64))
    if rows > 65535:
        raise ValueError(f"{rows} rows exceed the kernel grid")
    out = [torch.empty(x.shape[:-1], dtype=_F32, device=x.device)
           for _ in range(3)]
    if rows == 0:
        return (out[0] if lock is not None else None), out[1], out[2]
    hist, hs = _rows(hist)
    x, xs = _rows(x)
    lock_c = None if lock is None else lock.contiguous()
    floats = scratch_floats(rows, n)
    scratch = torch.empty(floats, dtype=_F32, device=x.device)
    KERNEL.launch("launch_pilot_power", x.device, ptr(hist), hs, ptr(x), xs,
                  rows, n, ptr(bp19.contiguous()),
                  None if lock_c is None else ptr(lock_c), lock_hi, lock_lo,
                  None if lock is None else ptr(out[0]), ptr(out[1]),
                  ptr(out[2]), ptr(scratch), floats,
                  None if sq is None else ptr(sq))
    return (out[0] if lock is not None else None), out[1], out[2]


def _pf2(pilot_floor: float) -> float:
    return float(np.float32(float(pilot_floor) ** 2))


def stereo_decode_reference(taps, hist, x, gate, gain: float,
                            pilot_floor: float, sq) -> torch.Tensor:
    """Plain PyTorch version of :func:`stereo_decode`."""
    _check(hist, x, {"gate": gate})
    _taps_of(taps, x, (4, TAPS))
    _check_boxcar(taps)
    _check_sq(sq, x)
    _, bp38, avg, lp15 = taps
    n, d = x.shape[-1], TAPS - 1
    xe = torch.cat([hist, x], dim=-1)
    nt = xe.shape[-1]
    car = fir_fma_reference(bp38, sq, nt - 2 * d)
    norm = boxcar_reference(sq, nt - 2 * d, avg[0])
    car = car * norm / (norm * norm + _pf2(pilot_floor))
    prod = xe[..., d: d + nt - 2 * d] * car
    diff = fir_fma_reference(lp15, prod, n)
    m = fir_fma_reference(lp15, xe, n, d)
    s = diff * float(np.float32(gain))
    if gate is not None:
        s = s * gate[..., None]
    y = torch.empty(x.shape[:-1] + (2, n), dtype=_F32, device=x.device)
    torch.add(m, s, out=y[..., 0, :])
    torch.sub(m, s, out=y[..., 1, :])
    return y


def stereo_decode(taps, hist, x, gate, gain: float, pilot_floor: float,
                  sq) -> torch.Tensor:
    """Launch B: the L/R planes ``[..., 2, n]`` of each row of ``[hist |
    x]``, from ``taps [4, 65]`` (bp19, bp38, avg, lp15; avg one constant,
    whose first tap scales the boxcar), the rows' ``gate
    [...]`` (None: 1), ``gain``, ``pilot_floor`` and the squared pilot
    ``sq [..., n + 128]`` that :func:`pilot_lock` wrote.  Launches K14's
    second kernel for CUDA tensors; CPU tensors take the plain version."""
    if x.device.type == "cpu":
        return stereo_decode_reference(taps, hist, x, gate, gain,
                                       pilot_floor, sq)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    _check(hist, x, {"gate": gate})
    _taps_of(taps, x, (4, TAPS))
    _check_boxcar(taps)
    _check_sq(sq, x)
    n = x.shape[-1]
    rows = int(np.prod(x.shape[:-1], dtype=np.int64))
    if rows > 65535:
        raise ValueError(f"{rows} rows exceed the kernel grid")
    y = torch.empty(x.shape[:-1] + (2, n), dtype=_F32, device=x.device)
    if rows == 0 or n == 0:
        return y
    hist, hs = _rows(hist)
    x, xs = _rows(x)
    gate_c = None if gate is None else gate.contiguous()
    KERNEL.launch("launch_stereo_cascade", x.device, ptr(hist), hs, ptr(x),
                  xs, rows, n, ptr(taps.contiguous()),
                  None if gate_c is None else ptr(gate_c),
                  float(np.float32(gain)), _pf2(pilot_floor), ptr(sq),
                  ptr(y))
    return y


def decode(taps, hist, x, lock, gain: float, pilot_floor: float,
           lock_hi: float, lock_lo: float):
    """Both launches, as ``StereoDecode.apply`` runs them: ``(y, new_lock)``
    with ``y [..., 2, n]`` the L/R planes of each row of ``[hist | x]``.
    Launch A writes the squared pilot into a buffer made here and gives
    the new lock from the entering ``lock [...]``; launch B stages that
    pilot and is gated by the new lock.  ``lock`` None runs without the
    pilot lock: the gate is 1 and ``new_lock`` is None."""
    sq = _sq_like(x)
    new, _, _ = pilot_lock(taps[0], hist, x, lock, lock_hi, lock_lo, sq)
    return stereo_decode(taps, hist, x, new, gain, pilot_floor, sq), new
