"""K1: fused u8 IQ front end + FM demod (csrc/u8_front_demod.cu).

Counterpart of sdr_tpu/kernels/u8_front_demod_pallas.py:
u8_front_demod_pallas.  A row's stream is ``concat(hist, x)``: output m
reads the bytes ``2(m*f + k) + c`` of it, so a streaming caller passes its
history and block as they are and no seam split is needed.  The taps
reach the kernel as ``__dp4a`` words (``u8_front.tap_words``), kept on
the device for each taps tensor.  :func:`ring_plan` mirrors the source's
plan: the tile, the ring's slots and the shared memory a launch takes.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from sdr_tpu_torch.kernels._build import Kernel, cuda_rows, ptr
from sdr_tpu_torch.kernels.u8_front import tap_words
from sdr_tpu_torch.ops.demod import fm_demod_planar
from sdr_tpu_torch.ops.quantized import front_acc

__all__ = ["KERNEL", "ring_plan", "u8_front_demod",
           "u8_front_demod_reference"]

_P, _LL, _I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
KERNEL = Kernel("u8_front_demod", {
    "launch_u8_front_demod": [_P, _P, _P, _P, _P, _P, _LL, _LL, _I, _I, _I,
                              _I, _I, _LL, ctypes.c_float],
})

# csrc/u8_front_demod.cu's plan: eight consumer warps and a producer warp
# a block, three blocks an SM (BLOCK_BYTES each at most), 3 to 8 slots
WARPS, BLOCKS_PER_SM = 8, 3
MIN_STAGES, MAX_STAGES = 3, 8
BLOCK_BYTES = 229_376 // BLOCKS_PER_SM
MAX_SMEM = 232_448              # an H100 block's shared memory
BAR_BYTES = 48 * MAX_STAGES     # the barriers and each slot's head


def _align16(v):
    return (v + 15) // 16 * 16


def plane_len(samples, f, K):
    """Plane samples that ``samples`` samples read (u8_window.cuh)."""
    return (samples - 1) * f + K


def raw_bytes(samples, f, K):
    """Stream bytes of ``samples`` samples with their alignment slack and
    u8w::deinterleave's read past them (u8_window.cuh's raw_bytes)."""
    return _align16(8 * ((plane_len(samples, f, K) + 3) // 4) + 32)


def plane_bytes(samples, f, nw):
    return _align16((samples - 1) * f + 4 * nw + 8)


def tile_outputs(W):
    """A tile's outputs: each consumer warp's W samples, the first the
    predecessor of its W - 1 outputs."""
    return WARPS * (W - 1)


def slot_bytes(W, f, K):
    """A slot: a tile's stream bytes, their alignment slack, and 32 bytes
    for the deinterleave's 16-byte reads past them."""
    return raw_bytes(tile_outputs(W) + 1, f, K) + 32


def ring_bytes(W, stages, f, K, nw):
    """A block's shared memory: the barriers, ``stages`` slots, each
    consumer warp's two planes."""
    return (BAR_BYTES + stages * slot_bytes(W, f, K)
            + 2 * WARPS * plane_bytes(W, f, nw))


def tiles_per_row(num, W):
    return -(-num // tile_outputs(W))


def ring_plan(f, K, nw):
    """K1's tile and ring at factor ``f``, ``K`` taps, ``nw`` tap words.

    ``W`` samples a consumer warp takes of a tile (a tile is
    ``tile_outputs(W)`` outputs), ``stages`` slots, ``pair`` (three
    blocks an SM, else one) and ``smem`` bytes a block; ``W`` 0 where no
    ring fits.  ``W`` is the largest of 128, 64 and 32 whose ring of at
    least MIN_STAGES slots fits BLOCK_BYTES, with as many slots as fit."""
    def fit(W, budget):
        s = (budget - ring_bytes(W, 0, f, K, nw)) // slot_bytes(W, f, K)
        return int(min(max(s, 0), MAX_STAGES))

    plan = dict(W=0, stages=0, pair=True, smem=0)
    for W in (128, 64, 32):
        if fit(W, BLOCK_BYTES) >= MIN_STAGES:
            plan.update(W=W, stages=fit(W, BLOCK_BYTES))
            break
    else:
        plan.update(W=32, stages=fit(32, MAX_SMEM), pair=False)
        if plan["stages"] == 0:
            plan["W"] = 0
    if plan["W"]:
        plan["smem"] = ring_bytes(plan["W"], plan["stages"], f, K, nw)
    return plan


def _check(taps, factor, x, hist, last_iq, num):
    if taps.dtype != torch.int32 or taps.ndim != 1:
        raise ValueError("taps must be a 1-D int32 tensor (u8_front_plan)")
    if x.dtype != torch.uint8 or hist.dtype != torch.uint8:
        raise ValueError("x and hist must be uint8")
    if last_iq.dtype != torch.float32:
        raise ValueError("last_iq must be float32")
    lead = x.shape[:-1]
    if hist.shape[:-1] != lead or last_iq.shape != lead + (2,):
        raise ValueError(f"shapes disagree: x {tuple(x.shape)}, hist "
                         f"{tuple(hist.shape)}, last_iq "
                         f"{tuple(last_iq.shape)}")
    if len({t.device for t in (taps, x, hist, last_iq)}) != 1:
        raise ValueError("taps, x, hist and last_iq must share a device")
    K, f = taps.shape[0], int(factor)
    have = hist.shape[-1] + x.shape[-1]
    if num < 1 or 2 * ((num - 1) * f + K) > have:
        raise ValueError(f"{num} outputs of {K} taps at factor {f} need more "
                         f"than the {have} bytes of concat(hist, x)")


def u8_front_demod_reference(taps, scale: float, factor: int,
                             x: torch.Tensor, hist: torch.Tensor,
                             last_iq: torch.Tensor, num: int):
    """Plain PyTorch version of :func:`u8_front_demod`."""
    _check(taps, factor, x, hist, last_iq, num)
    acc = front_acc(taps.tolist(), factor, torch.cat([hist, x], dim=-1), num)
    iq = acc.to(torch.float32) * float(np.float32(scale))
    return fm_demod_planar(iq, last_iq)


def u8_front_demod(taps, scale: float, factor: int, x: torch.Tensor,
                   hist: torch.Tensor, last_iq: torch.Tensor,
                   num: int | None = None):
    """u8 IQ ``x[..., n]`` after history ``hist[..., H]`` -> FM demod
    ``y[..., num]`` and the last decimated ``(I, Q)`` sample ``[..., 2]``.

    ``y[m] = atan2(s[m] * conj(s[m-1]))`` with
    ``s[m] = scale * sum_k taps[k] (v[2(m f + k) + c] - 128)``,
    ``v = concat(hist, x)`` and ``s[-1] = last_iq``.  ``taps`` are the
    int32 quantized taps of ``ops.quantized.u8_front_plan``.  Launches
    K1 for CUDA tensors; CPU tensors take the plain version."""
    if num is None:
        num = (hist.shape[-1] + x.shape[-1] - 2 * taps.shape[0]) \
            // (2 * factor) + 1
    num = int(num)
    if x.device.type == "cpu":
        return u8_front_demod_reference(taps, scale, factor, x, hist,
                                        last_iq, num)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    _check(taps, factor, x, hist, last_iq, num)
    rows = cuda_rows(x=x, hist=hist, last_iq=last_iq, taps=taps)
    packed = tap_words(taps)
    y = torch.empty(x.shape[:-1] + (num,), dtype=torch.float32,
                    device=x.device)
    iq = torch.empty(x.shape[:-1] + (2,), dtype=torch.float32,
                     device=x.device)
    if rows == 0:
        return y, iq
    KERNEL.launch("launch_u8_front_demod", x.device, ptr(x), ptr(hist),
                  ptr(last_iq), ptr(packed), ptr(y), ptr(iq), rows,
                  x.shape[-1], hist.shape[-1], taps.shape[0], int(factor),
                  packed.shape[1], int(packed.shape[0] == 2), num,
                  float(scale))
    return y, iq
