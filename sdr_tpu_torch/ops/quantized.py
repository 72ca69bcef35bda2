"""Quantized u8 front end: fused IQ convert + decimating FIR in exact
integer arithmetic (counterpart of sdr_tpu/ops/quantized.py).

Output sample m, component c (0 = I, 1 = Q) is

    acc[c, m] = sum_k Tq[k] * (raw[byte_off + 2(m*f + k) + c] - 128)   (int32)
    y[c, m]   = f32(acc) * scale

with the taps quantized as the JAX package quantizes them: to 8 bits
(``precision='s8'``, max |tap| -> 127) or 16 bits (``'s16'``, max |tap|
-> 32512).  The JAX package's s16 band splits each tap into hi/lo int8
bytes and sums ``256*hi + lo``, which is the same integer ``Tq[k]``; its
band geometry (``q_out``) exists for the TPU's matrix unit and does not
change a sample, so it has no counterpart here.

The sums are exact in int32 (|acc| <= 51 * 32512 * 128 < 2^31 for the
FM chain's taps).  ``torch.matmul`` on int8 would wrap in int8, so the
plain version accumulates tap by tap in int32.  On the card the same sums
run in kernel K4 (``fir_decimate_u8_planar``) or K1 (fused with the demod).
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["u8_front_plan", "front_acc", "fir_decimate_u8_planar"]


def u8_front_plan(taps, precision: str = "s16"):
    """(Tq int32 [K], scale float): the quantized taps and the epilogue
    scale ``max|tap| / qmax / 128``, as the JAX package's plan makes them."""
    taps = np.asarray(taps, dtype=np.float32)
    if precision not in ("s8", "s16"):
        raise ValueError(f"precision must be 's8' or 's16', got {precision!r}")
    maxabs = float(np.abs(taps).max()) or 1.0
    qmax = 127.0 if precision == "s8" else 32512.0
    tq = np.round(taps / maxabs * qmax).astype(np.int32)
    return tq, maxabs / qmax / 128.0


def front_acc(tq, factor: int, raw: torch.Tensor, num: int,
              byte_off: int = 0) -> torch.Tensor:
    """Exact int32 correlation ``[..., 2, num]`` of u8 IQ ``raw[..., nbytes]``
    with the integer taps ``tq`` (sequence of ints) at decimation
    ``factor``; windows start ``byte_off`` bytes into ``raw``."""
    tq = [int(t) for t in np.asarray(tq).reshape(-1)]
    K, f = len(tq), int(factor)
    need = byte_off + 2 * ((num - 1) * f + K) if num > 0 else 0
    if need > raw.shape[-1]:
        raise ValueError(f"{num} outputs need {need} bytes, got "
                         f"{raw.shape[-1]}")
    s = raw.to(torch.int32) - 128
    acc = torch.zeros(raw.shape[:-1] + (2, num), dtype=torch.int32,
                      device=raw.device)
    span = 2 * f * (num - 1) + 1
    for k, t in enumerate(tq):
        for c in (0, 1):
            lo = byte_off + 2 * k + c
            acc[..., c, :] += t * s[..., lo: lo + span: 2 * f]
    return acc


def fir_decimate_u8_planar(taps, factor: int, raw: torch.Tensor,
                           num: int | None = None, *,
                           precision: str = "s16", byte_off: int = 0):
    """Interleaved u8 IQ ``[..., 2n]`` -> decimated planar f32
    ``[..., 2, num]``: convert + K-tap decimate-by-f with quantized taps,
    windows starting ``byte_off`` bytes into ``raw``.  Runs kernel K4
    (kernels/u8_front.py) on CUDA tensors, its plain version on CPU
    tensors."""
    from sdr_tpu_torch.kernels.u8_front import u8_front
    tq, scale = u8_front_plan(taps, precision)
    empty = raw.new_empty(raw.shape[:-1] + (0,))
    return u8_front(torch.as_tensor(tq, device=raw.device), scale, factor,
                    raw.contiguous(), empty, num, byte_off)
