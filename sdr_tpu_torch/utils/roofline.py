"""Roofline accounting for streaming chains (counterpart of
sdr_tpu/utils/roofline.py).

For every op of a chain this module counts the bytes that must cross
device memory and the arithmetic the op defines, and turns them into a
per-stage lower bound on the card

    floor = max(bytes / hbm_bps, f32 flops / f32_flops,
                int8 ops / int8_ops, dependent steps * step_cycles / clock)

and a chain's speed of light, its input samples over the sum of its
stages' floors.  ``profile_fm`` prints each op's floor beside its device
time, and ``chip_smoke.py`` each block-parallel chain's.

The byte model is the JAX package's: each stage reads its input once and
writes its output once, intermediates inside a stage kept on chip.  For
every stage ``n_in``, ``n_out``, ``bytes_in`` and ``bytes_out`` equal the
JAX package's on the same chain, with one departure: the scans (``Agc``,
``DcBlocker``, ``Iir``, ``FmMod``) read their input once, where the JAX
model doubles it for its associative scan's second pass, one
implementation's cost and not the op's work.

The arithmetic is the work the op defines, not a kernel's geometry (the
JAX model counts its Pallas bands' dense matrix-unit products).  Per
output sample of a stream (a complex sample counts once in either form):

  ====================  =================================================
  ``IqConvertU8/I16``   4 f32 flops an input element
  ``U8FrontEnd``        ``n_taps`` int8 multiply-adds an output and I/Q
                        plane (twice that with 's16' taps: a 16-bit tap
                        is two 8-bit products)
  ``U8FrontDemod``      the same, and 30 f32 flops of demod an output
  ``Fir``               ``n_taps`` multiply-adds (I = 1), or
                        ``taps_per_phase`` (I > 1), a real plane
  ``ResampleFirScale``  ``taps_per_phase + len(taps_f)`` multiply-adds
  ``FmDemod``           30 f32 flops
  ``Mix``, ``AmDemod``  10
  ``Scale``             1 a real plane
  ``StereoDecode``      its five 65-tap FIRs (the pilot bandpass, the
                        38 kHz bandpass, the pilot power's moving
                        average, the difference and mono lowpasses: 650
                        flops) and 13 flops of pilot arithmetic (the
                        square, the normalisation's two products, sum and
                        quotient, the product with the composite, the
                        lock metric's two sums and square, the gain and
                        lock products, L and R); the JAX model has no
                        branch for it and counts no arithmetic
  ``Agc``               9 (a complex sample's step), 4 a real one
  ``DcBlocker``         3
  ``Iir``               9 a biquad section
  ``FmMod``             10
  ``FftStream``         5 N log2 N a frame of N bins
  ``Channelize``        ``2 P + 5 log2 C`` an output, real and imaginary
                        (P taps a branch, C channels), as in the JAX model
  ``Map``               bytes only
  ====================  =================================================

``Agc(method='scan')`` (kernel K6) is a dependent recurrence: each sample
waits for the previous one's gain.  Its floor is at least one row's
``(R + 1) * row_len`` dependent steps at ``step_cycles`` each (R store-less
sweeps for the rows' entering gains, ``approx_time_sharding``, then the
final pass), the rows running side by side; ``bound_by`` is then
'latency'.  An op class the model does not know raises: none is costed
at zero silently.

``chain_roofline`` defaults to the data sheet's ceilings, a floor that no
run can beat; the measured ones (``measure_ceilings``) are passed by
name.  Not ported: the JAX model's v5e ceilings and its matrix-unit
geometry.
"""

from __future__ import annotations

from dataclasses import asdict, dataclass
from functools import cache

import numpy as np
import torch

__all__ = ["Ceilings", "StageCost", "stage_costs", "chain_roofline",
           "MEASURED_CEILINGS", "DATASHEET"]


@dataclass(frozen=True)
class Ceilings:
    """The card's rates, and the latency of K6's step."""
    name: str
    hbm_bps: float          # device memory, bytes/s read + written
    f32_flops: float        # CUDA cores, an FMA counted as 2
    int8_ops: float         # dense int8 tensor cores, a multiply-add as 2
    clock_hz: float         # SM clock
    step_cycles: float      # K6's dependent step, cycles a sample


DATASHEET = "h100-sxm-datasheet"

# K6's step, FMUL, FMUL, FADD, MUFU.RSQ, FMUL, FFMA, FFMA, FADD, FMUL, FADD
# on its dependent chain (cuobjdump -sass of csrc/agc_scan.cu), at the
# latencies ``python -m sdr_tpu_torch.measure_ceilings`` measured on an
# NVIDIA H100 80GB HBM3 at a 700.00 W power limit: FMUL 4.141, FADD
# 4.141, FFMA 4.107, MUFU.RSQ 17.001 cycles.
_STEP_CYCLES = 54.20361328125

MEASURED_CEILINGS = {
    # NVIDIA's H100 SXM data sheet (dense rates at 700 W); the clock is
    # the card's clocks.max.sm.  A data sheet gives no latency:
    # step_cycles is the measured one.
    DATASHEET: Ceilings("H100 SXM (data sheet)", hbm_bps=3.35e12,
                        f32_flops=67e12, int8_ops=1979e12, clock_hz=1.98e9,
                        step_cycles=_STEP_CYCLES),
    # ``python -m sdr_tpu_torch.measure_ceilings`` on an NVIDIA H100 80GB
    # HBM3 at a 700.00 W power limit, the best of two runs: device memory
    # by the chained add (the copy kernel 2.865e12), the FFMA chains,
    # torch._int_mm at 8192, clock64 against CUDA events
    "NVIDIA H100 80GB HBM3": Ceilings(
        "NVIDIA H100 80GB HBM3 (measured)", hbm_bps=2905648672761.66,
        f32_flops=65477869737199.234, int8_ops=954835013365367.9,
        clock_hz=1995399856.760275, step_cycles=_STEP_CYCLES),
}


@dataclass
class StageCost:
    op: str
    n_in: int
    n_out: int
    bytes_in: int
    bytes_out: int
    f32_flops: float = 0.0
    int8_ops: float = 0.0
    dependent_steps: float = 0.0    # one row's chain of dependent steps
    note: str = ""

    @property
    def bytes_moved(self) -> int:
        return self.bytes_in + self.bytes_out

    def floors(self, c: Ceilings) -> dict:
        """Seconds each unit needs for this stage on ``c``."""
        return {"hbm": self.bytes_moved / c.hbm_bps,
                "f32": self.f32_flops / c.f32_flops,
                "int8": self.int8_ops / c.int8_ops,
                "latency": self.dependent_steps * c.step_cycles
                / c.clock_hz}


def _planes(dtype: torch.dtype) -> int:
    return 2 if dtype.is_complex else 1


def _per_complex(op, n_in: int, mul_in: int) -> int:
    """Complex input samples of an op over ``mul_in`` streams: a planar
    op's input carries the [2] plane axis, which ``mul_in`` counts."""
    return n_in * mul_in // (2 if getattr(op, "planar", False) else 1)


def _convert(op, c, n_in, n_out, dt_in, mul_in, mul_out):
    c.f32_flops = 4.0 * n_in * mul_in


def _u8_front(demod_flops: float):
    def cost(op, c, n_in, n_out, dt_in, mul_in, mul_out):
        bands = 2 if op.precision == "s16" else 1
        c.int8_ops = 2.0 * op.n_taps * n_out * 2 * mul_in * bands
        c.f32_flops = demod_flops * n_out * mul_out
        c.note = f"{op.n_taps} taps {op.precision}"
    return cost


def _fir(op, c, n_in, n_out, dt_in, mul_in, mul_out):
    spec = op.spec
    per_out = spec.n_taps if spec.interpolation == 1 \
        else spec.taps_per_phase
    c.f32_flops = 2.0 * per_out * n_out * mul_out * _planes(dt_in)
    c.note = (f"{spec.n_taps} taps, {spec.interpolation}/"
              f"{spec.decimation}")


def _resample_fir_scale(op, c, n_in, n_out, dt_in, mul_in, mul_out):
    macs = op.spec.taps_per_phase + op.taps_f.shape[0]
    c.f32_flops = 2.0 * macs * n_out * mul_out
    c.note = f"{macs} multiply-adds an output"


def _per_sample(flops: float):
    def cost(op, c, n_in, n_out, dt_in, mul_in, mul_out):
        c.f32_flops = flops * _per_complex(op, n_in, mul_in)
    return cost


def _scale(op, c, n_in, n_out, dt_in, mul_in, mul_out):
    c.f32_flops = 1.0 * n_out * mul_out * _planes(dt_in)


def _stereo(op, c, n_in, n_out, dt_in, mul_in, mul_out):
    c.f32_flops = (5 * 2.0 * op.K + 13) * n_out * mul_in
    c.note = f"five {op.K}-tap FIRs"


def _agc(op, c, n_in, n_out, dt_in, mul_in, mul_out):
    step = 9.0 if dt_in.is_complex or op.planar else 4.0
    c.f32_flops = step * _per_complex(op, n_in, mul_in)
    if op.method == "scan":
        sweeps = op.approx_time_sharding or 0
        c.dependent_steps = float((sweeps + 1) * n_in)
        c.note = f"sequential, {sweeps} sweeps + the pass"


def _iir(op, c, n_in, n_out, dt_in, mul_in, mul_out):
    c.f32_flops = 9.0 * op.sos.shape[0] * n_out * mul_out


def _fft(op, c, n_in, n_out, dt_in, mul_in, mul_out):
    c.f32_flops = 5.0 * op.size * np.log2(max(op.size, 2)) * n_out * mul_out


def _channelize(op, c, n_in, n_out, dt_in, mul_in, mul_out):
    C = op.n_channels
    c.f32_flops = (2.0 * op.taps_per_branch + 5.0 * np.log2(max(C, 2))) \
        * n_out * C * 2 * mul_in


def _bytes_only(op, c, n_in, n_out, dt_in, mul_in, mul_out):
    pass


@cache
def _costs() -> dict:
    """Each op class of stream/ops.py -> its arithmetic (imported here:
    the stream ops import this package)."""
    from sdr_tpu_torch.stream import ops as S
    return {
        S.IqConvertU8: _convert, S.IqConvertI16: _convert,
        S.U8FrontEnd: _u8_front(0.0), S.U8FrontDemod: _u8_front(30.0),
        S.Fir: _fir, S.ResampleFirScale: _resample_fir_scale,
        S.FmDemod: _per_sample(30.0), S.Mix: _per_sample(10.0),
        S.AmDemod: _per_sample(10.0), S.FmMod: _per_sample(10.0),
        S.DcBlocker: _per_sample(3.0), S.Scale: _scale,
        S.StereoDecode: _stereo, S.Agc: _agc, S.Iir: _iir,
        S.FftStream: _fft, S.Channelize: _channelize, S.Map: _bytes_only,
    }


def _cost_one(op, n_in: int, in_dtype, in_batch: tuple, batch: int):
    """(StageCost, n_out, out_dtype, out_batch) of one op at one block
    shape: ``in_batch`` is the per-block leading shape (a plane or
    channel axis), ``batch`` the block-parallel multiplier."""
    cost = _costs().get(type(op))
    if cost is None:
        raise TypeError(f"the roofline model has no cost for "
                        f"{type(op).__name__}")
    n_out = op.out_len(n_in)
    out_dtype = op.out_dtype(in_dtype)
    out_batch = tuple(op.map_batch_shape(tuple(in_batch)))
    mul_in = batch * int(np.prod(in_batch, dtype=np.int64))
    mul_out = batch * int(np.prod(out_batch, dtype=np.int64))
    tail = int(np.prod(op.out_tail(), dtype=np.int64))   # FFT bins
    c = StageCost(op=type(op).__name__, n_in=int(n_in), n_out=int(n_out),
                  bytes_in=int(n_in) * mul_in * in_dtype.itemsize,
                  bytes_out=int(n_out) * mul_out * tail
                  * out_dtype.itemsize)
    cost(op, c, n_in, n_out, in_dtype, mul_in, mul_out)
    return c, n_out, out_dtype, out_batch


def stage_costs(ops, block_in: int, in_dtype=torch.uint8, batch: int = 1):
    """Walk a chain, returning one :class:`StageCost` per op."""
    out, n, dt, bshape = [], int(block_in), in_dtype, ()
    for op in ops:
        c, n, dt, bshape = _cost_one(op, n, dt, bshape, batch)
        out.append(c)
    return out


def chain_roofline(ops, block_in: int, in_dtype=torch.uint8, batch: int = 1,
                   ceilings: Ceilings | str = DATASHEET):
    """Per-stage and total floors of a chain on ``ceilings`` (a
    :class:`Ceilings` or a key of :data:`MEASURED_CEILINGS`).

    Returns ``{"ceilings", "stages": [...], "total_floor_s",
    "input_samples", "sol_samples_per_s"}``, JSON-ready.  Each stage adds
    ``floor_s`` and ``bound_by`` ('hbm', 'f32', 'int8' or 'latency').
    ``input_samples`` counts complex input samples (u8 chains: bytes / 2),
    so ``sol_samples_per_s`` is the chain's speed of light in the
    headline unit."""
    if isinstance(ceilings, str):
        ceilings = MEASURED_CEILINGS[ceilings]
    total, rows = 0.0, []
    for s in stage_costs(ops, block_in, in_dtype, batch):
        floors = s.floors(ceilings)
        f = max(floors.values())
        total += f
        rows.append({**asdict(s), "floor_s": f,
                     "bound_by": max(floors, key=floors.get)})
    n_cplx = int(block_in) * int(batch)
    if in_dtype == torch.uint8:
        n_cplx //= 2
    return {"ceilings": asdict(ceilings), "stages": rows,
            "total_floor_s": total, "input_samples": n_cplx,
            "sol_samples_per_s": n_cplx / total if total else float("inf")}
