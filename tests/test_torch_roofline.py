"""The port's roofline (sdr_tpu_torch/utils/roofline.py) against the JAX
package's (sdr_tpu/utils/roofline.py).

The model is static, so no data runs.  On explicitly paired chains every
stage's ``n_in``, ``n_out``, ``bytes_in`` and ``bytes_out`` equal the JAX
package's, but for one stated departure: the scans (``Agc``,
``DcBlocker``, ``Iir``, ``FmMod``) read their input once, where the JAX
model doubles it for its associative scan's second pass.  The pairs are
explicit because the two ``fm_chain``s default to other stage splits: the
JAX one picks the exact front and the three-op back half off a TPU, the
port the fused front and ``ResampleFirScale``.  At the bench shapes the
JAX totals are the stage bytes the module is meant to reproduce.  The
port's arithmetic is held to counts done by hand.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sdr_tpu.apps import chains as jchains
from sdr_tpu.utils.roofline import chain_roofline as jax_chain_roofline
from sdr_tpu.utils.roofline import stage_costs as jax_stage_costs

from sdr_tpu_torch import measure_ceilings
from sdr_tpu_torch.apps import chains
from sdr_tpu_torch.stream import ops as S
from sdr_tpu_torch.stream.block import StreamOp
from sdr_tpu_torch.utils import roofline
from sdr_tpu_torch.utils.roofline import (DATASHEET, MEASURED_CEILINGS,
                                          Ceilings, chain_roofline,
                                          stage_costs)

ROWS, ROW_BYTES = 32, 10_485_760          # the bench's block-parallel batch
SCANS = {"Agc", "DcBlocker", "Iir", "FmMod"}
SHEET = MEASURED_CEILINGS[DATASHEET]

# name: (port ops, JAX ops, complex input)
PAIRS = {
    "mono_fused": (
        lambda: chains.fm_chain(front="fused", fuse_back=False,
                                device="cpu"),
        lambda: jchains.fm_chain(front="fused", fuse_back=False), False),
    "mono_fused_back": (
        lambda: chains.fm_chain(device="cpu"),
        lambda: jchains.fm_chain(front="fused", fuse_back=True), False),
    "mono_quantized": (
        lambda: chains.fm_chain(front="quantized", fuse_back=False,
                                device="cpu"),
        lambda: jchains.fm_chain(front="quantized", fuse_back=False), False),
    "stereo": (
        lambda: chains.fm_chain(front="quantized", stereo=True,
                                deemphasis=75e-6, fuse_back=False,
                                device="cpu"),
        lambda: jchains.fm_chain(front="quantized", stereo=True,
                                 deemphasis=75e-6, fuse_back=False), False),
    "exact": (
        lambda: chains.fm_chain(front="exact", fuse_back=False,
                                device="cpu"),
        lambda: jchains.fm_chain(front="exact", fuse_back=False), False),
    "exact_planar": (
        lambda: chains.fm_chain(front="exact", planar=True, fuse_back=False,
                                device="cpu"),
        lambda: jchains.fm_chain(front="exact", planar=True,
                                 fuse_back=False), False),
    "am": (lambda: chains.am_chain(device="cpu"), jchains.am_chain, False),
    "am_sequential": (lambda: chains.am_chain(agc_approx=1, device="cpu"),
                      lambda: jchains.am_chain(agc_approx=1), False),
    "waterfall": (lambda: chains.waterfall_chain(device="cpu"),
                  jchains.waterfall_chain, False),
    "wideband": (lambda: chains.channelizer_chain(64, wideband=True,
                                                  device="cpu"),
                 lambda: jchains.channelizer_chain(64, wideband=True), True),
    "narrowband": (lambda: chains.channelizer_chain(64, device="cpu"),
                   lambda: jchains.channelizer_chain(64), True),
}
# (block_in, batch): the bench's shapes (the narrowband bank's [64,
# 2,621,440] in 4 blocks), and one small shape
BENCH = {"wideband": (4_096_000, ROWS), "narrowband": (655_360, 4 * 64)}
SMALL = {"wideband": (51_200, 2), "narrowband": (2_080, 3 * 64)}
# the JAX model's summed stage bytes at the bench shapes (sdr_tpu's
# stage_costs on the CPU)
BENCH_TOTALS = {"mono_fused": 629_145_600, "stereo": 1_577_058_304,
                "exact": 3_649_044_480, "am": 6_375_342_080,
                "waterfall": 4_362_076_160, "wideband": 3_637_248_000}


def _shape(name, small: bool):
    table = SMALL if small else BENCH
    return table.get(name, (163_840, 2) if small else (ROW_BYTES, ROWS))


def _dtypes(cplx: bool):
    return (torch.complex64, jnp.complex64) if cplx else (torch.uint8,
                                                          jnp.uint8)


def _paired(name, small):
    port_ops, jax_ops, cplx = PAIRS[name]
    block, batch = _shape(name, small)
    tdt, jdt = _dtypes(cplx)
    return (stage_costs(port_ops(), block, tdt, batch),
            jax_stage_costs(jax_ops(), block, jdt, batch))


@pytest.mark.parametrize("small", [False, True], ids=["bench", "small"])
@pytest.mark.parametrize("name", sorted(PAIRS))
def test_stage_bytes_equal_the_jax_models(name, small):
    port, ref = _paired(name, small)
    assert [c.op for c in port] == [c.op for c in ref]
    for p, r in zip(port, ref):
        assert (p.n_in, p.n_out, p.bytes_out) == (r.n_in, r.n_out,
                                                  r.bytes_out), p.op
        # the stated departure: a scan reads its input once
        want = r.bytes_in // 2 if p.op in SCANS else r.bytes_in
        assert p.bytes_in == want, p.op


@pytest.mark.parametrize("name", sorted(BENCH_TOTALS))
def test_bench_totals_reproduced(name):
    port, ref = _paired(name, small=False)
    assert sum(r.bytes_moved for r in ref) == BENCH_TOTALS[name]
    scan_reads = sum(p.bytes_in for p in port if p.op in SCANS)
    assert sum(p.bytes_moved for p in port) + scan_reads \
        == BENCH_TOTALS[name]


@pytest.mark.parametrize("name", ["mono_quantized", "wideband"])
def test_chain_roofline_keys_and_input_samples(name):
    port_ops, jax_ops, cplx = PAIRS[name]
    block, batch = _shape(name, small=True)
    tdt, jdt = _dtypes(cplx)
    r = chain_roofline(port_ops(), block, tdt, batch)
    j = jax_chain_roofline(jax_ops(), block, jdt, batch)
    assert set(r) == set(j)
    assert r["input_samples"] == j["input_samples"]
    assert r["ceilings"]["name"] == SHEET.name
    assert r["sol_samples_per_s"] == r["input_samples"] / r["total_floor_s"]
    for s in r["stages"]:
        assert s["bound_by"] in ("hbm", "f32", "int8", "latency")


def test_floor_linear_in_batch():
    ops = chains.fm_chain(front="quantized", stereo=True, deemphasis=75e-6,
                          device="cpu")
    r1 = chain_roofline(ops, 1_638_400, batch=1)
    r8 = chain_roofline(ops, 1_638_400, batch=8)
    assert r8["total_floor_s"] == pytest.approx(8 * r1["total_floor_s"],
                                                rel=1e-12)
    assert r8["sol_samples_per_s"] == pytest.approx(
        r1["sol_samples_per_s"], rel=1e-12)


def test_measured_ceilings_are_slower_than_the_data_sheet():
    """A floor on the data sheet is one no run can beat: every measured
    rate is at most 1.05 times it (measure_ceilings fails otherwise), and
    the measured entry is keyed by the card's name."""
    measured = MEASURED_CEILINGS["NVIDIA H100 80GB HBM3"]
    for f in ("hbm_bps", "f32_flops", "int8_ops", "clock_hz"):
        assert 0 < getattr(measured, f) <= 1.05 * getattr(SHEET, f), f
    assert measured.step_cycles == SHEET.step_cycles > 0
    ops = chains.fm_chain(device="cpu")
    fast = chain_roofline(ops, ROW_BYTES, batch=ROWS)
    slow = chain_roofline(ops, ROW_BYTES, batch=ROWS,
                          ceilings="NVIDIA H100 80GB HBM3")
    assert slow["total_floor_s"] > fast["total_floor_s"]


def _one(op, n, dtype, batch):
    [c] = stage_costs([op], n, dtype, batch)
    return c, max(c.floors(SHEET).values())


@pytest.mark.parametrize("batch", [1, 32])
def test_stereo_decode_counted_by_hand(batch):
    op = S.StereoDecode(device="cpu")
    n = 655_360
    c, floor = _one(op, n, torch.float32, batch)
    flops = (5 * 2 * 65 + 13) * n * batch     # five 65-tap FIRs + pilot
    nbytes = n * batch * 4 + 2 * n * batch * 4
    assert (c.f32_flops, c.bytes_in + c.bytes_out) == (flops, nbytes)
    assert floor == max(nbytes / 3.35e12, flops / 67e12) == flops / 67e12


@pytest.mark.parametrize("precision", ["s8", "s16"])
@pytest.mark.parametrize("demod", [False, True])
def test_u8_fronts_counted_by_hand(precision, demod):
    rf, _, _ = chains.fm_taps()
    cls = S.U8FrontDemod if demod else S.U8FrontEnd
    op = cls(rf, 8, precision=precision, device="cpu")
    n_out = ROW_BYTES // 2 // 8
    c, floor = _one(op, ROW_BYTES, torch.uint8, ROWS)
    macs = 51 * n_out * 2 * ROWS * (2 if precision == "s16" else 1)
    assert c.int8_ops == 2 * macs
    assert c.f32_flops == (30 * n_out * ROWS if demod else 0)
    planes = 1 if demod else 2
    assert c.bytes_in + c.bytes_out == ROW_BYTES * ROWS \
        + n_out * planes * 4 * ROWS
    assert floor == max((c.bytes_in + c.bytes_out) / 3.35e12,
                        2 * macs / 1979e12, c.f32_flops / 67e12)


@pytest.mark.parametrize("sweeps", [None, 1, 3])
def test_sequential_agc_counted_by_hand(sweeps):
    """R sweeps and the final pass over one row of dependent steps, the
    rows side by side: the floor does not grow with the batch."""
    op = S.Agc(0.005, 1.0, method="scan", approx_time_sharding=sweeps,
               device="cpu")
    n = 327_680
    c = Ceilings("test", hbm_bps=1e12, f32_flops=1e13, int8_ops=1e14,
                 clock_hz=2e9, step_cycles=50.0)
    steps = ((sweeps or 0) + 1) * n
    for batch in (1, 32):
        r = chain_roofline([op], n, torch.complex64, batch, ceilings=c)
        [s] = r["stages"]
        assert s["dependent_steps"] == steps
        assert s["bound_by"] == "latency"
        assert s["floor_s"] == steps * 50.0 / 2e9
        assert s["bytes_in"] + s["bytes_out"] == 2 * n * batch * 8
    linear = S.Agc(0.005, 1.0, device="cpu")
    [s] = chain_roofline([linear], n, torch.complex64, 32)["stages"]
    assert s["dependent_steps"] == 0 and s["bound_by"] == "hbm"


@pytest.mark.parametrize("make", [
    lambda planar: S.FmDemod(planar=planar, device="cpu"),
    lambda planar: S.AmDemod(planar=planar, device="cpu"),
    lambda planar: S.Mix(0.25, planar=planar, device="cpu"),
    lambda planar: S.Agc(0.005, 1.0, planar=planar, device="cpu")],
    ids=["FmDemod", "AmDemod", "Mix", "Agc"])
def test_planar_and_complex_forms_count_alike(make):
    """A complex sample's arithmetic is counted once, whether it comes as
    complex64 or as the planar form's [2] I/Q planes."""
    n, batch = 4096, 3
    [cplx] = stage_costs([make(False)], n, torch.complex64, batch)
    conv = S.IqConvertU8(planar=True, device="cpu")
    _, planar = stage_costs([conv, make(True)], 2 * n, torch.uint8, batch)
    assert planar.f32_flops == cplx.f32_flops > 0
    assert planar.bytes_in == cplx.bytes_in


def _op_classes():
    return sorted((c for c in vars(S).values()
                   if isinstance(c, type) and issubclass(c, StreamOp)
                   and c.__module__ == S.__name__
                   and not c.__name__.startswith("_")),
                  key=lambda c: c.__name__)


def test_every_op_class_has_a_branch_and_unknown_ops_raise():
    classes = _op_classes()
    assert len(classes) == 18
    assert set(classes) <= set(roofline._costs())
    extra = [S.IqConvertI16(device="cpu"), S.FmMod(1.0, device="cpu"),
             S.Map(torch.abs, dtype=torch.float32, device="cpu")]
    costs = stage_costs(extra, 4096, torch.int16)
    assert [c.op for c in costs] == ["IqConvertI16", "FmMod", "Map"]
    assert costs[1].f32_flops == 10 * 2048
    assert costs[2].bytes_out == 2048 * 4 and costs[2].f32_flops == 0

    class Unknown(StreamOp):
        pass

    class Derived(S.Scale):
        pass

    for op in (Unknown(), Derived(2.0, device="cpu")):
        with pytest.raises(TypeError, match="no cost"):
            stage_costs([op], 1024, torch.float32)


def test_measure_ceilings_raises_without_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        measure_ceilings.main([])
    with pytest.raises(RuntimeError, match="CUDA GPU"):
        measure_ceilings.measure("cpu")


def test_k6_chain_and_probe_constants_match_the_sources():
    """The probe's Python constants are csrc/ceilings.cu's, and K6's chain
    names the instructions the step's intrinsics compile to."""
    src = measure_ceilings.KERNEL.source.read_text()
    assert f"constexpr int kUnroll = {measure_ceilings.UNROLL};" in src
    assert f"constexpr int kChains = {measure_ceilings.CHAINS};" in src
    kernels = [fn for _, _, fn in measure_ceilings.LATENCY_PROBES]
    assert ("kLatencyProbes[] = {" + ", ".join(kernels[:3])) in src
    assert (", ".join(kernels[3:]) + "};") in src
    chain = measure_ceilings.K6_CHAIN
    assert len(chain) == 10 and chain.count("mufu_rsq") == 1
    agc = (measure_ceilings.KERNEL.source.parent / "agc_scan.cu").read_text()
    for call in ("__fmul_rn(v.x, g)", "__fsqrt_rn(", "__fsub_rn(ref, m)"):
        assert call in agc
