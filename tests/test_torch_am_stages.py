"""The AM chain's inner stages and the AGC's premise counter
(``sdr_tpu_torch/utils/profiling.py``, ``stream/ops.py`` ``Agc`` and
``DcBlocker``) on the CPU: the inner stages nest in their op's stage, in
order, and sum within it (host clock here; CUDA events inside the graph
on the card); counters read, compute and launch nothing untraced; and
``agc.premise_breaks`` counts exactly the samples with ``mu*|x| >= 1``."""

import copy

import numpy as np
import pytest
import torch

from portbench import run
from sdr_tpu_torch.apps import chains
from sdr_tpu_torch.parallel.sharded import (compile_time_batched,
                                            run_time_batched)
from sdr_tpu_torch.stream import Agc, Pipeline
from sdr_tpu_torch.utils import profiling

BLOCK_U8 = 2 * 16 * 1024
INNER = {"3.Agc.carry": ["3.Agc.affine", "3.Agc.prefix"],
         "3.Agc.apply": ["3.Agc.premise", "3.Agc.gains"],
         "5.DcBlocker.carry": ["5.DcBlocker.halo", "5.DcBlocker.state",
                               "5.DcBlocker.prefix"]}


@pytest.fixture(autouse=True)
def empty_buffer():
    profiling.clear()
    yield
    profiling.clear()


def _am(blocks=4):
    rng = np.random.default_rng(11)
    x = torch.from_numpy(rng.integers(0, 256, blocks * BLOCK_U8,
                                      dtype=np.uint8))
    return chains.am_chain(device="cpu"), x, blocks


def _by_name(spans, name):
    return [s for s in spans if s.name == name]


def test_the_inner_stages_nest_in_their_ops_stage_and_sum_within_it():
    ops, x, nb = _am()
    want = run_time_batched(ops, x, nb, device="cpu")
    with profiling.tracing():
        call = compile_time_batched(ops, x, nb, device="cpu")
        profiling.clear()
        y = call()
        ms, inner = call.stage_ms(), call.inner_ms()
    assert torch.equal(y, want)
    assert {k: list(v) for k, v in inner.items()} == INNER
    spans = profiling.spans()
    for stage, names in INNER.items():
        # the first starts with its stage, each ends where the next
        # begins, the last with its stage: they partition it
        assert sum(inner[stage].values()) == pytest.approx(ms[stage],
                                                           abs=1e-9)
        assert all(v >= 0 for v in inner[stage].values())
        (outer,) = _by_name(spans, stage)
        got = [s for s in spans if s.parent == outer.id]
        assert [s.name for s in got] == names
        assert all(outer.start_ns <= s.start_ns <= s.end_ns <= outer.end_ns
                   for s in got)
        assert all(a.end_ns <= b.start_ns for a, b in zip(got, got[1:]))
    # the op stages themselves are as before: no inner name among them
    assert not set(ms) & {n for v in INNER.values() for n in v}


def test_eager_and_streamed_runs_carry_the_inner_stages():
    ops, x, nb = _am()
    with profiling.tracing():
        run_time_batched(ops, x, nb, device="cpu")
        names = [s.name for s in profiling.spans()]
        for stage, inner in INNER.items():
            assert names.index(inner[-1]) < names.index(stage)
        profiling.clear()
        p = Pipeline(ops, block_in=BLOCK_U8, device="cpu")
        step = p.jit_step()
        cs, _ = step(p.init(), x[:BLOCK_U8])
        step(cs, x[BLOCK_U8:2 * BLOCK_U8])
        assert {k: list(v) for k, v in step.inner_ms().items()} == {
            "3.Agc.apply": INNER["3.Agc.apply"]}
    untraced = p.jit_step()
    untraced(p.init(), x[:BLOCK_U8])
    assert untraced.inner_ms() is None


def test_a_call_built_untraced_has_no_inner_stages():
    ops, x, nb = _am()
    call = compile_time_batched(ops, x, nb, device="cpu")
    call()
    assert call.inner_ms() is None
    assert profiling.spans() == []
    with profiling.inner("loose"):      # outside any stage: nothing
        pass
    assert profiling.spans() == []


def test_counters_read_compute_and_launch_nothing_untraced():
    asked = []

    def n():
        asked.append(1)
        return 3

    profiling.count("probe", n)
    assert asked == [] and "probe" not in profiling.counts()
    ops, x, nb = _am()
    call = compile_time_batched(ops, x, nb, device="cpu")
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        call()
        run_time_batched(ops, x, nb, device="cpu")
    assert not any("vector_norm" in e.name for e in prof.events())
    assert profiling.counts().get("agc.premise_breaks", 0) == 0
    with profiling.tracing():
        profiling.count("probe", n)
        profiling.count("probe", torch.tensor(4))
        profiling.count("probe", 5)
    assert asked == [1] and profiling.counts()["probe"] == 12
    profiling.clear()
    assert profiling.counts()["probe"] == 0


def _envelope_planar(values, rows=3):
    """Planar I/Q ``[rows, 2, n]`` whose envelope is ``values`` on every
    row, at seeded angles."""
    rng = np.random.default_rng(2)
    v = np.tile(np.asarray(values, dtype=np.float64), (rows, 1))
    ang = rng.uniform(0, 2 * np.pi, v.shape)
    return torch.from_numpy(np.stack([v * np.cos(ang), v * np.sin(ang)],
                                     1).astype(np.float32))


@pytest.mark.parametrize("planar", [True, False])
def test_premise_breaks_counts_the_samples_with_mu_x_at_least_1(planar):
    """``mu = 0.005``: envelopes 150 and 190 keep the premise, 250, 400
    and 1e4 break it (none near the boundary, so rounding decides
    nothing)."""
    values = [0.5, 150.0, 250.0, 0.2, 400.0, 190.0, 1e4, 0.7] * 9
    x = _envelope_planar(values)
    if not planar:
        x = torch.complex(x[:, 0], x[:, 1])
    agc = Agc(0.005, 1.0, planar=planar, device="cpu")
    want = 3 * 9 * 3
    assert int(agc.premise_breaks(x)) == want
    carry = agc.init_carry(x.shape[-1], x.shape[:-1])
    agc.apply(carry, x)                         # untraced: not counted
    assert profiling.counts().get("agc.premise_breaks", 0) == 0
    with profiling.tracing():
        agc.apply(carry, x)
        agc.apply(carry, x)
    assert profiling.counts()["agc.premise_breaks"] == 2 * want
    # the sequential form has no premise: nothing counted
    profiling.clear()
    if not planar:
        with profiling.tracing():
            Agc(0.005, 1.0, method="scan", device="cpu").apply(
                carry, x)
        assert profiling.counts()["agc.premise_breaks"] == 0


def test_premise_breaks_of_a_traced_compiled_call():
    ops, x, nb = _am()
    with profiling.tracing():
        call = compile_time_batched(ops, x, nb, device="cpu")
        profiling.clear()
        call()
    # random u8 IQ reaches |x| of about 1.4 after the filter: mu*|x| < 1
    assert profiling.counts()["agc.premise_breaks"] == 0
    loud = [Agc(0.9, 1.0, planar=True, device="cpu")]
    planes = _envelope_planar([0.5, 1.5, 3.0, 0.2] * 16, rows=4)
    with profiling.tracing():
        call = compile_time_batched(loud, planes.reshape(4, 2, 64)
                                    .transpose(0, 1).reshape(2, 256), 4,
                                    device="cpu")
        profiling.clear()
        call()
    assert profiling.counts()["agc.premise_breaks"] == 2 * 16 * 4


def test_premise_breaks_is_0_on_the_cells_signal():
    cell = run.Cell("am_airband.bulk")
    cell.traffic = copy.deepcopy(cell.traffic)
    cell.traffic.update(blocks=12, block_bytes=40_960,
                        keying="bursts 0.003-0.02 s, gaps 0.003-0.02 s")
    x = cell.make_input(2_147_483_659, device="cpu")
    with profiling.tracing():
        call = compile_time_batched(cell.build("cpu"), x, 12, device="cpu")
        profiling.clear()
        call()
    assert profiling.counts()["agc.premise_breaks"] == 0
