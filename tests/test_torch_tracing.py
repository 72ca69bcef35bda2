"""The port's tracing (``sdr_tpu_torch/utils/profiling.py``) on the CPU:
spans, their parents and call indices, the set-up totals, the stages of
the compiled calls (host clock here; CUDA events inside the graph on the
card), and the Perfetto export."""

import json

import numpy as np
import pytest
import torch

from sdr_tpu_torch import profile_fm
from sdr_tpu_torch.apps import chains
from sdr_tpu_torch.ops import design
from sdr_tpu_torch.parallel.sharded import (compile_time_batched,
                                            run_time_batched)
from sdr_tpu_torch.stream import Pipeline
from sdr_tpu_torch.utils import graphs, profiling
from sdr_tpu_torch.utils.graphs import Captured

MONO = ["input", "0.U8FrontDemod.carry", "0.U8FrontDemod.apply",
        "1.ResampleFirScale.carry", "1.ResampleFirScale.apply", "output"]
STEREO_OPS = ["U8FrontEnd", "FmDemod", "StereoDecode", "ResampleFirScale",
              "Iir", "Scale"]
WIDEBAND_OPS = ["Channelize", "Fir", "FmDemod", "Fir", "Fir", "Scale"]
BLOCK_U8 = 20_480                   # u8 bytes a block: 1,280 composite
BLOCK_WB = 64 * 80 * 24             # complex samples a wideband block


@pytest.fixture(autouse=True)
def empty_buffer():
    profiling.clear()
    yield
    profiling.clear()


def _chain(name):
    """(ops, input, blocks, the op class names in order)."""
    rng = np.random.default_rng(3)
    if name == "wideband":
        x = (rng.standard_normal(2 * BLOCK_WB)
             + 1j * rng.standard_normal(2 * BLOCK_WB)).astype(np.complex64)
        return (chains.channelizer_chain(64, wideband=True, device="cpu"),
                torch.from_numpy(x), 2, WIDEBAND_OPS)
    x = torch.from_numpy(rng.integers(0, 256, 2 * BLOCK_U8, dtype=np.uint8))
    if name == "stereo":
        return (chains.fm_chain(front="quantized", stereo=True,
                                deemphasis=75e-6, device="cpu"),
                x, 2, STEREO_OPS)
    return chains.fm_chain(device="cpu"), x, 2, ["U8FrontDemod",
                                                 "ResampleFirScale"]


def _names(ops, carried):
    out = []
    for i, op in enumerate(ops):
        out += [f"{i}.{op}.carry"] * carried + [f"{i}.{op}.apply"]
    return out


def _by_name(spans, name):
    return [s for s in spans if s.name == name]


def test_spans_nest_with_parents_and_share_a_call_index():
    with profiling.tracing():
        assert profiling.enabled()
        with profiling.trace("outer"):
            with profiling.span("inner"):
                with profiling.span("leaf"):
                    pass
            with profiling.span("second"):
                pass
    assert not profiling.enabled()
    spans = profiling.spans()
    assert [s.name for s in spans] == ["leaf", "inner", "second", "outer"]
    outer = spans[-1]
    assert outer.parent is None
    assert _by_name(spans, "inner")[0].parent == outer.id
    assert _by_name(spans, "second")[0].parent == outer.id
    assert _by_name(spans, "leaf")[0].parent == \
        _by_name(spans, "inner")[0].id
    assert {s.call for s in spans} == {graphs.replays}
    for s in spans:
        assert outer.start_ns <= s.start_ns <= s.end_ns <= outer.end_ns
        assert s.ms == (s.end_ns - s.start_ns) / 1e6
    profiling.clear()
    assert profiling.spans() == []


def test_tracing_off_records_nothing_and_emits_no_range():
    assert not profiling.enabled()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with profiling.trace("quiet"), profiling.span("quiet2"):
            pass
    assert profiling.spans() == []
    assert not any(e.name in ("quiet", "sdr.quiet2")
                   for e in prof.events())
    # nested switches restore what was there
    with profiling.tracing():
        with profiling.tracing():
            pass
        assert profiling.enabled()
    assert not profiling.enabled()


def test_span_buffer_is_bounded():
    with profiling.tracing():
        for _ in range(profiling.SPAN_LIMIT + 10):
            with profiling.span("s"):
                pass
    spans = profiling.spans()
    assert len(spans) == profiling.SPAN_LIMIT
    assert spans[0].id < spans[-1].id


def test_totals_fill_with_tracing_off():
    before = profiling.totals()
    design.windowed_sinc(51, 0.1, design.hamming)
    design.remez(31, [0, 0.1, 0.3, 1.0], [1, 0])
    Captured(lambda: torch.zeros(3), torch.device("cpu"))
    after = profiling.totals()
    assert after["design"] > before.get("design", 0.0)
    assert after["capture"] > before.get("capture", 0.0)
    assert profiling.spans() == []          # counted, not traced
    # traced, a set-up is also its span
    with profiling.tracing():
        design.windowed_sinc(31, 0.2)
    assert [s.name for s in profiling.spans()] == ["design"]
    assert profiling.totals()["design"] > after["design"]


def test_calls_built_with_tracing_off_have_no_stages():
    ops, x, nb, _ = _chain("mono")
    call = compile_time_batched(ops, x, nb, device="cpu")
    y = call()
    assert call.stages is None and call.stage_ms() is None
    with profiling.tracing():
        traced = compile_time_batched(ops, x, nb, device="cpu")
    # built traced, the call times its stages whether or not tracing is
    # on when it runs; off, it records no span
    profiling.clear()
    assert torch.equal(traced(), y)
    assert list(traced.stage_ms()) == MONO
    assert profiling.spans() == []
    p = Pipeline(ops, block_in=x.shape[-1] // nb, device="cpu")
    step = p.jit_step()
    step(p.init(), x[:BLOCK_U8])
    assert step.stage_ms() is None


@pytest.mark.parametrize("name", ["mono", "stereo", "wideband"])
def test_compiled_call_stages_sum_to_the_call(name):
    """``compile_time_batched`` built with tracing on: every stage named,
    in order, and their times (the host clock on the CPU) sum to a span
    that lies inside the call's ``call.replay`` and holds each stage's
    own span."""
    ops, x, nb, classes = _chain(name)
    want = run_time_batched(ops, x, nb, device="cpu")
    with profiling.tracing():
        call = compile_time_batched(ops, x, nb, device="cpu")
        profiling.clear()
        y = call()
        ms = call.stage_ms()
    assert torch.equal(y, want)
    assert list(ms) == ["input", *_names(classes, True), "output"]
    if name == "mono":
        assert list(ms) == MONO
    assert all(v >= 0 for v in ms.values())
    spans = profiling.spans()
    (replay,) = _by_name(spans, "call.replay")
    (whole,) = _by_name(spans, "call")
    assert replay.parent == whole.id and whole.parent is None
    stage_spans = [s for s in spans if s.name in ms]
    assert [s.name for s in stage_spans] == list(ms)
    assert all(s.parent == replay.id for s in stage_spans)
    assert {s.call for s in spans} == {graphs.replays - 1}
    total = sum(ms.values())
    assert sum(s.ms for s in stage_spans) <= total + 1e-9
    assert total <= replay.ms + 1e-9
    # a second call times itself again, under the next index
    profiling.clear()
    with profiling.tracing():
        call(x.clone())
    spans = profiling.spans()
    assert [s.name for s in spans if s.parent == _by_name(
        spans, "call")[0].id] == ["call.copy_in", "call.replay"]
    assert {s.call for s in spans} == {graphs.replays - 1}
    assert list(call.stage_ms()) == list(ms)


@pytest.mark.parametrize("name", ["mono", "stereo", "wideband"])
def test_jit_step_stages_sum_to_the_step(name):
    """``Pipeline.jit_step`` built with tracing on: each op's apply and
    ``output`` (the carries' write-back), summing inside the replay."""
    ops, x, nb, classes = _chain(name)
    blk = x.shape[-1] // nb
    p = Pipeline(ops, block_in=blk, in_dtype=x.dtype, device="cpu")
    _, want = p.process(x)
    with profiling.tracing():
        step = p.jit_step()
        cs, y0 = step(p.init(), x[:blk])
        profiling.clear()
        cs, y1 = step(cs, x[blk:])
        ms = step.stage_ms()
    assert torch.equal(torch.cat([y0, y1], dim=-1), want)
    assert list(ms) == [*_names(classes, False), "output"]
    spans = profiling.spans()
    (whole,) = _by_name(spans, "call")
    (replay,) = _by_name(spans, "call.replay")
    (copy_in,) = _by_name(spans, "call.copy_in")
    assert replay.parent == copy_in.parent == whole.id
    stage_spans = [s for s in spans if s.name in ms]
    assert [s.name for s in stage_spans] == list(ms)
    total = sum(ms.values())
    assert sum(s.ms for s in stage_spans) <= total + 1e-9 <= \
        replay.ms + 2e-9


def test_eager_calls_emit_their_stages_as_spans():
    """``run_time_batched`` and ``Pipeline.apply`` under tracing: the
    stages are spans (the profiler's ``sdr.<stage>`` ranges), so a
    profile of an eager call holds each stage's PyTorch ops."""
    ops, x, nb, _ = _chain("mono")
    with profiling.tracing():
        run_time_batched(ops, x, nb, device="cpu")
        assert [s.name for s in profiling.spans()] == MONO
        profiling.clear()
        p = Pipeline(ops, block_in=BLOCK_U8, device="cpu")
        p.apply(p.init(), x[:BLOCK_U8])
    assert [s.name for s in profiling.spans()] == [
        "0.U8FrontDemod.apply", "1.ResampleFirScale.apply"]


def test_a_stage_that_raises_leaves_the_next_call_whole():
    with profiling.tracing():
        stages = profiling.Stages(["a", "b"], "cpu")
        with pytest.raises(RuntimeError):
            with profiling.stage(stages):
                raise RuntimeError("boom")
        for _ in stages.names:
            with profiling.stage(stages):
                pass
    assert [s.name for s in profiling.spans()] == ["a", "a", "b"]
    assert list(stages.ms()) == ["a", "b"]
    assert all(v >= 0 for v in stages.ms().values())


def test_profile_writes_the_program_spans(tmp_path):
    """``profile()`` turns tracing on: a caller's region keeps its name,
    the program's spans are ``sdr.<name>`` ranges."""
    ops, x, nb, _ = _chain("mono")
    call = compile_time_batched(ops, x, nb, device="cpu")
    with profiling.profile(tmp_path / "logs", device="cpu"):
        assert profiling.enabled()
        with profiling.trace("fm_block"):
            call()
    assert not profiling.enabled()
    (path,) = list((tmp_path / "logs").iterdir())
    names = {e.get("name") for e in json.loads(path.read_text())[
        "traceEvents"]}
    assert {"fm_block", "sdr.call", "sdr.call.replay"} <= names


# -- what profile_fm reads from the stages and spans ----------------------

STEREO_MS = {"input": 0.01, "0.U8FrontEnd.carry": 0.002,
             "0.U8FrontEnd.apply": 0.19, "1.FmDemod.carry": 0.003,
             "1.FmDemod.apply": 0.08, "2.StereoDecode.carry": 0.11,
             "2.StereoDecode.apply": 0.37, "3.ResampleFirScale.carry": 0.01,
             "3.ResampleFirScale.apply": 0.18, "output": 0.02}


@pytest.mark.parametrize("op,want", [
    ("StereoDecode", 0.48), ("U8FrontEnd", 0.192), ("FmDemod", 0.083),
    ("Channelize", None), ("Stereo", None)])
def test_op_ms_matches_stages_by_class(op, want):
    got = profile_fm.op_ms(STEREO_MS, op)
    assert got == pytest.approx(want) if want is not None else got is None
    assert profile_fm.op_ms(None, op) is None
    # the same class at two indices sums, whatever the indices
    both = {"1.Fir.carry": 1.0, "1.Fir.apply": 2.0, "4.Fir.apply": 4.0}
    assert profile_fm.op_ms(both, "Fir") == 7.0


def test_runner_ms_is_input_output_and_every_carry():
    assert profile_fm.runner_ms(STEREO_MS) == pytest.approx(
        0.01 + 0.02 + 0.002 + 0.003 + 0.11 + 0.01)
    assert profile_fm.runner_ms(None) is None
    # the streamed step has no input stage: no runner
    assert profile_fm.runner_ms({"0.Fir.apply": 1.0, "output": 0.1}) is None


def test_idle_gaps_labels_each_gap_by_the_innermost_span():
    device = [(100, 150), (160, 300), (290, 320), (400, 500)]
    host = [("call", 90, 200), ("call.replay", 95, 170),
            ("call", 350, 420), ("call.replay", 355, 410)]
    got = profile_fm.idle_gaps(device, host)
    assert got["window_ms"] == pytest.approx((500 - 90) / 1e3)
    # gaps: 90-100 (call: its replay opens at 95), 150-160 (call.replay),
    # 320-400 (outside: the next call opens at 350)
    assert got["gaps"] == [("outside", 0.08), ("call", 0.01),
                           ("call.replay", 0.01)]
    assert got["idle_ms"] == pytest.approx(0.1)
    # inside a call span: 90-100, 150-160 and 350-400
    assert got["call_idle_share"] == pytest.approx(70 / 410)
    assert profile_fm.idle_gaps(device, []) is None
    assert profile_fm.idle_gaps([], host) is None
