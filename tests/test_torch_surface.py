"""The rest of the port's public surface against the JAX package's:
``Pipeline.scan``, ``Timer`` and the profiling helpers, the filter-design
additions (``srrc``, ``frequency_response``, ``plot_frequency``) and the
plot helpers."""

from __future__ import annotations

import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from sdr_tpu.apps import chains as jchains
from sdr_tpu.io import plot as jplot
from sdr_tpu.ops import design as jdesign
from sdr_tpu.stream import Pipeline as JaxPipeline

from sdr_tpu_torch.apps import chains
from sdr_tpu_torch.io import plot
from sdr_tpu_torch.ops import design
from sdr_tpu_torch.stream import Pipeline, Timer
from sdr_tpu_torch.utils import profiling

BLOCK, NB = 81_920, 4          # 1,536 audio samples a block
ATOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs in several worker processes
    (pytest-xdist), where PyTorch's idle OpenMP workers spinning would
    cost the other workers the CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _broadcast(n_bytes):
    fs, n = 1_280_000, n_bytes // 2
    t = np.arange(n) / fs
    iq = 0.9 * np.exp(1j * (2 * np.pi * 75e3 * np.cumsum(
        np.sin(2 * np.pi * 1000 * t)) / fs))
    noise = 0.01 * np.random.default_rng(1).normal(size=(2, n))
    raw = np.empty(2 * n, np.uint8)
    raw[0::2] = np.clip(np.round((iq.real + noise[0]) * 128 + 128), 0, 255)
    raw[1::2] = np.clip(np.round((iq.imag + noise[1]) * 128 + 128), 0, 255)
    return raw


# -- Pipeline.scan -------------------------------------------------------


@pytest.fixture(scope="module")
def blocks():
    return _broadcast((NB + 2) * BLOCK).reshape(NB + 2, BLOCK)


@pytest.fixture(scope="module")
def jax_scan(blocks):
    """The JAX package's scan over the first NB blocks, and over all."""
    jp = JaxPipeline(jchains.fm_chain(front="fused", fuse_back=True),
                     block_in=BLOCK)
    scan = jax.jit(jp.scan)
    final, ys = scan(jnp.asarray(blocks[:NB]))
    _, ys_all = scan(jnp.asarray(blocks))
    return final, np.asarray(ys), np.asarray(ys_all)


@pytest.fixture(scope="module")
def pipe():
    return Pipeline(chains.fm_chain(device="cpu"), block_in=BLOCK,
                    device="cpu")


def test_scan_matches_jax_scan(pipe, blocks, jax_scan):
    _, want, _ = jax_scan
    final, ys = pipe.scan(blocks[:NB])
    assert ys.shape == want.shape == (NB, 1536)
    np.testing.assert_allclose(ys.numpy(), want, rtol=0, atol=ATOL)
    assert len(final) == len(pipe.ops)


def test_scan_equals_run_bitwise(pipe, blocks):
    final, ys = pipe.scan(torch.from_numpy(blocks))
    run = list(pipe.run(iter(blocks)))
    assert torch.equal(ys, torch.stack(run))
    # the final carries continue the stream as run's would
    _, more = pipe.scan(blocks[:2], carries=final)
    _, whole = pipe.scan(np.concatenate([blocks, blocks[:2]]))
    assert torch.equal(more, whole[-2:])


def test_scan_final_carries_resume_a_jax_stream(pipe, blocks, jax_scan):
    """A JAX scan's final carries continue in the port's scan: the next
    blocks equal the JAX package's uninterrupted scan (H4)."""
    final, _, want_all = jax_scan
    cs = pipe.carries_from_numpy([np.asarray(leaf) for leaf in
                                  jax.tree.leaves(final)])
    _, ys = pipe.scan(blocks[NB:], carries=cs)
    np.testing.assert_allclose(ys.numpy(), want_all[NB:], rtol=0, atol=ATOL)


def test_scan_shapes(pipe, blocks):
    final, ys = pipe.scan(blocks[:0])
    assert ys.shape == (0, 1536) and ys.dtype == torch.float32
    for bad in (blocks[0], blocks[:, :-160]):
        with pytest.raises(ValueError, match="stacked blocks"):
            pipe.scan(bad)
    # a stereo chain stacks its [2, n] L/R blocks
    sp = Pipeline(chains.fm_chain(front="quantized", stereo=True,
                                  deemphasis=75e-6, device="cpu"),
                  block_in=BLOCK, device="cpu")
    _, ys = sp.scan(blocks[:2])
    assert ys.shape == (2, 2, 1536)
    _, whole = sp.process(blocks[:2].reshape(-1))
    assert torch.equal(torch.cat(list(ys.unbind(0)), dim=-1), whole)


# -- Timer and the profiling helpers -------------------------------------


@pytest.fixture
def fake_card(monkeypatch):
    """A stand-in card: ``torch.cuda`` reports a GPU and records each
    ``synchronize``."""
    calls = []
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "synchronize",
                        lambda device=None: calls.append(device))
    return calls


def test_timer_syncs_the_card_on_exit(fake_card):
    with Timer() as t:
        assert fake_card == []
    assert fake_card == [torch.device("cuda")]
    assert t.seconds >= 0
    with Timer("cuda:0"):
        pass
    assert fake_card[-1] == torch.device("cuda:0")


def test_timed_syncs_the_card_before_reading_the_clock(fake_card):
    lines = []
    with profiling.timed("block", sink=lines.append):
        assert fake_card == []
    assert fake_card == [torch.device("cuda")]
    assert len(lines) == 1 and lines[0].startswith("block: ")
    assert lines[0].endswith("s")


def test_cpu_timer_and_timed_skip_the_sync(monkeypatch):
    monkeypatch.setattr(torch.cuda, "synchronize",
                        lambda device=None: pytest.fail("synchronized"))
    with Timer("cpu") as t:
        pass
    lines = []
    with profiling.timed("x", sink=lines.append, device="cpu"):
        pass
    assert t.seconds >= 0 and lines


def test_timer_and_profiling_raise_without_a_gpu(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for make in (Timer, lambda: profiling.timed("x").__enter__(),
                 lambda: profiling.profile(tmp_path).__enter__()):
        with pytest.raises(RuntimeError, match="no CUDA GPU"):
            make()
    assert list(tmp_path.iterdir()) == []


def test_profile_writes_a_trace_with_the_named_regions(tmp_path):
    x = torch.arange(4096.0)
    with profiling.profile(tmp_path / "logs", device="cpu"):
        with profiling.trace("fm_block"):
            (x * 2).sum()
    files = list((tmp_path / "logs").iterdir())
    assert len(files) == 1 and files[0].name.startswith("trace-")
    events = json.loads(files[0].read_text())["traceEvents"]
    assert any(e.get("name") == "fm_block" for e in events)


# -- filter design and plots ---------------------------------------------


@pytest.mark.parametrize("n,ts,beta", [(16, 4, 0.35), (24, 8, 0.5),
                                       (10, 4, 0.25)])
def test_srrc_matches_jax(n, ts, beta):
    """(4, 0.25) puts a sample on the |x| = ts / (4 beta) limit."""
    a, b = design.srrc(n, ts, beta), jdesign.srrc(n, ts, beta)
    assert a.dtype == b.dtype == np.float32 and a.shape == (2 * n + 1,)
    np.testing.assert_allclose(a, b, rtol=0, atol=1e-7)


@pytest.mark.parametrize("taps", [chains.fm_taps()[0], design.srrc(8, 4, .3),
                                  np.ones(7)], ids=["fm51", "srrc", "box"])
def test_frequency_response_matches_jax(taps):
    f, h = design.frequency_response(taps, 256)
    jf, jh = jdesign.frequency_response(taps, 256)
    np.testing.assert_allclose(f, jf, rtol=0, atol=1e-7)
    np.testing.assert_allclose(h, jh, rtol=0, atol=1e-7)
    assert f.shape == h.shape == (256,)


def test_axes_bitwise():
    for n, fs in ((1024, 1.28e6), (7, 1.0), (64, 48_000)):
        for mine, theirs in ((plot.zero_axis, jplot.zero_axis),
                             (plot.centered_axis, jplot.centered_axis)):
            a, b = mine(n, fs), theirs(n, fs)
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)


def test_plots_render_pngs(tmp_path):
    pytest.importorskip("matplotlib")
    y = torch.sin(torch.arange(512.0) / 20)
    plot.plot_line(y, str(tmp_path / "line.png"), title="tone")
    plot.plot_fill(y.abs(), str(tmp_path / "fill.png"),
                   x=plot.centered_axis(512, 48_000))
    design.plot_frequency(chains.fm_taps()[2], str(tmp_path / "h.png"))
    for name in ("line.png", "fill.png", "h.png"):
        assert (tmp_path / name).read_bytes()[:4] == b"\x89PNG"
