"""The port's compiled calls on the CPU: ``Pipeline.jit_step`` (and the
``run``, ``scan`` and ``process`` that drive it), ``compile_time_batched``
and the compiled groups of ``run_batched`` / ``process(parallel_blocks=)``.

On the CPU a compiled call keeps its function and runs it again on the
same static buffers (``utils/graphs.py``), so these tests exercise the
buffer handling the card's graphs run: a block copied into the input
buffer, the carries written back into theirs, the output handed out.
Each compiled form is held bitwise against its eager form on the same
inputs and carries (the same ops, in the same order), and the compiled
``run`` against the JAX package's ``Pipeline.run`` (its jitted step)
within the chain tolerances of ``PERF.md`` §2: mono 1e-5, stereo 2e-5.
Small sizes: 8 blocks of a few thousand samples.
"""

import gc
import weakref

import numpy as np
import pytest
import torch
import torch.distributed as dist

import jax

from sdr_tpu.apps import chains as jchains
from sdr_tpu.stream import Pipeline as JaxPipeline

from sdr_tpu_torch.apps import chains
from sdr_tpu_torch.ops.design import hamming, windowed_sinc
from sdr_tpu_torch.parallel.sharded import (compile_time_batched,
                                            run_time_batched)
from sdr_tpu_torch.stream import Fir, Pipeline, Scale
from sdr_tpu_torch.stream.pipeline import flatten_carries
from sdr_tpu_torch.utils import graphs

NB = 8
FM_BLOCK = 16_000                 # u8 bytes: 1,000 demod, 300 audio samples
AM_BLOCK = 1 << 13
WF_BLOCK = 8_192                  # 4,096 complex samples: 8 frames
CH_C, CH_BLOCK = 4, 3_200         # narrowband bank: channels, samples
FM_ATOL, STEREO_ATOL = 1e-5, 2e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs in several worker processes
    (pytest-xdist), where PyTorch's idle OpenMP workers spinning would
    cost the other workers the CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def broadcast(n_bytes, stereo=False, seed=0):
    """u8 IQ of an FM broadcast at 1.28 MS/s (75 kHz deviation): a 1 kHz
    tone, or with ``stereo`` the multiplex (L 1 kHz, R 400 Hz, a 10 %
    pilot), with seeded noise."""
    fs, n = 1_280_000, n_bytes // 2
    t = np.arange(n) / fs
    if stereo:
        left, right = np.sin(2 * np.pi * 1e3 * t), np.sin(2 * np.pi * 400 * t)
        comp = (0.25 * (left + right) + 0.1 * np.cos(2 * np.pi * 19e3 * t)
                + 0.25 * (left - right) * np.cos(2 * np.pi * 38e3 * t))
    else:
        comp = np.sin(2 * np.pi * 1e3 * t)
    iq = 0.9 * np.exp(1j * 2 * np.pi * 75e3 * np.cumsum(comp) / fs)
    iq += 0.01 * np.random.default_rng(seed).standard_normal(n)
    raw = np.empty(2 * n, np.uint8)
    raw[0::2] = np.clip(np.round(iq.real * 128 + 128), 0, 255)
    raw[1::2] = np.clip(np.round(iq.imag * 128 + 128), 0, 255)
    return raw


def am_raw(n_bytes, seed=0):
    """u8 IQ of an AM carrier at 0.25 cycles/sample, 50 % modulated."""
    k = np.arange(n_bytes // 2)
    v = 0.5 * (1 + 0.5 * np.sin(2 * np.pi * k / 4000)) * np.exp(
        0.5j * np.pi * k)
    v += 0.01 * np.random.default_rng(seed).standard_normal(len(k))
    raw = np.empty(n_bytes, np.uint8)
    raw[0::2] = np.clip(np.round(v.real * 128 + 128), 0, 255)
    raw[1::2] = np.clip(np.round(v.imag * 128 + 128), 0, 255)
    return raw


def bank(n, seed=0):
    """[CH_C, n] complex64 FM basebands with seeded noise."""
    rng = np.random.default_rng(seed)
    t = np.arange(n) / 160_000
    tones = 200.0 + 150.0 * np.arange(CH_C)[:, None]
    phase = 2 * np.pi * 75e3 * np.cumsum(np.sin(2 * np.pi * tones * t),
                                         axis=-1) / 160_000
    x = 0.9 * np.exp(1j * phase) + 0.01 * (
        rng.standard_normal((CH_C, n)) + 1j * rng.standard_normal((CH_C, n)))
    return x.astype(np.complex64)


def wideband(n, seed=0):
    """n complex64 samples of seeded noise: the wideband bank's input."""
    rng = np.random.default_rng(seed)
    return (0.3 * (rng.standard_normal(n) + 1j * rng.standard_normal(n))
            ).astype(np.complex64)


# name: (the chain on the CPU, its block, the recording of `blocks` blocks)
CHAINS = {
    "mono": (lambda: chains.fm_chain(device="cpu"), FM_BLOCK,
             lambda nb, seed=0: broadcast(nb * FM_BLOCK, seed=seed)),
    "stereo": (lambda: chains.fm_chain(front="quantized", stereo=True,
                                       deemphasis=75e-6, device="cpu"),
               FM_BLOCK,
               lambda nb, seed=0: broadcast(nb * FM_BLOCK, True, seed)),
    "exact": (lambda: chains.fm_chain(front="exact", device="cpu"),
              FM_BLOCK, lambda nb, seed=0: broadcast(nb * FM_BLOCK,
                                                     seed=seed)),
    "am": (lambda: chains.am_chain(device="cpu"), AM_BLOCK,
           lambda nb, seed=0: am_raw(nb * AM_BLOCK, seed)),
    "am_approx": (lambda: chains.am_chain(agc_approx=1, device="cpu"),
                  AM_BLOCK, lambda nb, seed=0: am_raw(nb * AM_BLOCK, seed)),
    "waterfall": (lambda: chains.waterfall_chain(device="cpu"), WF_BLOCK,
                  lambda nb, seed=0: broadcast(nb * WF_BLOCK, seed=seed)),
    "channelizer": (lambda: chains.channelizer_chain(CH_C, device="cpu"),
                    CH_BLOCK, lambda nb, seed=0: bank(nb * CH_BLOCK, seed)),
    "channelizer_wideband": (
        lambda: chains.channelizer_chain(CH_C, wideband=True, device="cpu"),
        CH_C * CH_BLOCK,
        lambda nb, seed=0: wideband(nb * CH_C * CH_BLOCK, seed)),
}


def pipeline(name):
    make, block, _ = CHAINS[name]
    lead = (CH_C,) if name == "channelizer" else ()
    dtype = (torch.complex64 if name.startswith("channelizer")
             else torch.uint8)
    return Pipeline(make(), block_in=block, batch_shape=lead,
                    in_dtype=dtype, device="cpu")


def blocks_of(name, nb=NB, seed=0):
    _, block, make = CHAINS[name]
    x = make(nb, seed)
    return [x[..., i * block:(i + 1) * block] for i in range(nb)]


def eager_run(p, blocks, carries=None):
    """The streamed run op by op: ``Pipeline.apply`` a block, the carries
    threaded (the compiled step's function, run eagerly)."""
    cs = p.init() if carries is None else carries
    ys = []
    for b in blocks:
        cs, y = p.apply(cs, torch.as_tensor(b))
        ys.append(y)
    return cs, ys


def same(a, b):
    """Tensors (or carry trees) equal bit for bit."""
    la, lb = flatten_carries(a), flatten_carries(b)
    return len(la) == len(lb) and all(
        u.dtype == v.dtype and u.shape == v.shape and torch.equal(
            torch.view_as_real(u) if u.is_complex() else u,
            torch.view_as_real(v) if v.is_complex() else v)
        for u, v in zip(la, lb))


@pytest.mark.parametrize("name", sorted(CHAINS))
def test_jit_step_is_the_eager_run_bitwise(name):
    """8 blocks through ``jit_step`` and through ``Pipeline.run`` (which
    drives the compiled step) equal the eager run bit for bit, carries
    included: for stereo, ``StereoDecode``'s history (a view of the
    block) is written back into the step's own buffer."""
    p = pipeline(name)
    blocks = blocks_of(name)
    want_cs, want = eager_run(p, blocks)
    step = p.jit_step()
    cs = p.init()
    for b, w in zip(blocks, want):
        cs, y = step(cs, b)
        assert same(y, w)
    assert same(cs, want_cs)
    assert step.carry_copies == len(flatten_carries(cs))   # init() only
    assert step.input_copies == NB
    assert all(same(y, w) for y, w in zip(p.run(blocks), want))


@pytest.mark.parametrize("name", ["mono", "stereo"])
def test_compiled_run_matches_jax_pipeline_run(name):
    """The port's compiled ``run`` against the JAX package's ``run`` (its
    jitted, donated step) on the same seeded u8 blocks.  The JAX run
    starts from copies of its initial carries: its ``Iir.init_carry``
    returns one array twice, which its donation refuses (as F1)."""
    jops = (jchains.fm_chain(front="fused", fuse_back=True) if name == "mono"
            else jchains.fm_chain(front="quantized", stereo=True,
                                  deemphasis=75e-6, fuse_back=True))
    blocks = blocks_of(name)
    jp = JaxPipeline(jops, block_in=FM_BLOCK)
    fresh = jax.tree.map(lambda leaf: jax.numpy.array(leaf, copy=True),
                         jp.init())
    want = [np.asarray(y) for y in jp.run(iter(blocks), carries=fresh)]
    got = list(pipeline(name).run(blocks))
    atol = FM_ATOL if name == "mono" else STEREO_ATOL
    for y, w in zip(got, want):
        assert y.shape == w.shape
        np.testing.assert_allclose(y.numpy(), w, rtol=0, atol=atol)


def test_yielded_block_unchanged_by_the_next_call():
    p = pipeline("mono")
    blocks = blocks_of("mono", 3)
    step = p.jit_step()
    cs, y0 = step(p.init(), blocks[0])
    keep = y0.clone()
    cs, y1 = step(cs, blocks[1])
    cs, _ = step(cs, blocks[2])
    assert torch.equal(y0, keep) and not torch.equal(y0, y1)
    ys = list(p.run(blocks))
    assert torch.equal(ys[0], keep)


@pytest.mark.parametrize("name", ["mono", "stereo"])
def test_restored_jax_checkpoint_continues_exactly(name, tmp_path):
    """Carries from ``restore()`` of the JAX chain's checkpoint after 4
    blocks are copied into the step's buffers: the compiled continuation
    is bitwise the eager one from the same carries, and within the chain
    tolerance of the JAX package's own continuation."""
    jops = (jchains.fm_chain(front="fused", fuse_back=True) if name == "mono"
            else jchains.fm_chain(front="quantized", stereo=True,
                                  deemphasis=75e-6, fuse_back=True))
    blocks = blocks_of(name)
    jp = JaxPipeline(jops, block_in=FM_BLOCK)
    process = jax.jit(jp.process)
    jcs, _ = process(np.concatenate(blocks[:4], axis=-1))
    _, jtail = process(np.concatenate(blocks[4:], axis=-1), jcs)
    path = str(tmp_path / "carries.npz")
    jp.checkpoint(jcs, path)
    p = pipeline(name)
    _, want = eager_run(p, blocks[4:], p.restore(path))
    step = p.jit_step()
    cs = p.restore(path)
    got = []
    for b in blocks[4:]:
        cs, y = step(cs, b)
        got.append(y)
    assert all(same(y, w) for y, w in zip(got, want))
    atol = FM_ATOL if name == "mono" else STEREO_ATOL
    np.testing.assert_allclose(torch.cat(got, dim=-1).numpy(),
                               np.asarray(jtail), rtol=0, atol=atol)


def test_new_block_shape_captures_again():
    """A filter whose carry does not depend on the block length: a block
    of another length takes a second capture, and both continue the
    stream as the eager steps do."""
    taps = windowed_sinc(33, 0.2, hamming)
    p = Pipeline([Fir.filter(taps, device="cpu"), Scale(0.5, device="cpu")],
                 block_in=1000, in_dtype=torch.float32, device="cpu")
    x = np.random.default_rng(3).standard_normal(4000).astype(np.float32)
    parts = [x[:1000], x[1000:1600], x[1600:2600], x[2600:3200]]
    _, want = eager_run(p, parts)
    step = p.jit_step()
    before = graphs.captures
    cs = p.init()
    for b, w in zip(parts, want):
        cs, y = step(cs, b)
        assert same(y, w)
    assert graphs.captures - before == 2 and len(step._calls) == 2


def test_run_batched_short_last_group():
    """7 blocks in groups of 3: the first group eager, the second replayed
    by the compiled call its shape captures, the short last 1 eager (its
    shape's first call); each bitwise the eager block-parallel call on
    the same carries; the stream equals the streamed run (mono is
    bitwise)."""
    p = pipeline("mono")
    blocks = blocks_of("mono", 7)
    got = list(p.run_batched(iter(blocks), 3))
    assert len(got) == 3 and len(p._batched) == 1
    assert sorted(n for _, n, _ in p._group_calls) == [FM_BLOCK,
                                                       3 * FM_BLOCK]
    cs = p.init()
    for i, g in enumerate((3, 3, 1)):
        seg = np.concatenate(blocks[3 * i:3 * i + g])
        cs, want = run_time_batched(p.ops, seg, g, carries=cs,
                                    return_carries=True, device="cpu")
        assert same(got[i], want)
    _, streamed = eager_run(p, blocks)
    assert torch.equal(torch.cat(got), torch.cat(streamed))


def test_compile_time_batched_on_two_inputs():
    """Called on its own input, then on a second recording copied in
    (counted), the compiled call is bitwise ``run_time_batched`` on each;
    with carries threaded through its buffers too."""
    ops = chains.fm_chain(device="cpu")
    a = broadcast(NB * FM_BLOCK, seed=1)
    b = broadcast(NB * FM_BLOCK, seed=2)
    call = compile_time_batched(ops, a.copy(), NB, device="cpu")
    assert same(call(), run_time_batched(ops, a, NB, device="cpu"))
    assert call.input_copies == 0
    assert same(call(b), run_time_batched(ops, b, NB, device="cpu"))
    assert call.input_copies == 1
    assert same(call(a), run_time_batched(ops, a, NB, device="cpu"))
    cs, _ = run_time_batched(ops, b, NB, return_carries=True, device="cpu")
    ce, ye = run_time_batched(ops, a, NB, carries=cs, return_carries=True,
                              device="cpu")
    threaded = compile_time_batched(ops, a, NB, carries=cs,
                                    return_carries=True, device="cpu")
    cg, yg = threaded()
    assert same(yg, ye) and same(cg, ce)
    ce2, ye2 = run_time_batched(ops, b, NB, carries=ce, return_carries=True,
                                device="cpu")
    cg, yg = threaded(b, carries=cg)        # its own buffers: no copy
    assert same(yg, ye2) and same(cg, ce2)
    assert threaded.carry_copies == len(flatten_carries(cs))
    # without carries, returned carries are fresh copies each call
    fresh = compile_time_batched(ops, a, NB, return_carries=True,
                                 device="cpu")
    c1, _ = fresh()
    c2, _ = fresh()
    assert same(c1, c2) and all(u is not v for u, v in
                                zip(flatten_carries(c1), flatten_carries(c2)))


@pytest.mark.parametrize("name", ["mono", "stereo", "channelizer"])
def test_process_is_its_eager_form_bitwise(name):
    """``process`` (the compiled step) and ``process(parallel_blocks=3)``
    (compiled groups of 3 and a short last group of 2) equal their eager
    forms: the block loop, and ``run_time_batched`` segment by segment
    with the carries threaded."""
    p = pipeline(name)
    blocks = blocks_of(name)
    x = np.concatenate(blocks, axis=-1)
    want_cs, want = eager_run(p, blocks)
    cs, seq = p.process(x)
    assert same(seq, torch.cat(want, dim=p.time_axis_out))
    assert same(cs, want_cs)
    cs, seg = p.process(x, parallel_blocks=3)
    ce, parts = p.init(), []
    for pos, g in ((0, 3), (3, 3), (6, 2)):
        span = x[..., pos * p.block_in:(pos + g) * p.block_in]
        ce, y = run_time_batched(p.ops, span, g, carries=ce,
                                 return_carries=True, device="cpu")
        parts.append(y)
    assert same(seg, torch.cat(parts, dim=p.time_axis_out))
    assert same(cs, ce)
    # the final carries are copies: a later call does not change them
    p.process(x)
    assert same(cs, ce)


def test_donate_false_leaves_the_passed_carries_untouched():
    p = pipeline("stereo")
    blocks = blocks_of("stereo", 3)
    carries = p.init()
    before = [leaf.clone() for leaf in flatten_carries(carries)]
    step = p.jit_step(donate=False)
    cs, _ = step(carries, blocks[0])
    cs2, _ = step(cs, blocks[1])
    assert same(carries, before)
    (_, static, _), = step._calls.values()
    assert not any(a is b for a in flatten_carries(cs2)
                   for b in static.bufs)
    assert step.carry_copies == 2 * len(before)
    # donate=True hands out the step's own buffers, updated in place
    donated = p.jit_step()
    d1, _ = donated(p.init(), blocks[0])
    d2, _ = donated(d1, blocks[1])
    assert all(a is b for a, b in zip(flatten_carries(d1),
                                      flatten_carries(d2)))
    assert same(d2, cs2)


def test_donated_carries_overwritten_by_another_call_raise():
    """Two interleaved runs of one pipeline share its step's buffers: once
    both hold the step's donated buffers, the one whose buffers the other
    overwrote raises at its next block instead of continuing from the
    other's state.  (The shape's first call ran eagerly and returned
    fresh carries, which are copied in.)"""
    p = pipeline("mono")
    blocks = blocks_of("mono", 3)
    first, second = p.run(blocks), p.run(blocks)
    next(first)                 # eager: fresh carries
    next(second)                # captured: the step's buffers
    next(first)                 # fresh carries copied in: the buffers
    with pytest.raises(ValueError, match="overwritten"):
        next(second)


def test_a_shape_captures_at_its_second_call():
    """The pipeline's own calls run a shape eagerly once and capture it
    at its second call: a one-group ``process(parallel_blocks=)`` or a
    one-block ``run`` captures nothing, the next call of the shape
    captures once, and every output is the eager one."""
    p = pipeline("mono")
    blocks = blocks_of("mono", 4)
    x = np.concatenate(blocks)
    before = graphs.captures
    _, one = p.process(x, parallel_blocks=4)
    assert graphs.captures == before and not p._batched
    _, again = p.process(x, parallel_blocks=4)
    assert graphs.captures == before + 1 and len(p._batched) == 1
    assert same(one, again)
    (y0,) = p.run(blocks[:1])
    assert graphs.captures == before + 1 and p._step.eager_calls == 1
    ys = list(p.run(blocks))
    assert graphs.captures == before + 2 and p._step.eager_calls == 1
    assert same(y0, ys[0])
    assert same(torch.cat(ys), torch.cat(eager_run(p, blocks)[1]))
    # jit_step keeps the JAX contract: it captures at its first call
    step = p.jit_step()
    step(p.init(), blocks[0])
    assert graphs.captures == before + 3 and step.eager_calls == 0


def test_a_dropped_pipeline_frees_its_compiled_calls():
    """A pipeline's compiled calls hold its ops, not the pipeline, so no
    reference cycle keeps their graphs, buffers and memory pool alive:
    with the cyclic collector off, dropping the pipeline frees them."""
    p = pipeline("stereo")
    blocks = blocks_of("stereo", 4)
    list(p.run(blocks))
    list(p.run_batched(iter(blocks), 2))
    held = [weakref.ref(p), weakref.ref(p._step),
            *(weakref.ref(c) for _, _, c in p._step._calls.values()),
            *(weakref.ref(c.graph) for c in p._batched.values())]
    assert len(held) == 4
    gc.collect()
    gc.disable()
    try:
        del p
        assert all(r() is None for r in held)
    finally:
        gc.enable()


def test_cuda_without_a_gpu_raises():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    ops = chains.fm_chain(device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        compile_time_batched(ops, broadcast(FM_BLOCK), 1, device="cuda")
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        Pipeline(chains.fm_chain(device="cpu"), block_in=FM_BLOCK,
                 device="cuda")


def test_a_group_raises():
    """A group whose CUDA collectives go through the host (gloo) cannot be
    captured: a compiled call on the card raises ``ValueError`` naming its
    backend and the one it needs, before any collective and without
    touching CUDA (a one-rank gloo group in this process)."""
    ops = chains.fm_chain(device="cpu")
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        with pytest.raises(ValueError,
                           match="runs 'gloo'.*'cpu:gloo,cuda:nccl'"):
            compile_time_batched(ops, broadcast(FM_BLOCK), 1, device="cuda",
                                 group=dist.group.WORLD)
    finally:
        dist.destroy_process_group()


def test_write_back_goes_through_a_temporary_on_overlap():
    """A new carry that is a view of a buffer is staged first, so the
    copies never read what another copy wrote."""
    a = torch.arange(6.0)
    b = torch.zeros(3)
    graphs.write_back([a[:3], b], [a[3:], a[:3]])
    assert a[:3].tolist() == [3.0, 4.0, 5.0] and b.tolist() == [0.0, 1.0, 2.0]
    with pytest.raises(ValueError, match="changed shape"):
        graphs.write_back([b], [a])


def test_cpu_form_runs_the_function_again():
    calls = []
    buf = torch.zeros(2)

    def fn():
        calls.append(1)
        buf.add_(1)
        return buf * 2

    c = graphs.Captured(fn, torch.device("cpu"), mutated=[buf])
    assert calls == [] and c.graph is None
    assert c.replay().tolist() == [2.0, 2.0]
    assert c.replay().tolist() == [4.0, 4.0] and len(calls) == 2
