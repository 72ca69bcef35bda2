"""The port's broadcast-FM chain vs the JAX package's, end to end.

The JAX chain is ``fm_chain(front='fused', fuse_back=True)``, the form the
JAX package runs on an accelerator; on the CPU it runs through its XLA and
interpret paths.  The port runs its plain versions (``device='cpu'``).
Signal: the synthetic FM broadcast of the verify recipe (1 kHz tone,
75 kHz deviation, 1.28 MS/s u8 IQ), 8 blocks of 163,840 bytes.
"""

import wave

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from sdr_tpu.apps import chains as jchains
from sdr_tpu.parallel.sharded import run_time_batched as jax_run_time_batched
from sdr_tpu.stream import Fir as JaxFir
from sdr_tpu.stream import Pipeline as JaxPipeline

from sdr_tpu_torch.apps import chains, fm
from sdr_tpu_torch.ops.fir import FirSpec
from sdr_tpu_torch.parallel.sharded import run_time_batched
from sdr_tpu_torch.stream import Pipeline
from sdr_tpu_torch.stream.ops import resampler_hist_len

BLOCK, NB = 163_840, 8
ATOL = 1e-5     # f32 sums in other orders than XLA's convolutions


def _broadcast(n_bytes):
    fs, n = 1_280_000, n_bytes // 2
    t = np.arange(n) / fs
    audio = np.sin(2 * np.pi * 1000 * t)
    iq = 0.9 * np.exp(1j * (2 * np.pi * 75e3 * np.cumsum(audio) / fs))
    raw = np.empty(2 * n, np.uint8)
    raw[0::2] = np.clip(np.round(iq.real * 128 + 128), 0, 255)
    raw[1::2] = np.clip(np.round(iq.imag * 128 + 128), 0, 255)
    return raw


def _tone_hz(y, rate=48_000):
    seg = np.asarray(y, dtype=np.float64)[2000:]
    return np.argmax(np.abs(np.fft.rfft(seg))) * rate / len(seg)


@pytest.fixture(scope="module")
def raw():
    return _broadcast(BLOCK * NB)


@pytest.fixture(scope="module")
def jax_ops():
    return jchains.fm_chain(front="fused", fuse_back=True)


@pytest.fixture(scope="module")
def jax_out(raw, jax_ops):
    _, y = JaxPipeline(jax_ops, block_in=BLOCK).process(raw)
    return np.asarray(y)


@pytest.fixture(scope="module")
def ops():
    return chains.fm_chain(device="cpu")


def test_fm_taps_bitwise():
    for a, b in zip(chains.fm_taps(), jchains.fm_taps()):
        assert a.dtype == b.dtype == np.float32
        np.testing.assert_array_equal(a.view(np.uint32), b.view(np.uint32))


def test_streamed_matches_jax(raw, ops, jax_out):
    _, y = Pipeline(ops, block_in=BLOCK, device="cpu").process(raw)
    assert y.shape == jax_out.shape == (NB * 3072,)
    np.testing.assert_allclose(y.numpy(), jax_out, rtol=0, atol=ATOL)
    assert abs(_tone_hz(y.numpy()) - 1000) < 5


def test_block_parallel_matches_jax_and_streamed(raw, ops, jax_ops, jax_out):
    par = run_time_batched(ops, raw, NB, device="cpu")
    want = np.asarray(jax_run_time_batched(jax_ops, jnp.asarray(raw), NB))
    np.testing.assert_allclose(par.numpy(), want, rtol=0, atol=ATOL)
    _, seq = Pipeline(ops, block_in=BLOCK, device="cpu").process(raw)
    np.testing.assert_allclose(par.numpy(), seq.numpy(), rtol=0, atol=1e-6)
    np.testing.assert_allclose(par.numpy(), jax_out, rtol=0, atol=ATOL)


def test_segmented_and_batched_runs_continue_exactly(raw, ops):
    """process(parallel_blocks=3) and run_batched thread the state across
    groups (a short final group included): equal to the streamed run."""
    p = Pipeline(ops, block_in=BLOCK, device="cpu")
    _, seq = p.process(raw)
    _, seg = p.process(raw, parallel_blocks=3)
    np.testing.assert_allclose(seg.numpy(), seq.numpy(), rtol=0, atol=1e-6)
    blocks = (raw[i:i + BLOCK] for i in range(0, len(raw), BLOCK))
    rb = torch.cat(list(p.run_batched(blocks, 3)))
    np.testing.assert_allclose(rb.numpy(), seq.numpy(), rtol=0, atol=1e-6)
    blocks = (raw[i:i + BLOCK] for i in range(0, len(raw), BLOCK))
    run = torch.cat(list(p.run(blocks)))
    assert torch.equal(run, seq)


def test_jax_checkpoint_resumes_in_port(raw, ops, jax_ops, jax_out,
                                        tmp_path):
    """A stream started in JAX, checkpointed mid-stream, continues in the
    port: from the .npz file and from the leaves in memory."""
    split = 3 * BLOCK
    jp = JaxPipeline(jax_ops, block_in=BLOCK)
    carries, _ = jp.process(raw[:split])
    path = str(tmp_path / "carries.npz")
    jp.checkpoint(carries, path)
    p = Pipeline(ops, block_in=BLOCK, device="cpu")
    n_done = 3 * 3072
    for cs in (p.restore(path),
               p.carries_from_numpy([np.asarray(leaf) for leaf in
                                     jax.tree.leaves(carries)])):
        _, y = p.process(raw[split:], carries=cs)
        np.testing.assert_allclose(y.numpy(), jax_out[n_done:], rtol=0,
                                   atol=ATOL)
    # and the port's own checkpoint round-trips exactly
    cs, _ = p.process(raw[:split])
    p.checkpoint(cs, path)
    _, a = p.process(raw[split:], carries=p.restore(path))
    _, b = p.process(raw[split:], carries=cs)
    assert torch.equal(a, b)


def test_restore_rejects_other_pipeline(raw, ops, tmp_path):
    p = Pipeline(ops, block_in=BLOCK, device="cpu")
    path = str(tmp_path / "c.npz")
    p.checkpoint(p.init(), path)
    with pytest.raises(ValueError, match="different pipeline"):
        Pipeline(ops, block_in=BLOCK, batch_shape=(2,),
                 device="cpu").restore(path)
    with pytest.raises(ValueError, match="carry leaves"):
        p.carries_from_numpy([np.zeros(3)])


def test_carries_are_not_aliased(raw, ops):
    p = Pipeline(ops, block_in=BLOCK, device="cpu")
    x = torch.from_numpy(raw[:BLOCK].copy())
    cs, _ = p.apply(p.init(), x)
    (hist, liq), back = cs
    x.zero_()       # reusing the input block must not change the state
    assert hist.min().item() > 0 or hist.max().item() > 0
    ptrs = {t.untyped_storage().data_ptr() for t in (hist, liq, back)}
    assert len(ptrs) == 3


@pytest.mark.parametrize("K,I,D,offset", [(31, 3, 10, 0), (31, 3, 10, 2),
                                          (17, 5, 2, 1), (64, 2, 3, 1)])
def test_resampler_hist_len_matches_jax(K, I, D, offset):
    taps = np.ones(K, np.float32)
    for n_in in (D * 30, D * 4 * 1000):
        want = JaxFir.resampler(taps, I, D, offset=offset).hist_len(n_in)
        assert resampler_hist_len(FirSpec(taps, I, D), offset, n_in) == want


def test_cli_on_cpu(raw, tmp_path):
    src = tmp_path / "capture.u8"
    raw.tofile(src)
    outs = []
    for extra in ([], ["--batched", "3", "--meter"]):
        out = tmp_path / f"a{len(outs)}.wav"
        assert fm.main(["--in", str(src), "--out", str(out), "--block",
                        str(BLOCK), "--device", "cpu", *extra]) == 0
        with wave.open(str(out), "rb") as wf:
            assert wf.getframerate() == 48_000
            outs.append(np.frombuffer(wf.readframes(wf.getnframes()), "<i2"))
    assert len(outs[0]) == NB * 3072
    np.testing.assert_array_equal(outs[0], outs[1])
    assert abs(_tone_hz(outs[0]) - 1000) < 5


def test_unported_options_raise():
    for kw in ({"front": "exact"}, {"front": "quantized"}, {"stereo": True},
               {"deemphasis": 75e-6}, {"fuse_back": False}):
        with pytest.raises(NotImplementedError, match="slice"):
            chains.fm_chain(device="cpu", **kw)
