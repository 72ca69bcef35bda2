"""The port's channelizer vs the JAX package: ``channelizer_taps``,
``polyphase_channelize`` against both JAX forms (the stencil and the
``'gather'`` oracle, which the port does not carry), the ``Channelize``
op, ``channelizer_chain`` narrowband on ``[C, N]`` and wideband, streamed,
block-parallel and in segments, a JAX checkpoint resumed in the port, and
``apps/channelizer.py``.

Tolerances: the taps bitwise; the filterbank within 1e-5 of its output's
peak; the narrowband chain's audio 1e-5 and the wideband chain's 1e-4 (the
JAX package's own bound between its channelizer forms,
tests/test_channelize.py:106,136); block-parallel against streamed 1e-6
(the plain versions' elementwise ops may round a sample at a block edge
otherwise).  The JAX references run jitted on the CPU.
"""

import wave

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from sdr_tpu.apps import chains as jchains
from sdr_tpu.apps.channelizer import synthesize as jax_synthesize
from sdr_tpu.ops import channelize as jchannelize
from sdr_tpu.parallel.sharded import run_time_batched as jax_run_time_batched
from sdr_tpu.stream import Channelize as JaxChannelize
from sdr_tpu.stream import Pipeline as JaxPipeline

from sdr_tpu_torch.apps import chains, channelizer
from sdr_tpu_torch.ops.channelize import (channelizer_taps,
                                          polyphase_channelize)
from sdr_tpu_torch.parallel.sharded import run_time_batched
from sdr_tpu_torch.stream import Channelize, Pipeline

ATOL_NB, ATOL_WB = 1e-5, 1e-4
C, NB = 4, 4                  # channels, blocks
N = 4 * 12_800                # samples a channel (a multiple of 80 * NB)
FS = 1_280_000
AUDIO = N * 3 // 80


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs in several worker processes
    (pytest-xdist), where PyTorch's idle OpenMP workers spinning would
    cost the other workers the CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _complex(rng, shape):
    return (rng.normal(size=shape) + 1j * rng.normal(size=shape)).astype(
        np.complex64)


def wideband_bank(n_channels, n, seed=2):
    """One wideband stream at ``n_channels * FS`` carrying ``n_channels``
    FM stations made at that rate, station c at +c/C cycles a sample with
    a tone of ``500 * (c + 1)`` Hz at 75 kHz deviation (the bank of
    tests/test_channelize.py at broadcast rates), with a little noise."""
    fs = n_channels * FS
    k = np.arange(n_channels * n)
    x = np.zeros(n_channels * n, np.complex128)
    for c in range(n_channels):
        audio = np.sin(2 * np.pi * 500 * (c + 1) * k / fs)
        phase = 2 * np.pi * 75e3 * np.cumsum(audio) / fs
        x += 0.2 * np.exp(1j * (phase + 2 * np.pi * (c / n_channels) * k))
    rng = np.random.default_rng(seed)
    x += 0.005 * (rng.normal(size=x.shape) + 1j * rng.normal(size=x.shape))
    return x.astype(np.complex64)


def peak_close(got, want, rtol):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = np.abs(got - want).max() / np.abs(want).max()
    assert err <= rtol, err


def tone_hz(y, rate=48_000, skip=200):
    """The tone of ``y``: the peak of its Hann-windowed spectrum, zero
    padded to 2^16 points (a fraction of a bin for a short capture)."""
    seg = np.asarray(y, dtype=np.float64)[skip:]
    spec = np.abs(np.fft.rfft(seg * np.hanning(len(seg)), 1 << 16))
    return np.argmax(spec) * rate / (1 << 16)


# -- the filterbank ------------------------------------------------------


@pytest.mark.parametrize("n_channels,per_branch", [(8, 5), (64, 12),
                                                   (4, 16), (8, 8)])
def test_channelizer_taps_bitwise(n_channels, per_branch):
    np.testing.assert_array_equal(
        channelizer_taps(n_channels, per_branch),
        jchannelize.channelizer_taps(n_channels, per_branch))
    np.testing.assert_array_equal(
        channelizer_taps(n_channels, per_branch, cutoff_scale=0.8),
        jchannelize.channelizer_taps(n_channels, per_branch,
                                     cutoff_scale=0.8))


@pytest.mark.parametrize("n_channels,per_branch", [(8, 5), (64, 12)])
@pytest.mark.parametrize("lead", [(), (2,)])
def test_polyphase_channelize_matches_both_jax_forms(rng, n_channels,
                                                     per_branch, lead):
    taps = channelizer_taps(n_channels, per_branch)
    x = _complex(rng, lead + (4096 + 3,))      # a ragged tail is dropped
    got = polyphase_channelize(taps, n_channels, torch.from_numpy(x))
    assert tuple(got.shape) == lead + (n_channels,
                                       4096 // n_channels - per_branch + 1)
    for method in ("stencil", "gather"):
        want = jax.jit(lambda v: jchannelize.polyphase_channelize(
            taps, n_channels, v, method=method))(x)
        peak_close(got.numpy(), want, 1e-5)
    short = polyphase_channelize(torch.as_tensor(taps), n_channels,
                                 torch.from_numpy(x), num=3)
    assert torch.equal(short, got[..., :3])


def test_polyphase_channelize_localises_tones():
    """A tone at +c/C cycles a sample lands in channel c."""
    n_channels = 16
    taps = channelizer_taps(n_channels, 12)
    for c in (0, 2, 9, 15):
        x = np.exp(2j * np.pi * (c / n_channels) * np.arange(1 << 13))
        y = polyphase_channelize(taps, n_channels, torch.from_numpy(
            x.astype(np.complex64)))
        power = (y.abs() ** 2).mean(dim=-1)
        assert int(power.argmax()) == c
        assert power[c] > 50 * np.delete(power.numpy(), c).max()


def test_polyphase_channelize_rejects_short_input():
    with pytest.raises(ValueError, match="shorter than one filterbank"):
        polyphase_channelize(channelizer_taps(8, 6), 8,
                             torch.zeros(40, dtype=torch.complex64))


def test_channelize_op_blockwise_block_parallel_and_jax(rng):
    """Blocks with the carried history give one call's channels, and so do
    block-parallel rows; both match the JAX op."""
    n_channels, n, blk = 8, 8192, 1024
    op = Channelize(channelizer_taps(n_channels, 6), n_channels,
                    device="cpu")
    x = torch.from_numpy(_complex(rng, n))
    assert op.map_batch_shape(()) == (n_channels,)
    assert op.time_axis_out == -1 and op.out_tail() == ()
    assert op.out_dtype(torch.complex64) == torch.complex64
    _, whole = op.apply(op.init_carry(n, (), torch.complex64), x)
    c, parts = op.init_carry(blk, (), torch.complex64), []
    for i in range(0, n, blk):
        c, y = op.apply(c, x[i:i + blk])
        parts.append(y)
    np.testing.assert_allclose(torch.cat(parts, dim=-1).numpy(),
                               whole.numpy(), rtol=0, atol=1e-6)
    batched = run_time_batched([op], x, n // blk, device="cpu")
    np.testing.assert_allclose(batched.numpy(), whole.numpy(), rtol=0,
                               atol=1e-6)
    jop = JaxChannelize(channelizer_taps(n_channels, 6), n_channels)
    _, want = jop.apply(jop.init_carry(n, jnp.complex64), jnp.asarray(x))
    peak_close(whole.numpy(), want, 1e-5)
    with pytest.raises(ValueError, match=r"stage 0 \(Channelize\)"):
        Pipeline([op], block_in=1001, in_dtype=torch.complex64,
                 device="cpu")


# -- the channel bank ----------------------------------------------------


@pytest.fixture(scope="module")
def narrowband():
    return jax_synthesize(C, N, FS)


@pytest.fixture(scope="module")
def wideband():
    return wideband_bank(C, N)


def _jax_batched(ops, x, nblocks):
    return np.asarray(jax.jit(
        lambda v: jax_run_time_batched(ops, v, nblocks))(x))


@pytest.mark.parametrize("form", ["narrowband", "wideband"])
def test_channelizer_chain_matches_jax(request, form):
    """Block-parallel over NB blocks on [C, N] (narrowband) and [C*N]
    (wideband) against the JAX package's run_time_batched; the streamed
    Pipeline, segments of 3 blocks and one block equal it."""
    wide = form == "wideband"
    x = request.getfixturevalue(form)
    atol = ATOL_WB if wide else ATOL_NB
    ops = chains.channelizer_chain(C, wideband=wide, device="cpu")
    got = run_time_batched(ops, x, NB, device="cpu")
    assert tuple(got.shape) == (C, AUDIO) and got.dtype == torch.float32
    want = _jax_batched(jchains.channelizer_chain(C, wideband=wide), x, NB)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=atol)
    n_in = x.shape[-1]
    p = Pipeline(ops, block_in=n_in // NB, batch_shape=x.shape[:-1],
                 in_dtype=torch.complex64, device="cpu")
    _, streamed = p.process(x)
    _, segments = p.process(x, parallel_blocks=3)
    one = run_time_batched(ops, x, 1, device="cpu")
    for y in (streamed, segments, one):
        np.testing.assert_allclose(y.numpy(), got.numpy(), rtol=0, atol=1e-6)
    blocks = [x[..., i:i + n_in // NB] for i in range(0, n_in, n_in // NB)]
    np.testing.assert_allclose(
        torch.cat(list(p.run_batched(blocks, 2)), dim=-1).numpy(),
        got.numpy(), rtol=0, atol=1e-6)


def test_wideband_bank_recovers_each_station(wideband):
    """Each channel of the wideband bank demodulates to its own
    station's tone."""
    y = run_time_batched(chains.channelizer_chain(C, wideband=True,
                                                  device="cpu"),
                         wideband, NB, device="cpu").numpy()
    for c in range(C):
        want = 500 * (c + 1)
        assert abs(tone_hz(y[c]) - want) < 5, (c, tone_hz(y[c]), want)


def test_narrowband_tones(narrowband):
    y = run_time_batched(chains.channelizer_chain(C, device="cpu"),
                         narrowband, 1, device="cpu").numpy()
    for c in range(C):
        assert abs(tone_hz(y[c]) - (200 + 150 * c)) < 5


@pytest.mark.parametrize("form", ["narrowband", "wideband"])
def test_jax_checkpoint_resumes_in_port(request, form, tmp_path):
    """The JAX chain's state after two of NB blocks (complex filterbank,
    decimator and demod carries), from its .npz file and from its leaves,
    continues in the port as the JAX chain's own uninterrupted run does."""
    wide = form == "wideband"
    x = request.getfixturevalue(form)
    atol = ATOL_WB if wide else ATOL_NB
    blk = x.shape[-1] // NB
    lead = x.shape[:-1]
    jp = JaxPipeline(jchains.channelizer_chain(C, wideband=wide),
                     block_in=blk, in_dtype=jnp.complex64, batch_shape=lead)
    carries, _ = jax.jit(lambda v: jp.process(v))(x[..., :2 * blk])
    _, want = jax.jit(lambda v: jp.process(v))(x)
    path = str(tmp_path / "carries.npz")
    jp.checkpoint(carries, path)
    p = Pipeline(chains.channelizer_chain(C, wideband=wide, device="cpu"),
                 block_in=blk, batch_shape=lead, in_dtype=torch.complex64,
                 device="cpu")
    leaves = [np.asarray(leaf) for leaf in jax.tree.leaves(carries)]
    assert any(np.iscomplexobj(leaf) for leaf in leaves)
    tail = AUDIO // 2
    for cs in (p.restore(path), p.carries_from_numpy(leaves)):
        _, y = p.process(x[..., 2 * blk:], carries=cs)
        np.testing.assert_allclose(y.numpy(), np.asarray(want)[:, tail:],
                                   rtol=0, atol=atol)


def _wavs(prefix, n_channels):
    out = []
    for c in range(n_channels):
        with wave.open(f"{prefix}{c:03d}.wav", "rb") as wf:
            assert wf.getframerate() == 48_000 and wf.getnchannels() == 1
            out.append(np.frombuffer(wf.readframes(wf.getnframes()), "<i2"))
    return np.stack(out)


@pytest.mark.parametrize("wide", [False, True])
def test_channelizer_cli_on_cpu(tmp_path, capsys, wide):
    """--synthetic: the JAX app's line and input; the WAVs are the JAX
    chain's audio on the JAX app's synthetic input (within the chain's
    tolerance and half an LSB); the plain form carries each channel's
    tone.  The --wideband synthetic zero-stuffs each station, so every
    channel carries all of them (ROADMAP F2): no tones are checked."""
    prefix = str(tmp_path / "ch")
    extra = ["--wideband"] if wide else []
    assert channelizer.main(["--synthetic", "--channels", str(C),
                             "--seconds", "0.05", "--device", "cpu",
                             "--out-prefix", prefix, *extra]) == 0
    n = int(FS * 0.05) // 80 * 80
    m = n * 3 // 80
    said = capsys.readouterr().out
    assert (f"demodulated {C} channels x {m} samples at 48000 Hz on 1 "
            "devices") in said
    assert f"wrote {C} WAV files" in said
    pcm = _wavs(prefix, C)
    assert pcm.shape == (C, m)
    x = jax_synthesize(C, n, FS)
    np.testing.assert_allclose(
        channelizer.synthesize(C, n, FS, "cpu").numpy(), x, rtol=0,
        atol=1e-6)
    if wide:      # the JAX app's stacking, as it writes it
        k = np.arange(C * n)
        w = np.zeros(C * n, dtype=np.complex64)
        for c in range(C):
            up = np.zeros(C * n, dtype=np.complex64)
            up[::C] = x[c]
            w += up * np.exp(2j * np.pi * (c / C) * k).astype(np.complex64)
        np.testing.assert_allclose(
            channelizer.stack_wideband(torch.from_numpy(x)).numpy(), w,
            rtol=0, atol=1e-6)
        x = w
    want = _jax_batched(jchains.channelizer_chain(C, wideband=wide), x, 1)
    atol = (ATOL_WB if wide else ATOL_NB) + 0.5 / 32767
    np.testing.assert_allclose(pcm / 32767, want, rtol=0, atol=atol)
    if not wide:
        for c in range(C):
            assert abs(tone_hz(pcm[c]) - (200 + 150 * c)) < 5
