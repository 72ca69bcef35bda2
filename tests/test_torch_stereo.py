"""The port's stereo + de-emphasis FM receiver vs the JAX package:
``StereoDecode``, the IIR ops and ``Iir``, the plane-axis runtime, and the
whole chain ``fm_chain(front='quantized', stereo=True, deemphasis=75e-6)``.

Tolerances (abs): ``StereoDecode`` and the IIR 1e-5 (f32 sums in other
orders; the JAX package evaluates the recurrence with an associative scan,
the port with blocked matrix products); the whole chain 2e-5; lock states
equal.  The JAX side runs on the CPU as its own tests run it, its
reference runs jitted (its eager scans compile for minutes).  Signals are
synthesised from numpy: the multiplex of tests/test_stereo.py (L = 1 kHz,
R = 400 Hz, a 10 % pilot), FM-modulated at 75 kHz deviation for the chain.
Shapes repeat across tests so the JAX package compiles each once.
"""

import wave

import numpy as np
import pytest
import scipy.signal
import torch

import jax
import jax.numpy as jnp

from sdr_tpu.apps import chains as jchains
from sdr_tpu.ops import iir as jiir
from sdr_tpu.parallel import halo as jhalo
from sdr_tpu.parallel.sharded import run_time_batched as jax_run_time_batched
from sdr_tpu.stream import Iir as JaxIir
from sdr_tpu.stream import Pipeline as JaxPipeline
from sdr_tpu.stream import StereoDecode as JaxStereoDecode

from sdr_tpu_torch.apps import chains, fm
from sdr_tpu_torch.ops import iir
from sdr_tpu_torch.parallel import halo
from sdr_tpu_torch.parallel.sharded import run_time_batched
from sdr_tpu_torch.stream import (Iir, Pipeline, ResampleFirScale,
                                  StereoDecode, StreamOp)

ATOL = 1e-5
CHAIN_ATOL = 2e-5
FS = 160_000.0
F_L, F_R = 1_000.0, 400.0
BLOCK, NB = 163_840, 8            # u8 bytes per block, blocks
COMP = BLOCK // 16                # composite samples per block (160 kS/s)
AUDIO = COMP * 3 // 10            # audio samples per block (48 kS/s)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs in several worker processes
    (pytest-xdist), where PyTorch's idle OpenMP workers spinning would
    cost the other workers the CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def make_composite(n, fs=FS, pilot=0.1, stereo=True):
    t = np.arange(n) / fs
    L = np.sin(2 * np.pi * F_L * t)
    R = np.sin(2 * np.pi * F_R * t) if stereo else L
    comp = (0.5 * (L + R) / 2 + pilot * np.cos(2 * np.pi * 19_000 * t)
            + 0.5 * (L - R) / 2 * np.cos(2 * np.pi * 38_000 * t))
    return comp.astype(np.float32)


def broadcast(n_bytes, fs=1_280_000):
    """u8 IQ of the stereo multiplex, FM at 75 kHz deviation."""
    n = n_bytes // 2
    comp = make_composite(n, fs).astype(np.float64)
    iq = 0.9 * np.exp(1j * (2 * np.pi * 75e3 * np.cumsum(comp) / fs))
    raw = np.empty(2 * n, np.uint8)
    raw[0::2] = np.clip(np.round(iq.real * 128 + 128), 0, 255)
    raw[1::2] = np.clip(np.round(iq.imag * 128 + 128), 0, 255)
    return raw


def tone(x, f, rate):
    m = len(x)
    k = int(round(f * m / rate))
    X = np.abs(np.fft.rfft(x * np.hanning(m)))
    return X[max(k - 2, 0): k + 3].max()


# -- StereoDecode -------------------------------------------------------


def test_stereo_taps_bitwise():
    op, jop = StereoDecode(FS, device="cpu"), JaxStereoDecode(FS)
    for name in ("bp19", "bp38", "lp15", "avg"):
        a, b = getattr(op, name), getattr(jop, name)
        assert a.dtype == b.dtype == np.float32
        np.testing.assert_array_equal(a.view(np.uint32), b.view(np.uint32))


def _lock_signals():
    """Block-rate lock cases of tests/test_stereo.py: [n] composites."""
    n = COMP
    t = np.arange(n) / FS
    marginal = (0.5 * np.sin(2 * np.pi * F_L * t)
                + 0.05 * np.cos(2 * np.pi * 19_000 * t)).astype(np.float32)
    return {
        "lock": [make_composite(n)],
        "no-pilot": [make_composite(n, pilot=0.0, stereo=False)],
        "weak-pilot": [make_composite(n, pilot=0.005, stereo=False)],
        # lock, hold through a marginal block (hysteresis), unlock
        "hysteresis": [make_composite(n), marginal,
                       make_composite(n, pilot=0.0, stereo=False)],
    }


@pytest.mark.parametrize("case", ["lock", "no-pilot", "weak-pilot",
                                  "hysteresis"])
def test_stereo_decode_streamed_matches_jax(case):
    want_locks = {"lock": [1.0], "no-pilot": [0.0], "weak-pilot": [0.0],
                  "hysteresis": [1.0, 1.0, 0.0]}[case]
    op, jop = StereoDecode(FS, device="cpu"), JaxStereoDecode(FS)
    c, jc = op.init_carry(COMP), jop.init_carry(COMP, jnp.float32)
    for blk, lock in zip(_lock_signals()[case], want_locks):
        c, y = op.apply(c, torch.from_numpy(blk))
        jc, jy = jop.apply(jc, jnp.asarray(blk))
        assert y.shape == (2, COMP)
        np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=0,
                                   atol=ATOL)
        np.testing.assert_allclose(c[0].numpy(), np.asarray(jc[0]), rtol=0,
                                   atol=ATOL)
        assert float(c[1]) == float(jc[1]) == lock
        if lock == 0.0:                       # mono: L == R exactly
            assert torch.equal(y[0], y[1])


def test_stereo_decode_block_parallel_matches_jax():
    """run_time_batched over a lock -> unlock transition == the JAX
    package's run_time_batched and the port's streamed run; the final lock
    state too."""
    comp = np.concatenate([make_composite(4 * COMP),
                           make_composite(4 * COMP, pilot=0.0,
                                          stereo=False)])
    jop = JaxStereoDecode(FS)
    want = np.asarray(jax.jit(
        lambda v: jax_run_time_batched([jop], v, NB))(comp))
    op = StereoDecode(FS, device="cpu")
    cs, got = run_time_batched([op], comp, NB, return_carries=True,
                               device="cpu")
    assert got.shape == want.shape == (2, NB * COMP)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL)
    scs, streamed = Pipeline([op], block_in=COMP, device="cpu").process(comp)
    np.testing.assert_allclose(got.numpy(), streamed.numpy(), rtol=0,
                               atol=ATOL)
    assert float(cs[0][1]) == float(scs[0][1]) == 0.0
    # the lock entering each row: 0 at warmup, locked by rows 0-3, and
    # unlocked by row 4, whose block carries no pilot
    rows = torch.from_numpy(comp).reshape(NB, COMP)
    assert op.shard_carry(rows)[1].tolist() == [0.0] + [1.0] * 4 + [0.0] * 3


def test_stereo_separation():
    op = StereoDecode(FS, device="cpu")
    comp = make_composite(1 << 16)
    _, y = op.apply(op.init_carry(1 << 16), torch.from_numpy(comp))
    L, R = y[0, 4096:].numpy(), y[1, 4096:].numpy()
    assert tone(L, F_L, FS) > 10 * tone(R, F_L, FS)
    assert tone(R, F_R, FS) > 10 * tone(L, F_R, FS)


def test_stereo_rejects_low_rate():
    with pytest.raises(ValueError, match="too low"):
        StereoDecode(fs=64_000.0, device="cpu")


# -- IIR ------------------------------------------------------------------


DEEMPH = jiir.deemphasis_taps(48_000, 75e-6)


@pytest.mark.parametrize("coeffs", [[0.9], [1.2, -0.5], [0.5, 0.2],
                                    [-float(DEEMPH[1][1]), 0.0]])
def test_linear_recurrence_matches_jax(rng, coeffs):
    x = rng.normal(size=(3, 2048)).astype(np.float32)
    y0 = rng.normal(size=(3, len(coeffs))).astype(np.float32)
    y0[0] = 0                 # row 0: the default zero state
    want = jax.jit(lambda b, s: jiir.linear_recurrence(np.array(coeffs), b,
                                                       s))(x, y0)
    got = iir.linear_recurrence(np.array(coeffs), torch.from_numpy(x),
                                torch.from_numpy(y0))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=ATOL)
    got = iir.linear_recurrence(np.array(coeffs), torch.from_numpy(x[0]))
    np.testing.assert_allclose(got.numpy(), np.asarray(want)[0], rtol=0,
                               atol=ATOL)


def test_biquad_sosfilt_deemphasis_match_jax(rng):
    x = rng.normal(size=(2, 4096)).astype(np.float32)
    b, a = iir.deemphasis_taps(48_000, 75e-6)
    np.testing.assert_array_equal(b, DEEMPH[0])
    np.testing.assert_array_equal(a, DEEMPH[1])
    np.testing.assert_allclose(
        iir.biquad(b, a, torch.from_numpy(x)).numpy(),
        np.asarray(jax.jit(lambda v: jiir.biquad(b, a, v))(x)), rtol=0,
        atol=ATOL)
    sos = scipy.signal.butter(4, 0.2, output="sos")
    np.testing.assert_allclose(
        iir.sosfilt(sos, torch.from_numpy(x)).numpy(),
        np.asarray(jax.jit(lambda v: jiir.sosfilt(sos, v))(x)), rtol=0,
        atol=ATOL)


@pytest.fixture(scope="module")
def audio():
    """[2, NB * AUDIO] audio-rate L/R noise: the chain's Iir shapes."""
    return np.random.default_rng(5).normal(
        size=(2, NB * AUDIO)).astype(np.float32)


def test_iir_streamed_and_block_parallel_match_jax(audio):
    """Iir streamed and block-parallel: the de-emphasis section == the JAX
    package's run_time_batched (which its own tests hold equal to its
    streamed run); a two-section cascade == the port's sosfilt over the
    whole signal (held against the JAX package's above)."""
    b, a = DEEMPH
    deemph = np.concatenate([b, a])
    want = np.asarray(jax.jit(lambda v: jax_run_time_batched(
        [JaxIir(deemph)], v, NB))(audio))
    cascade = scipy.signal.butter(4, 0.2, output="sos")
    for sos, ref in ((deemph, want),
                     (cascade, iir.sosfilt(cascade,
                                           torch.from_numpy(audio)).numpy())):
        op = Iir(sos, device="cpu")
        _, got = Pipeline([op], block_in=AUDIO, batch_shape=(2,),
                          device="cpu").process(audio)
        np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=ATOL)
        par = np.stack([run_time_batched([op], audio[c], NB,
                                         device="cpu").numpy()
                        for c in (0, 1)])
        np.testing.assert_allclose(par, ref, rtol=0, atol=ATOL)


def test_affine_prefixes_match_jax(rng):
    """The batch-axis prefixes == the JAX package's collectives under
    vmap over the same rows."""
    a = rng.uniform(-1, 1, (6, 3)).astype(np.float32)
    b = rng.uniform(-1, 1, (6, 3)).astype(np.float32)
    M = rng.uniform(-1, 1, (6, 3, 2, 2)).astype(np.float32)
    v = rng.uniform(-1, 1, (6, 3, 2)).astype(np.float32)
    want = jax.vmap(lambda x, y: jhalo.exclusive_affine_prefix(x, y, "b"),
                    axis_name="b")(jnp.asarray(a), jnp.asarray(b))
    got = halo.exclusive_affine_prefix(torch.from_numpy(a),
                                       torch.from_numpy(b))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=1e-6)
    want = jax.vmap(
        lambda x, y: jhalo.exclusive_matrix_affine_prefix(x, y, "b"),
        axis_name="b")(jnp.asarray(M), jnp.asarray(v))
    got = halo.exclusive_matrix_affine_prefix(torch.from_numpy(M),
                                              torch.from_numpy(v))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=1e-6)
    want = jax.vmap(lambda x: jhalo.right_shift_scalar(x, "b"),
                    axis_name="b")(jnp.asarray(a))
    got = halo.right_shift_scalar(torch.from_numpy(a))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# -- plane axes in the runtime -------------------------------------------


class _Planes(StreamOp):
    """Test op: ``[..., n]`` -> ``[..., 2, n]`` (the signal and its
    negation), like StereoDecode's L/R planes, with no state."""

    device = torch.device("cpu")

    def map_batch_shape(self, batch_shape):
        return tuple(batch_shape) + (2,)

    def apply(self, carry, x):
        return carry, torch.stack([x, -x], dim=-2)


def _plane_chain():
    _, ars, afl = chains.fm_taps()
    return [_Planes(), ResampleFirScale(ars, 3, 10, afl, 0.5, device="cpu")]


def test_pipeline_widens_carries_after_a_plane_axis(rng):
    """The op after a plane-adding op gets a [2, H] carry, and the chain
    runs block by block."""
    ops = _plane_chain()
    p = Pipeline(ops, block_in=1000, device="cpu")
    cs = p.init()
    assert cs[1].shape == (2, ops[1].hist_len(1000))
    x = rng.uniform(-1, 1, 3000).astype(np.float32)
    _, y = p.process(x)
    assert y.shape == (2, 900)
    torch.testing.assert_close(y[1], -y[0], rtol=0, atol=0)


def test_run_time_batched_restacks_planes(rng):
    """[B, 2, n] block outputs come back as [2, B*n] streams, equal to the
    streamed run."""
    x = rng.uniform(-1, 1, 4000).astype(np.float32)
    ops = _plane_chain()
    got = run_time_batched(ops, x, 4, device="cpu")
    _, want = Pipeline(ops, block_in=1000, device="cpu").process(x)
    assert got.shape == (2, 1200)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-6)
    _, seg = Pipeline(ops, block_in=1000, device="cpu").process(
        x, parallel_blocks=3)
    torch.testing.assert_close(seg, want, rtol=0, atol=1e-6)


# -- the whole chain -----------------------------------------------------


@pytest.fixture(scope="module")
def raw_more():
    """NB + 4 blocks: the checkpoint test continues past the NB blocks."""
    return broadcast(BLOCK * (NB + 4))


@pytest.fixture(scope="module")
def raw(raw_more):
    return raw_more[:BLOCK * NB]


@pytest.fixture(scope="module")
def jax_ops():
    return jchains.fm_chain(front="quantized", stereo=True, deemphasis=75e-6,
                            fuse_back=True)


@pytest.fixture(scope="module")
def jax_run(raw, jax_ops):
    """The JAX chain block-parallel over the NB blocks: (carries after them,
    output).  Its own tests hold it equal to its streamed run; one jitted
    run serves as the reference for both of the port's modes."""
    carries, y = jax.jit(lambda v: jax_run_time_batched(
        jax_ops, v, NB, return_carries=True))(raw)
    return carries, np.asarray(y)


@pytest.fixture(scope="module")
def ops():
    return chains.fm_chain(front="quantized", stereo=True, deemphasis=75e-6,
                           device="cpu")


def test_chain_streamed_matches_jax(raw, ops, jax_run):
    _, y = Pipeline(ops, block_in=BLOCK, device="cpu").process(raw)
    assert y.shape == jax_run[1].shape == (2, NB * AUDIO)
    np.testing.assert_allclose(y.numpy(), jax_run[1], rtol=0,
                               atol=CHAIN_ATOL)
    L, R = y[0, 4000:].numpy(), y[1, 4000:].numpy()
    assert tone(L, F_L, 48_000) > 5 * tone(R, F_L, 48_000)
    assert tone(R, F_R, 48_000) > 5 * tone(L, F_R, 48_000)


def test_chain_block_parallel_matches_jax(raw, ops, jax_run):
    cs, par = run_time_batched(ops, raw, NB, return_carries=True,
                               device="cpu")
    np.testing.assert_allclose(par.numpy(), jax_run[1], rtol=0,
                               atol=CHAIN_ATOL)
    assert float(cs[2][1]) == float(jax_run[0][2][1]) == 1.0    # locked


def test_chain_carries_match_jax_tree_order(ops, jax_ops):
    """The carry leaves, in order: U8FrontEnd bytes; FmDemod (I, Q);
    StereoDecode (hist, lock); ResampleFirScale [2, H]; Iir (xin, yout)."""
    jc = JaxPipeline(jax_ops, block_in=BLOCK).init()
    p = Pipeline(ops, block_in=BLOCK, device="cpu")
    from sdr_tpu_torch.stream.pipeline import flatten_carries
    shapes = [tuple(t.shape) for t in flatten_carries(p.init())]
    assert shapes == [tuple(np.shape(leaf)) for leaf in jax.tree.leaves(jc)]
    assert shapes == [(86,), (2,), (192,), (), (2, 217), (2, 1, 2),
                      (2, 1, 2)]


def test_jax_checkpoint_resumes_in_port(raw_more, ops, jax_ops, jax_run,
                                        tmp_path):
    """The JAX chain's state after NB blocks, from its .npz checkpoint and
    from its leaves in memory, continues in the port as the JAX chain
    itself continues from it, and as the port's own uninterrupted stream
    does (which equals the JAX output over the first NB blocks, above)."""
    path = str(tmp_path / "carries.npz")
    JaxPipeline(jax_ops, block_in=BLOCK).checkpoint(jax_run[0], path)
    p = Pipeline(ops, block_in=BLOCK, device="cpu")
    _, whole = p.process(raw_more)
    tail = raw_more[NB * BLOCK:]
    nt = len(tail) // BLOCK
    want = np.asarray(jax.jit(lambda v, c: jax_run_time_batched(
        jax_ops, v, nt, carries=c))(tail, jax_run[0]))
    for cs in (p.restore(path),
               p.carries_from_numpy([np.asarray(leaf) for leaf in
                                     jax.tree.leaves(jax_run[0])])):
        _, y = p.process(tail, carries=cs)
        np.testing.assert_allclose(y.numpy(), want, rtol=0, atol=CHAIN_ATOL)
        np.testing.assert_allclose(y.numpy(), whole[:, NB * AUDIO:].numpy(),
                                   rtol=0, atol=CHAIN_ATOL)


def test_stereo_cli_on_cpu(raw, tmp_path):
    """--front quantized --stereo --deemphasis: a 2-channel 48 kHz WAV with
    the tones in their channels; streamed and --batched within one LSB
    (the IIR's entering state is rounded otherwise block-parallel)."""
    src = tmp_path / "capture.u8"
    raw[:4 * BLOCK].tofile(src)
    pcm = []
    for extra in ([], ["--batched", "3"]):
        out = tmp_path / f"a{len(pcm)}.wav"
        assert fm.main(["--in", str(src), "--out", str(out), "--block",
                        str(BLOCK), "--device", "cpu", "--front",
                        "quantized", "--stereo", "--deemphasis", "75e-6",
                        *extra]) == 0
        with wave.open(str(out), "rb") as wf:
            assert wf.getnchannels() == 2 and wf.getframerate() == 48_000
            frames = np.frombuffer(wf.readframes(wf.getnframes()), "<i2")
        pcm.append(frames.reshape(-1, 2).astype(np.int32))
    assert pcm[0].shape == (4 * AUDIO, 2)
    assert np.abs(pcm[0] - pcm[1]).max() <= 1
    L, R = pcm[0][4000:, 0].astype(float), pcm[0][4000:, 1].astype(float)
    assert tone(L, F_L, 48_000) > 5 * tone(R, F_L, 48_000)
    assert tone(R, F_R, 48_000) > 5 * tone(L, F_R, 48_000)
