"""The port's exact f32 front vs the JAX package: the conversions, the
``Fir`` stream op (filter, decimator, resampler; real, planar, complex;
``symmetric=``) with its seam split, the complex FM demod, the stream
protocol's dtypes, and ``fm_chain(front='exact')`` streamed,
block-parallel, with ``fuse_back=False`` and with the FIR de-emphasis,
a JAX checkpoint resumed in the port, and ``apps/fm.py --front exact``.

Tolerances (abs): conversions 1e-6 (they are exact); ``Fir`` 1e-5 (f32
sums in other orders than XLA's); the complex demod 2e-6 rad; the chains
1e-5.  The seam split is bitwise equal to the unsplit ``cat`` form.  The
JAX references run jitted on the CPU, as tier-1 runs them.
"""

import wave

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from sdr_tpu.apps import chains as jchains
from sdr_tpu.ops import convert as jconvert
from sdr_tpu.ops import demod as jdemod
from sdr_tpu.ops import design as jdesign
from sdr_tpu.parallel.sharded import run_time_batched as jax_run_time_batched
from sdr_tpu.stream import Fir as JaxFir
from sdr_tpu.stream import IqConvertI16 as JaxIqConvertI16
from sdr_tpu.stream import IqConvertU8 as JaxIqConvertU8
from sdr_tpu.stream import Pipeline as JaxPipeline

from sdr_tpu_torch.apps import chains, fm
from sdr_tpu_torch.ops import convert, demod, design
from sdr_tpu_torch.ops.fir import fir_decimate
from sdr_tpu_torch.parallel.sharded import run_time_batched
from sdr_tpu_torch.stream import (Fir, FmDemod, IqConvertI16, IqConvertU8,
                                  Pipeline)

ATOL = 1e-5
BLOCK, NB = 163_840, 4            # u8 bytes per block, blocks
AUDIO = BLOCK // 160 * 3          # audio samples per block (48 kS/s)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs in several worker processes
    (pytest-xdist), where PyTorch's idle OpenMP workers spinning would
    cost the other workers the CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def broadcast(n_bytes, seed=3):
    """u8 IQ of an FM broadcast of a 1 kHz tone at 75 kHz deviation,
    1.28 MS/s, with a little noise."""
    fs, n = 1_280_000, n_bytes // 2
    t = np.arange(n) / fs
    audio = np.sin(2 * np.pi * 1000 * t)
    noise = np.random.default_rng(seed).normal(0, 0.01, (2, n))
    iq = 0.9 * np.exp(1j * (2 * np.pi * 75e3 * np.cumsum(audio) / fs))
    raw = np.empty(2 * n, np.uint8)
    raw[0::2] = np.clip(np.round((iq.real + noise[0]) * 128 + 128), 0, 255)
    raw[1::2] = np.clip(np.round((iq.imag + noise[1]) * 128 + 128), 0, 255)
    return raw


def tone_hz(y, rate=48_000):
    seg = np.asarray(y, dtype=np.float64)[2000:]
    return np.argmax(np.abs(np.fft.rfft(seg))) * rate / len(seg)


# -- conversions ---------------------------------------------------------


def _u8(rng):
    return rng.integers(0, 256, (3, 2048)).astype(np.uint8)


def _i16(rng):
    return rng.integers(-2048, 2048, (3, 2048)).astype(np.int16)


@pytest.mark.parametrize("name,make", [
    ("iq_u8_to_cfloat", _u8), ("iq_u8_to_planar", _u8),
    ("iq_i16_to_cfloat", _i16), ("iq_i16_to_planar", _i16)])
def test_conversions_match_jax(rng, name, make):
    x = make(rng)
    got = getattr(convert, name)(torch.from_numpy(x)).numpy()
    want = np.asarray(jax.jit(getattr(jconvert, name))(x))
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_transmit_conversion_scale_and_cplx_map_match_jax(rng):
    x = ((rng.uniform(-1.2, 1.2, 4096) + 1j * rng.uniform(-1.2, 1.2, 4096))
         .astype(np.complex64))
    x[:4] = [0.5 / 2048, 1.5 / 2048, -0.5 / 2048, 1j * 2.5 / 2048]  # ties
    got = convert.cfloat_to_iq_i16(torch.from_numpy(x)).numpy()
    want = np.asarray(jconvert.cfloat_to_iq_i16(jnp.asarray(x)))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_allclose(
        convert.scale(0.3, torch.from_numpy(x)).numpy(),
        np.asarray(jconvert.scale(0.3, jnp.asarray(x))), rtol=0, atol=1e-6)
    np.testing.assert_allclose(
        convert.cplx_map(lambda v: v * v, torch.from_numpy(x)).numpy(),
        np.asarray(jconvert.cplx_map(lambda v: v * v, jnp.asarray(x))),
        rtol=0, atol=1e-6)


@pytest.mark.parametrize("planar", [False, True])
def test_iq_convert_ops_match_jax(rng, planar):
    for op, jop, x in ((IqConvertU8(planar, device="cpu"),
                        JaxIqConvertU8(planar), _u8(rng)),
                       (IqConvertI16(planar, device="cpu"),
                        JaxIqConvertI16(planar), _i16(rng))):
        _, got = op.apply((), torch.from_numpy(x))
        _, want = jop.apply((), jnp.asarray(x))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=1e-6)
        assert op.out_dtype(None) == (torch.float32 if planar
                                      else torch.complex64)
        assert op.map_batch_shape((3,)) == ((3, 2) if planar else (3,))


# -- the Fir stream op ---------------------------------------------------


FIR_CASES = {     # kind: the constructor's kwargs, from a tap maker
    "filter": lambda t: dict(taps=t(64)),
    "filter_symmetric": lambda t: dict(taps=t(20), symmetric=True),
    "decimator": lambda t: dict(taps=t(51), factor=8),
    "decimator_symmetric": lambda t: dict(taps=t(25), factor=5,
                                          symmetric=True),
    "resampler": lambda t: dict(taps=t(31), interpolation=3, decimation=10),
}


def _fir_pair(kind, rng):
    """The port's op and the JAX package's, with the same random taps."""
    def t(k):
        return rng.uniform(-0.5, 0.5, k).astype(np.float32)
    kw = FIR_CASES[kind](t)
    make = kind.split("_")[0]
    return (getattr(Fir, make)(**kw, device="cpu"),
            getattr(JaxFir, make)(**kw))


@pytest.mark.parametrize("form", ["real", "planar", "complex"])
@pytest.mark.parametrize("kind", sorted(FIR_CASES))
def test_fir_streamed_matches_jax(rng, kind, form):
    """Four blocks through the op with its carry, against the JAX op in
    the JAX pipeline; ``planar`` runs the two planes as a batch."""
    op, jop = _fir_pair(kind, rng)
    n, nb = 2000, 4
    shape = {"real": (3,), "planar": (3, 2), "complex": (3,)}[form]
    x = rng.uniform(-1, 1, shape + (n * nb,)).astype(np.float32)
    if form == "complex":
        x = (x + 1j * rng.uniform(-1, 1, x.shape)).astype(np.complex64)
    dt = torch.complex64 if form == "complex" else torch.float32
    jdt = jnp.complex64 if form == "complex" else jnp.float32
    p = Pipeline([op], block_in=n, batch_shape=shape, in_dtype=dt,
                 device="cpu")
    cs = p.init()
    assert cs[0].dtype == dt
    cs, got = p.process(x)
    jp = JaxPipeline([jop], block_in=n, in_dtype=jdt, batch_shape=shape)
    jcs, want = jax.jit(jp.process)(x)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=ATOL)
    np.testing.assert_allclose(cs[0].numpy(), np.asarray(jcs[0]), rtol=0,
                               atol=0)
    assert op.hist_len(n) == jop.hist_len(n)


@pytest.mark.parametrize("kind", ["filter", "decimator",
                                  "decimator_symmetric"])
def test_fir_seam_split_equals_cat_form(rng, kind):
    """The split's outputs are bitwise the unsplit cat(hist, x) form's, for
    real and complex blocks, with a history from the previous block."""
    op, _ = _fir_pair(kind, rng)
    n = 4000
    for x in (rng.uniform(-1, 1, (2, 2, n)).astype(np.float32),
              (rng.uniform(-1, 1, (3, n)) + 1j * rng.uniform(-1, 1, (3, n)))
              .astype(np.complex64)):
        x = torch.from_numpy(x)
        H = op.hist_len(n)
        hist = torch.from_numpy(rng.uniform(-1, 1, x.shape[:-1] + (H,))
                                .astype(np.float32)).to(x.dtype)
        assert op._seam_plan(H, n, op.out_len(n)) is not None
        new, y = op.apply(hist, x)
        want = fir_decimate(op._taps, op.spec.decimation,
                            torch.cat([hist, x], dim=-1), op.out_len(n))
        assert torch.equal(y, want)
        assert torch.equal(new, x[..., n - H:])
        assert (new.untyped_storage().data_ptr()
                != x.untyped_storage().data_ptr())


def test_fir_block_parallel_matches_streamed(rng):
    """shard_carry's halos give each row its stream history: equal to the
    streamed run, real and complex."""
    for kind in ("decimator", "resampler"):
        op, _ = _fir_pair(kind, rng)
        x = (rng.uniform(-1, 1, 8000) + 1j * rng.uniform(-1, 1, 8000)
             ).astype(np.complex64)
        _, want = Pipeline([op], block_in=2000, in_dtype=torch.complex64,
                           device="cpu").process(x)
        got = run_time_batched([op], x, 4, device="cpu")
        assert torch.equal(got, want)


# -- demod and the stream protocol's dtypes ------------------------------


def test_complex_fm_demod_matches_jax(rng):
    x = (rng.uniform(-1, 1, (2, 4096)) + 1j * rng.uniform(-1, 1, (2, 4096))
         ).astype(np.complex64)
    last = (rng.uniform(-1, 1, 2) + 1j * rng.uniform(-1, 1, 2)
            ).astype(np.complex64)
    y, new = demod.fm_demod(torch.from_numpy(x), torch.from_numpy(last))
    jy, jnew = jax.jit(jdemod.fm_demod)(x, last)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=0, atol=2e-6)
    np.testing.assert_array_equal(new.numpy(), np.asarray(jnew))
    # warmup: the angle of x[0] * conj(0), signed zeros and all
    x[:, 0] = [-0.3 - 0.2j, 0.3 + 0.2j]
    y0, _ = demod.fm_demod(torch.from_numpy(x))
    jy0, _ = jax.jit(jdemod.fm_demod)(x)
    np.testing.assert_allclose(y0.numpy(), np.asarray(jy0), rtol=0,
                               atol=2e-6)
    op = FmDemod(device="cpu")
    c = op.init_carry(4096, (2,))
    assert c.dtype == torch.complex64 and c.shape == (2,)
    with pytest.raises(ValueError, match="planar"):
        FmDemod(atan2="poly", device="cpu")


def test_carries_from_numpy_keeps_complex_leaves(rng):
    ops = chains.fm_chain(front="exact", device="cpu")
    p = Pipeline(ops, block_in=BLOCK, device="cpu")
    from sdr_tpu_torch.stream.pipeline import flatten_carries
    leaves = [t.numpy() for t in flatten_carries(p.init())]
    assert [leaf.dtype for leaf in leaves] == [np.complex64, np.complex64,
                                               np.float32]
    leaves[0] = (rng.uniform(-1, 1, leaves[0].shape)
                 + 1j * rng.uniform(-1, 1, leaves[0].shape)).astype(
                     np.complex64)
    cs = p.carries_from_numpy(leaves)
    np.testing.assert_array_equal(cs[1].numpy(), leaves[0])
    leaves[2] = leaves[2].astype(np.complex64)
    with pytest.raises(ValueError, match="complex"):
        p.carries_from_numpy(leaves)


# -- the chain -----------------------------------------------------------


@pytest.fixture(scope="module")
def raw_more():
    return broadcast(BLOCK * (NB + 2))


@pytest.fixture(scope="module")
def raw(raw_more):
    return raw_more[:BLOCK * NB]


def _jax_streamed(jax_ops, x):
    jp = JaxPipeline(jax_ops, block_in=BLOCK)
    carries, y = jax.jit(jp.process)(x)
    return carries, np.asarray(y)


CHAINS = {     # name: (the port's kwargs, the JAX chain's kwargs)
    "complex": (dict(front="exact"), dict(front="exact", fuse_back=True)),
    "planar": (dict(front="exact", planar=True),
               dict(front="exact", planar=True, fuse_back=True)),
    "unfused": (dict(front="exact", fuse_back=False), dict(front="exact")),
    "deemphasis_fir": (dict(front="exact", fuse_back=False,
                            deemphasis=75e-6, deemphasis_mode="fir"),
                       dict(front="exact", deemphasis=75e-6,
                            deemphasis_mode="fir")),
}


@pytest.fixture(scope="module")
def jax_streamed(raw):
    return {name: _jax_streamed(jchains.fm_chain(**jkw), raw)
            for name, (_, jkw) in CHAINS.items()}


@pytest.mark.parametrize("name", sorted(CHAINS))
def test_exact_chain_streamed_and_block_parallel_match_jax(raw, jax_streamed,
                                                           name):
    ops = chains.fm_chain(device="cpu", **CHAINS[name][0])
    _, seq = Pipeline(ops, block_in=BLOCK, device="cpu").process(raw)
    want = jax_streamed[name][1]
    assert seq.shape == want.shape == (NB * AUDIO,)
    np.testing.assert_allclose(seq.numpy(), want, rtol=0, atol=ATOL)
    par = run_time_batched(ops, raw, NB, device="cpu")
    np.testing.assert_allclose(par.numpy(), want, rtol=0, atol=ATOL)
    np.testing.assert_allclose(par.numpy(), seq.numpy(), rtol=0, atol=1e-6)
    assert abs(tone_hz(seq.numpy()) - 1000) < 5


def test_exact_chain_block_parallel_matches_jax_block_parallel(raw):
    jax_ops = jchains.fm_chain(front="exact")
    want = np.asarray(jax.jit(lambda v: jax_run_time_batched(
        jax_ops, v, NB))(raw))
    got = run_time_batched(chains.fm_chain(front="exact", fuse_back=False,
                                           device="cpu"), raw, NB,
                           device="cpu")
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL)


@pytest.mark.parametrize("name", ["complex", "unfused"])
def test_jax_checkpoint_resumes_in_port(raw_more, jax_streamed, name,
                                        tmp_path):
    """The JAX chain's state after NB blocks (complex histories and demod
    sample), from its .npz file and from its leaves, continues in the port
    as the port's own uninterrupted stream does."""
    jax_ops = jchains.fm_chain(**CHAINS[name][1])
    carries, _ = _jax_streamed(jax_ops, raw_more[:NB * BLOCK])
    path = str(tmp_path / "carries.npz")
    JaxPipeline(jax_ops, block_in=BLOCK).checkpoint(carries, path)
    p = Pipeline(chains.fm_chain(device="cpu", **CHAINS[name][0]),
                 block_in=BLOCK, device="cpu")
    _, whole = p.process(raw_more)
    tail = raw_more[NB * BLOCK:]
    _, want = _jax_streamed(jax_ops, raw_more)
    leaves = [np.asarray(leaf) for leaf in jax.tree.leaves(carries)]
    assert any(np.iscomplexobj(leaf) for leaf in leaves)
    for cs in (p.restore(path), p.carries_from_numpy(leaves)):
        _, y = p.process(tail, carries=cs)
        np.testing.assert_allclose(y.numpy(), want[NB * AUDIO:], rtol=0,
                                   atol=ATOL)
        np.testing.assert_allclose(y.numpy(), whole[NB * AUDIO:].numpy(),
                                   rtol=0, atol=1e-6)


def test_exact_front_cli_on_cpu(raw, tmp_path):
    """--front exact --rate: the 1 kHz tone at 48 kHz, streamed ==
    --batched."""
    src = tmp_path / "capture.u8"
    raw.tofile(src)
    outs = []
    for extra in ([], ["--batched", "2"]):
        out = tmp_path / f"a{len(outs)}.wav"
        assert fm.main(["--in", str(src), "--out", str(out), "--block",
                        str(BLOCK), "--rate", "1280K", "--device", "cpu",
                        "--front", "exact", *extra]) == 0
        with wave.open(str(out), "rb") as wf:
            assert wf.getframerate() == 48_000
            outs.append(np.frombuffer(wf.readframes(wf.getnframes()), "<i2"))
    assert len(outs[0]) == NB * AUDIO
    np.testing.assert_array_equal(outs[0], outs[1])
    assert abs(tone_hz(outs[0]) - 1000) < 5


def test_fm_taps_fall_back_on_any_design_error(monkeypatch):
    """D1: a remez that raises ValueError gives the JAX package's windowed
    sinc fallback, bit for bit."""
    def fail(*a, **k):
        raise ValueError("remez did not converge")
    monkeypatch.setattr(design, "remez", fail)
    monkeypatch.setattr(jdesign, "remez", fail)
    got, want = chains.fm_taps(), jchains.fm_taps()
    for a, b in zip(got, want):
        assert a.dtype == b.dtype == np.float32
        np.testing.assert_array_equal(a.view(np.uint32), b.view(np.uint32))
    assert len(got[0]) == 51 and len(got[2]) == 64
