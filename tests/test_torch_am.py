"""The port's AM receiver vs the JAX package: the shift tables, ``Mix``,
``AmDemod``, the scans (``linear_scan``, ``dc_blocker``, the AGC) and
their stream ops ``Agc`` and ``DcBlocker``, ``Map``, and ``am_chain()``
planar and complex, streamed and block-parallel, a JAX checkpoint resumed
in the port, and ``apps/am.py``.

Tolerances (abs): tables bitwise; ``Mix`` and ``AmDemod`` 1e-6; the
scans and their ops 1e-5 (the JAX package composes the maps with an
associative scan, the port in chunks and by doubling, and the DC blocker
by the blocked closed form); the chain 1e-4, the JAX package's own bound
between its two AM forms (tests/test_am_planar.py).  The JAX references
run jitted on the CPU; the JAX carries come from ``Pipeline.process``
(its ``Pipeline.run`` donates the DcBlocker's one array twice).
"""

import wave

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from sdr_tpu.apps import chains as jchains
from sdr_tpu.ops import scans as jscans
from sdr_tpu.ops import shift as jshift
from sdr_tpu.parallel.sharded import run_time_batched as jax_run_time_batched
from sdr_tpu.stream import Agc as JaxAgc
from sdr_tpu.stream import AmDemod as JaxAmDemod
from sdr_tpu.stream import DcBlocker as JaxDcBlocker
from sdr_tpu.stream import Mix as JaxMix
from sdr_tpu.stream import Pipeline as JaxPipeline

from sdr_tpu_torch.apps import am, chains
from sdr_tpu_torch.ops import scans, shift
from sdr_tpu_torch.parallel.sharded import run_time_batched, time_sharded_fn
from sdr_tpu_torch.stream import (Agc, AmDemod, DcBlocker, Map, Mix,
                                  Pipeline)
from sdr_tpu_torch.stream.pipeline import flatten_carries

ATOL = 1e-5
CHAIN_ATOL = 1e-4
BLOCK, NB = 1 << 15, 4            # u8 bytes per block, blocks


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs in several worker processes
    (pytest-xdist), where PyTorch's idle OpenMP workers spinning would
    cost the other workers the CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def am_raw(n_bytes, f_if=0.25, seed=7):
    """u8 IQ of an AM carrier at ``f_if`` cycles/sample, 40 % modulated by
    a slow tone, with noise (tests/test_am_planar.py's signal)."""
    n = n_bytes // 2
    rng = np.random.default_rng(seed)
    t = np.arange(n)
    msg = 0.5 + 0.4 * np.sin(2 * np.pi * 0.001 * t)
    iq = msg * np.exp(2j * np.pi * f_if * t) + 0.01 * (
        rng.standard_normal(n) + 1j * rng.standard_normal(n))
    raw = np.empty(2 * n, np.uint8)
    raw[0::2] = np.clip(np.round(iq.real * 100 + 128), 0, 255)
    raw[1::2] = np.clip(np.round(iq.imag * 100 + 128), 0, 255)
    return raw


def _cplx(rng, shape, scale=1.0):
    return (scale * (rng.uniform(-1, 1, shape)
                     + 1j * rng.uniform(-1, 1, shape))).astype(np.complex64)


def _planar(x):
    return np.stack([x.real, x.imag], axis=-2).astype(np.float32)


# -- tables and the stateless ops ----------------------------------------


def test_shift_tables_match_jax():
    pairs = [(shift.oscillator(1000, -0.21, 0.3, device="cpu"),
              jshift.oscillator(1000, -0.21, 0.3)),
             (shift.oscillator_planar(1000, 0.13, device="cpu"),
              jshift.oscillator_planar(1000, 0.13)),
             (shift.half_band_up(9, device="cpu"), jshift.half_band_up(9)),
             (shift.quarter_band_up(9, device="cpu"),
              jshift.quarter_band_up(9))]
    for got, want in pairs:
        assert got.numpy().dtype == np.asarray(want).dtype
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    x = torch.ones(9, dtype=torch.complex64)
    assert torch.equal(shift.mix(x, shift.quarter_band_up(9, device="cpu")),
                       shift.quarter_band_up(9, device="cpu"))


@pytest.mark.parametrize("planar", [False, True])
def test_mix_matches_jax_over_blocks(rng, planar):
    """Three blocks with the phasor carried: outputs and carries."""
    op, jop = Mix(-0.21, planar, device="cpu"), JaxMix(-0.21, planar)
    x = _cplx(rng, (2, 4096))
    if planar:
        x = _planar(x)
    c = op.init_carry(4096, x.shape[:-1])
    jc = jop.init_carry(4096, jnp.float32 if planar else jnp.complex64,
                        x.shape[:-1])
    step = jax.jit(jop.apply)
    for _ in range(3):
        c, y = op.apply(c, torch.from_numpy(x))
        jc, jy = step(jc, x)
        np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=0,
                                   atol=1e-6)
        np.testing.assert_allclose(c.numpy(), np.asarray(jc), rtol=0,
                                   atol=1e-6)
    assert len(op._tables) == 1           # the table is made once


@pytest.mark.parametrize("planar", [False, True])
def test_am_demod_and_map_match_jax(rng, planar):
    x = _cplx(rng, (2, 1024))
    if planar:
        x = _planar(x)
    op = AmDemod(planar, device="cpu")
    _, y = op.apply((), torch.from_numpy(x))
    _, jy = JaxAmDemod(planar).apply((), jnp.asarray(x))
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=0, atol=1e-6)
    assert op.out_dtype(torch.complex64) == torch.float32
    assert op.map_batch_shape((2, 2)) == ((2,) if planar else (2, 2))
    m = Map(torch.abs, dtype=torch.float32, device="cpu")
    assert m.out_dtype(torch.complex64) == torch.float32
    assert torch.equal(m.apply((), torch.from_numpy(x))[1],
                       torch.from_numpy(x).abs())


# -- scans ---------------------------------------------------------------


@pytest.mark.parametrize("n", [1, 127, 128, 5000])
def test_linear_scan_matches_jax(rng, n):
    a = rng.uniform(0.9, 1.0, (3, n)).astype(np.float32)
    b = rng.uniform(-1, 1, (3, n)).astype(np.float32)
    y0 = rng.uniform(-1, 1, 3).astype(np.float32)
    got = scans.linear_scan(torch.from_numpy(a), torch.from_numpy(b),
                            torch.from_numpy(y0))
    want = jax.jit(jscans.linear_scan)(a, b, y0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=ATOL)
    # the whole row's map, by the pairwise tree, lands on the last output
    A, B = scans.affine_reduce(torch.from_numpy(a), torch.from_numpy(b))
    np.testing.assert_allclose((A * torch.from_numpy(y0) + B).numpy(),
                               np.asarray(want)[:, -1], rtol=0, atol=ATOL)


def test_dc_blocker_and_agc_match_jax(rng):
    x = rng.uniform(-1, 1, (2, 3000)).astype(np.float32) + 0.3
    ls, lo = np.float32([0.1, -0.2]), np.float32([0.5, 0.0])
    y, (ns, no) = scans.dc_blocker(torch.from_numpy(x), torch.from_numpy(ls),
                                   torch.from_numpy(lo))
    jy, (jns, jno) = jax.jit(jscans.dc_blocker)(x, ls, lo)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=0, atol=ATOL)
    np.testing.assert_allclose(no.numpy(), np.asarray(jno), rtol=0, atol=ATOL)
    np.testing.assert_array_equal(ns.numpy(), np.asarray(jns))
    xc = _cplx(rng, (2, 3000), 0.4)
    g0 = np.float32([1.0, 2.5])
    for arg in (xc, np.abs(xc)):
        y, g = scans.agc(torch.from_numpy(arg), 0.005, 1.0,
                         torch.from_numpy(g0))
        jy, jg = jax.jit(lambda v, s: jscans.agc(v, 0.005, 1.0, s))(arg, g0)
        np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=0,
                                   atol=ATOL)
        np.testing.assert_allclose(g.numpy(), np.asarray(jg), rtol=0,
                                   atol=ATOL)
    A, B = scans.agc_affine(torch.from_numpy(xc), 0.005, 1.0)
    jA, jB = jax.jit(lambda v: jscans.agc_affine(v, 0.005, 1.0))(xc)
    np.testing.assert_allclose(A.numpy(), np.asarray(jA), rtol=1e-5)
    np.testing.assert_allclose(B.numpy(), np.asarray(jB), rtol=0, atol=ATOL)
    # the sequential form: the same recurrence, |y| from the planes
    y, g = scans.agc(torch.from_numpy(xc), 0.005, 1.0, torch.from_numpy(g0),
                     method="scan")
    jy, jg = jax.jit(lambda v, s: jscans.agc(v, 0.005, 1.0, s,
                                             method="scan"))(xc, g0)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=0, atol=ATOL)
    np.testing.assert_allclose(g.numpy(), np.asarray(jg), rtol=0, atol=ATOL)


@pytest.mark.parametrize("planar", [False, True])
def test_agc_and_dc_blocker_ops_match_jax_and_block_parallel(rng, planar):
    """Agc, AmDemod and DcBlocker over six blocks streamed, against the
    JAX ops; block-parallel (each row's gain and DC state from the affine
    prefixes) against the streamed run, and from a segment's carries."""
    n, nb = 1024, 6
    x = _cplx(rng, (nb * n,), 0.5)
    if planar:
        x = _planar(x)
    ops = [Agc(0.005, 1.0, planar=planar, device="cpu"),
           AmDemod(planar, device="cpu"), DcBlocker(device="cpu")]
    jops = [JaxAgc(0.005, 1.0, planar=planar), JaxAmDemod(planar),
            JaxDcBlocker()]
    dt = torch.float32 if planar else torch.complex64
    bs = (2,) if planar else ()
    p = Pipeline(ops, block_in=n, batch_shape=bs, in_dtype=dt, device="cpu")
    cs, seq = p.process(x)
    jp = JaxPipeline(jops, block_in=n, batch_shape=bs,
                     in_dtype=jnp.float32 if planar else jnp.complex64)
    jcs, want = jax.jit(jp.process)(x)
    np.testing.assert_allclose(seq.numpy(), np.asarray(want), rtol=0,
                               atol=ATOL)
    for got, ref in zip(flatten_carries(cs), jax.tree.leaves(jcs)):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0,
                                   atol=ATOL)
    # rows of consecutive blocks, the planes (if any) after the row axis
    xb = torch.from_numpy(x).reshape(bs + (nb, n)).movedim(-2, 0)
    par = time_sharded_fn(ops)(xb.contiguous()).reshape(-1)
    np.testing.assert_allclose(par.numpy(), seq.numpy(), rtol=0, atol=ATOL)
    cs3, _ = p.process(x[..., :3 * n])
    tail = time_sharded_fn(ops, initials=cs3)(xb[3:].contiguous())
    np.testing.assert_allclose(tail.reshape(-1).numpy(),
                               seq[3 * n:].numpy(), rtol=0, atol=ATOL)


def test_dc_blocker_carries_are_distinct_tensors():
    op = DcBlocker(device="cpu")
    a, b = op.init_carry(1024, (3,))
    assert a.untyped_storage().data_ptr() != b.untyped_storage().data_ptr()
    a += 1
    assert b.abs().max().item() == 0
    x = torch.linspace(-1, 1, 3 * 1024).reshape(3, 1024)
    (s, o), _ = op.apply((a, b), x)
    ptrs = {t.untyped_storage().data_ptr() for t in (s, o, x)}
    assert len(ptrs) == 3
    s2, o2 = op.shard_carry(x.reshape(3, 1, 1024))
    assert s2.untyped_storage().data_ptr() != o2.untyped_storage().data_ptr()


# -- the chain -----------------------------------------------------------


@pytest.fixture(scope="module")
def raw_more():
    return am_raw(BLOCK * (NB + 2))


@pytest.fixture(scope="module")
def raw(raw_more):
    return raw_more[:BLOCK * NB]


@pytest.fixture(scope="module")
def jax_streamed(raw_more):
    """Each JAX form over NB blocks and over all of ``raw_more``: (carries
    after NB blocks, output over NB blocks, output over all)."""
    out = {}
    for planar in (False, True):
        jp = JaxPipeline(jchains.am_chain(planar=planar), block_in=BLOCK)
        run = jax.jit(jp.process)
        carries, y = run(raw_more[:NB * BLOCK])
        out[planar] = (carries, np.asarray(y),
                       np.asarray(run(raw_more)[1]))
    return out


@pytest.mark.parametrize("planar", [False, True])
def test_am_chain_streamed_and_block_parallel_match_jax(raw, jax_streamed,
                                                        planar):
    ops = chains.am_chain(planar=planar, device="cpu")
    _, seq = Pipeline(ops, block_in=BLOCK, device="cpu").process(raw)
    want = jax_streamed[planar][1]
    assert seq.shape == want.shape == (NB * BLOCK // 32,)
    np.testing.assert_allclose(seq.numpy(), want, rtol=0, atol=CHAIN_ATOL)
    par = run_time_batched(ops, raw, NB, device="cpu")
    np.testing.assert_allclose(par.numpy(), want, rtol=0, atol=CHAIN_ATOL)
    np.testing.assert_allclose(par.numpy(), seq.numpy(), rtol=0,
                               atol=CHAIN_ATOL)
    assert np.isfinite(seq.numpy()).all() and seq.abs().max().item() > 0.01


def test_am_chain_block_parallel_matches_jax_block_parallel(raw):
    jax_ops = jchains.am_chain()
    want = np.asarray(jax.jit(lambda v: jax_run_time_batched(
        jax_ops, v, NB))(raw))
    got = run_time_batched(chains.am_chain(device="cpu"), raw, NB,
                           device="cpu")
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=CHAIN_ATOL)


@pytest.mark.parametrize("planar", [False, True])
def test_jax_checkpoint_resumes_in_port(raw_more, jax_streamed, planar,
                                        tmp_path):
    """The JAX chain's carries after NB blocks (the phasor, the complex or
    planar channel-filter history, the gain, the DC blocker's pair), from
    its .npz file and from its leaves, continue in the port."""
    jax_ops = jchains.am_chain(planar=planar)
    carries, _, want = jax_streamed[planar]
    path = str(tmp_path / "carries.npz")
    JaxPipeline(jax_ops, block_in=BLOCK).checkpoint(carries, path)
    p = Pipeline(chains.am_chain(planar=planar, device="cpu"),
                 block_in=BLOCK, device="cpu")
    tail = raw_more[NB * BLOCK:]
    leaves = [np.asarray(leaf) for leaf in jax.tree.leaves(carries)]
    assert any(np.iscomplexobj(leaf) for leaf in leaves) != planar
    for cs in (p.restore(path), p.carries_from_numpy(leaves)):
        _, y = p.process(tail, carries=cs)
        np.testing.assert_allclose(y.numpy(), want[NB * BLOCK // 32:],
                                   rtol=0, atol=CHAIN_ATOL)


def test_am_cli_on_cpu(tmp_path):
    """tests/test_io_apps.py's AM capture (carrier at 0.2 cycles/sample, a
    500 Hz tone): the tone at rate // decim = 80 kHz."""
    fs, n = 1_280_000, 1 << 19
    t = np.arange(n) / fs
    msg = 0.5 * (1 + 0.8 * np.sin(2 * np.pi * 500 * t))
    iq = msg * np.exp(2j * np.pi * 0.2 * np.arange(n))
    raw = np.empty(2 * n, dtype=np.uint8)
    raw[0::2] = np.clip(np.round(iq.real * 128 + 128), 0, 255)
    raw[1::2] = np.clip(np.round(iq.imag * 128 + 128), 0, 255)
    cap, out = tmp_path / "am.iq", tmp_path / "am.wav"
    raw.tofile(cap)
    assert am.main(["--in", str(cap), "--out", str(out), "--if-freq", "0.2",
                    "--decim", "16", "--block", "262144",
                    "--device", "cpu"]) == 0
    with wave.open(str(out)) as wf:
        rate = wf.getframerate()
        pcm = np.frombuffer(wf.readframes(wf.getnframes()), dtype="<i2")
    assert rate == 80_000 and len(pcm) == n // 16
    seg = pcm[10000:].astype(np.float64)
    spec = np.abs(np.fft.rfft(seg * np.hanning(len(seg))))
    tone = (np.argmax(spec[5:]) + 5) * rate / len(seg)
    assert abs(tone - 500) < 10, f"tone {tone}"


@pytest.mark.parametrize("make", [
    lambda: chains.am_chain(agc_approx=2, device="cpu"),
    lambda: Agc(0.005, 1.0, method="scan", device="cpu"),
    lambda: Agc(0.005, 1.0, approx_time_sharding=2, device="cpu")])
def test_sequential_agc_waits_for_its_slice(make, rng):
    """The sequential AGC's entry points build working ops: each one's
    ``Agc`` runs a block as the JAX op with the same options does (1e-5)
    and is time-shardable exactly when the JAX op is.  The sequential AGC
    stays complex-form only."""
    made = make()
    op = made[3] if isinstance(made, list) else made
    jop = JaxAgc(op.mu, op.reference, method=op.method,
                 approx_time_sharding=op.approx_time_sharding)
    assert op.time_shardable == jop.time_shardable
    x = _cplx(rng, (2, 2048), 0.5)
    g0 = np.float32([1.0, 1.5])
    g, y = op.apply(torch.from_numpy(g0), torch.from_numpy(x))
    jg, jy = jax.jit(jop.apply)(g0, x)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=0, atol=ATOL)
    np.testing.assert_allclose(g.numpy(), np.asarray(jg), rtol=0, atol=ATOL)
    with pytest.raises(ValueError, match="planar"):
        chains.am_chain(agc_approx=2, planar=True, device="cpu")
