"""The port's sequential AGC against the JAX package: ``agc(method='scan')``
(kernel K6's plain version on the CPU), the ``Agc`` op with
``approx_time_sharding=R``, the runners' refusal of a scan AGC without
it, and ``am_chain(agc_approx=R)`` streamed, block-parallel and resumed
from a JAX checkpoint.

Tolerances (abs): the scan 1e-5 (the port takes ``|y|`` as
``sqrt(re*re + im*im)`` on the planes, the JAX package ``jnp.abs`` of the
complex value: an ulp apart); the block-parallel sweeps against JAX's
1e-5 and against the streamed run 1e-3 (the JAX package's own bound for
the approximation, tests/test_parallel.py); the chain 1e-4, the AM bound.
The JAX references run jitted on the CPU (eager scans compile for
minutes).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from sdr_tpu.apps import chains as jchains
from sdr_tpu.ops import scans as jscans
from sdr_tpu.parallel.sharded import run_time_batched as jax_run_time_batched
from sdr_tpu.stream import Agc as JaxAgc
from sdr_tpu.stream import Pipeline as JaxPipeline

from sdr_tpu_torch.apps import chains
from sdr_tpu_torch.kernels import agc as k6
from sdr_tpu_torch.ops import scans
from sdr_tpu_torch.parallel.sharded import run_time_batched, time_sharded_fn
from sdr_tpu_torch.stream import Agc, Pipeline

ATOL = 1e-5
SWEEP_ATOL = 1e-3
CHAIN_ATOL = 1e-4
BLOCK, NB = 1 << 18, 4            # u8 bytes per block: 8,192 samples
                                  # after the decimator, 16 AGC time
                                  # constants (mu*|x| ~ 0.002)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs in several worker processes
    (pytest-xdist), where PyTorch's idle OpenMP workers spinning would
    cost the other workers the CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _carrier(rng, shape, level=2.0, spread=0.2):
    """Complex samples of magnitude ``level`` +- ``spread`` at random
    phases (tests/test_parallel.py's AGC input)."""
    return ((level + spread * rng.normal(size=shape))
            * np.exp(2j * np.pi * rng.uniform(size=shape))).astype(
                np.complex64)


def _jax_scan(x, mu, ref, g0):
    return jax.jit(lambda v, s: jscans.agc(v, mu, ref, s, method="scan"))(
        x, g0)


@pytest.mark.parametrize("form", ["complex", "real"])
def test_agc_scan_matches_jax(rng, form):
    x = _carrier(rng, (3, 3000), 1.5, 0.3)
    if form == "real":
        x = (x.real * 2).astype(np.float32)
    g0 = np.float32([1.0, 2.0, 0.5])
    y, g = scans.agc(torch.from_numpy(x), 0.005, 1.0, torch.from_numpy(g0),
                     method="scan")
    jy, jg = _jax_scan(x, 0.005, 1.0, g0)
    assert y.dtype == (torch.complex64 if form == "complex"
                       else torch.float32)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=0, atol=ATOL)
    np.testing.assert_allclose(g.numpy(), np.asarray(jg), rtol=0, atol=ATOL)
    # a number as the entering gain, and only the final gain
    _, g1 = scans.agc(torch.from_numpy(x), 0.005, 1.0, 2.0, method="scan",
                      store=False)
    _, jg1 = _jax_scan(x, 0.005, 1.0, np.float32(2.0))
    np.testing.assert_allclose(g1.numpy(), np.asarray(jg1), rtol=0,
                               atol=ATOL)


def test_agc_scan_where_the_linear_form_fails(rng):
    """``mu*|x| = 2``: the gain turns negative and the linear form (which
    assumes ``|x*g| = |x|*g``) parts from the recurrence; the port's scan
    still equals JAX's.  A short block keeps the growing gain finite; the
    values reach ~1e6, so the bound is relative there (1e-5)."""
    x = (4.0 * np.exp(2j * np.pi * rng.uniform(size=(2, 12)))).astype(
        np.complex64)
    y, g = scans.agc(torch.from_numpy(x), 0.5, 1.0, 1.0, method="scan")
    jy, jg = jax.jit(lambda v: jscans.agc(v, 0.5, 1.0, 1.0,
                                          method="scan"))(x)
    ly, _ = jax.jit(lambda v: jscans.agc(v, 0.5, 1.0, 1.0))(x)
    assert np.isfinite(y.numpy()).all() and (g.numpy() < 0).all()
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=ATOL,
                               atol=ATOL)
    np.testing.assert_allclose(g.numpy(), np.asarray(jg), rtol=ATOL)
    assert np.abs(np.asarray(ly) - np.asarray(jy)).max() > 1.0
    lin, _ = scans.agc(torch.from_numpy(x), 0.5, 1.0, 1.0)
    np.testing.assert_allclose(lin.numpy(), np.asarray(ly), rtol=ATOL,
                               atol=ATOL)


def test_k6_plain_version_is_the_ieee_recurrence(rng):
    """The plain version is the step in f32 with every operation rounded
    once (numpy's f32 scalars), the square root included: the order the
    kernel keeps."""
    x = _carrier(rng, (2, 700), 0.2, 0.1)
    g0 = np.float32([1.0, 3.0])
    y, g = k6.agc_scan_reference(torch.from_numpy(x), 0.005, 1.0,
                                 torch.from_numpy(g0))
    f = np.float32
    for r in range(2):
        gg, mu, ref = g0[r], f(0.005), f(1.0)
        want = np.empty(x.shape[-1], np.complex64)
        for i, v in enumerate(x[r]):
            cr, ci = f(v.real * gg), f(v.imag * gg)
            m = np.sqrt(f(f(cr * cr) + f(ci * ci)))
            want[i] = cr + 1j * ci
            gg = f(gg + f(mu * f(ref - m)))
        np.testing.assert_array_equal(y[r].numpy(), want)
        assert g[r].item() == gg
    with pytest.raises(ValueError, match="leading dims"):
        k6.agc_scan(torch.from_numpy(x), 0.005, 1.0, torch.ones(3))
    with pytest.raises(ValueError, match="complex64 or float32"):
        k6.agc_scan(torch.ones(2, 4, dtype=torch.float64), 0.005, 1.0,
                    torch.ones(2))


def test_approx_time_sharding_matches_jax_and_the_stream(rng):
    """tests/test_parallel.py's case: 8 blocks of 8,192, R = 2 sweeps."""
    n, B = 65536, 8
    x = _carrier(rng, (n,))
    op = Agc(0.005, 1.0, method="scan", approx_time_sharding=2,
             device="cpu")
    assert op.time_shardable
    got = run_time_batched([op], x, B, device="cpu")
    want = jax.jit(lambda v: jax_run_time_batched(
        [JaxAgc(0.005, 1.0, method="scan", approx_time_sharding=2)], v,
        B))(x)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=ATOL)
    _, seq = Pipeline([Agc(0.005, 1.0, method="scan", device="cpu")],
                      block_in=n // B, in_dtype=torch.complex64,
                      device="cpu").process(x)
    np.testing.assert_allclose(got.numpy(), seq.numpy(), rtol=0,
                               atol=SWEEP_ATOL)
    # row 0 starts from the stream's gain: its block equals the stream's
    np.testing.assert_array_equal(got[:n // B].numpy(), seq[:n // B].numpy())


def test_approx_time_sharding_continues_a_segment(rng):
    """A segment's carries enter the next segment's row 0 (and its first
    sweep), as in the JAX package."""
    n, B = 4 * 2048, 4
    x = _carrier(rng, (2 * n,))
    op = Agc(0.005, 1.0, method="scan", approx_time_sharding=1,
             device="cpu")
    cs, first = run_time_batched([op], x[:n], B, return_carries=True,
                                 device="cpu")
    second = run_time_batched([op], x[n:], B, carries=cs, device="cpu")
    _, whole = Pipeline([op], block_in=n // B, in_dtype=torch.complex64,
                        device="cpu").process(x, parallel_blocks=B)
    np.testing.assert_array_equal(torch.cat([first, second]).numpy(),
                                  whole.numpy())
    jfn = jax.jit(lambda v, c: jax_run_time_batched(
        [JaxAgc(0.005, 1.0, method="scan", approx_time_sharding=1)], v, B,
        carries=[c]))
    np.testing.assert_allclose(second.numpy(),
                               np.asarray(jfn(x[n:], cs[0].numpy())),
                               rtol=0, atol=ATOL)


def test_scan_agc_without_the_opt_in_is_refused():
    """As the JAX package refuses it (tests/test_parallel.py): a
    ``ValueError`` naming ``approx_time_sharding`` before anything runs,
    from every runner."""
    x = (np.ones(8192) + 0j).astype(np.complex64)
    op = Agc(0.01, 1.0, method="scan", device="cpu")
    assert not op.time_shardable
    with pytest.raises(ValueError, match="approx_time_sharding"):
        run_time_batched([op], x, 8, device="cpu")
    with pytest.raises(ValueError, match="approx_time_sharding"):
        Pipeline([op], block_in=1024, in_dtype=torch.complex64,
                 device="cpu").process(x, parallel_blocks=8)
    with pytest.raises(ValueError, match="approx_time_sharding"):
        time_sharded_fn([op])
    with pytest.raises(NotImplementedError, match="approx_time_sharding"):
        op.shard_carry(torch.from_numpy(x).reshape(8, 1024))
    with pytest.raises(ValueError, match="approx_time_sharding must be"):
        Agc(0.01, 1.0, method="scan", approx_time_sharding=0, device="cpu")
    with pytest.raises(ValueError, match="linear method"):
        Agc(0.01, 1.0, method="scan", planar=True, device="cpu")


# -- am_chain(agc_approx=R) ----------------------------------------------


def am_raw(n_bytes, f_if=0.25, seed=11):
    """u8 IQ of an AM carrier at ``f_if`` cycles/sample, 40 % modulated by
    a slow tone, with noise (tests/test_torch_am.py's signal)."""
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


@pytest.fixture(scope="module")
def raw_more():
    return am_raw(BLOCK * (NB + 2))


@pytest.fixture(scope="module")
def jax_approx(raw_more):
    """The JAX ``am_chain(agc_approx=1)`` streamed over NB blocks and over
    all of ``raw_more``, and block-parallel over NB blocks."""
    jp = JaxPipeline(jchains.am_chain(agc_approx=1), block_in=BLOCK)
    run = jax.jit(jp.process)
    carries, y = run(raw_more[:NB * BLOCK])
    par = jax.jit(lambda v: jax_run_time_batched(
        jchains.am_chain(agc_approx=1), v, NB))(raw_more[:NB * BLOCK])
    return carries, np.asarray(y), np.asarray(run(raw_more)[1]), \
        np.asarray(par)


def test_am_chain_agc_approx_matches_jax(raw_more, jax_approx):
    raw = raw_more[:NB * BLOCK]
    _, want, _, want_par = jax_approx
    ops = chains.am_chain(agc_approx=1, device="cpu")
    assert isinstance(ops[3], Agc) and ops[3].method == "scan"
    assert ops[3].approx_time_sharding == 1 and not ops[0].planar
    _, seq = Pipeline(ops, block_in=BLOCK, device="cpu").process(raw)
    assert seq.shape == want.shape == (NB * BLOCK // 32,)
    assert np.isfinite(seq.numpy()).all() and seq.abs().max().item() > 0.01
    np.testing.assert_allclose(seq.numpy(), want, rtol=0, atol=CHAIN_ATOL)
    par = run_time_batched(ops, raw, NB, device="cpu")
    np.testing.assert_allclose(par.numpy(), want_par, rtol=0,
                               atol=CHAIN_ATOL)
    np.testing.assert_allclose(par.numpy(), seq.numpy(), rtol=0,
                               atol=SWEEP_ATOL)
    # against the linear complex chain: the synthetic keeps mu*|x| < 1
    _, lin = Pipeline(chains.am_chain(planar=False, device="cpu"),
                      block_in=BLOCK, device="cpu").process(raw)
    np.testing.assert_allclose(seq.numpy(), lin.numpy(), rtol=0,
                               atol=CHAIN_ATOL)


def test_am_chain_agc_approx_resumes_a_jax_checkpoint(raw_more, jax_approx,
                                                      tmp_path):
    """The JAX chain's carries after NB blocks (the phasor, the complex
    channel-filter history, the gain, the DC blocker's pair) continue in
    the port, from the .npz file and from the leaves."""
    carries, _, want, _ = jax_approx
    path = str(tmp_path / "carries.npz")
    JaxPipeline(jchains.am_chain(agc_approx=1),
                block_in=BLOCK).checkpoint(carries, path)
    p = Pipeline(chains.am_chain(agc_approx=1, device="cpu"),
                 block_in=BLOCK, device="cpu")
    leaves = [np.asarray(leaf) for leaf in jax.tree.leaves(carries)]
    tail = raw_more[NB * BLOCK:]
    for cs in (p.restore(path), p.carries_from_numpy(leaves)):
        _, y = p.process(tail, carries=cs)
        np.testing.assert_allclose(y.numpy(), want[NB * BLOCK // 32:],
                                   rtol=0, atol=CHAIN_ATOL)
