"""K8's complex form (the complex ``Mix``) on the CPU.

* ``mix_complex_reference`` (explicit real operations over
  ``view_as_real``) equals the complex ``Mix``'s former arithmetic, ``x *
  lo * carry``, within an ulp-scale bound (PyTorch's CPU complex multiply
  is vectorised in another order), and the JAX complex ``Mix`` within
  1e-6 of each row's peak |y|, streamed over three blocks with the phasor
  carried and block-parallel.
* ``csrc/mix.cu`` compiled for the host with ``g++`` under
  ``tests/torch_host_shim.py`` and run block by block through
  ``launch_mix_complex``: bitwise the plain version at ragged ends (n not
  a multiple of 4), rows and a table off 16-byte alignment, leading dims
  [B] and [B, C], and 1 sample.
* ``am_chain(agc_approx=1)`` (the complex ``Mix`` on K8's complex form,
  once a block) on the CPU against the JAX chain at its existing limit
  (1e-4), streamed and block-parallel.
"""

import ctypes

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import torch_host_shim as host_shim

from sdr_tpu.apps import chains as jchains
from sdr_tpu.parallel.sharded import run_time_batched as jax_run_time_batched
from sdr_tpu.stream import Mix as JaxMix
from sdr_tpu.stream import Pipeline as JaxPipeline

from sdr_tpu_torch.apps import chains
from sdr_tpu_torch.kernels import mix
from sdr_tpu_torch.parallel.sharded import run_time_batched
from sdr_tpu_torch.stream import Mix, Pipeline

PEAK_REL = 1e-6
CHAIN_ATOL = 1e-4
BLOCK, NB = 1 << 16, 2            # u8 bytes a block: 32,768 samples


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs in several worker processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _complex(rng, shape):
    return torch.from_numpy((rng.normal(size=shape)
                             + 1j * rng.normal(size=shape)).astype(
        np.complex64))


def _phasors(rng, shape):
    ang = rng.uniform(0, 2 * np.pi, shape)
    return torch.from_numpy(np.exp(1j * ang).astype(np.complex64))


def _bits(t):
    return torch.view_as_real(t.contiguous()).view(torch.int32)


def _peak_rel(y, ref):
    """max |y - ref| over each row's peak |ref|."""
    y, ref = np.asarray(y), np.asarray(ref)
    peak = np.abs(ref).max(axis=-1, keepdims=True)
    return float((np.abs(y - ref) / peak).max())


# -- the plain version -----------------------------------------------------


@pytest.mark.parametrize("lead", [(1,), (3,), (2, 3)])
@pytest.mark.parametrize("n", [1, 7, 4_099])
def test_plain_version_is_the_former_product(rng, lead, n):
    lo, carry, x = _phasors(rng, n), _phasors(rng, lead), _complex(rng,
                                                                   lead + (n,))
    got = mix.mix_complex(lo, carry, x)
    assert got.dtype == torch.complex64 and got.shape == x.shape
    assert torch.equal(_bits(got), _bits(mix.mix_complex_reference(
        lo, carry, x)))
    former = x * lo * carry[..., None]
    assert _peak_rel(got, former) <= 4 * np.finfo(np.float32).eps


@pytest.mark.parametrize("lead", [(2,), (2, 3)])
@pytest.mark.parametrize("freq", [-0.21, 0.25])
def test_complex_mix_matches_jax_over_blocks(rng, lead, freq):
    """Three blocks with the phasor carried: outputs within 1e-6 of each
    row's peak, carries within 1e-6, of the JAX op's."""
    n = 4_099
    op, jop = Mix(freq, device="cpu"), JaxMix(freq)
    c = op.init_carry(n, lead)
    jc = jop.init_carry(n, jnp.complex64, lead)
    step = jax.jit(jop.apply)
    for _ in range(3):
        x = _complex(rng, lead + (n,))
        c, y = op.apply(c, x)
        jc, jy = step(jc, x.numpy())
        assert _peak_rel(y.numpy(), jy) <= PEAK_REL
        np.testing.assert_allclose(c.numpy(), np.asarray(jc), rtol=0,
                                   atol=1e-6)


def test_complex_mix_block_parallel_matches_jax(rng):
    n, nb = 4_096, 4
    x = _complex(rng, (3, nb * n))
    jop = JaxMix(0.13)
    want = jax.jit(lambda v: jax_run_time_batched([jop], v, nb))(x.numpy())
    got = run_time_batched([Mix(0.13, device="cpu")], x, nb, device="cpu")
    assert got.shape == want.shape
    assert _peak_rel(got.numpy(), want) <= PEAK_REL


def test_complex_mix_reaches_k8_once_a_block(rng, monkeypatch):
    from sdr_tpu_torch.stream import ops
    calls = []
    real = ops.mix_complex

    def counted(*a):
        calls.append(a[2].shape)
        return real(*a)
    monkeypatch.setattr(ops, "mix_complex", counted)
    op = Mix(0.25, device="cpu")
    x = _complex(rng, (4, 1_000))
    op.apply(op.shard_carry(x), x)
    op.apply(op.init_carry(1_000, (4,)), x)
    assert calls == [(4, 1_000)] * 2


# -- the source on the host ------------------------------------------------


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    lib = host_shim.build_source(tmp_path_factory.mktemp("mix_complex"),
                                 "mix")
    for fn, types in mix.KERNEL.functions.items():
        getattr(lib, fn).argtypes = [*types, ctypes.c_void_p]
    return lib


def host_mix_complex(lib, lo, carry, x):
    y = torch.full_like(x, complex(np.nan, np.nan))
    rows = int(np.prod(x.shape[:-1], dtype=np.int64))
    assert lib.launch_mix_complex(lo.data_ptr(), carry.data_ptr(),
                                  x.data_ptr(), y.data_ptr(), rows,
                                  x.shape[-1], None) == 0
    return y


def _offset_c(t, off):
    """``t`` (complex64) starting ``off`` complex samples past a 16-byte
    boundary."""
    return torch.view_as_complex(host_shim.offset(torch.view_as_real(t),
                                                  2 * off))


@pytest.mark.parametrize("n", [1, 6, 1_027, 4_096, 4_099])
@pytest.mark.parametrize("lead", [(3,), (2, 3)])
@pytest.mark.parametrize("off", [0, 1])
def test_source_on_the_host_equals_plain_bitwise(lib, rng, n, lead, off):
    lo = _offset_c(_phasors(rng, n), off)
    carry = _phasors(rng, lead)
    x = _offset_c(_complex(rng, lead + (n,)), off)
    y = host_mix_complex(lib, lo, carry, x)
    assert torch.equal(_bits(y), _bits(mix.mix_complex_reference(lo, carry,
                                                                 x)))


# -- the wrappers' refusals ----------------------------------------------


def _args(**change):
    a = dict(lo=torch.ones(100, dtype=torch.complex64),
             carry=torch.ones(2, dtype=torch.complex64),
             x=torch.ones((2, 100), dtype=torch.complex64))
    a.update(change)
    return a


@pytest.mark.parametrize("args,match", [
    (_args(lo=torch.ones(100, dtype=torch.complex128)), "complex64"),
    (_args(x=torch.ones((2, 2, 100))), "complex64"),
    (_args(x=torch.ones((2, 200), dtype=torch.complex64)[:, ::2]),
     "contiguous"),
    (_args(lo=torch.ones(99, dtype=torch.complex64)), r"\[100\]"),
    (_args(carry=torch.ones(3, dtype=torch.complex64)), "leading dims"),
])
def test_wrapper_refuses(args, match):
    with pytest.raises(ValueError, match=match):
        mix.mix_complex(**args)


def test_wrapper_refuses_a_meta_device():
    with pytest.raises(ValueError, match="unsupported device"):
        mix.mix_complex(**{k: v.to("meta") for k, v in _args().items()})


# -- am_chain(agc_approx=1) ------------------------------------------------


def am_raw(n_bytes, f_if=0.25, seed=11):
    """u8 IQ of an AM carrier at ``f_if`` cycles/sample, 40 % modulated by
    a slow tone, with noise (tests/test_torch_am.py's signal)."""
    n = n_bytes // 2
    rng = np.random.default_rng(seed)
    t = np.arange(n)
    iq = (0.5 + 0.4 * np.sin(2 * np.pi * 0.001 * t)) * np.exp(
        2j * np.pi * f_if * t) + 0.01 * (rng.standard_normal(n)
                                         + 1j * rng.standard_normal(n))
    raw = np.empty(2 * n, np.uint8)
    raw[0::2] = np.clip(np.round(iq.real * 100 + 128), 0, 255)
    raw[1::2] = np.clip(np.round(iq.imag * 100 + 128), 0, 255)
    return raw


def test_am_chain_agc_approx_on_k8_complex_matches_jax(monkeypatch):
    from sdr_tpu_torch.stream import ops
    calls = []
    real = ops.mix_complex

    def counted(*a):
        calls.append(1)
        return real(*a)
    monkeypatch.setattr(ops, "mix_complex", counted)
    raw = am_raw(NB * BLOCK)
    port = chains.am_chain(agc_approx=1, device="cpu")
    _, seq = Pipeline(port, block_in=BLOCK, device="cpu").process(raw)
    assert len(calls) == NB
    par = run_time_batched(port, raw, NB, device="cpu")
    assert len(calls) == NB + 1
    jops = jchains.am_chain(agc_approx=1)
    _, want = jax.jit(JaxPipeline(jops, block_in=BLOCK).process)(raw)
    want_par = jax.jit(lambda v: jax_run_time_batched(jops, v, NB))(raw)
    assert seq.shape == want.shape and np.isfinite(seq.numpy()).all()
    np.testing.assert_allclose(seq.numpy(), np.asarray(want), rtol=0,
                               atol=CHAIN_ATOL)
    np.testing.assert_allclose(par.numpy(), np.asarray(want_par), rtol=0,
                               atol=CHAIN_ATOL)
