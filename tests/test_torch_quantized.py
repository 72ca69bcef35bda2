"""Port's quantized front end (kernel K4's plain version, ``U8FrontEnd``)
vs the JAX package.

Tolerance 0, bit-exact: both sides sum the same integer taps times
``byte - 128`` exactly in int32, then apply one f32 multiply by the same
scale.  The JAX side runs as its own tests run it on the CPU: the Pallas
kernel in interpret mode, or its XLA path.  Inputs come from a numpy seed.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from sdr_tpu.apps.chains import fm_taps
from sdr_tpu.kernels.u8_front_pallas import u8_front_pallas
from sdr_tpu.ops.quantized import fir_decimate_u8_planar as jax_front
from sdr_tpu.parallel.sharded import run_time_batched as jax_run_time_batched
from sdr_tpu.stream import Pipeline as JaxPipeline
from sdr_tpu.stream import U8FrontEnd as JaxU8FrontEnd

from sdr_tpu_torch.kernels.u8_front import u8_front, u8_front_reference
from sdr_tpu_torch.ops.quantized import fir_decimate_u8_planar, u8_front_plan
from sdr_tpu_torch.parallel.sharded import run_time_batched
from sdr_tpu_torch.stream import Pipeline, U8FrontEnd

RF = fm_taps()[0]
BLOCK, NB = 4096, 6


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs in several worker processes
    (pytest-xdist), where PyTorch's idle OpenMP workers spinning would
    cost the other workers the CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _taps(rng, K):
    return RF if K == 51 else rng.uniform(-1, 1, K).astype(np.float32)


@pytest.mark.parametrize("precision", ["s8", "s16"])
@pytest.mark.parametrize("K,f", [(51, 8), (16, 4), (63, 1)])
def test_k4_plain_matches_pallas_and_xla(rng, precision, K, f):
    """Plain K4 == u8_front_pallas(interpret=True) == the XLA path, bit for
    bit, with leading dims [2, 3]."""
    taps = _taps(rng, K)
    raw = rng.integers(0, 256, (2, 3, 2048)).astype(np.uint8)
    want = np.asarray(u8_front_pallas(taps, f, jnp.asarray(raw),
                                      interpret=True, precision=precision))
    xla = np.asarray(jax_front(taps, f, jnp.asarray(raw), impl="xla",
                               precision=precision))
    tq, scale = u8_front_plan(taps, precision)
    got = u8_front(torch.from_numpy(tq), scale, f, torch.from_numpy(raw),
                   torch.empty((2, 3, 0), dtype=torch.uint8))
    assert got.shape == want.shape == (2, 3, 2, (1024 - K) // f + 1)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), xla)


@pytest.mark.parametrize("precision", ["s8", "s16"])
def test_k4_history_and_byte_offset(rng, precision):
    """Reading concat(hist, x) through two pointers from byte ``start``
    == the XLA path with ``byte_off`` on the one buffer: a history that is
    not a whole number of output steps (86 bytes at 16 bytes a step), and
    odd offsets."""
    tq, scale = u8_front_plan(RF, precision)
    tq = torch.from_numpy(tq)
    v = rng.integers(0, 256, (3, 4096 + 86)).astype(np.uint8)
    vt = torch.from_numpy(v)
    for start in (0, 10, 37):
        want = np.asarray(jax_front(RF, 8, jnp.asarray(v), impl="xla",
                                    precision=precision, byte_off=start))
        got = u8_front(tq, scale, 8, vt[:, 86:].contiguous(),
                       vt[:, :86].contiguous(), start=start)
        np.testing.assert_array_equal(got.numpy(), want)
        got = fir_decimate_u8_planar(RF, 8, vt, precision=precision,
                                     byte_off=start)
        np.testing.assert_array_equal(got.numpy(), want)


def test_k4_rejects_short_stream():
    tq, scale = u8_front_plan(RF, "s8")
    x = torch.full((2, 200), 0x80, dtype=torch.uint8)
    with pytest.raises(ValueError, match="need more"):
        u8_front_reference(torch.from_numpy(tq), scale, 8, x, x[:, :0], 10)


@pytest.fixture(scope="module")
def raw_stream():
    return np.random.default_rng(3).integers(0, 256, BLOCK * NB).astype(
        np.uint8)


@pytest.mark.parametrize("precision", ["s8", "s16"])
def test_u8_front_end_matches_jax(raw_stream, precision):
    """U8FrontEnd streamed (Pipeline.process) and block-parallel
    (run_time_batched) == the JAX package's streamed run, bit for bit; the
    output is planar [2, N] and the carry is the trailing raw bytes."""
    jop = JaxU8FrontEnd(RF, 8, precision=precision)
    jc, want = JaxPipeline([jop], block_in=BLOCK).process(raw_stream)
    want = np.asarray(want)
    op = U8FrontEnd(RF, 8, precision=precision, device="cpu")
    cs, got = Pipeline([op], block_in=BLOCK, device="cpu").process(
        raw_stream)
    assert got.shape == want.shape == (2, NB * BLOCK // 16)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(cs[0].numpy(), np.asarray(jc[0]))
    got_b = run_time_batched([op], raw_stream, NB, device="cpu")
    np.testing.assert_array_equal(got_b.numpy(), want)
    want_b = np.asarray(jax_run_time_batched([jop], jnp.asarray(raw_stream),
                                             NB))
    np.testing.assert_array_equal(got_b.numpy(), want_b)


def test_u8_front_end_warmup_is_0x80():
    op = U8FrontEnd(RF, 8, device="cpu")
    hist = op.init_carry(BLOCK, (3,))
    assert hist.shape == (3, 86) and bool((hist == 0x80).all())
    assert op.map_batch_shape((3,)) == (3, 2)
