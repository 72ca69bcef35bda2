"""Port's front end (kernel K1's plain version) vs the JAX package.

The JAX side runs as its own tests run it on the CPU: the Pallas kernel in
interpret mode, or its XLA path.  Inputs come from a numpy seed.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from sdr_tpu.apps.chains import fm_taps
from sdr_tpu.kernels.u8_front_demod_pallas import u8_front_demod_pallas
from sdr_tpu.ops.demod import fm_demod_planar as jax_fm_demod_planar
from sdr_tpu.ops.quantized import fir_decimate_u8_planar as jax_front

from sdr_tpu_torch.kernels.u8_front_demod import (u8_front_demod,
                                                  u8_front_demod_reference)
from sdr_tpu_torch.ops.demod import fm_demod_planar
from sdr_tpu_torch.ops.quantized import (fir_decimate_u8_planar, front_acc,
                                         u8_front_plan)

# U8FrontDemod's seam offset in the JAX package: history H = 2(51 - 8) =
# 86 bytes, mb = ceil(86 / 16) = 6 boundary outputs, byte_off = 6*16 - 86
SEAM_OFF = 10
RF = fm_taps()[0]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs in several worker processes
    (pytest-xdist), where PyTorch's idle OpenMP workers spinning would
    cost the other workers the CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("precision", ["s8", "s16"])
@pytest.mark.parametrize("byte_off", [0, SEAM_OFF])
def test_k1_plain_matches_pallas(rng, precision, byte_off):
    """Plain K1 == u8_front_demod_pallas(interpret=True) on the bytes after
    ``byte_off``, leading dims batched: integer front identical, demod to
    the f32 rounding of the same polynomial (<= 2e-6 rad)."""
    raw = rng.integers(0, 256, (2, 16384)).astype(np.uint8)
    last = rng.uniform(-1, 1, (2, 2)).astype(np.float32)
    num = ((16384 - byte_off) // 2 - 51) // 8 + 1
    want = u8_front_demod_pallas(RF, 8, jnp.asarray(raw), jnp.asarray(last),
                                 num, interpret=True, precision=precision,
                                 byte_off=byte_off)
    tq, scale = u8_front_plan(RF, precision)
    x = torch.from_numpy(raw[:, byte_off:].copy())
    hist = torch.empty((2, 0), dtype=torch.uint8)
    got, iq = u8_front_demod(torch.from_numpy(tq), scale, 8, x, hist,
                             torch.from_numpy(last), num)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=2e-6)
    # the carry is the last decimated sample, bit-exact
    front = jax_front(RF, 8, jnp.asarray(raw), num, precision=precision,
                      byte_off=byte_off)
    np.testing.assert_array_equal(iq.numpy(), np.asarray(front)[..., -1])


@pytest.mark.parametrize("precision", ["s8", "s16"])
@pytest.mark.parametrize("byte_off", [0, SEAM_OFF, 37])
def test_front_bit_exact_vs_xla(rng, precision, byte_off):
    """The port's integer front == fir_decimate_u8_planar(impl='xla'),
    bit for bit, with leading dims; the int32 accumulator equals an int64
    numpy oracle."""
    raw = rng.integers(0, 256, (2, 3, 8192)).astype(np.uint8)
    want = np.asarray(jax_front(RF, 8, jnp.asarray(raw), impl="xla",
                                precision=precision, byte_off=byte_off))
    got = fir_decimate_u8_planar(RF, 8, torch.from_numpy(raw),
                                 precision=precision, byte_off=byte_off)
    assert got.shape == want.shape
    np.testing.assert_array_equal(got.numpy(), want)

    tq, _ = u8_front_plan(RF, precision)
    num = want.shape[-1]
    acc = front_acc(tq, 8, torch.from_numpy(raw), num, byte_off).numpy()
    s = raw[..., byte_off:].astype(np.int64) - 128
    m = np.arange(num)[:, None] * 8 + np.arange(51)[None, :]
    for c in (0, 1):
        oracle = (s[..., 2 * m + c] * tq.astype(np.int64)).sum(-1)
        np.testing.assert_array_equal(acc[..., c, :], oracle)


def test_demod_matches_jax_poly(rng):
    """Planar polynomial demod vs the JAX package's: <= 2e-6 rad; and vs
    float64 arctan2 within the polynomial's error."""
    x = rng.uniform(-1, 1, (3, 2, 4096)).astype(np.float32)
    x[0, :, :7] = 0                      # atan2(0, 0) = 0 branch
    last = rng.uniform(-1, 1, (3, 2)).astype(np.float32)
    want, wlast = jax_fm_demod_planar(jnp.asarray(x), jnp.asarray(last),
                                      atan2="poly")
    got, glast = fm_demod_planar(torch.from_numpy(x), torch.from_numpy(last))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=2e-6)
    np.testing.assert_array_equal(glast.numpy(), np.asarray(wlast))
    x64 = x.astype(np.float64)
    prev = np.concatenate([last[..., None], x64[..., :-1]], axis=-1)
    exact = np.arctan2(x64[:, 1] * prev[:, 0] - x64[:, 0] * prev[:, 1],
                       x64[:, 0] * prev[:, 0] + x64[:, 1] * prev[:, 1])
    np.testing.assert_allclose(got.numpy(), exact, rtol=0, atol=2e-6)


def test_k1_two_pointer_history(rng):
    """Reading concat(hist, x) through two pointers == the plain version
    on the concatenation, and the per-row carries are independent."""
    tq, scale = u8_front_plan(RF, "s8")
    tq = torch.from_numpy(tq)
    v = torch.from_numpy(rng.integers(0, 256, (3, 4096 + 86)).astype(
        np.uint8))
    last = torch.from_numpy(rng.uniform(-1, 1, (3, 2)).astype(np.float32))
    y, iq = u8_front_demod(tq, scale, 8, v[:, 86:].contiguous(),
                           v[:, :86].contiguous(), last)
    y2, iq2 = u8_front_demod_reference(tq, scale, 8, v, v[:, :0], last,
                                       4096 // 16)
    assert torch.equal(y, y2) and torch.equal(iq, iq2)
