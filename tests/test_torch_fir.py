"""Port's FIR engine (kernels K2 and K3's plain versions) vs the JAX package.

The JAX side is its Pallas kernels in interpret mode where their plan
applies, and its direct gather path elsewhere.  Tolerance 1e-5 abs: both
sides sum in f32, in different orders.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from sdr_tpu.kernels import fir_pallas, resample_pallas
from sdr_tpu.ops import fir as jfir

from sdr_tpu_torch.kernels.fir import fir_strided
from sdr_tpu_torch.kernels.resample import resample
from sdr_tpu_torch.ops import fir

ATOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs in several worker processes
    (pytest-xdist), where PyTorch's idle OpenMP workers spinning would
    cost the other workers the CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _taps(rng, k):
    return rng.uniform(-0.5, 0.5, k).astype(np.float32)


@pytest.mark.parametrize("K,I,D", [(31, 3, 10), (17, 2, 3), (40, 5, 4)])
@pytest.mark.parametrize("start", [0, 37, 200])
def test_k2_plain_matches_jax(rng, K, I, D, start):
    """Every phase offset 0..I-1 at this start: vs resample_band
    (interpret) where its lane-aligned plan applies, else vs the direct
    gather path."""
    taps = _taps(rng, K)
    x = rng.uniform(-1, 1, (2, 6144)).astype(np.float32)
    table = torch.from_numpy(jfir.prepare_phase_table(taps, I))
    empty = torch.empty((2, 0))
    band = 0
    for offset in range(I):
        num = jfir.resample_output_count(6144 - start, K, I, D, offset) - 2
        plan = resample_pallas._plan(K, I, D, offset, start)
        if plan is not None and num >= plan[0]:
            band += 1
            want = resample_pallas.resample_band(
                taps, I, D, jnp.asarray(x), offset, num, start,
                interpret=True, required=True)
        else:
            want, _ = jfir.fir_resample(taps, I, D, jnp.asarray(x), offset,
                                        num, method="direct", start=start)
        got = resample(table, I, D, torch.from_numpy(x), empty, offset, num,
                       start)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=ATOL)
    assert band == I or start != 0      # the Pallas plan applies at start 0


def test_k2_history_two_pointer(rng):
    """concat(hist, x) read through two pointers == the same stream in one
    buffer, bit for bit, at nonzero offset and start."""
    taps = _taps(rng, 31)
    table = torch.from_numpy(jfir.prepare_phase_table(taps, 3))
    v = torch.from_numpy(rng.uniform(-1, 1, (3, 3000)).astype(np.float32))
    for H in (0, 1, 223):
        a = resample(table, 3, 10, v[:, H:].contiguous(),
                     v[:, :H].contiguous(), 2, 850, 11)
        b = resample(table, 3, 10, v, torch.empty((3, 0)), 2, 850, 11)
        assert torch.equal(a, b)


def test_k2_reads_past_end_as_zeros(rng):
    """Outputs whose window runs past the stream read zeros, as the JAX
    gather path pads."""
    taps = _taps(rng, 31)
    x = rng.uniform(-1, 1, 300).astype(np.float32)
    want, _ = jfir.fir_resample(taps, 3, 10, jnp.asarray(x), 1, 95,
                                method="direct")
    got, end = fir.fir_resample(taps, 3, 10, torch.from_numpy(x), 1, 95)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
    assert end == jfir.resample_end_offset(95, 3, 10, 1)


@pytest.mark.parametrize("K,f,start", [(64, 1, 0), (64, 1, 5), (51, 8, 0),
                                       (33, 3, 0)])
def test_k3_plain_matches_pallas(rng, K, f, start):
    """vs fir_strided (interpret); the Pallas kernel folds sub-row
    unit-stride starts into its band."""
    taps = _taps(rng, K)
    x = rng.uniform(-1, 1, (2, 3, 8192)).astype(np.float32)
    num = (8192 - start - K) // f + 1
    want = fir_pallas.fir_strided(taps, jnp.asarray(x), num, f,
                                  interpret=True, start=start)
    got = fir_strided(torch.from_numpy(taps), torch.from_numpy(x), num, f,
                      start)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=ATOL)


@pytest.mark.parametrize("f,start", [(1, 200), (1, 1000), (4, 131)])
def test_k3_plain_matches_direct(rng, f, start):
    """Any start, any stride: vs fir_filter / fir_decimate direct."""
    taps = _taps(rng, 64)
    x = rng.uniform(-1, 1, (2, 4096)).astype(np.float32)
    if f == 1:
        want = jfir.fir_filter(taps, jnp.asarray(x), method="direct",
                               start=start)
        got = fir.fir_filter(taps, torch.from_numpy(x), start=start)
    else:
        want = jfir.fir_decimate(taps, f, jnp.asarray(x), method="direct",
                                 start=start)
        got = fir.fir_decimate(taps, f, torch.from_numpy(x), start=start)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=ATOL)


def test_closed_form_helpers_match():
    for args in [(1000, 31, 3, 10, 0), (999, 31, 3, 10, 2), (10, 64, 5, 4, 1),
                 (5, 64, 2, 3, 0)]:
        assert (fir.resample_output_count(*args)
                == jfir.resample_output_count(*args))
    for args in [(196671, 3, 10, 0), (7, 5, 4, 3), (0, 2, 3, 1)]:
        assert (fir.resample_end_offset(*args)
                == jfir.resample_end_offset(*args))
    taps = np.arange(31, dtype=np.float32)
    np.testing.assert_array_equal(fir.prepare_phase_table(taps, 3),
                                  jfir.prepare_phase_table(taps, 3))
    i, o = fir._resample_positions(100, 3, 10, 2)
    ji, jo = jfir._resample_positions(100, 3, 10, 2)
    np.testing.assert_array_equal(i, ji)
    np.testing.assert_array_equal(o, jo)
    spec = fir.FirSpec(taps, 3, 10)
    assert (spec.n_taps, spec.taps_per_phase) == (31, 11)
    with pytest.raises(ValueError):
        fir.FirSpec(taps, 0, 1)


def test_k3_rejects_reads_past_input():
    with pytest.raises(ValueError, match="read past"):
        fir_strided(torch.ones(64), torch.ones(2, 100), 40)
