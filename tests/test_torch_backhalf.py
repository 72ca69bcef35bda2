"""Port's fused back half (kernel K5's plain version,
``ResampleFirScale(fused=True)``) vs the JAX package and vs the unfused
K2 -> K3 pair.

Tolerance 2e-5 abs against the JAX package, its own tolerance for the
fused kernel (tests/test_backhalf.py): the Pallas kernel sums its banded
matmuls in another order.  The port's fused and unfused paths run the same
sums in the same order, so they agree exactly.  Inputs come from a numpy
seed.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from sdr_tpu.apps.chains import fm_taps
from sdr_tpu.kernels.backhalf_pallas import resample_fir_gain
from sdr_tpu.stream import Pipeline as JaxPipeline
from sdr_tpu.stream import ResampleFirScale as JaxResampleFirScale

from sdr_tpu_torch.kernels.backhalf import resample_fir
from sdr_tpu_torch.ops.fir import prepare_phase_table
from sdr_tpu_torch.stream import Pipeline, ResampleFirScale

ATOL = 2e-5
KR, I, D, KF, GAIN = 31, 3, 10, 64, 0.2


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs in several worker processes
    (pytest-xdist), where PyTorch's idle OpenMP workers spinning would
    cost the other workers the CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("n,num,offset,start", [(8000, 2000, 0, 0),
                                                (6000, 1500, 2, 17),
                                                (30000, 8000, 1, 200)])
def test_k5_plain_matches_pallas(n, num, offset, start):
    rng = np.random.default_rng(7)
    tr = rng.uniform(-1, 1, KR).astype(np.float32)
    tf = rng.uniform(-1, 1, KF).astype(np.float32)
    x = rng.uniform(-1, 1, n).astype(np.float32)
    want = resample_fir_gain(tr, I, D, tf, GAIN, jnp.asarray(x), offset, num,
                             start, interpret=True, required=True)
    got = resample_fir(torch.from_numpy(prepare_phase_table(tr, I)), I, D,
                       torch.from_numpy((GAIN * tf).astype(np.float32)),
                       torch.from_numpy(x), torch.empty(0), offset, num,
                       start)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=ATOL)


def test_k5_history_two_pointer(rng):
    """concat(hist, x) read through two pointers == the same stream in one
    buffer, bit for bit, reads past the end included."""
    table = torch.from_numpy(prepare_phase_table(
        rng.uniform(-1, 1, KR).astype(np.float32), I))
    taps = torch.from_numpy(rng.uniform(-1, 1, KF).astype(np.float32))
    v = torch.from_numpy(rng.uniform(-1, 1, (3, 3000)).astype(np.float32))
    for H in (0, 1, 223):
        a = resample_fir(table, I, D, taps, v[:, H:].contiguous(),
                         v[:, :H].contiguous(), 2, 850, 11)
        b = resample_fir(table, I, D, taps, v, v[:, :0], 2, 850, 11)
        assert torch.equal(a, b)


def test_fused_equals_unfused_on_planes(rng):
    """ResampleFirScale(fused=True) == fused=False on [3, 2, n] blocks, bit
    for bit, streamed over two blocks."""
    _, ars, afl = fm_taps()
    block = 10240
    x = torch.from_numpy(rng.uniform(-1, 1, (2, 3, 2, block)).astype(
        np.float32))
    ys = []
    for fused in (True, False):
        op = ResampleFirScale(ars, 3, 10, afl, GAIN, fused=fused,
                              device="cpu")
        p = Pipeline([op], block_in=block, batch_shape=(3, 2), device="cpu")
        c = p.init()
        assert c[0].shape == (3, 2, op.hist_len(block))
        out = []
        for b in range(2):
            c, y = p.apply(c, x[b])
            out.append(y)
        ys.append(torch.cat(out, dim=-1))
    assert ys[0].shape == (3, 2, 2 * 3072)
    assert torch.equal(ys[0], ys[1])


def test_fused_streamed_matches_jax(rng):
    """The fused op streamed == the JAX package's ResampleFirScale over the
    same blocks, with the plane axis batched."""
    _, ars, afl = fm_taps()
    block = 10240
    x = rng.uniform(-1, 1, (2, 4 * block)).astype(np.float32)
    jp = JaxPipeline([JaxResampleFirScale(ars, 3, 10, afl, GAIN)],
                     block_in=block, in_dtype=jnp.float32, batch_shape=(2,))
    _, want = jp.process(jnp.asarray(x))
    op = ResampleFirScale(ars, 3, 10, afl, GAIN, fused=True, device="cpu")
    _, got = Pipeline([op], block_in=block, batch_shape=(2,),
                      device="cpu").process(x)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=ATOL)
