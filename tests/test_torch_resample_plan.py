"""K2's and K5's tile plan, checked on the CPU.

* The period table (``kernels/resample.py:period_table``): the kernels'
  index math (one origin a tile of whole periods, then the table's phase
  and input step) gives the closed form's ``(i_m, o_m)``
  (``ops/fir.py:_resample_positions``) for every output of a tile, at tile
  origins on and one period past multiples of the tile.  Exact: integers.
* The plain versions of K2 and K5 against the JAX package at the seams the
  tiles create: ``num`` one below, at and one above a multiple of the
  3072-output tile, a span from inside the history into the block, a
  history shorter than a phase's taps, and reads past the end of the
  stream.  The JAX side is its direct gather path for K2 (1e-5 abs, f32
  sums in another order) and its fused kernel's plain tail
  (``backhalf_pallas._ref_tail``) for K5 (2e-5 abs, the fused kernel's own
  tolerance), jitted once per case.
* The wrappers raise ``ValueError`` for a bad geometry before they look at
  the device, and launch nothing.

Inputs come from a numpy seed.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sdr_tpu.kernels import backhalf_pallas
from sdr_tpu.ops import fir as jfir

from sdr_tpu_torch.kernels import backhalf, resample
from sdr_tpu_torch.kernels.resample import period_table
from sdr_tpu_torch.ops.fir import _resample_positions, prepare_phase_table

TILE = 3072                 # outputs of the kernels' tile at I | 3072


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs in several worker processes
    (pytest-xdist), where PyTorch's idle OpenMP workers spinning would
    cost the other workers the CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def tile_positions(period, I, D, start, m0, count):
    """The kernels' (i, o) of outputs m0 .. m0 + count - 1 (m0 a multiple
    of I): the tile's origin ``start + (m0 / I) * D``, then per output u
    ``(u // I) * D + di[u % I]`` and phase ``o[u % I]``."""
    u = np.arange(count)
    origin = start + (m0 // I) * D
    return origin + (u // I) * D + period[1][u % I], period[0][u % I]


@pytest.mark.parametrize("I,D", [(3, 10), (2, 3), (5, 4), (1, 1)])
@pytest.mark.parametrize("start", [0, 37, 200])
def test_period_table_gives_the_closed_form(I, D, start):
    T = I * max(1, TILE // I)           # the kernels' tile: whole periods
    for offset in range(I):
        period = period_table(I, D, offset)
        assert period.dtype == np.int32 and period.shape == (2, I)
        for m0 in (0, T, 5 * T, T + I, 5 * T + I):
            i, o = tile_positions(period, I, D, start, m0, T + 70)
            ci, co = _resample_positions(T + 70, I, D, offset, m0)
            np.testing.assert_array_equal(i, ci + start)
            np.testing.assert_array_equal(o, co)


# (I, D, K, history, block, offset, start, num): the tile's seams
SEAMS = [
    (3, 10, 31, 82, 10_240, 0, 0, TILE - 1),
    (3, 10, 31, 82, 10_240, 0, 0, TILE),
    (3, 10, 31, 82, 10_240, 1, 0, TILE + 1),
    (3, 10, 31, 40, 2_000, 2, 5, 200),      # span from hist into x
    (3, 10, 31, 5, 2_000, 0, 0, 590),       # history shorter than Kp
    (3, 10, 31, 82, 2_000, 1, 3, 700),      # reads past the end
    (5, 4, 40, 9, 3_000, 3, 2, 3_800),      # 5/4, past the end too
]


def _seam_inputs(I, D, K, H, n, Kf=0):
    rng = np.random.default_rng(H + n + K)
    taps = rng.uniform(-0.5, 0.5, K).astype(np.float32)
    v = rng.uniform(-1, 1, (2, H + n)).astype(np.float32)
    tf = rng.uniform(-0.5, 0.5, Kf).astype(np.float32)
    return taps, v, tf


@pytest.mark.parametrize("I,D,K,H,n,offset,start,num", SEAMS)
def test_k2_plain_matches_jax_at_tile_seams(I, D, K, H, n, offset, start,
                                            num):
    taps, v, _ = _seam_inputs(I, D, K, H, n)
    want = jax.jit(lambda a: jfir.fir_resample(
        taps, I, D, a, offset, num, method="direct", start=start)[0])(
            jnp.asarray(v))
    got = resample.resample(torch.from_numpy(prepare_phase_table(taps, I)),
                            I, D, torch.from_numpy(v[:, H:].copy()),
                            torch.from_numpy(v[:, :H].copy()), offset, num,
                            start)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-5)


@pytest.mark.parametrize("I,D,K,H,n,offset,start,num", SEAMS)
def test_k5_plain_matches_jax_at_tile_seams(I, D, K, H, n, offset, start,
                                            num):
    taps, v, tf = _seam_inputs(I, D, K, H, n, Kf=64)
    want = jax.jit(lambda a: backhalf_pallas._ref_tail(
        taps, I, D, tf, 0.5, a, offset, 0, num, start))(jnp.asarray(v))
    got = backhalf.resample_fir(
        torch.from_numpy(prepare_phase_table(taps, I)), I, D,
        torch.from_numpy(0.5 * tf), torch.from_numpy(v[:, H:].copy()),
        torch.from_numpy(v[:, :H].copy()), offset, num, start)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=2e-5)


# (what, I, D, offset, start, num, table rows, taps): one fault each
BAD = [
    ("offset", 3, 10, 3, 0, 10, 3, 64),
    ("interpolation", 0, 10, 0, 0, 10, 0, 64),
    ("decimation", 3, 0, 0, 0, 10, 3, 64),
    ("start", 3, 10, 0, -1, 10, 3, 64),
    ("num", 3, 10, 0, 0, -1, 3, 64),
    ("table", 3, 10, 0, 0, 10, 2, 64),
    ("taps", 3, 10, 0, 0, 10, 3, 0),
]


@pytest.mark.parametrize("device", ["cpu", "meta"])
@pytest.mark.parametrize("what,I,D,offset,start,num,rows,Kf", BAD)
def test_wrappers_reject_bad_geometry_before_launch(what, I, D, offset,
                                                    start, num, rows, Kf,
                                                    device):
    """ValueError from both wrappers on any device, before the device is
    looked at (meta tensors reach the geometry check, not the device
    check) and without a launch."""
    table = torch.zeros((rows, 11), device=device)
    x = torch.zeros((2, 100), device=device)
    hist = torch.zeros((2, 7), device=device)
    taps = torch.zeros(Kf, device=device)
    launches = (resample.KERNEL.launches, backhalf.KERNEL.launches)
    if what != "taps":
        with pytest.raises(ValueError, match="geometry|table"):
            resample.resample(table, I, D, x, hist, offset, num, start)
    with pytest.raises(ValueError, match="geometry|table|taps"):
        backhalf.resample_fir(table, I, D, taps, x, hist, offset, num, start)
    assert (resample.KERNEL.launches, backhalf.KERNEL.launches) == launches


def test_wrappers_raise_for_a_device_without_kernels():
    """A good geometry on a device that is neither the CPU nor CUDA raises
    too, and launches nothing."""
    table = torch.zeros((3, 11), device="meta")
    x = torch.zeros((2, 100), device="meta")
    hist = torch.zeros((2, 7), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        resample.resample(table, 3, 10, x, hist, 0, 10)
    with pytest.raises(ValueError, match="unsupported device"):
        backhalf.resample_fir(table, 3, 10, torch.zeros(64, device="meta"),
                              x, hist, 0, 10)
    assert resample.KERNEL.launches == backhalf.KERNEL.launches == 0
