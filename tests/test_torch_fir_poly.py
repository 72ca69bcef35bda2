"""K3's staged f > 1 branch (csrc/fir.cu, ``fird_kernel``), checked on the
CPU.

The CUDA kernel runs only on the card, so its arithmetic is emulated here
in numpy: the tile origins, each tile's staged span at its 16-byte
offset, the split into f polyphase rows and the tap-order f32 sums (one
rounded multiply, then one rounded add, from +0).  The emulation must
equal ``kernels/fir.py:fir_strided_reference`` (the plain version the
card holds the kernel against) bitwise: tolerance 0.  The plain version
is also held against the JAX package's Pallas kernel in interpret mode
at the paths' geometries, at 1e-5 (both sum in f32, in different orders).

Inputs come from numpy seeds.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from sdr_tpu.kernels import fir_pallas

from sdr_tpu_torch.kernels.fir import fir_strided_reference

F32 = np.float32


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs in several worker processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def raw_floats(T, K, f):
    """fir.cu:213 ``dec_raw_floats``: a staging buffer's floats."""
    return ((T - 1) * f + K + 6) & ~3


def row_stride(T, K, f):
    """fir.cu:221 ``dec_row_stride``: a phase row's floats, padded."""
    pad = (32 // f) % 8 if f % 4 == 0 and f <= 32 else 0
    return ((T + (K - 1) // f + 4 + 7) & ~7) + pad


def emulate(taps, x, num, f, start, T, base_off):
    """``fird_kernel`` (fir.cu:353-400) over the rows of ``x`` [rows, n],
    whose first float lies ``base_off`` floats past a 16-byte boundary,
    with tiles of ``T`` outputs.  Shared memory the copies do not fill
    holds NaN, so a read of it shows in the outputs."""
    rows, n = x.shape
    K = taps.shape[0]
    flat = x.ravel()
    RS = row_stride(T, K, f)
    y = np.full((rows, num), np.nan, F32)
    tiles_per_row = -(-num // T)
    for it in range(rows * tiles_per_row):
        # persistent::tile_origin, as stage (fir.cu:118) and the loop
        # (fir.cu:387) call it
        row, m0 = divmod(it, tiles_per_row)
        m0 *= T
        nb = min(T, num - m0)
        # stage (fir.cu:111-136): the span of nb outputs at stride f from
        # its 16-byte offset off, whole chunks where they lie in x
        S = (nb - 1) * f + K
        src = row * n + start + m0 * f
        off = (base_off + src) % 4
        chunks = (off + S + 3) // 4
        buf = np.full(raw_floats(T, K, f), np.nan, F32)
        g = src - off + np.arange(4 * chunks)
        inside = (g >= 0) & (g < rows * n)
        buf[:4 * chunks][inside] = flat[g[inside]]
        # split_phases (fir.cu:248-263): span[s] to row s % f, column s / f
        P = np.full(f * RS, np.nan, F32)
        s = np.arange(4 * chunks) - off
        keep = (s >= 0) & (s < S)
        P[(s[keep] % f) * RS + s[keep] // f] = buf[:4 * chunks][keep]
        # poly_sums / poly_sums_rt (fir.cu:270-316): output i sums taps in
        # order, j = q f + p, reading row p at column i + q
        acc = np.zeros(nb, F32)
        i = np.arange(nb)
        for j in range(K):
            p, q = j % f, j // f
            acc = acc + taps[j] * P[p * RS + i + q]
        # dec_tile's stores (fir.cu:329-350)
        y[row, m0:m0 + nb] = acc
    return y


def plain(taps, x, num, f, start):
    return fir_strided_reference(torch.from_numpy(taps), torch.from_numpy(x),
                                 num, f, start).numpy()


@pytest.mark.parametrize("K", [1, 7, 51, 64, 65, 200])
@pytest.mark.parametrize("f", [2, 3, 8, 16])
def test_staged_emulation_equals_plain(f, K):
    """Starts 0 to f; outputs one below, at and one above a tile
    multiple; tiles of 1024 (512 at f = 16: the kernel's tiles at these
    tap counts) and of 40 (many tiles a row)."""
    rng = np.random.default_rng(1000 * f + K)
    taps = rng.uniform(-1, 1, K).astype(F32)
    for T, m in ((min(1024, 8192 // f), 1), (40, 3)):
        n = (m * T + 1) * f + K + f
        x = rng.uniform(-1, 1, (2, n)).astype(F32)
        for start in range(f + 1):
            for num in (m * T - 1, m * T, m * T + 1):
                got = emulate(taps, x, num, f, start, T, start % 4)
                want = plain(taps, x, num, f, start)
                assert got.shape == want.shape
                assert np.array_equal(got.view(np.uint32),
                                      want.view(np.uint32)), (T, start, num)


@pytest.mark.parametrize("K,f,n,num", [(51, 8, 91, 6), (64, 16, 96, 3)])
def test_staged_emulation_at_the_seam(K, f, n, num):
    """The seam launches of the exact front (6 outputs from the 43-float
    history and 48 block samples) and the AM channel filter (3 from 48 +
    48): one partial tile a row, its span reaching the tensor's end."""
    rng = np.random.default_rng(K)
    taps = rng.uniform(-1, 1, K).astype(F32)
    x = rng.uniform(-1, 1, (64, n)).astype(F32)
    want = plain(taps, x, num, f, 0)
    for base_off in range(4):
        got = emulate(taps, x, num, f, 0, min(1024, 8192 // f), base_off)
        assert np.array_equal(got.view(np.uint32), want.view(np.uint32))


@pytest.mark.parametrize("K,f,start", [(51, 8, 5), (64, 16, 0)])
def test_staged_geometries_plain_matches_pallas(K, f, start):
    """The paths' geometries: the plain version vs fir_strided
    (interpret), jitted once."""
    rng = np.random.default_rng(7 * K + f)
    taps = rng.uniform(-0.5, 0.5, K).astype(F32)
    x = rng.uniform(-1, 1, (2, 3, 8192)).astype(F32)
    num = (8192 - start - K) // f + 1
    run = jax.jit(lambda v: fir_pallas.fir_strided(
        taps, v, num, f, interpret=True, start=start))
    want = np.asarray(run(jnp.asarray(x)))
    got = plain(taps, x, num, f, start)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
