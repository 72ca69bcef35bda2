"""K3's complex form (csrc/fir.cu ``launch_fir_complex``), checked on the
CPU.

(a) The whole of ``fir.cu`` is compiled for the host once, under
``tests/torch_host_shim.py`` and this file's stand-in for
``persistent.cuh`` (synchronous copies, three resident blocks, dynamic
shared memory filled with NaN before each block, so a read of a word the
copies did not fill shows), and its complex launches run block by block:
both layouts, the staged branches and the one-thread-an-output one, row
bases 0 and 2 floats past 16-byte alignment, starts 0 to f, outputs
around a tile multiple, ragged channel groups and ``out=`` rows at a
stride.  Each equals the complex plain version bitwise (tolerance 0).
(b) The complex plain version is bitwise the planar route the parent
took (``as_real_batch`` -> the real plain version -> ``torch.complex``).
(c) ``fir_decimate`` and ``Fir.decimator`` on complex input, rows and
channel-major, against the JAX package's (jitted on the CPU), 1e-5: f32
sums in another order than XLA's.  (d) ``Fir.apply``'s one-output seam
form is bitwise the ``cat`` form.  (e) What the wrapper refuses.

Inputs come from numpy seeds.
"""

import ctypes

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from sdr_tpu.ops import fir as jfir
from sdr_tpu.stream import Fir as JaxFir
from sdr_tpu.stream import Pipeline as JaxPipeline

import torch_host_shim as host_shim
from sdr_tpu_torch.kernels import fir
from sdr_tpu_torch.kernels._build import CSRC
from sdr_tpu_torch.ops import fir as ops_fir
from sdr_tpu_torch.ops.fir import as_real_batch, fir_decimate
from sdr_tpu_torch.stream import Fir, Pipeline

F32 = np.float32
NAN_C = complex(float("nan"), float("nan"))


def _header(name):
    text = (CSRC / name).read_text()
    return text.replace("#pragma once", "").replace(
        "#include <cuda_runtime.h>", "")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs in several worker processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    lib = host_shim.build_source(
        tmp_path_factory.mktemp("fir_complex"), "fir", patches=[
            ('#include "fir_tile.cuh"', _header("fir_tile.cuh")),
            # three resident blocks: the persistent loops walk many tiles
            ('#include "persistent.cuh"', host_shim.persistent(3))])
    lib.launch_fir_complex.argtypes = [
        *fir.KERNEL.functions["launch_fir_complex"], ctypes.c_void_p]
    lib.fir_plan_complex.argtypes = [ctypes.c_int] * 3 + [
        ctypes.POINTER(ctypes.c_int)] * 3
    return lib


def host_plan(lib, K, f, layout):
    out = [ctypes.c_int() for _ in range(3)]
    rc = lib.fir_plan_complex(K, f, fir.LAYOUTS.index(layout),
                              *(ctypes.byref(v) for v in out))
    assert rc == 0, rc
    branch, tile, _ = (v.value for v in out)
    return fir.BRANCHES[branch], tile


def host_fir(lib, taps, x, num, f, start, out=None, layout=None):
    """The complex form's launch on host tensors, as the wrapper makes it
    (``layout`` forces one: a [.., 1, n] channel-major x reads as rows
    otherwise)."""
    lay, batch, C, bs = fir.complex_layout(x)
    if layout == "channel-major" and lay == "rows":
        assert x.shape[-2] == 1
        lay, batch, C, bs = layout, batch // 1, 1, bs
    y = out if out is not None else torch.full(
        x.shape[:-1] + (num,), NAN_C, dtype=torch.complex64)
    ys = fir.complex_layout(y)[3]
    rc = lib.launch_fir_complex(
        x.data_ptr(), taps.data_ptr(), y.data_ptr(), batch, C, bs,
        fir.LAYOUTS.index(lay), x.shape[-1], ys, num, taps.shape[0], f,
        start, None)
    assert rc == 0
    return y


def cplx(rng, shape):
    return torch.from_numpy((rng.uniform(-1, 1, shape)
                             + 1j * rng.uniform(-1, 1, shape))
                            .astype(np.complex64))


def same_bits(a, b):
    return a.shape == b.shape and torch.equal(
        torch.view_as_real(a).contiguous().view(torch.int32),
        torch.view_as_real(b).contiguous().view(torch.int32))


def planar_route(taps, x, num, f, start):
    """The parent's route: planes, the real plain version, rebuilt."""
    xr, rebuild = as_real_batch(x)
    return rebuild(fir.fir_strided_reference(taps, xr, num, f, start))


def taps_of(rng, K):
    return torch.from_numpy(rng.uniform(-1, 1, K).astype(F32))


@pytest.mark.parametrize("f", [2, 3, 8, 16])
def test_rows_staged_equals_plain(lib, f):
    """Time-contiguous rows through the staged branch: K in {7, 51, 64},
    starts 0 to f, outputs one below, at and one above the plan's tile
    (2 rows: more tiles than the three blocks), row bases 0 and 2 floats
    past 16-byte alignment."""
    rng = np.random.default_rng(100 + f)
    for K in (7, 51, 64):
        branch, T = host_plan(lib, K, f, "rows")
        assert branch == "staged"
        taps = taps_of(rng, K)
        n = (T + 1) * f + K + f
        x0 = cplx(rng, (2, n))
        for off in (0, 1):
            x = host_shim.offset(x0, off)
            for start in range(f + 1):
                for num in (T - 1, T, T + 1):
                    got = host_fir(lib, taps, x, num, f, start)
                    want = fir.fir_strided_reference(taps, x, num, f, start)
                    assert same_bits(got, want), (K, off, start, num)


@pytest.mark.parametrize("C", [1, 5, 64])
@pytest.mark.parametrize("f", [1, 2, 8, 16])
def test_channel_major_equals_plain(lib, f, C):
    """Channel-major [2, C, n] (a transpose of [2, n, C]) through the
    channel tile: C 1 (forced), 5 (a ragged group) and 64 (two groups),
    K in {7, 51}, starts 0 and f, outputs one below, at and one above the
    tile, and the base 1 complex off alignment (the 8-byte copies)."""
    rng = np.random.default_rng(1000 * f + C)
    for K in (7, 51):
        branch, T = host_plan(lib, K, f, "channel-major")
        assert branch == "channel tile"
        taps = taps_of(rng, K)
        n = (2 * T + 1) * f + K + f
        for off in (0, 1):
            x = host_shim.offset(cplx(rng, (2, n, C)), off).transpose(-1, -2)
            for start in (0, f):
                for num in (T - 1, T, 2 * T + 1):
                    got = host_fir(lib, taps, x, num, f, start,
                                   layout="channel-major")
                    want = fir.fir_strided_reference(taps, x, num, f, start)
                    assert same_bits(got, want), (K, off, start, num)


def test_out_rows_at_a_stride_and_per_output_branch(lib):
    """``out=`` rows 7 complex wider than the outputs, both layouts and
    the staged branch; the one-thread-an-output branch for factor-1 rows,
    for taps past the staged rows' switch and past the channel tile's."""
    rng = np.random.default_rng(5)
    taps = taps_of(rng, 51)
    x = cplx(rng, (3, 4100))
    xc = cplx(rng, (2, 600, 40)).transpose(-1, -2)
    for xin, num in ((x, 500), (xc, 60)):
        buf = torch.full(xin.shape[:-1] + (num + 7,), NAN_C,
                         dtype=torch.complex64)
        out = buf[..., 3:3 + num]
        y = host_fir(lib, taps, xin, num, 8, 5, out=out)
        assert y.data_ptr() == out.data_ptr()
        assert same_bits(out, fir.fir_strided_reference(taps, xin, num, 8,
                                                        5))
        assert torch.isnan(torch.view_as_real(buf[..., :3])).all()
    # per output: factor 1 rows; 8,294 taps at factor 2 (rows); 450 taps
    # channel-major
    assert host_plan(lib, 51, 1, "rows")[0] == "per output"
    got = host_fir(lib, taps, x, 300, 1, 3)
    assert same_bits(got, fir.fir_strided_reference(taps, x, 300, 1, 3))
    for K, layout, xin, f in ((8294, "rows", cplx(rng, (2, 8400)), 2),
                              (450, "channel-major", xc, 8)):
        assert host_plan(lib, K, f, layout)[0] == "per output"
        big = taps_of(rng, K)
        num = (xin.shape[-1] - K) // f + 1
        got = host_fir(lib, big, xin, num, f, 0)
        assert same_bits(got, fir.fir_strided_reference(big, xin, num, f, 0))


def test_plan_switches_match_the_docstring(lib):
    """The largest tap counts of the staged branches (an H100's block
    under the shim), as kernels/fir.py states them."""
    def most(f, layout, branch):
        lo, hi = 1, 58_112
        while hi - lo > 1:
            mid = (lo + hi) // 2
            if host_plan(lib, mid, f, layout)[0] == branch:
                lo = mid
            else:
                hi = mid
        return lo
    rows = {f: most(f, "rows", "staged") for f in (2, 8, 16)}
    cm = {f: most(f, "channel-major", "channel tile") for f in (1, 8, 16)}
    assert rows == {2: 8_293, 8: 8_280, 16: 8_229}
    assert cm == {1: 449, 8: 449, 16: 449}
    doc = " ".join(fir.__doc__.split())
    assert "up to 8,293 taps at factor 2, 8,280 at 8 and 8,229 at 16" in doc
    assert "up to 449 taps at any factor" in doc
    assert host_plan(lib, 51, 8, "rows")[1] == 512
    assert host_plan(lib, 64, 16, "rows")[1] == 256
    assert host_plan(lib, 51, 8, "channel-major")[1] == 21


@pytest.mark.parametrize("layout", ["rows", "channel-major", "strided rows"])
def test_plain_equals_planar_route(layout):
    """The complex plain version, into a fresh tensor and into ``out=``,
    bitwise the parent's planar route."""
    rng = np.random.default_rng(11)
    taps = taps_of(rng, 51)
    x = {"rows": lambda: cplx(rng, (2, 3, 900)),
         "channel-major": lambda: cplx(rng, (2, 900, 5)).transpose(-1, -2),
         "strided rows": lambda: cplx(rng, (4, 1000))[:, 40:940]}[layout]()
    assert fir.complex_layout(x)[0] == layout.split()[-1]
    for num, f, start in ((106, 8, 5), (53, 16, 0), (850, 1, 0)):
        want = planar_route(taps, x, num, f, start)
        assert same_bits(fir.fir_strided_reference(taps, x, num, f, start),
                         want)
        out = torch.empty(x.shape[:-1] + (num + 2,),
                          dtype=torch.complex64)[..., 2:]
        assert same_bits(fir.fir_strided(taps, x, num, f, start, out=out),
                         want)


@pytest.mark.parametrize("layout", ["rows", "channel-major"])
@pytest.mark.parametrize("K,f", [(51, 8), (64, 16), (7, 1)])
def test_fir_decimate_matches_jax(layout, K, f):
    rng = np.random.default_rng(K * f)
    taps = rng.uniform(-0.5, 0.5, K).astype(F32)
    if layout == "rows":
        x = cplx(rng, (2, 3, 4000))
    else:
        x = cplx(rng, (2, 4000, 5)).transpose(-1, -2)
    assert fir.complex_layout(x)[0] == layout
    start = 3
    before = ops_fir.layout_copies
    got = fir_decimate(taps, f, x, start=start)
    assert ops_fir.layout_copies == before
    want = jax.jit(lambda v: jfir.fir_decimate(taps, f, v, start=start))(
        jnp.asarray(x.numpy()))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-5)


@pytest.mark.parametrize("layout", ["rows", "channel-major"])
def test_fir_decimator_stream_matches_jax(layout):
    """``Fir.decimator`` (51 taps, factor 8) over four blocks of [2, 5]
    complex rows with its carry, the blocks channel-major views or rows,
    against the JAX op in its pipeline."""
    rng = np.random.default_rng(23)
    taps = rng.uniform(-0.5, 0.5, 51).astype(F32)
    n, nb = 1600, 4
    if layout == "rows":
        x = cplx(rng, (2, 5, n * nb))
    else:
        x = cplx(rng, (2, n * nb, 5)).transpose(-1, -2)
    assert fir.complex_layout(x[..., :n])[0] == layout
    before = ops_fir.layout_copies
    _, got = Pipeline([Fir.decimator(taps, 8, device="cpu")], block_in=n,
                      batch_shape=(2, 5), in_dtype=torch.complex64,
                      device="cpu").process(x)
    assert ops_fir.layout_copies == before
    jp = JaxPipeline([JaxFir.decimator(taps, 8)], block_in=n,
                     in_dtype=jnp.complex64, batch_shape=(2, 5))
    _, want = jax.jit(jp.process)(x.numpy())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-5)


@pytest.mark.parametrize("layout", ["rows", "channel-major"])
@pytest.mark.parametrize("K,f", [(51, 8), (64, 16), (30, 1)])
def test_seam_out_form_equals_cat_form(layout, K, f):
    """``Fir.apply`` on a complex block writes the seam and main launches
    into one output: bitwise the parent's ``cat`` of the two, and the
    unsplit ``cat(hist, x)`` form."""
    rng = np.random.default_rng(K + f)
    op = Fir.decimator(rng.uniform(-0.5, 0.5, K).astype(F32), f,
                       device="cpu")
    n = 2048
    if layout == "rows":
        x = cplx(rng, (3, n))
    else:
        x = cplx(rng, (2, n, 6)).transpose(-1, -2)
    H = op.hist_len(n)
    hist = cplx(rng, x.shape[:-1] + (H,))
    mb, seam_x, main_start = op._seam_plan(H, n, op.out_len(n))
    _, y = op.apply(hist, x)
    taps, D = op._taps, op.spec.decimation
    yb = fir_decimate(taps, D, torch.cat([hist, x[..., :seam_x]], dim=-1),
                      mb)
    ym = fir_decimate(taps, D, x, op.out_len(n) - mb, main_start)
    assert same_bits(y, torch.cat([yb, ym], dim=-1))
    assert same_bits(y, fir_decimate(taps, D, torch.cat([hist, x], dim=-1),
                                     op.out_len(n)))


def test_wrapper_refuses_other_layouts_and_dtypes():
    rng = np.random.default_rng(3)
    taps = taps_of(rng, 7)
    x = cplx(rng, (4, 100))
    bad = [x[:, ::2],                                  # last stride 2
           cplx(rng, (100, 8)).transpose(0, 1)[::2],   # channels 2 apart
           cplx(rng, (3, 4, 100)).transpose(0, 1)]     # rows do not fold
    for b in bad:
        assert fir.complex_layout(b) is None
        with pytest.raises(ValueError, match="complex form reads"):
            fir.fir_strided(taps, b, 10, 2)
    with pytest.raises(ValueError, match="complex64"):
        fir.fir_strided(taps, x.to(torch.complex128), 10, 2)
    with pytest.raises(ValueError, match="complex form's"):
        fir.fir_strided(taps, x.real.contiguous(), 10, 2,
                        out=torch.empty(4, 10))
    for out in (torch.empty(4, 11, dtype=torch.complex64),
                torch.empty(4, 10, dtype=torch.complex128),
                torch.empty(10, 4, dtype=torch.complex64).t()):
        with pytest.raises(ValueError, match="out"):
            fir.fir_strided(taps, x, 10, 2, out=out)
    # fir_decimate copies a layout K3 does not read, once, and counts it
    before = ops_fir.layout_copies
    for b in bad:
        got = fir_decimate(taps, 2, b, 10)
        assert same_bits(got, fir.fir_strided_reference(taps, b.contiguous(),
                                                        10, 2))
    assert ops_fir.layout_copies == before + len(bad)
    with pytest.raises(ValueError, match="complex64"):
        fir_decimate(taps, 2, x.to(torch.complex128), 10)
