"""K7 + DFT (the channelizer's filterbank in one launch, the second launch
of csrc/channelize.cu) on the CPU, where its wrapper takes the plain
version; and the CUDA source itself, compiled for the host with ``g++``
under tests/torch_host_shim.py and run block by block, thread by thread.

* The host build against the plain version (K7's plain stencil, then
  ``torch.fft``) and against a numpy float64 DFT of the float64 stencil,
  each within 1e-5 of each output row's peak ``|Y|``, at C in {64, 128,
  256} x P in {1, 5, 12}, ``num`` one below and one above its tile,
  histories 0 and (P - 1) C and row bases 1-3 samples off 16-byte
  alignment; unstaged shared memory full of NaNs, and no NaN reaches an
  output.
* Its sums are K7's: with the transform patched out, the launch writes
  K7's ``v`` (max |diff| = 0 against K7's plain version, which may differ
  in a zero's sign).
* A row's output depends on its inputs alone: rows of the batch, and the
  stream, split over two calls give one call's output bitwise.
* ``dft_plan`` and ``dft_route`` mirror the source's plan, which refuses
  C outside 64-1,024 and tiles past a block; the wrapper refuses what the
  plan refuses, wrong dtypes, reads past the input and other devices.
* ``channelize_rows`` on the CPU gives K7's plain stencil then
  ``torch.fft`` bitwise on either route; the build digest covers
  ``csrc/dft.cuh``, which K9 shares.
"""

import ctypes
import itertools

import numpy as np
import pytest
import torch

import torch_host_shim as host_shim

from sdr_tpu_torch.kernels import _build, channelize, fft_stream
from sdr_tpu_torch.ops.channelize import channelize_rows

RTOL = 1e-5         # of each output row's peak |Y|

# The whole source on the host: dynamic shared memory and launches from the
# shim's persistent.cuh stand-in (one resident block), and K7's two
# card-only lines (its shared-memory declaration and launch) in the forms
# the shim takes.
HOST_PATCHES = [
    ("#include <cstdint>\n", "#include <cstdint>\n" + host_shim.persistent(1)),
    ("extern __shared__ __align__(16) float smem[];",
     "float* const smem = g_smem;"),
    ("kernel<<<static_cast<unsigned>(blocks), kThreads, smem, st>>>(",
     "KERNEL_LAUNCH_SMEM(kernel, static_cast<unsigned>(blocks), kThreads, "
     "smem, st, "),
]
# no transform: every thread idle in the passes, so the planes keep v
NO_DFT = [("const bool busy = slot < rows_here;", "const bool busy = false;")]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs in several worker processes
    (pytest-xdist), where PyTorch's idle OpenMP workers spinning would
    cost the other workers the CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def rng():
    return np.random.default_rng(21)


def _bind(lib):
    lib.launch_branch_dft.argtypes = [
        *channelize.KERNEL.functions["launch_branch_dft"], ctypes.c_void_p]
    lib.branch_dft_plan.argtypes = [ctypes.c_int, ctypes.c_int,
                                    ctypes.c_longlong,
                                    ctypes.POINTER(ctypes.c_int),
                                    ctypes.POINTER(ctypes.c_int)]
    return lib


@pytest.fixture(scope="module")
def host_libs(tmp_path_factory):
    d = tmp_path_factory.mktemp("host_k7_dft")
    return {"fused": _bind(host_shim.build_source(d, "channelize",
                                                  HOST_PATCHES)),
            "no_dft": _bind(host_shim.build_source(
                d, "channelize", HOST_PATCHES + NO_DFT, tag="_no_dft"))}


def _complex(rng, shape):
    return torch.from_numpy((rng.normal(size=shape)
                             + 1j * rng.normal(size=shape)).astype(
        np.complex64))


def host_dft(lib, hb, hist, x, num):
    """The host build's launch over ``hist`` and ``x``: (rc, Y)."""
    P, C = hb.shape
    rows = int(np.prod(x.shape[:-1], dtype=np.int64))
    y = torch.full(x.shape[:-1] + (num, C), complex(np.nan, np.nan),
                   dtype=torch.complex64)
    rc = lib.launch_branch_dft(
        hb.data_ptr(), hist.data_ptr(), x.data_ptr(),
        fft_stream.twiddles(C, "cpu").data_ptr(), y.data_ptr(), rows,
        hist.shape[-1], x.shape[-1], num, C, P, None)
    return rc, y


def host_plan(lib, C, P, num):
    tile, smem = ctypes.c_int(), ctypes.c_int()
    rc = lib.branch_dft_plan(C, P, num, ctypes.byref(tile),
                             ctypes.byref(smem))
    return rc, tile.value, smem.value


def f64_dft(hb, hist, x, num):
    """The filterbank in float64 numpy: the stencil, then the DFT."""
    P, C = hb.shape
    z = np.concatenate([hist.numpy(), x.numpy()], axis=-1).astype(
        np.complex128)
    x2 = z[..., : (num + P - 1) * C].reshape(z.shape[:-1] + (-1, C))
    h = hb.numpy().astype(np.float64)
    v = sum(x2[..., p:p + num, :] * h[p] for p in range(P))
    return np.fft.fft(v, axis=-1)


def peak_err(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    return (np.abs(got - want)
            / np.abs(want).max(axis=-1, keepdims=True)).max()


# -- the source on the host ----------------------------------------------


@pytest.mark.parametrize("C,P", list(itertools.product((64, 128, 256),
                                                       (1, 5, 12))))
def test_fused_source_on_the_host(host_libs, rng, C, P):
    """Two rows; ``num`` one below and one above the tile (two tiles a
    row, the second of one row), histories 0 and (P - 1) C, row bases 1-3
    samples off 16-byte alignment (the rows hold a sample more than read,
    so the second row's base moves too)."""
    hb = torch.from_numpy(rng.normal(size=(P, C)).astype(np.float32))
    tile = channelize.dft_plan(C, P)["tile"]
    offs = itertools.cycle((1, 2, 3))
    for num, H in itertools.product((tile - 1, tile + 1),
                                    (0, (P - 1) * C)):
        off = next(offs)
        n = (num + P - 1) * C - H + 1
        hist = host_shim.offset(_complex(rng, (2, H)), off)
        x = host_shim.offset(_complex(rng, (2, n)), off)
        rc, y = host_dft(host_libs["fused"], hb, hist, x, num)
        assert rc == 0
        assert torch.isfinite(torch.view_as_real(y)).all()
        want = channelize.branch_dft_reference(hb, hist, x, num)
        assert peak_err(y, want) <= RTOL, (num, H, off)
        assert peak_err(y, f64_dft(hb, hist, x, num)) <= RTOL, (num, H, off)


@pytest.mark.parametrize("C,P", [(64, 12), (128, 1), (256, 5)])
def test_fused_sums_are_k7s(host_libs, rng, C, P):
    """With the passes idle the planes keep v, which the launch writes:
    K7's plain version up to a zero's sign, past a tile too."""
    hb = torch.from_numpy(rng.normal(size=(P, C)).astype(np.float32))
    num = channelize.dft_plan(C, P)["tile"] + 3
    H = (P - 1) * C
    hist, x = _complex(rng, (2, H)), _complex(rng, (2, num * C + 1))
    rc, v = host_dft(host_libs["no_dft"], hb, hist, x, num)
    assert rc == 0
    assert (v - channelize.branch_filter_reference(hb, hist, x, num)
            ).abs().max().item() == 0


def test_fused_rows_do_not_depend_on_their_call(host_libs, rng):
    """Leading dims [3]: rows 0 and 1-2 in two calls give one call's
    output; the stream cut at a tile's row and again a row later, each
    part with its carry, gives the whole run's rows; all bitwise."""
    C, P = 64, 12
    H = (P - 1) * C
    hb = torch.from_numpy(rng.normal(size=(P, C)).astype(np.float32))
    num = 300
    hist, x = _complex(rng, (3, H)), _complex(rng, (3, num * C))
    lib = host_libs["fused"]
    rc, whole = host_dft(lib, hb, hist, x, num)
    assert rc == 0
    parts = [host_dft(lib, hb, hist[a:b].contiguous(), x[a:b].contiguous(),
                      num)[1] for a, b in ((0, 1), (1, 3))]
    assert torch.equal(torch.view_as_real(torch.cat(parts)),
                       torch.view_as_real(whole))
    outs, carry = [], hist
    for a, b in ((0, 128), (128, 129), (129, num)):
        xb = x[:, a * C: b * C].contiguous()
        rc, y = host_dft(lib, hb, carry.contiguous(), xb, b - a)
        assert rc == 0
        outs.append(y)
        carry = torch.cat([carry, xb], dim=-1)[:, -H:]
    assert torch.equal(torch.view_as_real(torch.cat(outs, dim=-2)),
                       torch.view_as_real(whole))


@pytest.mark.parametrize("C,P,num", [
    (64, 12, 1 << 30), (64, 12, 1), (64, 12, 63), (64, 1, 1 << 30),
    (64, 200, 1 << 30), (64, 300, 1 << 30), (64, 400, 1 << 30),
    (128, 12, 1 << 30), (128, 140, 1 << 30),
    (512, 12, 9), (1024, 12, 1 << 30), (1024, 20, 1 << 30),
    (2048, 1, 1 << 30), (32, 12, 100), (63, 12, 100), (4096, 1, 100)])
def test_plan_mirrors_the_source(host_libs, C, P, num):
    """The source's plan (on an H100's 232,448 bytes a block) and
    ``dft_plan`` give the same tile and bytes, or both refuse: C outside
    64-1,024 (kBadSize, -3), no tile that fits (kDoesNotFit, -1)."""
    rc, tile, smem = host_plan(host_libs["fused"], C, P, num)
    try:
        want = channelize.dft_plan(C, P, num)
    except ValueError as e:
        assert rc == (-3 if "power of two" in str(e) else -1)
        assert channelize.dft_route(C, P) == "k7+fft"
    else:
        assert rc == 0 and (tile, smem) == (want["tile"], want["smem"])
        assert want["tile"] % 4 == 0 and want["tile"] * C <= 4096


def test_route_by_shape():
    """Fused at the bank's C = 64 (P = 12, a tile of 64 rows in 41,472
    bytes) and up to C = 1,024; K7 + cuFFT at C = 63, 32 and 2,048, and
    at 1,024 with 20 taps a branch, whose four rows and taps take 270,336
    bytes."""
    assert channelize.dft_route(64, 12) == "fused"
    assert channelize.dft_plan(64, 12) == {"tile": 64, "smem": 41_472}
    assert channelize.dft_route(63, 12) == "k7+fft"
    assert channelize.dft_route(32, 12) == "k7+fft"
    assert channelize.dft_route(1024, 12) == "fused"
    assert channelize.dft_route(2048, 1) == "k7+fft"
    assert channelize.dft_route(1024, 20) == "k7+fft"
    with pytest.raises(ValueError, match="do not fit"):
        channelize.dft_plan(1024, 20)


# -- the wrapper on the CPU ----------------------------------------------


def _args(device=None, **kw):
    a = dict(hb=torch.ones((3, 64)),
             hist=torch.ones((2, 128), dtype=torch.complex64),
             x=torch.ones((2, 640), dtype=torch.complex64), num=10)
    if device is not None:
        a = {k: v.to(device) if torch.is_tensor(v) else v
             for k, v in a.items()}
    a.update(kw)
    return a


REFUSED = [
    (_args(hb=torch.ones((3, 64), dtype=torch.float64)), "float32"),
    (_args(x=torch.ones((2, 640))), "complex64"),
    (_args(hist=torch.ones((2, 128), dtype=torch.complex128)), "complex64"),
    (_args(hb=torch.ones((3, 63))), "power of two"),
    (_args(hb=torch.ones((3, 32))), "power of two"),
    (_args(hb=torch.ones((3, 4096)), num=1,
           x=torch.ones((2, 3 * 4096), dtype=torch.complex64)),
     "power of two"),
    (_args(hb=torch.ones((3, 2048)), num=1,
           x=torch.ones((2, 3 * 2048), dtype=torch.complex64)),
     "power of two"),
    (_args(hb=torch.ones((20, 1024)), num=1,
           x=torch.ones((2, 20 * 1024), dtype=torch.complex64)),
     "do not fit"),
    (_args(num=11), "read past"),
    (_args(x=torch.ones((2, 1280), dtype=torch.complex64)[:, ::2]),
     "contiguous"),
    (_args(hist=torch.ones((3, 128), dtype=torch.complex64)),
     "leading dims"),
    (_args(hb=torch.ones((3, 64), device="meta")), "share"),
]


@pytest.mark.parametrize("args,match", REFUSED)
def test_branch_dft_refuses(args, match):
    with pytest.raises(ValueError, match=match):
        channelize.branch_dft(**args)


def test_branch_dft_refuses_a_meta_device():
    with pytest.raises(ValueError, match="unsupported device"):
        channelize.branch_dft(**_args("meta"))


@pytest.mark.parametrize("C,P,H", [(64, 12, 704), (64, 12, 0), (63, 12, 0),
                                   (128, 5, 0)])
def test_channelize_rows_on_the_cpu_is_k7_then_fft(rng, C, P, H):
    """On either route a CPU call is K7's plain stencil, then
    ``torch.fft``, bitwise; ``branch_dft`` on the CPU is that too."""
    hb = torch.from_numpy(rng.normal(size=(P, C)).astype(np.float32))
    hist, x = _complex(rng, (2, H)), _complex(rng, (2, 40 * C))
    num = (H + 40 * C) // C - P + 1
    want = torch.fft.fft(channelize.branch_filter(hb, hist, x, num), dim=-1)
    got = channelize_rows(hb, hist, x, num)
    assert got.shape == (2, C, num)
    assert torch.equal(torch.view_as_real(got.transpose(-1, -2)),
                       torch.view_as_real(want))
    if channelize.dft_route(C, P) == "fused":
        assert torch.equal(torch.view_as_real(
            channelize.branch_dft(hb, hist, x, num)),
            torch.view_as_real(want))


# -- the registry and the build digest -----------------------------------


def test_source_exports_both_launches():
    assert set(channelize.KERNEL.functions) == {"launch_branch_filter",
                                                "launch_branch_dft"}
    assert channelize.KERNEL.source == _build.CSRC / "channelize.cu"


def test_build_digest_covers_the_shared_dft(tmp_path, monkeypatch):
    """An edited ``dft.cuh`` renames both libraries that include it."""
    for f in _build.CSRC.iterdir():
        if f.suffix in (".cu", ".cuh"):
            (tmp_path / f.name).write_text(f.read_text())
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    kernels = [_build.Kernel(name, {}) for name in ("channelize",
                                                    "fft_stream")]
    for k in kernels:
        k.source = tmp_path / f"{k.name}.cu"
    before = [k.library_path() for k in kernels]
    header = tmp_path / "dft.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    assert all(k.library_path() != b for k, b in zip(kernels, before))
