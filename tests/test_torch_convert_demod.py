"""K10 (the interleaved-IQ convert) and K11 (the FM demod, planar and
complex) on the CPU, where their wrappers take the plain versions; and the
two CUDA sources themselves, compiled for the host with ``g++`` under a
shim of the CUDA built-ins they use (tests/torch_host_shim.py) and run
block by block, thread by thread.

* Against the JAX package: the converts bitwise
  (``sdr_tpu.ops.convert``), the demods within 2e-6 rad of angular
  distance (``sdr_tpu.ops.demod``, both atan2s, a random carry), and the
  warmup sample ``x[0] * conj(0)`` (a signed zero: 0, or pi where both
  parts of ``x[0]`` are negative) in all four quadrants, in both forms
  (hazard H16).
* The host builds at the geometry sets ``chip_smoke.py`` uses (n odd, 0,
  1, 7, 8, 9 and around a tile; leading dims [], [B], [B, C]; bases 1-15
  bytes or 1-3 floats off 16-byte alignment; zero and random carries):
  K10 and the planar polynomial K11 bitwise their plain versions, the
  ``atan2f`` forms (the C library's here) within 2e-6 rad; rows whose
  tiles cross the row seam read their own row's sample before a tile and
  the carry only at a row's start (hazard H3).
* Routing: ``IqConvertU8``, ``IqConvertI16`` and ``FmDemod`` call the
  K10/K11 wrappers, and the chains that run them on the CPU still equal
  the JAX chains to their tests' limits.
"""

import collections
import ctypes
import itertools

import numpy as np
import pytest
import torch

import jax

import torch_host_shim as host_shim

from sdr_tpu.apps import chains as jchains
from sdr_tpu.apps.channelizer import synthesize as jax_synthesize
from sdr_tpu.ops import convert as jconvert
from sdr_tpu.ops import demod as jdemod
from sdr_tpu.parallel.sharded import run_time_batched as jax_run_time_batched

from sdr_tpu_torch.apps import chains
from sdr_tpu_torch.kernels import KERNELS, _build, fm_demod, iq_convert
from sdr_tpu_torch.parallel.sharded import run_time_batched
from sdr_tpu_torch.stream import FmDemod, IqConvertI16, IqConvertU8
from sdr_tpu_torch.stream import ops as stream_ops

ANGLE = 2e-6                      # PERF.md's demod limit, rad
CONVERTS = {("u8", True): "iq_u8_to_planar", ("u8", False): "iq_u8_to_cfloat",
            ("i16", True): "iq_i16_to_planar",
            ("i16", False): "iq_i16_to_cfloat"}
LEADS = [(), (3,), (2, 3)]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs in several worker processes
    (pytest-xdist), where PyTorch's idle OpenMP workers spinning would
    cost the other workers the CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _iq(rng, fmt, shape):
    if fmt == "u8":
        return rng.integers(0, 256, shape).astype(np.uint8)
    return rng.integers(-32768, 32768, shape).astype(np.int16)


def _bits(t):
    t = torch.as_tensor(t)
    if t.is_complex():
        t = torch.view_as_real(t)
    return t.contiguous().view(torch.int32)


def _angular(a, b) -> float:
    """Largest angular distance |remainder(a - b + pi, 2 pi) - pi|, in
    float64 (a flip from -pi to +pi is 0)."""
    d = np.asarray(a, np.float64) - np.asarray(b, np.float64)
    if d.size == 0:
        return 0.0
    return float(np.abs(np.remainder(d + np.pi, 2 * np.pi) - np.pi).max())


def _planar(rng, shape):
    return np.asarray(rng.normal(size=shape), np.float32)


def _complex(rng, shape):
    return np.asarray(rng.normal(size=shape) + 1j * rng.normal(size=shape),
                      np.complex64)


def _demod_inputs(rng, form, lead, n):
    """(x, last) numpy for the form: planar [*lead, 2, n] with [*lead, 2]
    carries, or complex [*lead, n] with [*lead] ones."""
    if form == "complex":
        return _complex(rng, lead + (n,)), _complex(rng, lead)
    return _planar(rng, lead + (2, n)), _planar(rng, lead + (2,))


def _port_demod(form, x, last):
    x, last = torch.from_numpy(x), torch.from_numpy(last)
    if form == "complex":
        return fm_demod.fm_demod_complex(x, last)
    return fm_demod.fm_demod_planar(x, last, atan2=form)


def _jax_demod(form, x, last):
    if form == "complex":
        f = jax.jit(jdemod.fm_demod)
    else:
        f = jax.jit(lambda v, c: jdemod.fm_demod_planar(v, c, atan2=form))
    y, new = f(x, last)
    return np.asarray(y), np.asarray(new)


# -- against the JAX package ---------------------------------------------


@pytest.mark.parametrize("fmt,planar", sorted(CONVERTS))
@pytest.mark.parametrize("lead", LEADS)
@pytest.mark.parametrize("n", [1, 7, 1000])
def test_convert_matches_jax_bitwise(rng, fmt, planar, lead, n):
    x = _iq(rng, fmt, lead + (2 * n,))
    got = iq_convert.iq_convert(torch.from_numpy(x), planar)
    want = np.asarray(jax.jit(getattr(jconvert, CONVERTS[fmt, planar]))(x))
    assert tuple(got.shape) == want.shape
    assert got.dtype == (torch.float32 if planar else torch.complex64)
    assert torch.equal(_bits(got), _bits(torch.tensor(want)))


@pytest.mark.parametrize("form", ["poly", "exact", "complex"])
@pytest.mark.parametrize("lead", LEADS)
def test_demod_matches_jax_with_a_random_carry(rng, form, lead):
    x, last = _demod_inputs(rng, form, lead, 1000)
    y, new = _port_demod(form, x, last)
    jy, jnew = _jax_demod(form, x, last)
    assert tuple(y.shape) == jy.shape == lead + (1000,)
    assert _angular(y.numpy(), jy) <= ANGLE
    assert torch.equal(_bits(new), _bits(torch.tensor(jnew)))


# x[0] in each quadrant: (+, +), (-, +), (-, -), (+, -)
QUADRANTS = np.array([[0.5, 0.25], [-0.5, 0.25], [-0.5, -0.25],
                      [0.5, -0.25]], np.float32)


def _warmup_inputs(form):
    """Four rows of 3 samples, row r's first sample in quadrant r, and a
    zero carry: the stream's warmup."""
    x = np.tile(QUADRANTS[:, :, None], (1, 1, 3)) * np.float32(0.5)
    x[:, :, 0] = QUADRANTS
    if form == "complex":
        return (x[:, 0] + 1j * x[:, 1]).astype(np.complex64), \
            np.zeros(4, np.complex64)
    return x, np.zeros((4, 2), np.float32)


@pytest.mark.parametrize("form", ["poly", "exact", "complex"])
def test_warmup_sample_in_each_quadrant_matches_jax(form):
    """H16: ``x[0] * conj(0)`` is a signed zero.  Its angle is 0, or pi
    where both parts of x[0] are negative (the exact atan2s), and 0 for
    the polynomial (atan2(0, 0) = 0); the port's first output is the
    JAX package's bit for bit."""
    x, last = _warmup_inputs(form)
    y, _ = _port_demod(form, x, last)
    jy, _ = _jax_demod(form, x, last)
    want = [0.0, 0.0, np.pi, 0.0] if form != "poly" else [0.0] * 4
    np.testing.assert_array_equal(np.abs(y[:, 0].numpy()),
                                  np.float32(want))
    assert torch.equal(_bits(y[:, 0]), _bits(torch.tensor(jy[:, 0])))


@pytest.mark.parametrize("form", ["poly", "exact", "complex"])
def test_empty_block_passes_the_carry_through(rng, form):
    x, last = _demod_inputs(rng, form, (3,), 0)
    y, new = _port_demod(form, x, last)
    assert tuple(y.shape) == (3, 0) and y.dtype == torch.float32
    assert torch.equal(new, torch.from_numpy(last))
    got = iq_convert.iq_convert(torch.zeros((3, 0), dtype=torch.uint8),
                                form != "complex")
    assert got.numel() == 0


# -- wrappers, registry and the build digest -----------------------------


def _k10_call(device):
    return lambda: iq_convert.iq_convert(
        torch.zeros((2, 64), dtype=torch.uint8, device=device), True)


def _k11_planar(device):
    return lambda: fm_demod.fm_demod_planar(
        torch.zeros((2, 2, 64), device=device),
        torch.zeros((2, 2), device=device))


def _k11_complex(device):
    return lambda: fm_demod.fm_demod_complex(
        torch.zeros((2, 64), dtype=torch.complex64, device=device),
        torch.zeros(2, dtype=torch.complex64, device=device))


@pytest.mark.parametrize("make", [_k10_call, _k11_planar, _k11_complex])
def test_wrappers_refuse_a_meta_device(make):
    with pytest.raises(ValueError, match="unsupported device"):
        make("meta")()


REFUSED = [
    (lambda: iq_convert.iq_convert(torch.zeros((2, 64)), True), "uint8"),
    (lambda: iq_convert.iq_convert(torch.zeros((2, 63), dtype=torch.uint8),
                                   False), "even"),
    (lambda: fm_demod.fm_demod_planar(torch.zeros((2, 3, 64)),
                                      torch.zeros((2, 3))), "planar"),
    (lambda: fm_demod.fm_demod_planar(torch.zeros((2, 2, 64)),
                                      torch.zeros(2)), "last"),
    (lambda: fm_demod.fm_demod_planar(torch.zeros((2, 2, 64)),
                                      torch.zeros((2, 2)), atan2="fast"),
     "atan2"),
    (lambda: fm_demod.fm_demod_complex(torch.zeros((2, 64)),
                                       torch.zeros(2)), "complex64"),
    (lambda: fm_demod.fm_demod_complex(
        torch.zeros((2, 64), dtype=torch.complex64),
        torch.zeros(3, dtype=torch.complex64)), "last"),
]


@pytest.mark.parametrize("call,match", REFUSED)
def test_wrappers_refuse(call, match):
    with pytest.raises(ValueError, match=match):
        call()


def test_kernels_hold_k10_and_k11():
    assert KERNELS[9] is iq_convert.KERNEL and KERNELS[10] is fm_demod.KERNEL
    assert iq_convert.KERNEL.source == _build.CSRC / "iq_convert.cu"
    assert fm_demod.KERNEL.source == _build.CSRC / "fm_demod.cu"
    assert set(iq_convert.KERNEL.functions) == {"launch_iq_convert"}
    assert set(fm_demod.KERNEL.functions) == {"launch_fm_demod_planar",
                                              "launch_fm_demod_complex"}


def test_shared_atan2_header_is_in_k1_and_k11_and_their_digests(
        tmp_path, monkeypatch):
    """K1 and K11 take the polynomial from csrc/fm_demod.cuh (K1 no longer
    has its own copy), and an edited header renames both libraries (H8)."""
    header = (_build.CSRC / "fm_demod.cuh").read_text()
    assert "float poly_atan2(float b, float a)" in header
    for name in ("u8_front_demod", "fm_demod"):
        src = (_build.CSRC / f"{name}.cu").read_text()
        assert '#include "fm_demod.cuh"' in src
        assert "float poly_atan2(" not in src
    copy = tmp_path / "csrc"
    copy.mkdir()
    for f in _build.CSRC.iterdir():
        (copy / f.name).write_bytes(f.read_bytes())
    monkeypatch.setattr(_build, "CSRC", copy)
    kernels = [_build.Kernel("u8_front_demod", {}),
               _build.Kernel("fm_demod", {})]
    before = [k.library_path() for k in kernels]
    (copy / "fm_demod.cuh").write_text(header + "\n// edited\n")
    after = [k.library_path() for k in kernels]
    assert all(a != b for a, b in zip(after, before))


# -- the CUDA sources, built for the host --------------------------------

K10_HOST_RUN = r"""
template <class T>
void run(const T* x, float* y, long long rows, long long n, int planar) {
  const long long per_block = static_cast<long long>(kThreads) * kElems;
  if (planar) {
    for (long long r = 0; r < rows; ++r)
      for (long long b = 0; b < (2 * n + per_block - 1) / per_block; ++b)
        for (int t = 0; t < kThreads; ++t) {
          threadIdx = {static_cast<unsigned>(t), 0, 0};
          blockIdx = {static_cast<unsigned>(b), static_cast<unsigned>(r), 0};
          iq_planar_kernel<T>(x, y, n);
        }
  } else {
    const long long total = rows * 2 * n;
    for (long long b = 0; b < (total + per_block - 1) / per_block; ++b)
      for (int t = 0; t < kThreads; ++t) {
        threadIdx = {static_cast<unsigned>(t), 0, 0};
        blockIdx = {static_cast<unsigned>(b), 0, 0};
        iq_complex_kernel<T>(x, y, total);
      }
  }
}
}  // namespace
extern "C" void host_iq_convert(const void* x, float* y, long long rows,
                                long long n, int i16, int planar) {
  if (i16) run(static_cast<const int16_t*>(x), y, rows, n, planar);
  else run(static_cast<const uint8_t*>(x), y, rows, n, planar);
}
"""

K11_HOST_RUN = r"""
}  // namespace
extern "C" void host_fm_demod(const float* x, const float* c, float* y,
                              long long rows, long long n, int form) {
  for (long long r = 0; r < rows; ++r)
    for (long long b = 0; b < (n + kTile - 1) / kTile; ++b)
      for (int t = 0; t < kThreads; ++t) {
        threadIdx = {static_cast<unsigned>(t), 0, 0};
        blockIdx = {static_cast<unsigned>(b), static_cast<unsigned>(r), 0};
        if (form == 2)
          fm_demod_complex_kernel(reinterpret_cast<const float2*>(x),
                                  reinterpret_cast<const float2*>(c), y, n);
        else if (form == 1)
          fm_demod_planar_kernel<true>(x, c, y, n);
        else
          fm_demod_planar_kernel<false>(x, c, y, n);
      }
}
"""

FORMS = {"exact": 0, "poly": 1, "complex": 2}


@pytest.fixture(scope="module")
def host_builds(tmp_path_factory):
    d = tmp_path_factory.mktemp("host_kernels")
    libs = {"iq_convert": host_shim.build(
                d, "iq_convert", "template <class T>\nint launch(",
                K10_HOST_RUN),
            "fm_demod": host_shim.build(d, "fm_demod", "int grid(",
                                        K11_HOST_RUN)}
    P_, LL, I_ = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    libs["iq_convert"].host_iq_convert.argtypes = [P_, P_, LL, LL, I_, I_]
    libs["fm_demod"].host_fm_demod.argtypes = [P_, P_, P_, LL, LL, I_]
    return libs


def _rows(lead) -> int:
    return int(np.prod(lead, dtype=np.int64))


@pytest.mark.parametrize("fmt,planar", sorted(CONVERTS))
@pytest.mark.parametrize("n", [1, 7, 8, 9, 2047, 2048, 2049, 4101])
def test_k10_source_on_the_host_equals_plain_bitwise(host_builds, rng, fmt,
                                                     planar, n):
    """Every leading shape, each input base 0-15 bytes off 16-byte
    alignment (u8; i16 0-7 elements), the output 0-3 floats off."""
    lib = host_builds["iq_convert"]
    offsets = range(16) if fmt == "u8" else range(8)
    for lead, off in itertools.product(LEADS, offsets):
        x = host_shim.offset(torch.from_numpy(_iq(rng, fmt, lead + (2 * n,))),
                             off)
        shape = lead + ((2, n) if planar else (2 * n,))
        y = host_shim.offset(torch.full(shape, np.nan), off % 4)
        lib.host_iq_convert(x.data_ptr(), y.data_ptr(), _rows(lead), n,
                            int(fmt == "i16"), int(planar))
        want = iq_convert.iq_convert_reference(x, planar)
        assert torch.equal(_bits(y).flatten(), _bits(want).flatten()), (
            lead, off)


@pytest.mark.parametrize("form", sorted(FORMS))
@pytest.mark.parametrize("n", [1, 7, 8, 9, 1023, 1024, 1025, 2053])
def test_k11_source_on_the_host_equals_plain(host_builds, rng, form, n):
    """Every leading shape, bases 0-3 floats off 16-byte alignment (0-1
    complex samples), zero and random carries: the polynomial bitwise,
    the atan2f forms within 2e-6 rad.  At n = 1025 and 2053 a row's
    second and third tiles start one sample into their window: the
    sample before each is the row's own (H3), and only a row's first
    output reads the carry."""
    lib = host_builds["fm_demod"]
    offsets = range(2) if form == "complex" else range(4)
    for lead, off, carry in itertools.product(LEADS, offsets,
                                              ("zero", "random")):
        xs, last = _demod_inputs(rng, form, lead, n)
        if carry == "zero":
            last = np.zeros_like(last)
        x = host_shim.offset(torch.from_numpy(xs), off)
        c = torch.from_numpy(last).contiguous()
        y = host_shim.offset(torch.full(lead + (n,), np.nan), off)
        lib.host_fm_demod(x.data_ptr(), c.data_ptr(), y.data_ptr(),
                          _rows(lead), n, FORMS[form])
        if form == "complex":
            want, _ = fm_demod.fm_demod_complex_reference(x, c)
        else:
            want, _ = fm_demod.fm_demod_planar_reference(x, c, atan2=form)
        if form == "poly":
            assert torch.equal(_bits(y), _bits(want)), (lead, off, carry)
        else:
            assert torch.isfinite(y).all()
            assert _angular(y.numpy(), want.numpy()) <= ANGLE, (lead, off)


@pytest.mark.parametrize("form", sorted(FORMS))
def test_k11_source_on_the_host_warmup_quadrants(host_builds, form):
    """H16 on the host build: 0, or pi where both parts of x[0] are
    negative (atan2f forms), 0 for the polynomial."""
    x, last = (torch.from_numpy(a) for a in _warmup_inputs(form))
    y = torch.full((4, 3), np.nan)
    host_builds["fm_demod"].host_fm_demod(x.data_ptr(), last.data_ptr(),
                                          y.data_ptr(), 4, 3, FORMS[form])
    want = [0.0, 0.0, np.pi, 0.0] if form != "poly" else [0.0] * 4
    np.testing.assert_array_equal(np.abs(y[:, 0].numpy()), np.float32(want))


# -- routing -------------------------------------------------------------


@pytest.fixture
def counted(monkeypatch):
    """Calls of the K10/K11 wrappers as the stream ops reach them."""
    calls = collections.Counter()
    for name in ("iq_convert", "fm_demod_planar", "fm_demod_complex"):
        real = getattr(stream_ops, name)

        def wrapper(*a, _name=name, _real=real, **kw):
            calls[_name] += 1
            return _real(*a, **kw)
        monkeypatch.setattr(stream_ops, name, wrapper)
    return calls


@pytest.mark.parametrize("op_cls,fmt", [(IqConvertU8, "u8"),
                                        (IqConvertI16, "i16")])
@pytest.mark.parametrize("planar", [False, True])
def test_convert_ops_call_k10(counted, rng, op_cls, fmt, planar):
    x = torch.from_numpy(_iq(rng, fmt, (3, 2 * 1000)))
    _, y = op_cls(planar, device="cpu").apply((), x)
    assert counted == {"iq_convert": 1}
    assert torch.equal(_bits(y), _bits(iq_convert.iq_convert_reference(
        x, planar)))


def test_i16_convert_casts_other_integer_types_first(rng):
    x = torch.from_numpy(_iq(rng, "i16", (2, 64)))
    op = IqConvertI16(planar=True, device="cpu")
    assert torch.equal(op.apply((), x.to(torch.int32))[1],
                       op.apply((), x)[1])
    with pytest.raises(ValueError, match="uint8"):
        IqConvertU8(device="cpu").apply((), x)


@pytest.mark.parametrize("form", ["poly", "exact", "complex"])
def test_fm_demod_op_calls_k11(counted, rng, form):
    planar = form != "complex"
    op = FmDemod(planar=planar, atan2="exact" if form == "complex" else form,
                 device="cpu")
    x, last = _demod_inputs(rng, form, (3,), 500)
    new, y = op.apply(torch.from_numpy(last), torch.from_numpy(x))
    assert counted == {"fm_demod_planar" if planar else "fm_demod_complex":
                       1}
    want, wnew = _port_demod(form, x, last)
    assert torch.equal(_bits(y), _bits(want))
    assert torch.equal(_bits(new), _bits(wnew))


def _broadcast(n_bytes, seed=7):
    """u8 IQ of an FM broadcast of a 1 kHz tone at 75 kHz deviation,
    1.28 MS/s, with a little noise."""
    n = n_bytes // 2
    phase = 75.0 * (1 - np.cos(2 * np.pi * 1e3 * np.arange(n) / 1.28e6))
    noise = np.random.default_rng(seed).normal(0, 0.01, (2, n))
    raw = np.empty(2 * n, np.uint8)
    raw[0::2] = np.clip(np.round((0.9 * np.cos(phase) + noise[0]) * 128
                                 + 128), 0, 255)
    raw[1::2] = np.clip(np.round((0.9 * np.sin(phase) + noise[1]) * 128
                                 + 128), 0, 255)
    return raw


def _peak_close(got, want, rtol):
    peak = np.abs(want).max(axis=-1, keepdims=True)
    return bool((np.abs(got - want) <= rtol * peak).all())


# name: (the port's chain, the JAX chain, input, blocks, limit, whether
# the limit is of each frame's peak, the wrappers' calls in one call)
ROUTED = {
    "exact": (lambda: chains.fm_chain(front="exact", device="cpu"),
              lambda: jchains.fm_chain(front="exact", fuse_back=True),
              "fm", 2, 1e-5, False,
              {"iq_convert": 1, "fm_demod_complex": 1}),
    "exact_planar": (
        lambda: chains.fm_chain(front="exact", planar=True, device="cpu"),
        lambda: jchains.fm_chain(front="exact", planar=True, fuse_back=True),
        "fm", 2, 1e-5, False, {"iq_convert": 1, "fm_demod_planar": 1}),
    "stereo": (
        lambda: chains.fm_chain(front="quantized", stereo=True,
                                deemphasis=75e-6, device="cpu"),
        lambda: jchains.fm_chain(front="quantized", stereo=True,
                                 deemphasis=75e-6, fuse_back=True),
        "fm", 2, 2e-5, False, {"fm_demod_planar": 1}),
    "am": (lambda: chains.am_chain(device="cpu"), jchains.am_chain,
           "am", 4, 1e-4, False, {"iq_convert": 1}),
    "waterfall": (lambda: chains.waterfall_chain(device="cpu"),
                  jchains.waterfall_chain, "wf", 2, 1e-5, True,
                  {"iq_convert": 1}),
    "waterfall_complex": (
        lambda: chains.waterfall_chain(planar=False, device="cpu"),
        lambda: jchains.waterfall_chain(planar=False), "wf", 2, 1e-5, True,
        {"iq_convert": 1}),
    "narrowband": (lambda: chains.channelizer_chain(4, device="cpu"),
                   lambda: jchains.channelizer_chain(4), "bank", 2, 1e-5,
                   False, {"fm_demod_complex": 1}),
}
INPUTS = {"fm": lambda: _broadcast(2 * 163_840),
          "am": lambda: _broadcast(4 * (1 << 15)),
          "wf": lambda: _broadcast(2 * (1 << 16)),
          "bank": lambda: jax_synthesize(4, 2 * 3_200, 1_280_000)}


@pytest.mark.parametrize("name", sorted(ROUTED))
def test_chain_on_the_wrappers_matches_jax(counted, name):
    port, jax_ops, inp, nb, limit, peak, calls = ROUTED[name]
    x = INPUTS[inp]()
    got = run_time_batched(port(), x, nb, device="cpu").numpy()
    assert counted == calls
    ops = jax_ops()
    want = np.asarray(jax.jit(lambda v: jax_run_time_batched(ops, v, nb))(x))
    assert got.shape == want.shape
    assert np.isfinite(got).all()
    if peak:
        assert _peak_close(got, want, limit)
    else:
        np.testing.assert_allclose(got, want, rtol=0, atol=limit)
