"""K12 (the linear AGC's affine scan) and K13 (one IIR section) on the
CPU, where their wrappers take the plain versions; their CUDA sources
compiled for the host with ``g++`` under tests/torch_host_shim.py; the
routing of ``Agc``, ``DcBlocker`` and ``Iir`` through the wrappers; and
``IqConvertU8`` on int8 bytes (D2).

* The plain versions against the JAX package (jitted on the CPU) at the
  present limits: ``agc_gains``, ``agc_affine`` and the planar AGC 1e-5
  (``A`` relative 1e-5), ``dc_blocker``, ``linear_recurrence`` at p = 1
  and 2 and the de-emphasis ``biquad`` 1e-5 (tests/test_torch_am.py,
  tests/test_torch_stereo.py).
* The host builds of ``csrc/agc_linear.cu`` and ``csrc/iir.cu`` through
  their own launch functions (one launch each: tickets in waves of rows,
  tests/torch_host_shim.py running a block's threads and shuffles), at
  ``chip_smoke.py``'s geometries (rows 1-5 and 32, n from 1 to past two
  reduce folds and below a sub-chunk or a multiple of none of 32, 128
  and a tile, inputs off 16-byte alignment, seeded entering states,
  ``mu*|x|`` near 1, sections with ``a_2 != 0``), over more rows than a
  wave (a build with waves of 32 KB), K12's row doubling past shared
  memory, and 65,536 rows (refused): K12 bitwise its plain version, K13
  within 1e-5 of each row's peak |y| (its recurrence runs in float64,
  the plain version's in blocked f32 products) with its final-state
  launch bitwise the full launch's state; each bitwise across two runs
  and across wave sizes.  Every K12 and K13 variant of
  ``kernel_variants`` builds and runs for the host.
* A block-parallel AM call reaches K12 twice (the reduce in
  ``Agc.shard_carry``, the scan in ``Agc.apply``) and K13 twice (the
  ``DcBlocker``'s final state and its output), a streamed block once
  each; stereo reaches K13 twice; each chain within its limit of the JAX
  package's (AM 1e-4, stereo 2e-5).
* int8 IQ through ``IqConvertU8`` equals the JAX package's (which reads
  the bytes' u8 patterns), bitwise, planar and complex.
"""

import ctypes

import numpy as np
import pytest
import torch

import jax

import torch_host_shim as host_shim

from sdr_tpu.apps import chains as jchains
from sdr_tpu.ops import iir as jiir
from sdr_tpu.ops import scans as jscans
from sdr_tpu.parallel.sharded import run_time_batched as jax_run_time_batched
from sdr_tpu.stream import IqConvertU8 as JaxIqConvertU8

from sdr_tpu_torch import kernel_variants
from sdr_tpu_torch.apps import chains
from sdr_tpu_torch.kernels import KERNELS, agc_linear, iir
from sdr_tpu_torch.kernels._build import CSRC
from sdr_tpu_torch.ops import iir as ops_iir
from sdr_tpu_torch.ops import scans
from sdr_tpu_torch.parallel.sharded import run_time_batched
from sdr_tpu_torch.stream import IqConvertU8, Pipeline

ATOL = 1e-5
AM_ATOL = 1e-4
STEREO_ATOL = 2e-5
DEEMPH = jiir.deemphasis_taps(48_000, 75e-6)
# (feed-forward taps, feedback coefficients): the DC blocker, the
# de-emphasis, a section with a_2 != 0
SECTIONS = [((1.0, -1.0), (0.997,)),
            (tuple(DEEMPH[0]), (-float(DEEMPH[1][1]), 0.0)),
            ((0.2, 0.3, 0.1), (1.2, -0.5))]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs in several worker processes
    (pytest-xdist), where PyTorch's idle OpenMP workers spinning would
    cost the other workers the CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _bits(t):
    return t.contiguous().view(torch.int32)


def _planar_iq(rng, shape, lo=0.0, hi=2.0):
    """Planar I/Q ``shape + [2, n]``... of magnitudes in [lo, hi) at
    random phases."""
    mag = rng.uniform(lo, hi, shape)
    ang = rng.uniform(0, 2 * np.pi, shape)
    return np.stack([mag * np.cos(ang), mag * np.sin(ang)],
                    axis=-2).astype(np.float32)


# -- the plain versions against the JAX package ---------------------------


@pytest.mark.parametrize("n", [1, 128, 3000])
def test_agc_plain_versions_match_jax(rng, n):
    m = rng.uniform(0, 2, (3, n)).astype(np.float32)
    g0 = rng.uniform(0.5, 2, 3).astype(np.float32)
    g, f = agc_linear.agc_gains(torch.from_numpy(m), 0.005, 1.0,
                                torch.from_numpy(g0))
    jg, jf = jax.jit(lambda v, s: jscans.agc_gains(v, 0.005, 1.0, s))(m, g0)
    np.testing.assert_allclose(g.numpy(), np.asarray(jg), rtol=0, atol=ATOL)
    np.testing.assert_allclose(f.numpy(), np.asarray(jf), rtol=0, atol=ATOL)
    A, B = agc_linear.agc_affine(torch.from_numpy(m), 0.005, 1.0)
    jA, jB = jax.jit(lambda v: jscans.agc_affine(v, 0.005, 1.0))(m)
    np.testing.assert_allclose(A.numpy(), np.asarray(jA), rtol=1e-5)
    np.testing.assert_allclose(B.numpy(), np.asarray(jB), rtol=0, atol=ATOL)
    # the planar form: the envelope taken inside, both planes scaled
    x = _planar_iq(rng, (3, n))
    env = np.sqrt(x[:, 0] ** 2 + x[:, 1] ** 2)
    y, f = agc_linear.agc_apply(torch.from_numpy(x), 0.005, 1.0,
                                torch.from_numpy(g0))
    jg, jf = jax.jit(lambda v, s: jscans.agc_gains(v, 0.005, 1.0, s))(env,
                                                                      g0)
    np.testing.assert_allclose(y.numpy(), x * np.asarray(jg)[:, None],
                               rtol=0, atol=ATOL)
    np.testing.assert_allclose(f.numpy(), np.asarray(jf), rtol=0, atol=ATOL)
    A, B = agc_linear.agc_affine(torch.from_numpy(x), 0.005, 1.0,
                                 planar=True)
    jA, jB = jax.jit(lambda v: jscans.agc_affine(v, 0.005, 1.0))(env)
    np.testing.assert_allclose(A.numpy(), np.asarray(jA), rtol=1e-5)
    np.testing.assert_allclose(B.numpy(), np.asarray(jB), rtol=0, atol=ATOL)


def test_agc_plain_versions_at_the_empty_row():
    """n = 0: no gain is applied, the gain passes through, the map is the
    identity."""
    g0 = torch.tensor([1.5, 0.5])
    g, f = agc_linear.agc_gains(torch.zeros((2, 0)), 0.005, 1.0, g0)
    assert g.shape == (2, 0) and torch.equal(f, g0)
    y, f = agc_linear.agc_apply(torch.zeros((2, 2, 0)), 0.005, 1.0, g0)
    assert y.shape == (2, 2, 0) and torch.equal(f, g0)
    A, B = agc_linear.agc_affine(torch.zeros((2, 0)), 0.005, 1.0)
    assert torch.equal(A, torch.ones(2)) and torch.equal(B, torch.zeros(2))


def test_planar_envelope_is_correctly_rounded(rng):
    """The plain version's root is the f32 root of the f32 sum, rounded
    once (the kernel's ``__fsqrt_rn``)."""
    x = torch.from_numpy(_planar_iq(rng, (4, 5000)))
    s = (x[:, 0] * x[:, 0] + x[:, 1] * x[:, 1]).numpy()
    want = np.sqrt(s.astype(np.float64)).astype(np.float32)
    assert np.array_equal(agc_linear.envelope(x).numpy(), want)


def test_dc_blocker_matches_jax(rng):
    x = (rng.uniform(-1, 1, (2, 3000)) + 0.3).astype(np.float32)
    ls, lo = np.float32([0.1, -0.2]), np.float32([0.5, 0.0])
    y, (ns, no) = scans.dc_blocker(torch.from_numpy(x), torch.from_numpy(ls),
                                   torch.from_numpy(lo))
    jy, (jns, jno) = jax.jit(jscans.dc_blocker)(x, ls, lo)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=0, atol=ATOL)
    np.testing.assert_allclose(no.numpy(), np.asarray(jno), rtol=0,
                               atol=ATOL)
    np.testing.assert_array_equal(ns.numpy(), np.asarray(jns))
    # only the carries: the same ones
    none, (ns2, no2) = scans.dc_blocker(torch.from_numpy(x),
                                        torch.from_numpy(ls),
                                        torch.from_numpy(lo), store=False)
    assert none is None
    assert torch.equal(ns2, ns) and torch.equal(no2, no)


@pytest.mark.parametrize("b,coeffs", SECTIONS[1:] + [((0.5, 0.25), (0.9,))])
def test_iir_section_plain_version_matches_jax(rng, b, coeffs):
    """The section's plain version (its drive, then ``linear_recurrence``)
    at p = 1 and 2 against the JAX package's ``linear_recurrence`` over
    the same drive, from entering inputs and states."""
    p = len(coeffs)
    x = rng.normal(size=(3, 2048)).astype(np.float32)
    xin = rng.normal(size=(3, 2)).astype(np.float32)
    s0 = rng.normal(size=(3, p)).astype(np.float32)
    y, s = iir.iir_section(torch.from_numpy(x), b, coeffs,
                           torch.from_numpy(xin), torch.from_numpy(s0))
    xp = np.concatenate([xin, x], axis=-1)
    bb = np.float32(b + (0.0,) * (3 - len(b)))
    drive = (bb[0] * xp[..., 2:] + bb[1] * xp[..., 1:-1]
             + bb[2] * xp[..., :-2])
    want = np.asarray(jax.jit(lambda u, v: jiir.linear_recurrence(
        np.float32(coeffs), u, v))(drive, s0))
    np.testing.assert_allclose(y.numpy(), want, rtol=0, atol=ATOL)
    np.testing.assert_allclose(s.numpy(), want[:, ::-1][:, :p], rtol=0,
                               atol=ATOL)
    # p = 2 leaves a short row's older state in the state after it
    if p == 2:
        _, s1 = iir.iir_section(torch.from_numpy(x[:, :1]), b, coeffs,
                                torch.from_numpy(xin), torch.from_numpy(s0))
        assert torch.equal(s1[:, 1], torch.from_numpy(s0[:, 0]))


def test_deemphasis_biquad_matches_jax(rng):
    """The de-emphasis ``biquad`` (ops/iir.py) and the same section through
    K13's plain version, both against the JAX package's ``biquad``."""
    x = rng.normal(size=(2, 4096)).astype(np.float32)
    b, a = DEEMPH
    want = np.asarray(jax.jit(lambda v: jiir.biquad(b, a, v))(x))
    got = ops_iir.biquad(b, a, torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL)
    y, _ = iir.iir_section(torch.from_numpy(x), *SECTIONS[1],
                           torch.zeros((2, 2)), torch.zeros((2, 2)))
    np.testing.assert_allclose(y.numpy(), want, rtol=0, atol=ATOL)


# -- the refusals ---------------------------------------------------------


def _f32(*shape, device="cpu"):
    return torch.ones(shape, device=device)


def _k12_calls(device):
    return [
        lambda: agc_linear.agc_affine(_f32(2, 64, device=device), 0.005,
                                      1.0),
        lambda: agc_linear.agc_gains(_f32(2, 64, device=device), 0.005, 1.0,
                                     _f32(2, device=device)),
        lambda: agc_linear.agc_apply(_f32(2, 2, 64, device=device), 0.005,
                                     1.0, _f32(2, device=device)),
    ]


def _k13_call(device):
    return lambda: iir.iir_section(_f32(2, 64, device=device), (1.0, -1.0),
                                   (0.997,), _f32(2, 2, device=device),
                                   _f32(2, 1, device=device))


@pytest.mark.parametrize("make", [lambda d: _k12_calls(d)[0],
                                  lambda d: _k12_calls(d)[1],
                                  lambda d: _k12_calls(d)[2], _k13_call])
def test_wrappers_refuse_a_meta_device(make):
    with pytest.raises(ValueError, match="unsupported device"):
        make("meta")()


REFUSED = [
    (lambda: agc_linear.agc_gains(torch.ones((2, 64), dtype=torch.float64),
                                  0.005, 1.0, _f32(2)), "float32"),
    (lambda: agc_linear.agc_gains(_f32(2, 64), 0.005, 1.0, _f32(3)),
     "leading dims"),
    (lambda: agc_linear.agc_gains(_f32(2, 64), 0.005, 1.0,
                                  torch.ones(2, device="meta")), "device"),
    (lambda: agc_linear.agc_apply(_f32(2, 3, 64), 0.005, 1.0, _f32(2)),
     "planar"),
    (lambda: agc_linear.agc_affine(torch.ones((2, 64), dtype=torch.int32),
                                   0.005, 1.0), "float32"),
    (lambda: iir.iir_section(_f32(2, 64), (1.0,), (0.997,), _f32(2, 2),
                             _f32(2, 1)), "2 or 3 taps"),
    (lambda: iir.iir_section(_f32(2, 64), (1.0, -1.0), (0.5, 0.2, 0.1),
                             _f32(2, 2), _f32(2, 3)), "order"),
    (lambda: iir.iir_section(_f32(2, 64), (1.0, -1.0), (0.997,),
                             _f32(2, 3), _f32(2, 1)), "xin"),
    (lambda: iir.iir_section(_f32(2, 64), (1.0, -1.0), (0.9, 0.1),
                             _f32(2, 2), _f32(2, 1)), "s0"),
    (lambda: iir.iir_section(torch.ones((2, 64), dtype=torch.float64),
                             (1.0, -1.0), (0.997,), _f32(2, 2), _f32(2, 1)),
     "float32"),
    (lambda: iir.iir_section(_f32(2, 64), (1.0, -1.0), (0.997,),
                             _f32(2, 2, device="meta"), _f32(2, 1)),
     "share a device"),
]


@pytest.mark.parametrize("call,match", REFUSED)
def test_wrappers_refuse(call, match):
    with pytest.raises(ValueError, match=match):
        call()


def test_kernels_hold_k12_and_k13():
    assert KERNELS[11] is agc_linear.KERNEL and KERNELS[12] is iir.KERNEL
    assert agc_linear.KERNEL.source == CSRC / "agc_linear.cu"
    assert iir.KERNEL.source == CSRC / "iir.cu"
    assert set(agc_linear.KERNEL.functions) == {"launch_agc_linear_reduce",
                                                "launch_agc_linear_scan"}
    assert set(iir.KERNEL.functions) == {"launch_iir_section"}


# -- the CUDA sources, built for the host --------------------------------


# The wave constants of the sources, and a wave of 32 KB of input in their
# place: waves of one to a few short rows, whose tickets interleave one
# wave's first pass with the output pass of the wave before
WAVE = {"agc_linear": kernel_variants.WAVE_K12,
        "iir": kernel_variants.WAVE_K13}
SMALL_WAVE = "constexpr long long kWaveBytes = 1LL << 15;"
# chunk maps K12's row doubling holds in shared memory (kRowCap)
ROW_CAP = 4_096 + 4_096 // 32 + 1


def _bind(lib, kernel):
    for fn, types in kernel.functions.items():
        getattr(lib, fn).argtypes = [*types, ctypes.c_void_p]
    return lib


@pytest.fixture(scope="module")
def host_builds(tmp_path_factory):
    """K12's and K13's sources as committed (``agc_linear``, ``iir``) and
    with waves of 32 KB (``..._waves``), built for the host."""
    d = tmp_path_factory.mktemp("host_recurrences")
    libs = {}
    for name, mod in (("agc_linear", agc_linear), ("iir", iir)):
        libs[name] = _bind(host_shim.build_source(d, name), mod.KERNEL)
        libs[name + "_waves"] = _bind(host_shim.build_source(
            d, name, [(WAVE[name], SMALL_WAVE)], "_waves"), mod.KERNEL)
    return libs


def _host_k12(lib, x, mu, g0=None, planar=False, rows=None):
    """The host build through its launch functions, as the wrapper calls
    them: ``(A, B)`` without ``g0``, else the scan's outputs.  ``rows``
    overrides the launch's row count (the return code is then returned,
    not checked)."""
    lead = x.shape[:-2] if planar else x.shape[:-1]
    n = x.shape[-1]
    real = int(np.prod(lead, dtype=np.int64))
    count = real if rows is None else rows
    mu32, muref = agc_linear._coeffs(mu, 1.0)
    if g0 is None:
        A, B = torch.full(lead, np.nan), torch.full(lead, np.nan)
        floats, tiles = 0, -(-n // agc_linear.REDUCE_TILE)
        while tiles > 1:
            floats += 2 * real * tiles
            tiles = -(-tiles // agc_linear.REDUCE_TILE)
        scratch = torch.full((max(floats, 1),), np.nan)
        rc = lib.launch_agc_linear_reduce(
            x.data_ptr(), A.data_ptr(), B.data_ptr(), scratch.data_ptr(),
            floats, count, n, mu32, muref, int(planar), None)
        if rows is not None:
            return rc
        assert rc == 0
        return A, B
    out, final = torch.full_like(x, np.nan), torch.full_like(g0, np.nan)
    floats = agc_linear.scan_scratch_floats(real, n)
    scratch = torch.full((floats,), np.nan)
    rc = lib.launch_agc_linear_scan(
        x.data_ptr(), g0.data_ptr(), out.data_ptr(), final.data_ptr(),
        scratch.data_ptr(), floats, count, n, mu32, muref, int(planar), None)
    if rows is not None:
        return rc
    assert rc == 0
    return out, final


# chip_smoke.py's K12 geometries, cut to the shim's pace: rows 1, 2, 5
# and 32, n about the sub-chunk (32), the chunk (128), a block's tile
# (4,096) and past one and two reduce tiles (4,096), and n below a
# sub-chunk or a multiple of none of them
K12_GEOMETRIES = ([(r, n) for r in (1, 2, 5)
                   for n in (1, 2, 127, 128, 129, 255, 257)]
                  + [(32, 129), (3, 4_097), (1, 2 * 128 * 20 + 1),
                     (1, 5), (2, 33), (3, 77), (2, 4_096 + 33), (1, 8_193)])


def _k12_inputs(rng, rows, n, lo=0.0, hi=2.0):
    """Planar I/Q and envelopes ``[rows, (2,) n]`` of magnitudes in [lo,
    hi), and entering gains."""
    xp = torch.from_numpy(_planar_iq(rng, (rows, n), lo, hi))
    m = torch.from_numpy(rng.uniform(lo, hi, (rows, n)).astype(np.float32))
    g0 = torch.from_numpy(rng.uniform(0.5, 2, rows).astype(np.float32))
    return xp, m, g0


def _same_bits(got, want):
    return all(torch.equal(_bits(a), _bits(b)) for a, b in zip(got, want))


@pytest.mark.parametrize("mu,lo,hi,geometries", [
    (0.005, 0.0, 2.0, K12_GEOMETRIES),
    (0.5, 1.9, 1.999, [(1, 129), (2, 257), (3, 4_097)])])
def test_k12_source_on_the_host_equals_plain_bitwise(host_builds, mu, lo,
                                                     hi, geometries):
    """Both modes, over planar I/Q and over envelopes, the input 0-3
    floats off 16-byte alignment, seeded entering gains; ``mu*|x|``
    typical and near 1 (up to 0.9995, at a few geometries).  Unwritten
    outputs would stay NaN."""
    lib = host_builds["agc_linear"]
    rng = np.random.default_rng(16)
    for rows, n in geometries:
        off = (rows + n) % 4
        xp, m, g0 = _k12_inputs(rng, rows, n, lo, hi)
        for x, planar in ((xp, True), (m, False)):
            xo = host_shim.offset(x, off)
            got = _host_k12(lib, xo, mu, planar=planar)
            want = agc_linear.agc_affine_reference(x, mu, 1.0, planar)
            assert _same_bits(got, want), ("reduce", rows, n)
            got = _host_k12(lib, xo, mu, g0, planar)
            plain = (agc_linear.agc_apply_reference if planar
                     else agc_linear.agc_gains_reference)
            want = plain(x, mu, 1.0, g0)
            assert _same_bits(got, want), ("scan", rows, n)


@pytest.mark.parametrize("planar", [True, False])
def test_k12_source_on_the_host_row_doubling_in_scratch(host_builds,
                                                        planar):
    """A row of more chunk maps than the shared-memory doubling holds:
    the row's doubling runs in place in scratch, bitwise the plain
    version."""
    rng = np.random.default_rng(19)
    xp, m, g0 = _k12_inputs(rng, 1, 128 * ROW_CAP + 77)
    x = xp if planar else m
    plain = (agc_linear.agc_apply_reference if planar
             else agc_linear.agc_gains_reference)
    got = _host_k12(host_builds["agc_linear"], x, 0.005, g0, planar)
    assert _same_bits(got, plain(x, 0.005, 1.0, g0))


def _peak_rel(y, ref):
    peak = ref.abs().amax(-1, keepdim=True).clamp_min(1e-30)
    return ((y - ref).abs() / peak).max().item()


def _host_k13(lib, x, b, coeffs, xin, s0, store=True, rows=None):
    """The host build as the wrapper calls it: ``(y, s_out)``; ``rows``
    overrides the launch's row count (the return code is then
    returned)."""
    b, coeffs = iir._taps(b, coeffs)
    p, n = coeffs.shape[0], x.shape[-1]
    real = int(np.prod(x.shape[:-1], dtype=np.int64))
    y = torch.full_like(x, np.nan) if store else None
    s_out = torch.full_like(s0, np.nan)
    doubles = iir.scratch_doubles(real, n, p)
    scratch = torch.full((doubles,), np.nan, dtype=torch.float64)
    params = iir._params(b, tuple(float(c) for c in coeffs))
    rc = lib.launch_iir_section(
        x.data_ptr(), xin.data_ptr(), s0.data_ptr(),
        y.data_ptr() if store else None, s_out.data_ptr(),
        scratch.data_ptr(), doubles, real if rows is None else rows, n, p,
        params.ctypes.data_as(ctypes.c_void_p),
        params[6:].ctypes.data_as(ctypes.c_void_p), int(store), None)
    if rows is not None:
        return rc
    assert rc == 0
    return y, s_out


def _k13_inputs(rng, rows, n, p):
    return tuple(torch.from_numpy(rng.normal(size=shape).astype(np.float32))
                 for shape in ((rows, n), (rows, 2), (rows, p)))


@pytest.mark.parametrize("section", range(len(SECTIONS)))
def test_k13_source_on_the_host_within_its_limit(host_builds, section):
    """Each section at rows 1-5 and 32, n about a thread's run (32) and a
    block's tile (4,096) and past two tiles, below a run and a multiple
    of neither, the input 0-3 floats off 16-byte alignment, seeded
    entering inputs and states: y and the state after the row within 1e-5
    of each row's peak |y| of the plain version; the final-state launch's
    state bitwise the full launch's."""
    lib = host_builds["iir"]
    b, coeffs = SECTIONS[section]
    rng = np.random.default_rng(17 + section)
    for rows, n in [(r, n) for r in (1, 2, 3, 4, 5)
                    for n in (1, 2, 31, 32, 33, 4_095, 4_097)] + [
            (32, 33), (2, 2 * 4_096 * 3 + 1), (1, 5), (2, 77),
            (3, 4_096 + 33), (1, 8_192), (2, 8_193)]:
        x, xin, s0 = _k13_inputs(rng, rows, n, len(coeffs))
        xo = host_shim.offset(x, (rows + n) % 4)
        y, s = _host_k13(lib, xo, b, coeffs, xin, s0)
        ry, rs = iir.iir_section_reference(x, b, coeffs, xin, s0)
        assert _peak_rel(torch.cat([y, s], -1),
                         torch.cat([ry, rs], -1)) <= 1e-5, (rows, n)
        _, s_only = _host_k13(lib, xo, b, coeffs, xin, s0, store=False)
        assert torch.equal(_bits(s_only), _bits(s)), (rows, n)


def test_k13_source_on_the_host_over_an_am_row(host_builds):
    """The DC blocker over a whole row of the AM path's length (327,677)
    of an AGC'd envelope: the pole at 0.997 carries each rounding over
    some 333 samples, and the worst sample stays within 1e-5 of the row's
    peak."""
    lib = host_builds["iir"]
    n = 327_677
    t = np.arange(n)
    rng = np.random.default_rng(18)
    x = torch.from_numpy((1 + 0.4 * np.sin(2 * np.pi * 500 / 80_000 * t)
                          + 0.01 * rng.standard_normal(n)).astype(
        np.float32))[None]
    xin, s0 = torch.zeros((1, 2)), torch.zeros((1, 1))
    y, s = _host_k13(lib, x, *SECTIONS[0], xin, s0)
    ry, rs = iir.iir_section_reference(x, *SECTIONS[0], xin, s0)
    assert _peak_rel(torch.cat([y, s], -1), torch.cat([ry, rs], -1)) <= 1e-5


@pytest.mark.parametrize("rows,n", [(7, 4_097), (5, 9_000), (1, 4_097)])
def test_k12_source_on_the_host_over_waves(host_builds, rows, n):
    """More rows than one wave (the 32 KB build: one or two of these rows
    a wave, so first and output passes of neighbouring waves interleave)
    and one row: the scan bitwise its plain version, bitwise the
    committed build (one wave: the waves order the tickets, not the
    arithmetic), and two runs bitwise equal."""
    rng = np.random.default_rng(20 + rows)
    xp, m, g0 = _k12_inputs(rng, rows, n)
    for x, planar in ((xp, True), (m, False)):
        plain = (agc_linear.agc_apply_reference if planar
                 else agc_linear.agc_gains_reference)
        want = plain(x, 0.005, 1.0, g0)
        runs = [_host_k12(host_builds[lib], x, 0.005, g0, planar)
                for lib in ("agc_linear_waves", "agc_linear_waves",
                            "agc_linear")]
        assert all(_same_bits(got, want) for got in runs), (rows, n, planar)


@pytest.mark.parametrize("rows,n", [(7, 4_097), (5, 9_000), (1, 4_097)])
def test_k13_source_on_the_host_over_waves(host_builds, rows, n):
    """As for K12: the 32 KB build over more rows than a wave and over one
    row, for the DC blocker and the a_2 != 0 section, within 1e-5 of the
    plain version, bitwise the committed build and across two runs, and
    the final-state launch bitwise the full launch's state."""
    rng = np.random.default_rng(30 + rows)
    for b, coeffs in (SECTIONS[0], SECTIONS[2]):
        x, xin, s0 = _k13_inputs(rng, rows, n, len(coeffs))
        ry, rs = iir.iir_section_reference(x, b, coeffs, xin, s0)
        runs = [_host_k13(host_builds[lib], x, b, coeffs, xin, s0)
                for lib in ("iir_waves", "iir_waves", "iir")]
        y, s = runs[0]
        assert _peak_rel(torch.cat([y, s], -1),
                         torch.cat([ry, rs], -1)) <= 1e-5, (rows, n)
        assert all(_same_bits(got, runs[0]) for got in runs[1:]), (rows, n)
        _, s_only = _host_k13(host_builds["iir_waves"], x, b, coeffs, xin,
                              s0, store=False)
        assert torch.equal(_bits(s_only), _bits(s)), (rows, n)


# kernel_variants' K12 and K13 variants that keep the committed
# arithmetic (every wave size, the registers' bound, streaming stores,
# the sub-chunk level through shared memory) or leave it alone where the
# blocks run in turn (no waits)
SAME_BITS = {"agc_one_wave", "agc_wave2", "agc_wave8", "agc_smem_level2",
             "agc_bounds5", "agc_bounds6", "agc_stream_stores", "agc_no_wait",
             "iir_one_wave", "iir_wave2", "iir_wave32", "iir_stream_stores",
             "iir_bounds8", "iir_bounds10", "iir_no_wait"}


@pytest.mark.parametrize("name", sorted(
    n for n, (targets, _) in kernel_variants.VARIANTS.items()
    if targets[0] in ("agc_linear", "iir")))
def test_recurrence_variants_build_and_run_on_the_host(tmp_path, name):
    """Each K12 and K13 variant of ``kernel_variants`` builds for the host
    and runs over 3 rows of 9,000 samples: bitwise the committed kernel
    where it keeps its arithmetic, K13's serial chain (the first design)
    within 1e-5 of each row's peak of the plain version."""
    (target,), patches = kernel_variants.VARIANTS[name]
    mod = {"agc_linear": agc_linear, "iir": iir}[target]
    lib = _bind(host_shim.build_source(tmp_path, target, patches), mod.KERNEL)
    rng = np.random.default_rng(40)
    if target == "agc_linear":
        xp, _, g0 = _k12_inputs(rng, 3, 9_000)
        got = _host_k12(lib, xp, 0.005, g0, True)
        if name in SAME_BITS:
            assert _same_bits(got, agc_linear.agc_apply_reference(
                xp, 0.005, 1.0, g0))
        return
    x, xin, s0 = _k13_inputs(rng, 3, 9_000, 2)
    got = _host_k13(lib, x, *SECTIONS[2], xin, s0)
    if name in SAME_BITS:
        committed = _bind(host_shim.build_source(tmp_path, "iir",
                                                 tag="_committed"), iir.KERNEL)
        assert _same_bits(got, _host_k13(committed, x, *SECTIONS[2], xin,
                                         s0))
    elif name == "iir_serial_runs":
        ry, rs = iir.iir_section_reference(x, *SECTIONS[2], xin, s0)
        assert _peak_rel(torch.cat(got, -1), torch.cat([ry, rs], -1)) <= 1e-5


def test_sources_on_the_host_refuse_rows_past_the_grid(host_builds):
    """65,536 rows: each launch function refuses before touching a
    buffer (the wrappers refuse them first, kernels/_build.py)."""
    x, g0 = torch.ones((1, 2, 1)), torch.ones(1)
    lib = host_builds["agc_linear"]
    assert _host_k12(lib, x, 0.005, planar=True, rows=65_536) != 0
    assert _host_k12(lib, x, 0.005, g0, planar=True, rows=65_536) != 0
    x, xin, s0 = torch.ones((1, 1)), torch.zeros((1, 2)), torch.zeros((1, 1))
    assert _host_k13(host_builds["iir"], x, *SECTIONS[0], xin, s0,
                     rows=65_536) != 0


def test_k13_section_chains_cascade_to_sosfilt(rng):
    """Two sections in turn, each from a zero state, are ``sosfilt``."""
    sos = np.array([[*SECTIONS[1][0], 1.0, -SECTIONS[1][1][0], 0.0],
                    [0.2, 0.3, 0.1, 1.0, -1.2, 0.5]], np.float32)
    x = torch.from_numpy(rng.normal(size=(3, 3000)).astype(np.float32))
    z = torch.zeros((3, 2))
    y = x
    for b, coeffs in (SECTIONS[1], SECTIONS[2]):
        y, _ = iir.iir_section(y, b, coeffs, z, z)
    assert torch.equal(y, ops_iir.sosfilt(sos, x))


# -- the routing ------------------------------------------------------------


@pytest.fixture
def counted(monkeypatch):
    """Count the calls of K12's and K13's wrappers (each a launch on the
    card), wherever the ops reach them."""
    calls = {}
    for mod, names in ((agc_linear, ("agc_affine", "agc_gains",
                                     "agc_apply")),
                       (iir, ("iir_section",))):
        for name in names:
            real = getattr(mod, name)

            def wrapper(*a, _name=name, _real=real, **kw):
                calls[_name] = calls.get(_name, 0) + 1
                return _real(*a, **kw)
            monkeypatch.setattr(mod, name, wrapper)
    return calls


def _am_raw(n_bytes, seed=7):
    """u8 IQ of an AM carrier at a quarter of the rate, 40 % modulated by
    a slow tone, with noise (tests/test_torch_am.py's signal)."""
    n = n_bytes // 2
    rng = np.random.default_rng(seed)
    t = np.arange(n)
    iq = (0.5 + 0.4 * np.sin(2 * np.pi * 0.001 * t)) * np.exp(
        2j * np.pi * 0.25 * t) + 0.01 * (rng.standard_normal(n)
                                         + 1j * rng.standard_normal(n))
    raw = np.empty(2 * n, np.uint8)
    raw[0::2] = np.clip(np.round(iq.real * 100 + 128), 0, 255)
    raw[1::2] = np.clip(np.round(iq.imag * 100 + 128), 0, 255)
    return raw


def _fm_raw(n_bytes, seed=7):
    """u8 IQ of an FM broadcast of a 1 kHz tone at 75 kHz deviation."""
    n = n_bytes // 2
    phase = 75.0 * (1 - np.cos(2 * np.pi * 1e3 * np.arange(n) / 1.28e6))
    noise = np.random.default_rng(seed).normal(0, 0.01, (2, n))
    raw = np.empty(2 * n, np.uint8)
    raw[0::2] = np.clip(np.round((0.9 * np.cos(phase) + noise[0]) * 128
                                 + 128), 0, 255)
    raw[1::2] = np.clip(np.round((0.9 * np.sin(phase) + noise[1]) * 128
                                 + 128), 0, 255)
    return raw


# name: (the port's chain, the JAX chain, input, blocks, limit, the
# wrappers' calls in one block-parallel call)
ROUTED = {
    "am": (lambda: chains.am_chain(device="cpu"), jchains.am_chain,
           lambda: _am_raw(4 * (1 << 15)), 4, AM_ATOL,
           {"agc_affine": 1, "agc_apply": 1, "iir_section": 2}),
    "am_complex": (lambda: chains.am_chain(planar=False, device="cpu"),
                   lambda: jchains.am_chain(planar=False),
                   lambda: _am_raw(4 * (1 << 15)), 4, AM_ATOL,
                   {"agc_affine": 1, "agc_gains": 1, "iir_section": 2}),
    "stereo": (
        lambda: chains.fm_chain(front="quantized", stereo=True,
                                deemphasis=75e-6, device="cpu"),
        lambda: jchains.fm_chain(front="quantized", stereo=True,
                                 deemphasis=75e-6, fuse_back=True),
        lambda: _fm_raw(2 * 163_840), 2, STEREO_ATOL, {"iir_section": 2}),
}


@pytest.mark.parametrize("name", sorted(ROUTED))
def test_chain_reaches_k12_and_k13_and_matches_jax(counted, name):
    port, jax_ops, make, nb, limit, calls = ROUTED[name]
    x = make()
    got = run_time_batched(port(), x, nb, device="cpu").numpy()
    assert counted == calls
    ops = jax_ops()
    want = np.asarray(jax.jit(lambda v: jax_run_time_batched(ops, v, nb))(x))
    assert got.shape == want.shape and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=0, atol=limit)


def test_streamed_am_block_reaches_k12_and_k13_once(counted):
    raw = _am_raw(2 * (1 << 15))
    pipe = Pipeline(chains.am_chain(device="cpu"), block_in=1 << 15,
                    device="cpu")
    blocks = list(pipe.run(torch.from_numpy(raw).split(1 << 15)))
    assert len(blocks) == 2
    assert counted == {"agc_apply": 2, "iir_section": 2}


# -- D2: IqConvertU8 on int8 bytes ----------------------------------------


@pytest.mark.parametrize("planar", [False, True])
def test_int8_iq_converts_as_its_u8_bytes_like_jax(rng, planar):
    x = rng.integers(-128, 128, (3, 2 * 1000)).astype(np.int8)
    _, got = IqConvertU8(planar, device="cpu").apply((), torch.from_numpy(x))
    op = JaxIqConvertU8(planar)
    want = np.array(jax.jit(lambda v: op.apply((), v)[1])(x))
    assert tuple(got.shape) == want.shape
    assert torch.equal(_bits(got), _bits(torch.from_numpy(want)))
    _, u8 = IqConvertU8(planar, device="cpu").apply(
        (), torch.from_numpy(x.view(np.uint8)))
    assert torch.equal(_bits(got), _bits(u8))
    with pytest.raises(ValueError, match="uint8"):
        IqConvertU8(planar, device="cpu").apply(
            (), torch.from_numpy(x.astype(np.int16)))

