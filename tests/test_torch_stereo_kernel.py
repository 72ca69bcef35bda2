"""K14 (``StereoDecode``'s pilot power and cascade) on the CPU, and the
decoder's constructor against the JAX package.

* The plain versions (``kernels/stereo_decode.py``): the L/R planes
  within 1e-5 of each row's peak of the decoder's former arithmetic (a
  product and a sum rounded apiece, the average as a filter) given the
  same gate; ``row_sum``, the FMA sums and the boxcar each in the
  kernel's order (checked against explicit loops over tiles, threads and
  levels, over taps through ``fma_f32``, and over quads).
* ``csrc/stereo_decode.cu`` compiled for the host with ``g++`` under
  ``tests/torch_host_shim.py`` (``persistent.cuh`` replaced by the
  shim's: two resident blocks, so each walks several tiles) and run block by block through its launch
  functions, as the wrappers call them: launch A (the lock, ``a``, ``b``,
  the written ``sq``) and launch B (gated and ungated, from that ``sq``)
  bitwise the plain versions at chip_smoke.py's geometries cut to the
  shim's pace: n < 192, n = 1, n % 4 != 0, a ragged tile, rows [B] and
  [B, C], a misaligned block, a history that is a slice of the previous
  block, signals that lock, unlock and hold in the hysteresis band from
  lock 0 and 1, and without the pilot lock; two launches bitwise equal.
* ``StereoDecode`` on the CPU against the JAX ``StereoDecode`` (jitted),
  streamed and through ``run_time_batched``, within 1e-5 with equal lock
  states, at the defaults and at other ``separation_gain``,
  ``pilot_floor``, ``lock_hi``/``lock_lo`` and ``pilot_lock=False``; and
  the refusal of ``lock_lo >= lock_hi``.
"""

import ctypes

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import torch_host_shim as host_shim

from sdr_tpu.parallel.sharded import run_time_batched as jax_run_time_batched
from sdr_tpu.stream import StereoDecode as JaxStereoDecode

from sdr_tpu_torch.kernels import KERNELS
from sdr_tpu_torch.kernels import stereo_decode as k14
from sdr_tpu_torch.kernels._build import CSRC
from sdr_tpu_torch.kernels._fma import fma_f32
from sdr_tpu_torch.kernels.fir import fir_strided_reference
from sdr_tpu_torch.parallel.sharded import run_time_batched
from sdr_tpu_torch.stream import Pipeline, StereoDecode

ATOL = 1e-5
FS = 160_000.0
COMP = 10_240                   # composite samples a block
NB = 4
F_L, F_R = 1_000.0, 400.0


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs in several worker processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def make_composite(n, pilot=0.1, stereo=True, t0=0):
    """The multiplex of tests/test_stereo.py: L = 1 kHz, R = 400 Hz."""
    t = (t0 + np.arange(n)) / FS
    L = np.sin(2 * np.pi * F_L * t)
    R = np.sin(2 * np.pi * F_R * t) if stereo else L
    comp = (0.5 * (L + R) / 2 + pilot * np.cos(2 * np.pi * 19_000 * t)
            + 0.5 * (L - R) / 2 * np.cos(2 * np.pi * 38_000 * t))
    return comp.astype(np.float32)


def marginal(n, t0=0):
    """r inside the hysteresis band: a weak pilot under a strong tone."""
    t = (t0 + np.arange(n)) / FS
    return (0.5 * np.sin(2 * np.pi * F_L * t)
            + 0.05 * np.cos(2 * np.pi * 19_000 * t)).astype(np.float32)


SIGNALS = {"lock": lambda n: make_composite(n),
           "unlock": lambda n: make_composite(n, pilot=0.0, stereo=False),
           "hold": marginal}


def _bits(t):
    return t.contiguous().view(torch.int32)


def former_decode(op, hist, x, gate):
    """The decoder's former arithmetic (six K3 plain versions and the
    glue), given the gate."""
    xe = torch.cat([hist, x], dim=-1)
    n, nt, d = x.shape[-1], xe.shape[-1], 32
    pilot = fir_strided_reference(op._taps[0], xe, nt - 2 * d)
    sq = pilot * pilot
    car = fir_strided_reference(op._taps[1], sq, nt - 4 * d)
    norm = fir_strided_reference(op._taps[2], sq, nt - 4 * d)
    car = car * norm / (norm * norm + op.pilot_floor ** 2)
    prod = xe[..., 2 * d: 2 * d + nt - 4 * d] * car
    diff = fir_strided_reference(op._taps[3], prod, nt - 6 * d)
    m = fir_strided_reference(op._taps[3], xe, n, 1, op.H - 4 * d)
    s = diff[..., :n] * op.gain
    if gate is not None:
        s = s * gate[..., None]
    return torch.stack([m + s, m - s], dim=-2)


# -- the plain versions ----------------------------------------------------


def _within_peak(got, want, tol=1e-5):
    """``|got - want|`` within ``tol`` of each row's peak ``|want|``."""
    err = (got - want).abs().flatten(-2).amax(-1)
    peak = want.abs().flatten(-2).amax(-1).clamp_min(1e-30)
    return bool((err <= tol * peak).all()), (err / peak).max().item()


@pytest.mark.parametrize("n", [1, 100, 5_000])
def test_plain_cascade_is_the_former_arithmetic(rng, n):
    """The FMA sums and the boxcar round otherwise than the former
    arithmetic (a product and a sum rounded apiece, the average a filter):
    within 1e-5 of each row's peak, not bitwise."""
    op = StereoDecode(FS, separation_gain=1.5, pilot_floor=3e-4,
                      device="cpu")
    hist = torch.from_numpy(rng.normal(size=(3, 192)).astype(np.float32))
    x = torch.from_numpy(rng.normal(size=(3, n)).astype(np.float32))
    gate = torch.tensor([1.0, 0.0, 1.0])
    sq = torch.empty(3, n + 128)
    k14.pilot_lock_reference(op._bp19, hist, x, None, op.lock_hi,
                             op.lock_lo, sq)
    for g in (gate, None):
        got = k14.stereo_decode(op._taps, hist, x, g, op.gain,
                                op.pilot_floor, sq)
        ok, worst = _within_peak(got, former_decode(op, hist, x, g))
        assert ok, worst
    got, new = k14.decode(op._taps, hist, x, None, op.gain, op.pilot_floor,
                          op.lock_hi, op.lock_lo)
    assert new is None
    ok, worst = _within_peak(got, former_decode(op, hist, x, None))
    assert ok, worst


@pytest.mark.parametrize("num,start", [(1, 0), (7, 3), (300, 64)])
def test_fma_sums_follow_the_kernel_order(rng, num, start):
    """Each output's taps in order from +0, each step ``fma_f32``."""
    taps = torch.from_numpy(rng.normal(size=65).astype(np.float32))
    v = torch.from_numpy(rng.normal(size=(2, start + num + 64))
                         .astype(np.float32))
    want = torch.zeros(2, num)
    for j in range(65):
        want = fma_f32(taps[j].expand(2, num),
                       v[:, start + j: start + j + num], want)
    got = k14.fir_fma_reference(taps, v, num, start)
    assert torch.equal(_bits(got), _bits(want))


@pytest.mark.parametrize("num", [1, 4, 6, 65, 130])
def test_boxcar_follows_the_quad_order(rng, num):
    """S[4m + j] from the quad's 62 shared terms, as the source writes it
    down; within a few ulp of the float64 sum."""
    sq = torch.from_numpy(rng.random((2, num + 64)).astype(np.float32))
    a = torch.tensor(1 / 65, dtype=torch.float32)
    got = k14.boxcar_reference(sq, num, a)
    v = torch.nn.functional.pad(sq, (0, 8))
    want = torch.empty(2, num)
    for k in range(num):
        b = k - k % 4
        c = v[:, b + 3]
        for o in range(4, 65):
            c = c + v[:, b + o]
        l2 = v[:, b + 2] + c
        l1 = v[:, b + 1] + l2
        s = (v[:, b] + l1, l1 + v[:, b + 65],
             (l2 + v[:, b + 65]) + v[:, b + 66],
             ((c + v[:, b + 65]) + v[:, b + 66]) + v[:, b + 67])[k % 4]
        want[:, k] = a * s
    assert torch.equal(_bits(got), _bits(want))
    exact = sq.double().unfold(-1, 65, 1)[:, :num].sum(-1) / 65
    # 64 adds and a scale, each within half an ulp: 66 x 2^-24 < 4e-6
    np.testing.assert_allclose(got.numpy(), exact.numpy(), rtol=4e-6)


@pytest.mark.parametrize("n", [1, 3_071, 3_072, 3_073, 9_000])
def test_row_sum_follows_the_kernel_order(rng, n):
    v = torch.from_numpy(rng.random((2, n)).astype(np.float32))
    want = torch.zeros(2)
    for k in range(0, n, k14.TILE):
        tile = torch.zeros(2, k14.TILE)
        tile[:, :min(k14.TILE, n - k)] = v[:, k:k + k14.TILE]
        part = torch.zeros(2, 256)
        for t in range(256):
            for g in range(3):
                for j in range(4):
                    part[:, t] = part[:, t] + tile[:, 4 * (t + 256 * g) + j]
        half = 256
        while half > 1:
            half //= 2
            for t in range(half):
                part[:, t] = part[:, t] + part[:, t + half]
        want = want + part[:, 0]
    assert torch.equal(_bits(k14.row_sum(v)), _bits(want))


# -- the source on the host ------------------------------------------------


# persistent.cuh as the host build takes it: the shim's, two resident
# blocks a launch
HEADERS = [('#include "persistent.cuh"', host_shim.persistent(2))]


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    lib = host_shim.build_source(
        tmp_path_factory.mktemp("stereo_decode"), "stereo_decode", HEADERS)
    for fn, types in k14.KERNEL.functions.items():
        getattr(lib, fn).argtypes = [*types, ctypes.c_void_p]
    return lib


def _p(t):
    return None if t is None else t.data_ptr()


def host_pilot_lock(lib, bp19, hist, x, lock, hi, lo, sq=None):
    """Launch A of the host build, as ``pilot_lock`` calls it."""
    n = x.shape[-1]
    rows = int(np.prod(x.shape[:-1], dtype=np.int64))
    hist, hs = k14._rows(hist)
    x, xs = k14._rows(x)
    out = [torch.full(x.shape[:-1], np.nan) for _ in range(3)]
    floats = k14.scratch_floats(rows, n)
    scratch = torch.full((floats,), np.nan)
    rc = lib.launch_pilot_power(
        hist.data_ptr(), hs, x.data_ptr(), xs, rows, n, bp19.data_ptr(),
        _p(lock), hi, lo, None if lock is None else out[0].data_ptr(),
        out[1].data_ptr(), out[2].data_ptr(), scratch.data_ptr(), floats,
        _p(sq), None)
    assert rc == 0
    return (out[0] if lock is not None else None), out[1], out[2]


def host_decode(lib, taps, hist, x, gate, gain, pf, sq):
    """Launch B of the host build, as ``stereo_decode`` calls it."""
    n = x.shape[-1]
    rows = int(np.prod(x.shape[:-1], dtype=np.int64))
    hist, hs = k14._rows(hist)
    x, xs = k14._rows(x)
    y = torch.full(x.shape[:-1] + (2, n), np.nan)
    rc = lib.launch_stereo_cascade(
        hist.data_ptr(), hs, x.data_ptr(), xs, rows, n, taps.data_ptr(),
        _p(gate), float(np.float32(gain)), k14._pf2(pf), _p(sq),
        y.data_ptr(), None)
    assert rc == 0
    return y


def _case(rng, lead, n, signal, misaligned=False):
    """A history that is the tail of the previous stretch of the signal,
    the block after it, rows offset in time and scaled."""
    rows = int(np.prod(lead, dtype=np.int64))
    make = SIGNALS[signal]
    full = np.stack([make(192 + n + 37 * r)[-(192 + n):]
                     for r in range(rows)])
    full = full * rng.uniform(0.5, 2.0, (rows, 1))
    full = torch.from_numpy(full.astype(np.float32))
    hist = full[:, :192].reshape(lead + (192,))
    x = full[:, 192:].reshape(lead + (n,))
    if misaligned:
        x = host_shim.offset(x, 1)
    return hist, x


# chip_smoke.py's geometries cut to the shim's pace
GEOMETRIES = [((1,), 1), ((2,), 100), ((3,), 191), ((2,), 2_944 + 57),
              ((2, 2), 700), ((1,), 9_000), ((2,), 9_000)]


@pytest.mark.parametrize("signal", sorted(SIGNALS))
@pytest.mark.parametrize("lead,n", GEOMETRIES)
def test_source_on_the_host_equals_plain_bitwise(lib, rng, signal, lead, n):
    op = StereoDecode(FS, device="cpu")
    hist, x = _case(rng, lead, n, signal, misaligned=n == 700)
    for lock0 in (0.0, 1.0):
        lock = torch.full(lead, lock0)
        args = (op._bp19, hist, x, lock, op.lock_hi, op.lock_lo)
        sq = torch.full(lead + (n + 128,), np.nan)
        sq_ref = torch.empty_like(sq)
        got = host_pilot_lock(lib, *args, sq)
        want = k14.pilot_lock_reference(*args, sq_ref)
        for g, w in zip(got, want):
            assert torch.equal(_bits(g), _bits(w))
        assert torch.equal(_bits(sq), _bits(sq_ref))
        if n >= 5_000:      # long enough to decide as the signal says
            decided = {"lock": 1.0, "unlock": 0.0, "hold": lock0}[signal]
            assert got[0].eq(decided).all(), (signal, got)
        for gate in (got[0], None):
            y = host_decode(lib, op._taps, hist, x, gate, op.gain,
                            op.pilot_floor, sq)
            ref = k14.stereo_decode_reference(op._taps, hist, x, gate,
                                              op.gain, op.pilot_floor,
                                              sq_ref)
            assert torch.equal(_bits(y), _bits(ref))


@pytest.mark.parametrize("lead,n", [((2,), 100), ((2, 2), 2_944 + 57)])
def test_source_on_the_host_through_written_sq(lib, rng, lead, n):
    """Launch A in shard_carry's form (no entering lock, no sq) gives the
    a, b of apply's form; apply's form writes the plain version's squared
    pilot without the pilot lock too, and launch B from it is bitwise."""
    op = StereoDecode(FS, device="cpu")
    hist, x = _case(rng, lead, n, "lock")
    bare = host_pilot_lock(lib, op._bp19, hist, x, None, op.lock_hi,
                           op.lock_lo)
    sq = torch.full(lead + (n + 128,), np.nan)
    full = host_pilot_lock(lib, op._bp19, hist, x, None, op.lock_hi,
                           op.lock_lo, sq)
    assert full[0] is None
    for g, w in zip(bare[1:], full[1:]):
        assert torch.equal(_bits(g), _bits(w))
    y = host_decode(lib, op._taps, hist, x, None, op.gain, op.pilot_floor,
                    sq)
    want, new = k14.decode(op._taps, hist, x, None, op.gain,
                           op.pilot_floor, op.lock_hi, op.lock_lo)
    assert new is None
    assert torch.equal(_bits(y), _bits(want))


def test_source_on_the_host_with_a_history_slice(lib, rng):
    """The carry's history is a slice of the last block (row stride n):
    read in place, the same bits as a contiguous copy."""
    op = StereoDecode(FS, device="cpu")
    prev = torch.from_numpy(np.stack([make_composite(3_000),
                                      make_composite(3_000, pilot=0.0)]))
    hist = prev[:, -192:]
    assert hist.stride() == (3_000, 1)
    x = torch.from_numpy(np.stack([make_composite(2_000, t0=3_000),
                                   make_composite(2_000, pilot=0.0,
                                                  t0=3_000)]))
    sq = torch.empty(2, 2_000 + 128)
    host_pilot_lock(lib, op._bp19, hist, x, None, op.lock_hi, op.lock_lo,
                    sq)
    y = host_decode(lib, op._taps, hist, x, None, op.gain, op.pilot_floor,
                    sq)
    assert torch.equal(_bits(y), _bits(host_decode(
        lib, op._taps, hist.contiguous(), x, None, op.gain,
        op.pilot_floor, sq)))


@pytest.mark.parametrize("n", [3_001, 9_000])
def test_two_host_launches_are_bitwise_equal(lib, rng, n):
    """Launch A's completion count and launch B's persistent walk order
    no arithmetic: two launches give the same bits."""
    op = StereoDecode(FS, device="cpu")
    hist, x = _case(rng, (3,), n, "hold", misaligned=n % 4 == 0)
    runs = []
    for _ in range(2):
        sq = torch.full((3, n + 128), np.nan)
        got = host_pilot_lock(lib, op._bp19, hist, x, torch.ones(3),
                              op.lock_hi, op.lock_lo, sq)
        y = host_decode(lib, op._taps, hist, x, got[0], op.gain,
                        op.pilot_floor, sq)
        runs.append((*got, sq, y))
    for a, b in zip(*runs):
        assert torch.equal(_bits(a), _bits(b))


def test_sources_on_the_host_refuse_bad_geometry(lib):
    op = StereoDecode(FS, device="cpu")
    x, h = torch.zeros(1, 10), torch.zeros(1, 192)
    y = torch.zeros(1, 2, 10)
    sq = torch.zeros(1, 10 + 128)
    s = torch.zeros(k14.scratch_floats(1, 10))
    out = torch.zeros(3)
    for rows, floats in ((0, s.numel()), (70_000, s.numel()),
                         (1, s.numel() - 1)):
        assert lib.launch_pilot_power(
            h.data_ptr(), 192, x.data_ptr(), 10, rows, 10,
            op._bp19.data_ptr(), None, 0.02, 0.005, None, out.data_ptr(),
            out.data_ptr(), s.data_ptr(), floats, None, None) != 0
    for rows, n, sq_p in ((0, 10, sq.data_ptr()), (70_000, 10, sq.data_ptr()),
                          (1, 0, sq.data_ptr()), (1, 10, None)):
        assert lib.launch_stereo_cascade(
            h.data_ptr(), 192, x.data_ptr(), 10, rows, n,
            op._taps.data_ptr(), None, 2.0, 1e-8, sq_p, y.data_ptr(),
            None) != 0


STEREO_VARIANTS = ["pilot_no_fence", "pilot_no_loads", "pilot_no_sums",
                   "pilot_stride", "stereo_blocks2", "stereo_bounds1",
                   "stereo_fir_avg", "stereo_mul_add", "stereo_no_loads",
                   "stereo_no_stores", "stereo_no_sums", "stereo_one_buffer",
                   "stereo_single_stage"]


@pytest.mark.parametrize("name", STEREO_VARIANTS)
def test_variants_build_and_run_on_the_host(tmp_path, rng, name):
    """Each K14 variant of kernel_variants builds for the host and runs;
    one that changes no arithmetic (kernel_variants.EXACT) equals the
    committed source bitwise."""
    from sdr_tpu_torch import kernel_variants
    targets, patches = kernel_variants.VARIANTS[name]
    assert targets == ("stereo_decode",)
    var = host_shim.build_source(tmp_path, "stereo_decode",
                                 [*patches, *HEADERS], "_" + name)
    for fn, types in k14.KERNEL.functions.items():
        getattr(var, fn).argtypes = [*types, ctypes.c_void_p]
    op = StereoDecode(FS, device="cpu")
    hist, x = _case(rng, (2,), 3_001, "lock")
    sq = torch.empty(2, 3_001 + 128)
    lock, _, _ = host_pilot_lock(var, op._bp19, hist, x, torch.zeros(2),
                                 op.lock_hi, op.lock_lo, sq)
    y = host_decode(var, op._taps, hist, x, lock, op.gain, op.pilot_floor,
                    sq)
    if name in kernel_variants.EXACT:
        sq_ref = torch.empty_like(sq)
        lock, _, _ = k14.pilot_lock_reference(
            op._bp19, hist, x, torch.zeros(2), op.lock_hi, op.lock_lo, sq_ref)
        ref = k14.stereo_decode_reference(op._taps, hist, x, lock, op.gain,
                                          op.pilot_floor, sq_ref)
        assert torch.equal(_bits(y), _bits(ref))


# -- the wrappers ------------------------------------------------------------


def test_kernels_hold_k14():
    assert KERNELS[13] is k14.KERNEL
    assert k14.KERNEL.source == CSRC / "stereo_decode.cu"
    assert set(k14.KERNEL.functions) == {"launch_pilot_power",
                                         "launch_stereo_cascade"}


SQ = torch.zeros(2, 50 + 128)


def _ramped_avg(t):
    """``t`` with its avg row no longer one constant."""
    return torch.cat([t[:2], t[2:3] * torch.linspace(0.5, 1.5, 65), t[3:]])


@pytest.mark.parametrize("call,match", [
    (lambda t, h, x: k14.stereo_decode(t[:3], h, x, None, 2.0, 1e-4, SQ),
     r"\[4, 65\]"),
    (lambda t, h, x: k14.stereo_decode(t, h[..., :100], x, None, 2.0, 1e-4,
                                       SQ), "hist"),
    (lambda t, h, x: k14.stereo_decode(t, h, x.double(), None, 2.0, 1e-4,
                                       SQ), "float32"),
    (lambda t, h, x: k14.stereo_decode(t, h, x, torch.ones(3), 2.0, 1e-4,
                                       SQ), "gate"),
    (lambda t, h, x: k14.stereo_decode(t, h, x, None, 2.0, 1e-4, None),
     "sq"),
    (lambda t, h, x: k14.stereo_decode(t, h, x, None, 2.0, 1e-4, SQ[:, 1:]),
     "sq"),
    (lambda t, h, x: k14.stereo_decode(_ramped_avg(t), h, x, None, 2.0,
                                       1e-4, SQ), "avg"),
    (lambda t, h, x: k14.stereo_decode_reference(_ramped_avg(t), h, x, None,
                                                 2.0, 1e-4, SQ), "avg"),
    (lambda t, h, x: k14.pilot_lock(t[0, :64], h, x, None, 0.02, 0.005),
     r"\[65\]"),
    (lambda t, h, x: k14.pilot_lock(t[0], h, x, torch.ones(2, 1), 0.02,
                                    0.005), "lock"),
])
def test_wrappers_refuse(call, match):
    op = StereoDecode(FS, device="cpu")
    with pytest.raises(ValueError, match=match):
        call(op._taps, torch.zeros(2, 192), torch.zeros(2, 50))


def test_boxcar_check_follows_in_place_edits():
    """The avg row is checked once for a tensor, and again after it is
    modified in place."""
    t = StereoDecode(FS, device="cpu")._taps.clone()
    args = (torch.zeros(2, 192), torch.zeros(2, 50), None, 2.0, 1e-4, SQ)
    k14.stereo_decode(t, *args)
    k14.stereo_decode(t, *args)
    t[2, 7] = 0.5
    with pytest.raises(ValueError, match="avg"):
        k14.stereo_decode(t, *args)


def test_wrappers_refuse_a_meta_device():
    args = (torch.zeros(2, 192, device="meta"),
            torch.zeros(2, 50, device="meta"))
    with pytest.raises(ValueError, match="unsupported device"):
        k14.stereo_decode(torch.zeros(4, 65, device="meta"), *args, None,
                          2.0, 1e-4, torch.zeros(2, 178, device="meta"))
    with pytest.raises(ValueError, match="unsupported device"):
        k14.pilot_lock(torch.zeros(65, device="meta"), *args, None, 0.02,
                       0.005)


def test_apply_and_shard_carry_reach_k14(monkeypatch):
    calls = []
    for name in ("pilot_lock", "stereo_decode"):
        real = getattr(k14, name)

        def wrapper(*a, _name=name, _real=real, **kw):
            calls.append(_name)
            return _real(*a, **kw)
        monkeypatch.setattr(k14, name, wrapper)
    x = torch.from_numpy(make_composite(4 * COMP)).view(4, COMP)
    op = StereoDecode(FS, device="cpu")
    op.apply(op.shard_carry(x), x)
    assert calls == ["pilot_lock", "pilot_lock", "stereo_decode"]
    calls.clear()
    op = StereoDecode(FS, pilot_lock=False, device="cpu")
    op.apply(op.shard_carry(x), x)
    assert calls == ["pilot_lock", "stereo_decode"]


# -- the decoder against the JAX package ----------------------------------


SETTINGS = {
    "defaults": {},
    "gain_floor": {"separation_gain": 1.25, "pilot_floor": 2e-3},
    "thresholds": {"lock_hi": 0.05, "lock_lo": 0.0},
    "no_lock": {"pilot_lock": False},
}


def _stream():
    """Lock, hold through a marginal block, unlock, lock again."""
    parts = [make_composite(COMP), marginal(COMP, COMP),
             make_composite(COMP, pilot=0.0, stereo=False, t0=2 * COMP),
             make_composite(COMP, t0=3 * COMP)]
    return parts


@pytest.mark.parametrize("setting", sorted(SETTINGS))
def test_streamed_matches_jax(setting):
    kw = SETTINGS[setting]
    op, jop = StereoDecode(FS, device="cpu", **kw), JaxStereoDecode(FS, **kw)
    c, jc = op.init_carry(COMP), jop.init_carry(COMP, jnp.float32)
    japply = jax.jit(jop.apply)
    for blk in _stream():
        c, y = op.apply(c, torch.from_numpy(blk))
        jc, jy = japply(jc, jnp.asarray(blk))
        np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=0,
                                   atol=ATOL)
        np.testing.assert_allclose(c[0].numpy(), np.asarray(jc[0]), rtol=0,
                                   atol=0)
        assert float(c[1]) == float(jc[1])


@pytest.mark.parametrize("setting", sorted(SETTINGS))
def test_block_parallel_matches_jax(setting):
    kw = SETTINGS[setting]
    comp = np.concatenate(_stream())
    jop = JaxStereoDecode(FS, **kw)
    jcs, want = jax.jit(lambda v: jax_run_time_batched(
        [jop], v, NB, return_carries=True))(comp)
    op = StereoDecode(FS, device="cpu", **kw)
    cs, got = run_time_batched([op], comp, NB, return_carries=True,
                               device="cpu")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=ATOL)
    assert float(cs[0][1]) == float(jcs[0][1])
    _, streamed = Pipeline([op], block_in=COMP, device="cpu").process(comp)
    np.testing.assert_allclose(got.numpy(), streamed.numpy(), rtol=0,
                               atol=ATOL)


def test_lock_states_entering_each_row():
    """shard_carry's lock entering each row: locked after row 0, held
    through the marginal row 1, unlocked by row 2."""
    x = torch.from_numpy(np.concatenate(_stream())).view(NB, COMP)
    assert StereoDecode(FS, device="cpu").shard_carry(x)[1].tolist() == [
        0.0, 1.0, 1.0, 0.0]
    assert StereoDecode(FS, pilot_lock=False, device="cpu").shard_carry(
        x)[1].tolist() == [0.0] * NB


@pytest.mark.parametrize("hi,lo", [(0.01, 0.01), (0.01, 0.02), (0.02, -0.1)])
def test_lock_thresholds_refused(hi, lo):
    with pytest.raises(ValueError, match="lock_lo < lock_hi"):
        StereoDecode(FS, lock_hi=hi, lock_lo=lo, device="cpu")
    with pytest.raises(ValueError, match="lock_lo < lock_hi"):
        JaxStereoDecode(FS, lock_hi=hi, lock_lo=lo)
