"""``kernels/_fma.py:fma_f32``, the exact f32 FMA that K14's plain versions
sum with, against the C library's ``fmaf`` (correctly rounded in glibc)
through ``ctypes``: bitwise on 120,000 seeded random triples over a wide
range of exponents and signs (a third with ``c`` near ``-a b``, where the
sum cancels), on the double-rounding cases that defeat the plain float64
route (both signs, several scalings), which the float64 route is shown to
fail, and on zeros, signed zeros and results in f32's subnormal range.
"""

import ctypes
import ctypes.util

import numpy as np
import pytest
import torch

from sdr_tpu_torch.kernels._fma import fma_f32

F32 = np.float32


@pytest.fixture(scope="module")
def fmaf():
    libm = ctypes.CDLL(ctypes.util.find_library("m") or "libm.so.6")
    f = libm.fmaf
    f.restype = ctypes.c_float
    f.argtypes = [ctypes.c_float] * 3

    def call(a, b, c):
        out = [f(*t) for t in zip(a.tolist(), b.tolist(), c.tolist())]
        return np.array(out, dtype=F32)
    return call


def _bits(v):
    return np.asarray(v, dtype=F32).view(np.int32)


def _ours(a, b, c):
    return fma_f32(*(torch.from_numpy(np.asarray(v, dtype=F32))
                     for v in (a, b, c))).numpy()


def _float64_route(a, b, c):
    """The plain route: the sum in float64, rounded twice."""
    return (np.asarray(a, np.float64) * np.asarray(b, np.float64)
            + np.asarray(c, np.float64)).astype(F32)


def _random(rng, n, lo, hi):
    m = rng.integers(1 << 23, 1 << 24, n)          # full 24-bit significands
    e = rng.integers(lo, hi, n) - 23
    s = rng.choice(np.array([-1.0, 1.0]), n)
    return (s * np.ldexp(m.astype(np.float64), e)).astype(F32)


def crafted():
    """a b = 2^-24 + 2^-60 against c = 1: the exact sum lies just above
    the tie 1 + 2^-24, which float64 keeps and f32 rounds to even."""
    a0 = F32((2 ** 12 + 1) * 2.0 ** -12)
    b0 = F32((2 ** 24 - 2 ** 12 + 1) * 2.0 ** -48)
    rows = []
    for k in (-60, -20, 0, 7, 40):
        for sa, sc in ((1, 1), (-1, -1)):
            for a, b in ((a0, b0), (b0, a0)):
                rows.append((F32(sa * np.ldexp(a, k)), b,
                             F32(sc * np.ldexp(1.0, k))))
    return [np.array(v, dtype=F32) for v in zip(*rows)]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_random_triples_equal_fmaf(fmaf, seed):
    rng = np.random.default_rng(seed)
    n = 40_000
    a, b = _random(rng, n, -60, 60), _random(rng, n, -60, 60)
    c = _random(rng, n, -140, 110)
    near = rng.random(n) < 1 / 3
    c[near] = (-(a[near].astype(np.float64) * b[near])
               * (1 + rng.normal(0, 1e-7, near.sum()))).astype(F32)
    got, want = _ours(a, b, c), fmaf(a, b, c)
    bad = np.flatnonzero(_bits(got) != _bits(want))
    assert bad.size == 0, (a[bad[:3]], b[bad[:3]], c[bad[:3]])


def test_crafted_double_rounding(fmaf):
    a, b, c = crafted()
    want = fmaf(a, b, c)
    assert np.array_equal(_bits(_ours(a, b, c)), _bits(want))
    # the tie 1 + 2^-24 (scaled) rounds to even in the float64 route
    plain = _float64_route(a, b, c)
    assert (_bits(plain) != _bits(want)).all()
    assert np.array_equal(np.abs(want), np.abs(c) * F32(1 + 2.0 ** -23))
    assert np.array_equal(plain, c)


def test_zeros_and_subnormals(fmaf):
    tiny = np.float32(2.0 ** -149)
    a = np.array([0.0, -0.0, 0.0, -0.0, 1.0, -1.0, 2.0 ** -70, 2.0 ** -70,
                  3.0 * 2.0 ** -75, -3.0 * 2.0 ** -75, 2.0 ** -100,
                  1.5 * 2.0 ** -126, 2.0 ** -63, 1.0], F32)
    b = np.array([5.0, 5.0, -5.0, -5.0, 0.0, 0.0, 2.0 ** -70,
                  -(2.0 ** -70), 5.0 * 2.0 ** -75, 5.0 * 2.0 ** -75,
                  2.0 ** -40, -1.0, 2.0 ** -63 * (1 + 2.0 ** -23), tiny],
                 F32)
    c = np.array([0.0, 0.0, -0.0, -0.0, -0.0, 0.0, tiny, 3 * tiny,
                  2.0 ** -140, 2.0 ** -140, -tiny,
                  2.0 ** -126, -(2.0 ** -126), -tiny], F32)
    want = fmaf(a, b, c)
    got = _ours(a, b, c)
    assert np.array_equal(_bits(got), _bits(want))
    assert (np.abs(want[6:]) < np.float32(2.0 ** -126)).sum() >= 5
    assert np.signbit(want[:6]).any() and not np.signbit(want[:6]).all()


def test_broadcast_and_float64_images(fmaf):
    """A caller may pass f32 values as float64 tensors, and broadcast."""
    rng = np.random.default_rng(5)
    a = _random(rng, 1, -4, 4)
    b, c = _random(rng, 500, -4, 4), _random(rng, 500, -8, 8)
    got = fma_f32(torch.tensor(a[0], dtype=torch.float64),
                  torch.from_numpy(b).double(), torch.from_numpy(c))
    assert got.dtype == torch.float32
    want = fmaf(np.repeat(a, 500), b, c)
    assert np.array_equal(_bits(got.numpy()), _bits(want))
