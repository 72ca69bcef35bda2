"""K7 (the channelizer's branch filter) and K8 (the planar oscillator mix)
on the CPU, where their wrappers take the plain versions; and the two
CUDA sources themselves, compiled for the host with ``g++`` under a shim
of the CUDA built-ins they use and run block by block, thread by thread.

* ``branch_filter`` with ``hist`` apart equals the ``cat`` form it
  replaces, bitwise; ``polyphase_channelize`` and ``Channelize`` match the
  JAX stencil and ``'gather'`` forms within 1e-5 of each output's peak
  (tests/test_torch_channelize.py's bound), streamed == block-parallel
  within 1e-6; the carry is the last H samples, also after a block
  shorter than H.
* ``mix_planar_reference`` equals the planar ``Mix``'s former arithmetic
  bitwise, and ``Mix(planar=True)`` matches the JAX op over three blocks
  within 1e-6 (tests/test_torch_am.py's bound).
* The host builds of ``csrc/channelize.cu`` and ``csrc/mix.cu``:
  K7's staging, tiles, register ring and edges, and K8's vector and scalar
  paths, against the plain versions: max |diff| = 0 for K7 (the plain
  version multiplies by the taps promoted to complex, so a zero's sign
  may differ), bitwise for K8.  Unstaged shared memory is filled with
  NaNs, and no NaN may reach an output.
"""

import ctypes
import itertools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import torch_host_shim as host_shim

from sdr_tpu.ops import channelize as jchannelize
from sdr_tpu.stream import Channelize as JaxChannelize
from sdr_tpu.stream import Mix as JaxMix

from sdr_tpu_torch.kernels import KERNELS, channelize, mix
from sdr_tpu_torch.kernels._build import CSRC, Kernel
from sdr_tpu_torch.ops.channelize import (branch_taps, channelizer_taps,
                                          polyphase_channelize)
from sdr_tpu_torch.parallel.sharded import run_time_batched
from sdr_tpu_torch.stream import Channelize, Mix, Pipeline


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs in several worker processes
    (pytest-xdist), where PyTorch's idle OpenMP workers spinning would
    cost the other workers the CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _complex(rng, shape):
    return torch.from_numpy((rng.normal(size=shape)
                             + 1j * rng.normal(size=shape)).astype(
        np.complex64))


def cat_form(hb, hist, x, num):
    """The stencil as the port ran it before K7: one concatenated copy,
    then P shifted views of its row-major reshape, summed p = 0..P-1."""
    P, C = hb.shape
    z = torch.cat([hist, x], dim=-1)
    m_total = z.shape[-1] // C
    x2 = z[..., : m_total * C].reshape(z.shape[:-1] + (m_total, C))
    v = x2[..., 0:num, :] * hb[0]
    for p in range(1, P):
        v += x2[..., p:p + num, :] * hb[p]
    return v


def former_mix(lo, carry, x):
    """The planar ``Mix``'s rotation as the port ran it before K8."""
    def rot(ar, ai, br, bi):
        return ar * br - ai * bi, ar * bi + ai * br
    pr, pi = rot(lo[0], lo[1], carry[..., 0, None], carry[..., 1, None])
    xr, xi = x[..., 0, :], x[..., 1, :]
    y = torch.empty_like(x)
    torch.sub(xr * pr, xi * pi, out=y[..., 0, :])
    torch.add(xr * pi, xi * pr, out=y[..., 1, :])
    return y


def _bits(t):
    return t.contiguous().view(torch.int32)


# -- K7's function -------------------------------------------------------


@pytest.mark.parametrize("C,P", [(1, 1), (1, 5), (8, 16), (64, 12),
                                 (100, 5), (3, 12)])
@pytest.mark.parametrize("lead", [(), (2,), (2, 3)])
@pytest.mark.parametrize("history", ["none", "full", "short"])
def test_branch_filter_with_history_apart_equals_cat_form(rng, C, P, lead,
                                                          history):
    hb = torch.from_numpy(rng.normal(size=(P, C)).astype(np.float32))
    H = {"none": 0, "full": (P - 1) * C, "short": C // 2 + 1}[history]
    for num in (1, 7):
        n = (num + P - 1) * C - H + C // 3       # a ragged tail unread
        hist, x = _complex(rng, lead + (H,)), _complex(rng, lead + (n,))
        got = channelize.branch_filter(hb, hist, x, num)
        assert got.shape == lead + (num, C)
        assert torch.equal(_bits(torch.view_as_real(got)),
                           _bits(torch.view_as_real(
                               cat_form(hb, hist, x, num))))


@pytest.mark.parametrize("n_channels,per_branch,num", [(8, 5, None),
                                                       (64, 12, None),
                                                       (4, 16, 9)])
@pytest.mark.parametrize("lead", [(), (3,)])
def test_polyphase_channelize_on_k7_matches_both_jax_forms(rng, n_channels,
                                                           per_branch, num,
                                                           lead):
    taps = channelizer_taps(n_channels, per_branch)
    x = _complex(rng, lead + (2048 + 5,))
    got = polyphase_channelize(taps, n_channels, x, num)
    m = 2048 // n_channels - per_branch + 1 if num is None else num
    assert tuple(got.shape) == lead + (n_channels, m)
    for method in ("stencil", "gather"):
        want = jax.jit(lambda v: jchannelize.polyphase_channelize(
            taps, n_channels, v, num, method=method))(x.numpy())
        want = np.asarray(want)
        err = np.abs(got.numpy() - want).max() / np.abs(want).max()
        assert err <= 1e-5, (method, err)
    hb = branch_taps(taps, n_channels)
    v = cat_form(hb, x.new_empty(lead + (0,)), x, m)
    assert torch.equal(got, torch.fft.fft(v, dim=-1).transpose(-1, -2))


@pytest.mark.parametrize("blk", [64, 256, 1024])
def test_channelize_carry_is_the_last_h_samples(rng, blk):
    """The new carry is the last H = (P - 1) C samples of cat(carry, x),
    also after a block shorter than H (64 < 88); the outputs equal one
    call over the whole stream within 1e-6 and the JAX op's within 1e-5
    of the peak, block by block."""
    n_channels, n = 8, 2048
    taps = channelizer_taps(n_channels, 12)
    op, jop = Channelize(taps, n_channels, device="cpu"), \
        JaxChannelize(taps, n_channels)
    H = op.hist_len()
    assert H == 88
    x = _complex(rng, (2, n))
    c = op.init_carry(blk, (2,), torch.complex64)
    jc = jop.init_carry(blk, jnp.complex64, (2,))
    step = jax.jit(jop.apply)
    stream = torch.cat([c, x], dim=-1)
    parts = []
    for i in range(0, n, blk):
        prev = c
        c, y = op.apply(c, x[:, i:i + blk])
        assert c.shape == (2, H)
        assert torch.equal(c, stream[:, i + blk: i + blk + H])
        assert c.data_ptr() != prev.data_ptr()     # a copy, not a view
        jc, jy = step(jc, x[:, i:i + blk].numpy())
        np.testing.assert_array_equal(c.numpy(), np.asarray(jc))
        err = np.abs(y.numpy() - np.asarray(jy)).max() / \
            np.abs(np.asarray(jy)).max()
        assert err <= 1e-5
        parts.append(y)
    _, whole = op.apply(op.init_carry(n, (2,), torch.complex64), x)
    np.testing.assert_allclose(torch.cat(parts, dim=-1).numpy(),
                               whole.numpy(), rtol=0, atol=1e-6)
    pipe = Pipeline([op], block_in=blk, batch_shape=(2,),
                    in_dtype=torch.complex64, device="cpu")
    streamed = torch.cat(list(pipe.run(x[:, i:i + blk]
                                       for i in range(0, n, blk))), dim=-1)
    np.testing.assert_allclose(streamed.numpy(), whole.numpy(), rtol=0,
                               atol=1e-6)
    if blk >= H:                # a block-parallel row's halo is one block
        batched = run_time_batched([op], x, n // blk, device="cpu")
        np.testing.assert_allclose(batched.numpy(), streamed.numpy(),
                                   rtol=0, atol=1e-6)


# -- K8's function -------------------------------------------------------


@pytest.mark.parametrize("lead", [(1,), (4,), (2, 3)])
@pytest.mark.parametrize("n", [1, 6, 1027, 4096])
def test_mix_planar_reference_is_the_former_arithmetic(rng, lead, n):
    ang = rng.uniform(0, 2 * np.pi, lead)
    carry = torch.from_numpy(np.stack([np.cos(ang), np.sin(ang)],
                                      axis=-1).astype(np.float32))
    lo = torch.from_numpy(rng.normal(size=(2, n)).astype(np.float32))
    x = torch.from_numpy(rng.normal(size=lead + (2, n)).astype(np.float32))
    got = mix.mix_planar(lo, carry, x)
    assert torch.equal(_bits(got), _bits(former_mix(lo, carry, x)))
    assert torch.equal(_bits(got), _bits(mix.mix_planar_reference(lo, carry,
                                                                  x)))


@pytest.mark.parametrize("lead", [(2,), (2, 3)])
@pytest.mark.parametrize("freq", [-0.21, 0.25])
def test_planar_mix_on_k8_matches_jax_over_blocks(rng, lead, freq):
    """Three blocks with the phasor carried: outputs and carries within
    1e-6 of the JAX op's."""
    n = 4099
    op, jop = Mix(freq, planar=True, device="cpu"), JaxMix(freq, True)
    x = rng.uniform(-1, 1, lead + (2, n)).astype(np.float32)
    c = op.init_carry(n, lead + (2,))
    jc = jop.init_carry(n, jnp.float32, lead + (2,))
    step = jax.jit(jop.apply)
    for _ in range(3):
        c, y = op.apply(c, torch.from_numpy(x))
        jc, jy = step(jc, x)
        np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=0,
                                   atol=1e-6)
        np.testing.assert_allclose(c.numpy(), np.asarray(jc), rtol=0,
                                   atol=1e-6)


# -- the wrappers' refusals ----------------------------------------------


def _k7_args(device="cpu", **change):
    a = dict(hb=torch.ones((3, 4)),
             hist=torch.ones((2, 8), dtype=torch.complex64),
             x=torch.ones((2, 40), dtype=torch.complex64), num=10)
    a.update(change)
    return {k: v.to(device) if torch.is_tensor(v) else v
            for k, v in a.items()}


def _k8_args(device="cpu", **change):
    a = dict(lo=torch.ones((2, 100)), carry=torch.ones((2, 2)),
             x=torch.ones((2, 2, 100)))
    a.update(change)
    return {k: v.to(device) for k, v in a.items()}


REFUSED = [
    (channelize.branch_filter, _k7_args(hb=torch.ones((3, 4)).double()),
     "float32"),
    (channelize.branch_filter, _k7_args(x=torch.ones((2, 40))), "complex64"),
    (channelize.branch_filter,
     _k7_args(hist=torch.ones((2, 8), dtype=torch.complex128)), "complex64"),
    (channelize.branch_filter,
     _k7_args(x=torch.ones((2, 80), dtype=torch.complex64)[:, ::2]),
     "contiguous"),
    (channelize.branch_filter, _k7_args(hb=torch.ones((4, 3)).t()),
     "contiguous"),
    (channelize.branch_filter, _k7_args(hist=torch.ones(
        (3, 8), dtype=torch.complex64)), "leading dims"),
    (channelize.branch_filter, _k7_args(num=17), "read past"),
    (channelize.branch_filter,
     dict(_k7_args(), hb=torch.ones((3, 4), device="meta")), "share"),
    (mix.mix_planar, _k8_args(lo=torch.ones((2, 100)).double()), "float32"),
    (mix.mix_planar, _k8_args(x=torch.ones((2, 2, 100), dtype=torch.int32)),
     "float32"),
    (mix.mix_planar, _k8_args(x=torch.ones((2, 2, 200))[..., ::2]),
     "contiguous"),
    (mix.mix_planar, _k8_args(carry=torch.ones((2, 4))[:, ::2]),
     "contiguous"),
    (mix.mix_planar, _k8_args(lo=torch.ones((2, 99))), r"\[2, 100\]"),
    (mix.mix_planar, _k8_args(x=torch.ones((2, 3, 100))), "planar"),
    (mix.mix_planar, _k8_args(carry=torch.ones((3, 2))), "leading dims"),
    (mix.mix_planar, dict(_k8_args(), carry=torch.ones((2, 2),
                                                       device="meta")),
     "share"),
]


@pytest.mark.parametrize("fn,args,match", REFUSED)
def test_wrappers_refuse(fn, args, match):
    with pytest.raises(ValueError, match=match):
        fn(**args)


@pytest.mark.parametrize("fn,args", [(channelize.branch_filter, _k7_args),
                                     (mix.mix_planar, _k8_args)])
def test_wrappers_refuse_a_meta_device(fn, args):
    with pytest.raises(ValueError, match="unsupported device"):
        fn(**args("meta"))


# -- the registry and the build digest -----------------------------------


def test_kernels_hold_k7_and_k8():
    assert KERNELS[6] is channelize.KERNEL and KERNELS[7] is mix.KERNEL
    assert channelize.KERNEL.source == CSRC / "channelize.cu"
    assert mix.KERNEL.source == CSRC / "mix.cu"
    assert set(channelize.KERNEL.functions) == {"launch_branch_filter",
                                                "launch_branch_dft"}
    assert set(mix.KERNEL.functions) == {"launch_mix_planar",
                                         "launch_mix_complex"}


@pytest.mark.parametrize("name", ["channelize", "mix"])
def test_build_digest_follows_the_source(tmp_path, name):
    """An edited K7 or K8 source gets a library of another name, so a
    stale build is never loaded."""
    k = Kernel(name, {})
    k.source = tmp_path / f"{name}.cu"
    text = (CSRC / f"{name}.cu").read_text()
    k.source.write_text(text)
    before = k.library_path()
    assert before.name.startswith(f"lib{name}-")
    k.source.write_text(text + "\n// edited\n")
    assert k.library_path() != before
    k.source.write_text(text)
    assert k.library_path() == before


# -- the CUDA sources, built for the host --------------------------------

K7_HOST_RUN = r"""
template <int V>
void run(const float* hb, const float* hist, const float* x, float* v,
         long long rows, long long H, long long n, long long num, int C,
         int P, int T, int smem) {
  const long long tpr = (num + T - 1) / T;
  for (long long b = 0; b < rows * tpr; ++b) {
    float* buf = static_cast<float*>(aligned_alloc(16, (smem + 15) / 16 * 16));
    for (int i = 0; i < smem / 4; ++i) buf[i] = NAN;
    std::barrier<> bar(kThreads);
    g_bar = &bar;
    std::vector<std::thread> th;
    for (int t = 0; t < kThreads; ++t)
      th.emplace_back([=] {
        threadIdx = {static_cast<unsigned>(t), 0, 0};
        blockIdx = {static_cast<unsigned>(b), 0, 0};
        g_smem = buf;
        branch_filter_kernel<V>(hb, hist, x, v, H, n, num, C, P, T, tpr);
      });
    for (auto& t : th) t.join();
    free(buf);
  }
}
}  // namespace
extern "C" int host_branch_filter(const float* hb, const float* hist,
                                  const float* x, float* v, long long rows,
                                  long long H, long long n, long long num,
                                  int C, int P, int* tile) {
  int T = 0, smem = 0;
  const int p = plan(C, P, num, &T, &smem);
  if (p != 0) return p;
  *tile = T;
  if (C % 2 == 0) run<4>(hb, hist, x, v, rows, H, n, num, C, P, T, smem);
  else run<2>(hb, hist, x, v, rows, H, n, num, C, P, T, smem);
  return 0;
}
"""

K8_HOST_RUN = r"""
}  // namespace
extern "C" void host_mix_planar(const float* lo, const float* c,
                                const float* x, float* y, long long rows,
                                long long n) {
  for (long long b = 0; b < (n + kTile - 1) / kTile; ++b)
    for (int t = 0; t < kThreads; ++t) {
      threadIdx = {static_cast<unsigned>(t), 0, 0};
      blockIdx = {static_cast<unsigned>(b), 0, 0};
      mix_planar_kernel(lo, c, x, y, rows, n);
    }
}
"""


@pytest.fixture(scope="module")
def host_builds(tmp_path_factory):
    d = tmp_path_factory.mktemp("host_kernels")
    libs = {name: host_shim.build(d, name, cut, runner)
            for name, cut, runner in (
                ("channelize", "template <int V>\nint launch(", K7_HOST_RUN),
                ("mix", "}  // namespace", K8_HOST_RUN))}
    P_, LL, I_ = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    libs["channelize"].host_branch_filter.argtypes = [
        P_, P_, P_, P_, LL, LL, LL, LL, I_, I_, ctypes.POINTER(I_)]
    libs["mix"].host_mix_planar.argtypes = [P_, P_, P_, P_, LL, LL]
    return libs


@pytest.mark.parametrize("C,P", list(itertools.product((1, 8, 64, 100),
                                                       (1, 5, 12, 16))))
def test_k7_source_on_the_host_equals_plain(host_builds, rng, C, P):
    """Each (C, P) with histories 0 and (P - 1) C, row bases 0 and 1
    samples off 16-byte alignment, 2 rows, and num = 1 and one above the
    kernel's tile (two tiles a row, the second of 1 row)."""
    lib = host_builds["channelize"]
    hb = torch.from_numpy(rng.normal(size=(P, C)).astype(np.float32))
    tile = ctypes.c_int()
    for H, off, num in itertools.product((0, (P - 1) * C), (0, 1),
                                         (1, None)):
        if num is None:
            num = tile.value + 1
        n = (num + P - 1) * C - H + 1
        hist = host_shim.offset(_complex(rng, (2, H)), off)
        x = host_shim.offset(_complex(rng, (2, n)), off)
        v = torch.full((2, num, C), complex(np.nan, np.nan),
                       dtype=torch.complex64)
        assert lib.host_branch_filter(
            hb.data_ptr(), hist.data_ptr(), x.data_ptr(), v.data_ptr(), 2,
            H, n, num, C, P, ctypes.byref(tile)) == 0
        want = channelize.branch_filter_reference(hb, hist, x, num)
        assert torch.isfinite(torch.view_as_real(v)).all()
        assert (v - want).abs().max().item() == 0, (H, off, num)


@pytest.mark.parametrize("n", [1, 3, 4, 1023, 1024, 1029, 4099])
@pytest.mark.parametrize("lead", [(3,), (2, 3)])
def test_k8_source_on_the_host_equals_plain_bitwise(host_builds, rng, n,
                                                    lead):
    lib = host_builds["mix"]
    for off in range(4):
        lo = host_shim.offset(torch.from_numpy(
            rng.normal(size=(2, n)).astype(np.float32)), off)
        ang = rng.uniform(0, 2 * np.pi, lead)
        carry = torch.from_numpy(np.stack([np.cos(ang), np.sin(ang)],
                                          axis=-1).astype(np.float32))
        x = host_shim.offset(torch.from_numpy(
            rng.normal(size=lead + (2, n)).astype(np.float32)), off)
        y = torch.full(lead + (2, n), np.nan)
        lib.host_mix_planar(lo.data_ptr(), carry.data_ptr(), x.data_ptr(),
                            y.data_ptr(), int(np.prod(lead)), n)
        assert torch.equal(_bits(y), _bits(mix.mix_planar_reference(
            lo, carry, x))), off


@pytest.mark.parametrize("C,fits", [(1383, True), (1384, False)])
def test_k7_plan_on_the_host_raises_past_a_block(host_builds, rng, C, fits):
    """At P = 12 a block stages kR + P - 1 = 15 rows and the taps, (15 * 2
    + 12) C floats of an H100 block's 58,112: C = 1,383 runs, 1,384 is
    refused by the plan (the wrapper then raises)."""
    lib = host_builds["channelize"]
    hb = torch.from_numpy(rng.normal(size=(12, C)).astype(np.float32))
    x = _complex(rng, (1, 12 * C))
    hist = x.new_empty((1, 0))
    v = torch.zeros((1, 1, C), dtype=torch.complex64)
    tile = ctypes.c_int()
    rc = lib.host_branch_filter(hb.data_ptr(), hist.data_ptr(), x.data_ptr(),
                                v.data_ptr(), 1, 0, 12 * C, 1, C, 12,
                                ctypes.byref(tile))
    assert rc == (0 if fits else -1)
    if fits:
        want = channelize.branch_filter_reference(hb, hist, x, 1)
        assert tile.value == 4 and (v - want).abs().max().item() == 0
