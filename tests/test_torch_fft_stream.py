"""K9 (the waterfall's FFT stream, csrc/fft_stream.cu) on the CPU, where
its wrapper takes the plain version; and the CUDA source itself, compiled
for the host with ``g++`` under tests/torch_host_shim.py and run block by
block, thread by thread.

* ``fft_stream_reference`` is ``FftStream.apply``'s former arithmetic
  moved unchanged: bitwise equal to it for both forms, with and without
  ``magnitude`` and ``shift``; so is ``FftStream.apply`` on the CPU.
* ``FftStream`` over three blocks matches the JAX op, jitted, within 1e-5
  of each frame's peak (tests/test_torch_spectral.py's bound).
* ``plan`` takes the powers of two from 64 to 16,384 and refuses other
  sizes and hops; ``kernel_route`` sends the rest to cuFFT.
* The host build of ``csrc/fft_stream.cu``: staging (row bases off
  16-byte alignment, carries, odd hops, partial tiles), the Stockham
  passes and the stores, against a float64 numpy FFT (2e-6 of each
  frame's peak: an f32 FFT's rounding, about 2e-7 here) and the plain
  version (1e-5); the planar and complex forms bitwise equal; unstaged
  shared memory full of NaNs, and no NaN reaches an output.
"""

import ctypes
import itertools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import torch_host_shim as host_shim
from test_torch_spectral import assert_peak_close

from sdr_tpu.stream import FftStream as JaxFftStream

from sdr_tpu_torch.kernels import KERNELS, fft_stream
from sdr_tpu_torch.kernels._build import CSRC, Kernel
from sdr_tpu_torch.ops import design, fftops
from sdr_tpu_torch.stream import FftStream

F64_RTOL = 2e-6     # host build vs float64 numpy, of each frame's peak
PLAIN_RTOL = 1e-5   # host build vs the plain version (pocketfft)


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
    return np.random.default_rng(14)


def _input(rng, lead, n, planar):
    if planar:
        return torch.from_numpy(
            rng.normal(size=lead + (2, n)).astype(np.float32))
    return torch.from_numpy((rng.normal(size=lead + (n,))
                             + 1j * rng.normal(size=lead + (n,))).astype(
        np.complex64))


def _planes(t):
    """A complex64 tensor as its planar [..., 2, n] f32 form."""
    return torch.view_as_real(t).movedim(-1, -2).contiguous()


def _bits(t):
    return torch.view_as_real(t).view(torch.int32) if t.is_complex() \
        else t.view(torch.int32)


def former_apply(op, carry, x):
    """``FftStream.apply`` as the port ran it before K9."""
    xext = torch.cat([carry, x], dim=-1)
    H = op.size - op.hop
    new = xext[..., xext.shape[-1] - H:].clone() if H else carry
    if op.planar:
        xext = torch.complex(xext[..., 0, :], xext[..., 1, :])
    frames = fftops.frame(xext, op.size, op.hop, op._window)
    del xext
    F = fftops.fft(frames)
    del frames
    if op.magnitude:
        F = F.abs()
    if op.shift:
        F = torch.fft.fftshift(F, dim=-1)
    return new, F


# -- the plain version and the op ----------------------------------------


@pytest.mark.parametrize("planar,magnitude,shift", [
    (True, True, True), (True, True, False), (False, True, True),
    (False, True, False), (False, False, True), (False, False, False)])
def test_reference_is_the_former_apply_bitwise(rng, planar, magnitude,
                                               shift):
    """The plain version and the op on the CPU, with a carry of H and a
    block shorter than H, give the former ``apply``'s bits."""
    for size, hop in ((256, 64), (128, 128), (256, 37)):
        op = FftStream(size, hop, shift=shift, magnitude=magnitude,
                       planar=planar, device="cpu")
        H = size - hop
        carry = _input(rng, (3,), H, planar)
        for n in (hop * 5, hop):
            x = _input(rng, (3,), n, planar)
            want_new, want = former_apply(op, carry, x)
            got = fft_stream.fft_stream_reference(
                carry, x, op._window, hop, magnitude, shift)
            assert torch.equal(_bits(got), _bits(want))
            new, y = op.apply(carry, x)
            assert torch.equal(_bits(y), _bits(want))
            assert torch.equal(_bits(new), _bits(want_new))
            # the wrapper on CPU tensors is the plain version
            assert torch.equal(_bits(fft_stream.fft_stream(
                carry, x, op._window, hop, magnitude, shift)), _bits(want))


@pytest.mark.parametrize("planar", [True, False])
def test_fft_stream_three_blocks_vs_jax(rng, planar):
    """Three blocks through the carry against the jitted JAX op, within
    1e-5 of each frame's peak; the carry after each block is the JAX
    op's bitwise."""
    size, hop, blk = 1024, 512, 4096
    window = design.blackman(size)
    op = FftStream(size, hop, window=window, planar=planar, device="cpu")
    jop = JaxFftStream(size, hop, window=window, planar=planar)
    bs = (2, 2) if planar else (2,)
    c = op.init_carry(blk, bs, torch.float32 if planar else torch.complex64)
    jc = jop.init_carry(blk, jnp.float32 if planar else jnp.complex64, bs)
    japply = jax.jit(jop.apply)
    for _ in range(3):
        x = _input(rng, (2,), blk, planar)
        c, y = op.apply(c, x)
        jc, want = japply(jc, jnp.asarray(x.numpy()))
        assert y.shape == (2, blk // hop, size)
        assert_peak_close(y.numpy(), want)
        assert np.array_equal(c.numpy(), np.asarray(jc))


# -- the plan and the route ----------------------------------------------


@pytest.mark.parametrize("size", fft_stream.SIZES)
def test_plan_takes_the_powers_of_two(size):
    p = fft_stream.plan(size, size // 2)
    assert p["elems"] == 32
    assert int(np.prod(p["radices"])) == size
    assert p["threads"] == p["frames"] * size // 32
    assert p["threads"] == max(256, size // 32)
    assert p["smem"] == 8 * p["frames"] * (size + size // 32)
    assert p["smem"] <= 232_448          # an H100 block's shared memory
    assert fft_stream.kernel_route(size) == "k9"


@pytest.mark.parametrize("size", [1, 16, 32, 96, 1000, 1023, 1025, 32768])
def test_plan_refuses_other_sizes(size):
    with pytest.raises(ValueError, match="power-of-two size from 64 to"):
        fft_stream.plan(size)
    assert fft_stream.kernel_route(size) == "cufft"


@pytest.mark.parametrize("hop", [0, -1, 1025])
def test_plan_refuses_a_hop_outside_the_frame(hop):
    with pytest.raises(ValueError, match="hop"):
        fft_stream.plan(1024, hop)


def test_twiddle_table_is_each_pass_rounded_once():
    """Pass p reads exp(-2 pi i k r / (Ns R)) at Ns - 1 + (r - 1) Ns + k,
    each the float64 value rounded to f32 once."""
    for size in (64, 1024, 4096):
        tw = fft_stream.twiddles(size, "cpu")
        assert tw.shape == (size, 2) and tw.dtype == torch.float32
        assert fft_stream.twiddles(size, "cpu") is tw      # cached
        ns = 1
        for R in fft_stream.radices(size):
            for r in range(1, R if ns > 1 else 1):
                k = np.arange(ns)
                w = np.exp(-2j * np.pi * k * r / (ns * R))
                at = ns - 1 + (r - 1) * ns + k
                assert np.array_equal(tw[at, 0].numpy(),
                                      w.real.astype(np.float32))
                assert np.array_equal(tw[at, 1].numpy(),
                                      w.imag.astype(np.float32))
            ns *= R


REFUSED = [
    (dict(hist=torch.zeros(2, 2, 0, dtype=torch.float64),
          x=torch.zeros(2, 2, 64, dtype=torch.float64)), "float32"),
    (dict(hist=torch.zeros(2, 0), x=torch.zeros(2, 2, 64)), "dtype|dims"),
    (dict(hist=torch.zeros(2, 3, 0), x=torch.zeros(2, 3, 64)),
     r"\[\.\.\., 2, n\]"),
    (dict(hist=torch.zeros(3, 2, 0), x=torch.zeros(2, 2, 64)), "leading dims"),
    (dict(hist=torch.zeros(2, 2, 0), x=torch.zeros(2, 2, 64), hop=65), "hop"),
    (dict(hist=torch.zeros(2, 2, 0), x=torch.zeros(2, 2, 64), hop=0), "hop"),
    (dict(hist=torch.zeros(2, 2, 0), x=torch.zeros(2, 2, 64),
          window=torch.ones(64, dtype=torch.float64)), "window"),
]


@pytest.mark.parametrize("args,match", REFUSED)
def test_wrapper_refuses(args, match):
    kw = {"window": torch.ones(64), "hop": 64, **args}
    with pytest.raises(ValueError, match=match):
        fft_stream.fft_stream(**kw)


def test_wrapper_refuses_a_meta_device():
    with pytest.raises(ValueError, match="unsupported device"):
        fft_stream.fft_stream(torch.zeros(2, 2, 0, device="meta"),
                              torch.zeros(2, 2, 64, device="meta"),
                              torch.ones(64, device="meta"), 64)


# -- the registry and the build digest -----------------------------------


def test_kernels_hold_k9():
    assert KERNELS[8] is fft_stream.KERNEL
    assert fft_stream.KERNEL.source == CSRC / "fft_stream.cu"
    assert set(fft_stream.KERNEL.functions) == {"launch_fft_stream"}
    assert fft_stream.KERNEL.launches == 0


def test_build_digest_follows_the_source(tmp_path):
    k = Kernel("fft_stream", {})
    k.source = tmp_path / "fft_stream.cu"
    text = (CSRC / "fft_stream.cu").read_text()
    k.source.write_text(text)
    before = k.library_path()
    k.source.write_text(text + "\n// edited\n")
    assert k.library_path() != before


# -- the CUDA source, built for the host ---------------------------------

K9_HOST_RUN = r"""
template <int LOG2N>
int run(const float* hist, const float* x, const float* win,
        const float2* tw, float* out, long long rows, long long H,
        long long n, long long nf, int hop, int frames, int threads,
        int smem, int planar, int magnitude, int shift) {
  const int p = plan_error<LOG2N>(frames, threads, smem);
  if (p != 0) return p;
  const long long tpr = (nf + frames - 1) / frames;
  for (long long b = 0; b < rows * tpr; ++b) {
    float* buf = static_cast<float*>(aligned_alloc(16, (smem + 15) / 16 * 16));
    for (int i = 0; i < smem / 4; ++i) buf[i] = NAN;
    std::barrier<> bar(threads);
    g_bar = &bar;
    std::vector<std::thread> th;
    for (int t = 0; t < threads; ++t)
      th.emplace_back([=] {
        threadIdx = {static_cast<unsigned>(t), 0, 0};
        blockIdx = {static_cast<unsigned>(b), 0, 0};
        g_smem = buf;
        fft_stream_kernel<LOG2N>(hist, x, win, tw, out, H, n, nf, hop,
                                 frames, tpr, planar, magnitude, shift);
      });
    for (auto& t : th) t.join();
    free(buf);
  }
  return 0;
}
}  // namespace
extern "C" int host_fft_stream(const float* hist, const float* x,
                               const float* win, const float2* tw,
                               float* out, long long rows, long long H,
                               long long n, long long nf, int size, int hop,
                               int frames, int threads, int smem, int planar,
                               int magnitude, int shift) {
  switch (size) {
#define K9_SIZE(L)                                                        \
  case 1 << L:                                                            \
    return run<L>(hist, x, win, tw, out, rows, H, n, nf, hop, frames,     \
                  threads, smem, planar, magnitude, shift);
    K9_SIZE(6) K9_SIZE(7) K9_SIZE(8) K9_SIZE(9) K9_SIZE(10) K9_SIZE(11)
    K9_SIZE(12) K9_SIZE(13) K9_SIZE(14)
#undef K9_SIZE
    default:
      return kBadSize;
  }
}
"""


@pytest.fixture(scope="module")
def host_k9(tmp_path_factory):
    lib = host_shim.build(tmp_path_factory.mktemp("host_k9"), "fft_stream",
                          "int device_smem_limit(", K9_HOST_RUN)
    P_, LL, I_ = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    lib.host_fft_stream.argtypes = [P_] * 5 + [LL] * 4 + [I_] * 8
    return lib


def host_run(lib, hist, x, window, hop, magnitude, shift, frames=None):
    """K9's host build over ``hist`` and ``x``; returns (rc, output)."""
    planar = x.dtype == torch.float32
    size = window.numel()
    p = fft_stream.plan(size, hop)
    lead = x.shape[:-2] if planar else x.shape[:-1]
    H, n = hist.shape[-1], x.shape[-1]
    nf = (H + n - size) // hop + 1
    out = torch.full(lead + (nf, size) + (() if magnitude else (2,)),
                     float("nan"))
    rc = lib.host_fft_stream(
        hist.data_ptr(), x.data_ptr(), window.data_ptr(),
        fft_stream.twiddles(size, "cpu").data_ptr(), out.data_ptr(),
        int(np.prod(lead)), H, n, nf, size, hop,
        p["frames"] if frames is None else frames, p["threads"], p["smem"],
        int(planar), int(magnitude), int(shift))
    return rc, (out if magnitude else torch.view_as_complex(out))


def f64_frames(hist, x, window, hop, magnitude, shift):
    """The frames' spectra in float64 numpy."""
    z = np.concatenate([hist.numpy(), x.numpy()], axis=-1)
    if z.dtype == np.float32:
        z = z[..., 0, :].astype(np.float64) + 1j * z[..., 1, :]
    size = window.numel()
    nf = (z.shape[-1] - size) // hop + 1
    at = np.arange(nf)[:, None] * hop + np.arange(size)
    X = np.fft.fft(z[..., at] * window.numpy().astype(np.float64), axis=-1)
    if magnitude:
        X = np.abs(X)
    return np.fft.fftshift(X, axes=-1) if shift else X


def _peak_err(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    return (np.abs(got - want)
            / np.abs(want).max(axis=-1, keepdims=True)).max()


HOST_SIZES = [64, 128, 256, 512, 1024, 2048, 4096]


@pytest.mark.parametrize("size", HOST_SIZES)
@pytest.mark.parametrize("hop_kind", ["size", "half", "odd"])
def test_k9_source_on_the_host(host_k9, rng, size, hop_kind):
    """Each size and hop with histories 0 and H, both forms, row bases 1
    and 3 floats (planar) or 0 and 1 samples (complex) off 16-byte
    alignment (each row's plane bases move with n), and
    one frame past a block's plan (a partial second tile).  Magnitude and
    shift take each combination over the runs."""
    hop = {"size": size, "half": size // 2, "odd": size // 4 + 1}[hop_kind]
    frames = fft_stream.plan(size, hop)["frames"]
    window = torch.from_numpy(design.blackman(size))
    combos = itertools.cycle([(True, True), (False, False), (True, False),
                              (False, True)])
    for H, off in itertools.product((0, size - hop), (0, 1)):
        nf = frames + 1
        n = (nf - 1) * hop + size - H
        xc = _input(rng, (2,), n, False)
        hc = _input(rng, (2,), H, False)
        magnitude, shift = next(combos)
        outs = []
        for planar in (True, False):
            hist, x = (_planes(hc), _planes(xc)) if planar else (hc, xc)
            o = 2 * off + 1 if planar else off      # floats; samples
            hist, x = host_shim.offset(hist, o), host_shim.offset(x, o)
            rc, got = host_run(host_k9, hist, x, window, hop, magnitude,
                               shift)
            assert rc == 0
            assert got.shape == (2, nf, size)
            assert torch.isfinite(torch.view_as_real(got) if got.is_complex()
                                  else got).all()
            assert _peak_err(got, f64_frames(hist, x, window, hop, magnitude,
                                             shift)) <= F64_RTOL
            want = fft_stream.fft_stream_reference(hist, x, window, hop,
                                                   magnitude, shift)
            assert _peak_err(got, want) <= PLAIN_RTOL
            outs.append(got)
        assert torch.equal(_bits(outs[0]), _bits(outs[1]))


def test_k9_host_frames_do_not_depend_on_their_block(host_k9, rng):
    """Leading dims [2, 3]; a stream cut into blocks at a hop multiple,
    each block with its carry, gives the whole run's frames bitwise; so
    does a block of one frame's span."""
    size, hop = 256, 64
    window = torch.from_numpy(design.hanning(size))
    H = size - hop
    x = _input(rng, (2, 3), 40 * hop, True)
    carry = torch.zeros((2, 3, 2, H))
    rc, whole = host_run(host_k9, carry, x, window, hop, True, True)
    assert rc == 0 and whole.shape == (2, 3, 40, size)
    parts, c = [], carry
    for a, b in ((0, 7 * hop), (7 * hop, 8 * hop), (8 * hop, 40 * hop)):
        xb = x[..., a:b].contiguous()
        rc, y = host_run(host_k9, c.contiguous(), xb, window, hop, True, True)
        assert rc == 0
        parts.append(y)
        c = torch.cat([c, xb], dim=-1)[..., -H:]
    assert torch.equal(torch.cat(parts, dim=-2), whole)
    # a block of one frame's span, no carry: frame H / hop of the run
    rc, one = host_run(host_k9, x.new_empty((2, 3, 2, 0)),
                       x[..., :size].contiguous(), window, hop, True, True)
    assert rc == 0 and one.shape == (2, 3, 1, size)
    assert torch.equal(one[..., 0, :], whole[..., H // hop, :])


def test_k9_host_refuses_a_plan_that_is_not_its_own(host_k9, rng):
    """Frames a block other than the plan's return kBadPlan (-2) before
    any thread runs; a size outside 64-16,384 kBadSize (-3)."""
    window = torch.ones(256)
    x = _input(rng, (1,), 1024, True)
    hist = x.new_empty((1, 2, 0))
    rc, out = host_run(host_k9, hist, x, window, 256, True, True, frames=8)
    assert rc == -2 and torch.isnan(out).all()
    rc = host_k9.host_fft_stream(hist.data_ptr(), x.data_ptr(),
                                 window.data_ptr(), window.data_ptr(),
                                 out.data_ptr(), 1, 0, 1024, 1, 32, 32, 1,
                                 1, 256, 1, 1, 1)
    assert rc == -3
