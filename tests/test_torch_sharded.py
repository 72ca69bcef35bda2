"""The port's sharded runners over four gloo processes on the CPU, against
the port's one-process block-parallel run and the JAX package's sharded
runners (the counterpart of tests/test_parallel.py), and the compiled
sharded calls (``compile_time_sharded``, ``compile_channel_sharded``,
``compile_grid_sharded``, and ``compile_time_batched(group=)`` under
them) against the eager runners and the JAX package's.

Four worker processes (tests/torch_sharded_worker.py) run every scenario
once for the module: each rank its span of the inputs made here with
numpy, on a 4-rank ``"t"`` mesh (time), a ``"c"`` mesh (channels) or the
2 x 2 ``("c", "t")`` grid.  The JAX references run jitted on a submesh of
the conftest's virtual CPU devices.  On the CPU a compiled call keeps its
function and runs it again on its own buffers (utils/graphs.py), so the
compiled scenarios hold the buffer handling the card's graphs run: the
input copied in, the carries entering rank 0's first block and the
stream's state written back on every rank, the output handed out.  The
card's capture of the NCCL gathers is checked by ``chip_smoke.py``
(phase 11, one rank).

Tolerances:

* against the port's ``run_time_batched`` over the same blocks: bitwise
  for the chains whose seams are halos only (FIRs, fronts, resamplers,
  demods, ``Mix``'s row phasors, FFT frames, ``Channelize``) and for the
  sequential AGC's R sweeps, but an ulp of pi where the CPU's complex
  demod rounds a batch's tail otherwise (``ANGLE``); 1e-5 where an affine
  prefix composes the ranks' maps in another order than one process does
  (``DcBlocker``, linear ``Agc``, ``Iir``, ``StereoDecode``'s lock);
* against the JAX package, the bounds the other ``test_torch_*`` files
  hold the same ops to (1e-5 for f32 chains, 2e-5 for the stereo chain,
  1e-6 for ``Mix``, 1e-4 for the wideband filterbank and the FM demod
  after it, 1e-5 of each frame's peak for FFT frames);
* a compiled call against its eager runner: bitwise on every rank (the
  same ops on the same inputs).
"""

from __future__ import annotations

import numpy as np
import pytest
import scipy.signal
import torch

import jax
import jax.numpy as jnp

from sdr_tpu import ops as jops
from sdr_tpu import parallel as jparallel
from sdr_tpu.apps import chains as jchains
from sdr_tpu.ops.channelize import channelizer_taps as jchannelizer_taps
from sdr_tpu.stream import (Agc as JAgc, Channelize as JChannelize,
                            DcBlocker as JDcBlocker, FftStream as JFftStream,
                            Fir as JFir, FmDemod as JFmDemod, Iir as JIir,
                            IqConvertU8 as JIqConvertU8, Mix as JMix,
                            Scale as JScale)

from sdr_tpu_torch.apps import chains
from sdr_tpu_torch.parallel import halo
from sdr_tpu_torch.parallel.sharded import run_time_batched

import torch_sharded_worker as worker
from torch_sharded_worker import spawn

WORLD = 4

PREFIX = {"dc_blocker", "agc_linear", "iir", "fm_deemphasis",
          "dry_wideband", "dry_stereo", "am_planar"}
PREFIX_ATOL = 1e-5
# chains with the complex demod: PyTorch's CPU angle runs a vector body
# and a scalar tail over each tensor, which may round an output an ulp
# apart, so an output's last bit depends on where the batch ends; the
# card's elementwise kernels do not, and chip_smoke.py holds these
# chains bitwise there
ANGLE = {"fm_exact", "channel", "grid"}
ANGLE_ULP = float(np.spacing(np.float32(np.pi)))
RUN = [n for n in worker.SCENARIOS if n != "agc_scan_refused"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs in several worker processes
    (pytest-xdist), where PyTorch's idle OpenMP workers spinning would
    cost the other workers the CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _carrier(rng, n):
    return ((2.0 + 0.2 * rng.normal(size=n))
            * np.exp(2j * np.pi * rng.uniform(size=n))).astype(np.complex64)


def _fm_bank(n_channels, n, fs=1_280_000.0):
    """FM basebands, channel c carrying a tone of ``200 + 150 c`` Hz at
    75 kHz deviation (the channelizer app's synthetic input): a demod of
    noise would make the JAX comparison a test of ill-conditioned angles."""
    t = np.arange(n) / fs
    tones = 200.0 + 150.0 * np.arange(n_channels)
    audio = np.sin(2 * np.pi * tones[:, None] * t)
    return (0.9 * np.exp(2j * np.pi * 75e3 * np.cumsum(audio, -1) / fs)
            ).astype(np.complex64)


def _cplx(rng, shape):
    return (rng.normal(size=shape) + 1j * rng.normal(size=shape)).astype(
        np.complex64)


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(0)
    u8 = lambda n: rng.integers(0, 256, n).astype(np.uint8)  # noqa: E731
    return {
        "real": rng.uniform(-1, 1, WORLD * 2 * 1024).astype(np.float32),
        "real_dc": (rng.uniform(-1, 1, WORLD * 2 * 1024) + 0.7).astype(
            np.float32),
        "raw": u8(WORLD * 2 * 81_920),
        "cplx": _cplx(rng, WORLD * 2 * 1024),
        "planar": rng.normal(size=(2, WORLD * 2 * 1024)).astype(np.float32),
        "bank": _fm_bank(8, 4096),
        "bank_long": _fm_bank(4, 2 * 2 * 20_480),
        "agc": _carrier(rng, WORLD * 2 * 8192),
        "raw_grid": u8((2, 2 * 10_240)),
        "wide": _cplx(rng, WORLD * 2048),
        "raw_q": u8(WORLD * 10_240),
        "raw_s": u8(WORLD * 20_480),
        # the halo helpers: 8 rows of one stream, 2 a rank
        "halo_x": rng.normal(size=(8, 3, 16)).astype(np.float32),
        "halo_a": rng.uniform(0.5, 1.0, (8, 3)).astype(np.float32),
        "halo_b": rng.normal(size=(8, 3)).astype(np.float32),
        "halo_M": (0.5 * rng.normal(size=(8, 3, 2, 2))).astype(np.float32),
        "halo_v": rng.normal(size=(8, 3, 2)).astype(np.float32),
        # the compiled scenarios' second inputs, and the segments
        "raw2": u8(WORLD * 2 * 81_920),
        "raw3": u8(WORLD * 2 * 81_920),
        "bank_long2": (_fm_bank(4, 2 * 2 * 20_480)
                       + 0.01 * _cplx(rng, (4, 2 * 2 * 20_480))).astype(
                           np.complex64),
    }


@pytest.fixture(scope="module")
def ranks(inputs, tmp_path_factory):
    """Each rank's outputs of every scenario."""
    tmp = tmp_path_factory.mktemp("sharded")
    np.savez(tmp / "in.npz", **inputs)
    outs = spawn("sharded", WORLD, tmp / "in.npz", tmp)
    loaded = []
    for path in outs:
        with np.load(path) as f:
            loaded.append({k: f[k] for k in f.files})
    return loaded


def _join(name, parts, t_axis):
    """The ranks' outputs as one: along the stream axis for time meshes,
    the channel axis for a channel mesh, both for the grid (rank c*2 + t,
    channels outermost)."""
    mode = worker.SCENARIOS[name][0]
    if mode == "time":
        return np.concatenate(parts, axis=t_axis)
    if mode == "channel":
        return np.concatenate(parts, axis=-2)
    rows = [np.concatenate(parts[2 * c:2 * c + 2], axis=t_axis)
            for c in range(WORLD // 2)]
    return np.concatenate(rows, axis=-2)


def joined(ranks, name):
    ops = worker.SCENARIOS[name][3]()
    return _join(name, [r[name] for r in ranks], ops[-1].time_axis_out)


def batched(inputs, name):
    """The port's one-process block-parallel run over the same blocks."""
    mode, key, nblocks, make = worker.SCENARIOS[name]
    blocks = {"time": WORLD * nblocks, "channel": 1, "grid": 2 * nblocks}
    return run_time_batched(make(), inputs[key], blocks[mode],
                            device="cpu").numpy()


@pytest.mark.parametrize("name", RUN)
def test_sharded_matches_one_process(ranks, inputs, name):
    got, want = joined(ranks, name), batched(inputs, name)
    assert got.shape == want.shape
    if name in PREFIX:
        np.testing.assert_allclose(got, want, rtol=0, atol=PREFIX_ATOL)
    elif name in ANGLE:
        np.testing.assert_allclose(got, want, rtol=0, atol=ANGLE_ULP)
    else:
        np.testing.assert_array_equal(got, want)


def test_refused_chain_raises_on_every_rank(ranks):
    """A scan AGC without the opt-in raises the runners' ValueError on every
    rank before any collective: no rank hangs, and the scenarios after it
    ran on all four."""
    for r in ranks:
        assert "approx_time_sharding" in str(r["agc_scan_refused.error"])
        assert "agc_scan_refused" not in r
        assert all(n in r for n in RUN)


def test_unequal_spans_raise_on_every_rank(ranks):
    """One rank's span longer than the others': the runner's gathered
    shape check raises the same ValueError on every rank."""
    for r in ranks:
        assert "differ in shape" in str(r["unequal.error"])
        assert "(1024,)" in str(r["unequal.error"])
        assert "(1088,)" in str(r["unequal.error"])


# -- the halo helpers ---------------------------------------------------


def test_halos_follow_the_rank_order(ranks, inputs):
    x = torch.from_numpy(inputs["halo_x"])
    a = torch.from_numpy(inputs["halo_a"])
    whole = lambda k: np.concatenate([r[k] for r in ranks])  # noqa: E731
    np.testing.assert_array_equal(whole("halo.left"),
                                  halo.left_halo(x, 5, fill=7).numpy())
    np.testing.assert_array_equal(whole("halo.right"),
                                  halo.right_shift_scalar(a).numpy())
    want = x.clone().numpy()
    want[0] = 0                           # only the stream's first row
    np.testing.assert_array_equal(whole("halo.first"), want)
    assert [int(r["halo.row0"]) for r in ranks] == [0, 2, 4, 6]


def test_prefixes_compose_the_ranks_before(ranks, inputs):
    t = {k: torch.from_numpy(inputs[k]) for k in inputs if "halo" in k}
    whole = lambda k: np.concatenate([r[k] for r in ranks])  # noqa: E731
    A, B = halo.exclusive_affine_prefix(t["halo_a"], t["halo_b"])
    MA, Mc = halo.exclusive_matrix_affine_prefix(t["halo_M"], t["halo_v"])
    for k, want in (("halo.A", A), ("halo.B", B), ("halo.MA", MA),
                    ("halo.Mc", Mc)):
        np.testing.assert_allclose(whole(k), want.numpy(), rtol=0,
                                   atol=1e-6)
    # rank 0 has nothing before it: its rows are the one-process rows
    np.testing.assert_array_equal(ranks[0]["halo.B"], B[:2].numpy())


# -- against the JAX package -------------------------------------------


def _jax_fm_exact():
    ws, ham = jops.windowed_sinc, jops.hamming
    return [JIqConvertU8(), JFir.decimator(ws(51, 0.1, ham), 8), JFmDemod(),
            JFir.resampler(ws(31, 0.25, ham), 3, 10),
            JFir.filter(ws(64, 0.5, ham)), JScale(0.2)]


JAX = {
    "fir": (lambda: [JFir.filter(worker._fir_taps())], 1e-5),
    "fm_exact": (_jax_fm_exact, 1e-5),
    "dc_blocker": (lambda: [JDcBlocker()], 1e-5),
    "mix": (lambda: [JMix(0.05)], 1e-6),
    "mix_planar": (lambda: [JMix(0.1234567, planar=True)], 1e-6),
    "fft_stream": (lambda: [JFftStream(256, 128)], None),
    "channel": (lambda: [JFir.decimator(jops.windowed_sinc(
        33, 0.2, jops.hamming), 4), JFmDemod()], 1e-5),
    "grid": (lambda: [JFir.decimator(jops.windowed_sinc(
        51, 0.1, jops.hamming), 8), JFmDemod()], 1e-5),
    "agc_linear": (lambda: [JAgc(0.005, 1.0)], 1e-5),
    "am_planar": (lambda: jchains.am_chain(planar=True), 1e-4),
    "agc_approx": (lambda: [JAgc(0.005, 1.0, method="scan",
                                 approx_time_sharding=2)], 1e-5),
    "iir": (lambda: [JIir(scipy.signal.butter(4, 0.2, output="sos")
                          .astype(np.float32))], 1e-5),
    "fm_deemphasis": (lambda: jchains.fm_chain(
        front="fused", fuse_back=True, deemphasis=75e-6,
        deemphasis_mode="iir"), 1e-5),
    "dry_grid_fm": (lambda: jchains.fm_chain(front="fused",
                                             fuse_back=True), 1e-5),
    "dry_wideband": (lambda: [JChannelize(jchannelizer_taps(4, 4), 4),
                              JFmDemod(), JDcBlocker()], 1e-4),
    "dry_quantized": (lambda: jchains.fm_chain(method="conv",
                                               front="quantized"), 1e-5),
    "dry_fused": (lambda: jchains.fm_chain(method="conv", front="fused",
                                           front_precision="s8"), 1e-5),
    "dry_stereo": (lambda: jchains.fm_chain(
        method="conv", front="quantized", stereo=True, deemphasis=75e-6,
        fuse_back=True), 2e-5),
}


def jax_sharded(mode, ops, x):
    """The JAX package's runner of ``mode``'s mesh over ``ops``, jitted, on
    the first four virtual CPU devices."""
    if mode == "time":
        mesh = jparallel.make_mesh((WORLD,), ("t",))
        fn = lambda v: jparallel.run_time_sharded(ops, mesh, v)  # noqa
    elif mode == "channel":
        mesh = jparallel.make_mesh((WORLD,), ("c",))
        fn = lambda v: jparallel.run_channel_sharded(ops, mesh, v)  # noqa
    else:
        mesh = jparallel.make_mesh((2, 2), ("c", "t"))
        fn = lambda v: jparallel.run_grid_sharded(ops, mesh, v)  # noqa
    return np.asarray(jax.jit(fn)(jnp.asarray(x)))


@pytest.mark.parametrize("name", sorted(JAX))
def test_sharded_matches_jax_sharded(ranks, inputs, name):
    got = joined(ranks, name)
    mode, key = worker.SCENARIOS[name][:2]
    want = jax_sharded(mode, JAX[name][0](), inputs[key])
    assert got.shape == want.shape
    atol = JAX[name][1]
    if atol is None:        # FFT frames: within 1e-5 of each frame's peak
        err = np.abs(got - want).max(axis=-1) / np.abs(want).max(axis=-1)
        assert err.max() <= 1e-5, err.max()
    else:
        np.testing.assert_allclose(got, want, rtol=0, atol=atol)


# -- the compiled sharded calls ------------------------------------------


def same(a, b) -> bool:
    return a.dtype == b.dtype and a.shape == b.shape and np.array_equal(
        a.reshape(-1).view(np.uint8), b.reshape(-1).view(np.uint8))


@pytest.mark.parametrize("call", [0, 1])
@pytest.mark.parametrize("name", sorted(worker.COMPILED))
def test_compiled_is_the_eager_runner_bitwise(ranks, name, call):
    """Call 0 on the input the call was compiled on, call 1 after copying
    the second recording in: every rank's output is the eager runner's on
    the same span, bit for bit."""
    for r, out in enumerate(ranks):
        got, want = out[f"{name}.compiled{call}"], out[f"{name}.eager{call}"]
        assert same(got, want), (r, np.abs(got - want).max())


@pytest.mark.parametrize("name", sorted(worker.COMPILED))
def test_a_new_input_is_copied_in_once(ranks, name):
    assert [int(r[f"{name}.input_copies"]) for r in ranks] == [1] * WORLD


def _carries(out, form, seg):
    return [out[k] for k in sorted(
        (k for k in out if k.startswith(f"segment.{form}{seg}.carry")),
        key=lambda k: int(k.rsplit("carry", 1)[1]))]


@pytest.mark.parametrize("form", worker.SEGMENT_FORMS)
@pytest.mark.parametrize("seg", [0, 1])
def test_segmented_compiled_is_the_eager_runner_bitwise(ranks, seg, form):
    """``am_chain()`` in two segments, the carries entering rank 0's first
    block and each rank returning its own last block's: the compiled
    call's outputs and carries are the eager ``run_time_batched(group=)``'s
    on every rank, bit for bit, whether the second call takes the carries
    the first returned, none (the stream's state the graph wrote back), or
    the last rank's."""
    for r, out in enumerate(ranks):
        assert same(out[f"segment.{form}{seg}"], out[f"segment.eager{seg}"])
        got, want = _carries(out, form, seg), _carries(out, "eager", seg)
        assert len(got) == len(want) > 0
        assert all(same(a, b) for a, b in zip(got, want)), r


@pytest.mark.parametrize("form", worker.SEGMENT_FORMS)
def test_segmented_copies(ranks, form):
    """The second call copied its input in, and each carry leaf was
    copied in once at compile time, and again only where the second call
    was given other carries than the first returned."""
    leaves = len(_carries(ranks[0], form, 0))
    more = leaves if form == "gathered" else 0
    for out in ranks:
        assert out[f"segment.{form}.copies"].tolist() == [1, leaves + more]


@pytest.mark.parametrize("form", worker.SEGMENT_FORMS)
def test_segmented_run_is_the_one_process_stream(ranks, inputs, form):
    """The ranks' two segments joined equal one process over the whole
    stream with its carries threaded, within 1e-5 (H7)."""
    ops = chains.am_chain(device="cpu")
    blocks = WORLD * worker.SEGMENT_BLOCKS
    first, *rest = worker.SEGMENTS
    cs, _ = run_time_batched(ops, inputs[first], worker.SEGMENT_BLOCKS,
                             return_carries=True, device="cpu")
    for seg, key in enumerate(rest):
        cs, want = run_time_batched(ops, inputs[key], blocks, carries=cs,
                                    return_carries=True, device="cpu")
        got = np.concatenate([r[f"segment.{form}{seg}"] for r in ranks],
                             axis=-1)
        assert got.shape == tuple(want.shape)
        np.testing.assert_allclose(got, want.numpy(), rtol=0,
                                   atol=PREFIX_ATOL)


JAX_COMPILED = {
    "mono": (lambda: jchains.fm_chain(front="fused", fuse_back=True), 1e-5),
    "am": JAX["am_planar"],
}


@pytest.mark.parametrize("call", [0, 1])
@pytest.mark.parametrize("name", sorted(JAX_COMPILED))
def test_compiled_matches_jax_sharded(ranks, inputs, name, call):
    """The ranks' compiled outputs joined against the JAX package's
    ``jax.jit(lambda g: run_time_sharded(...))`` on the same recording."""
    mode, key = worker.COMPILED[name][:2]
    make, atol = JAX_COMPILED[name]
    got = np.concatenate([r[f"{name}.compiled{call}"] for r in ranks],
                         axis=-1)
    want = jax_sharded(mode, make(), inputs[key + ("", "2")[call]])
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=atol)


def test_unequal_spans_raise_at_compile_time_on_every_rank(ranks):
    """One rank's span longer than the others': the compile-time shape
    check raises the same ValueError on every rank."""
    errors = {str(r["compiled.unequal.error"]) for r in ranks}
    assert len(errors) == 1
    error, = errors
    assert "differ in shape" in error
    assert "(1024,)" in error and "(1088,)" in error


def test_capturable_refuses_a_gloo_group_on_the_card(ranks):
    """A gloo group runs gloo for CUDA tensors (``group_backend``), so its
    collectives cannot be captured on the card; on the CPU there is no
    graph, so any group will do.  No CUDA call is made."""
    for r in ranks:
        assert r["capturable"].tolist() == [False, True, True]


def test_a_failure_on_one_rank_raises_on_every_rank(ranks):
    """``on_every_rank``: a step that succeeds everywhere returns each
    rank's result; one that raises on rank 2 raises there and on every
    other rank, which names it."""
    assert [int(r["agree.ok"]) for r in ranks] == list(range(WORLD))
    for rank, r in enumerate(ranks):
        text = str(r["agree.fail"])
        if rank == 2:
            assert text == "ArithmeticError: rank 2 failed"
        else:
            assert text.startswith("RuntimeError: ranks [2] of the group")
