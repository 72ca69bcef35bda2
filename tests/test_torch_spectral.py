"""The port's spectral path vs the JAX package: the Hann and Blackman
windows, ``frame``, ``fft``, ``rfft`` and ``spectrogram``, the
``FftStream`` op (complex and planar), ``waterfall_chain`` streamed,
block-parallel and in segments, ``follow_iq_file``, the ``Waterfall``
consumer and ``apps/waterfall.py``.

Tolerances: the windows and frames bitwise (the same f64 arithmetic, the
same copies); every spectrum within 1e-5 of each frame's peak (pocketfft
in torch and in XLA round differently: about 3e-7 of the peak at 1,024
points).  The JAX references run jitted on the CPU.
"""

import threading
import time

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from sdr_tpu.apps import chains as jchains
from sdr_tpu.io.plot import Waterfall as JaxWaterfall
from sdr_tpu.ops import design as jdesign
from sdr_tpu.ops import fftops as jfftops
from sdr_tpu.parallel.sharded import run_time_batched as jax_run_time_batched
from sdr_tpu.stream import FftStream as JaxFftStream
from sdr_tpu.stream import Pipeline as JaxPipeline

from sdr_tpu_torch.apps import chains, waterfall
from sdr_tpu_torch.io import Waterfall, follow_iq_file
from sdr_tpu_torch.ops import design, fftops
from sdr_tpu_torch.parallel.sharded import run_time_batched
from sdr_tpu_torch.stream import FftStream, Pipeline

PEAK_RTOL = 1e-5
BLOCK, NB = 1 << 16, 4            # u8 bytes per block, blocks


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs in several worker processes
    (pytest-xdist), where PyTorch's idle OpenMP workers spinning would
    cost the other workers the CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def broadcast(n_bytes, seed=5):
    """u8 IQ of an FM broadcast of a 1 kHz tone at 75 kHz deviation,
    1.28 MS/s, with a little noise."""
    fs, n = 1_280_000, n_bytes // 2
    phase = 75.0 * (1 - np.cos(2 * np.pi * 1e3 * np.arange(n) / fs))
    noise = np.random.default_rng(seed).normal(0, 0.01, (2, n))
    raw = np.empty(2 * n, np.uint8)
    raw[0::2] = np.clip(np.round((0.9 * np.cos(phase) + noise[0]) * 128
                                 + 128), 0, 255)
    raw[1::2] = np.clip(np.round((0.9 * np.sin(phase) + noise[1]) * 128
                                 + 128), 0, 255)
    return raw


@pytest.fixture(scope="module")
def raw():
    return broadcast(NB * BLOCK)


def assert_peak_close(got, want, rtol=PEAK_RTOL):
    """Within ``rtol`` of each frame's peak magnitude."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    peak = np.abs(want).max(axis=-1, keepdims=True)
    err = np.abs(got - want) / peak
    assert err.max() <= rtol, err.max()


def _complex(rng, shape):
    return (rng.normal(size=shape) + 1j * rng.normal(size=shape)).astype(
        np.complex64)


# -- design and frames ---------------------------------------------------


@pytest.mark.parametrize("size", [7, 64, 1024])
def test_windows_bitwise(size):
    for name in ("hanning", "blackman", "hamming"):
        np.testing.assert_array_equal(getattr(design, name)(size),
                                      getattr(jdesign, name)(size))
    # windowed_sinc's default window is Hann, as in the JAX package
    np.testing.assert_array_equal(design.windowed_sinc(size, 0.3),
                                  jdesign.windowed_sinc(size, 0.3))


@pytest.mark.parametrize("size,hop", [(16, 8), (16, 16), (16, 5), (12, 7)])
@pytest.mark.parametrize("window", [False, True])
@pytest.mark.parametrize("dtype", [np.float32, np.complex64])
def test_frame_matches_jax(rng, size, hop, window, dtype):
    x = rng.normal(size=(3, 203)).astype(np.float32)
    if dtype == np.complex64:
        x = _complex(rng, (3, 203))
    w = jdesign.hanning(size) if window else None
    got = fftops.frame(torch.from_numpy(x), size, hop, w).numpy()
    want = np.asarray(jfftops.frame(jnp.asarray(x), size, hop, w))
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


def test_frame_rejects_short_input():
    with pytest.raises(ValueError, match="shorter than one frame"):
        fftops.frame(torch.zeros(10), 16, 4)


def test_fft_rfft_spectrogram_match_jax(rng):
    x = _complex(rng, (3, 1024))
    assert_peak_close(fftops.fft(torch.from_numpy(x)).numpy(),
                      jnp.fft.fft(x))
    assert_peak_close(fftops.fft(torch.from_numpy(x), axis=0).numpy().T,
                      np.asarray(jnp.fft.fft(x, axis=0)).T)
    r = x.real.copy()
    assert_peak_close(fftops.rfft(torch.from_numpy(r)).numpy(),
                      jnp.fft.rfft(r))
    for kw in ({}, {"hop": 96, "shift": False},
               {"window": jdesign.blackman(256)}):
        got = fftops.spectrogram(torch.from_numpy(x), 256, **kw).numpy()
        want = jax.jit(lambda v: jfftops.spectrogram(v, 256, **kw))(x)
        assert_peak_close(got, want)


# -- FftStream -----------------------------------------------------------


@pytest.mark.parametrize("planar", [False, True])
def test_fft_stream_blockwise_equals_one_shot(rng, planar):
    """Blocks with the carried overlap give the frames of one call over
    the whole stream, and block-parallel rows the same."""
    n, blk = 4096, 512
    x = rng.normal(size=(2, n)).astype(np.float32) if planar \
        else _complex(rng, n)
    op = FftStream(256, 128, planar=planar, device="cpu")
    xt = torch.from_numpy(x)
    dt = xt.dtype
    bs = (2,) if planar else ()
    _, whole = op.apply(op.init_carry(n, bs, dt), xt)
    c, parts = op.init_carry(blk, bs, dt), []
    for i in range(0, n, blk):
        c, y = op.apply(c, xt[..., i:i + blk])
        parts.append(y)
    assert torch.equal(torch.cat(parts, dim=-2), whole)
    assert whole.shape == (n // 128, 256)
    assert torch.equal(run_time_batched([op], xt, n // blk, device="cpu"),
                       whole)
    # the JAX op on the same stream
    jop = JaxFftStream(256, 128, planar=planar)
    _, want = jop.apply(jop.init_carry(n, jnp.asarray(x).dtype, bs),
                        jnp.asarray(x))
    assert_peak_close(whole.numpy(), want)


def test_fft_stream_complex_spectrum_and_no_shift(rng):
    x = _complex(rng, 2048)
    for kw in ({"magnitude": False}, {"shift": False}, {"hop": 256}):
        op = FftStream(256, device="cpu", **kw)
        jop = JaxFftStream(256, **kw)
        _, got = op.apply(op.init_carry(2048, (), torch.complex64),
                          torch.from_numpy(x))
        _, want = jop.apply(jop.init_carry(2048, jnp.complex64),
                            jnp.asarray(x))
        assert got.dtype == (torch.complex64 if "magnitude" in kw
                             else torch.float32)
        assert_peak_close(got.numpy(), want)


def test_fft_stream_axes():
    """Frames are the stream (axis -2); the frame's bins follow it."""
    op = FftStream(256, 64, device="cpu")
    assert op.time_axis_out == -2 and op.out_tail() == (256,)
    assert op.out_len(1024) == 16
    p = Pipeline(chains.waterfall_chain(device="cpu"), block_in=4096,
                 device="cpu")
    assert p.time_axis_out == -2 and p.out_tail == (1024,)


def test_fft_stream_rejects_bad_geometry():
    with pytest.raises(ValueError, match="hop must be <= size"):
        FftStream(256, 512, device="cpu")
    with pytest.raises(ValueError, match="requires magnitude=True"):
        FftStream(256, planar=True, magnitude=False, device="cpu")
    with pytest.raises(ValueError, match=r"stage 1 \(FftStream\).*hop"):
        Pipeline(chains.waterfall_chain(device="cpu"), block_in=1000,
                 device="cpu")


# -- the waterfall chain -------------------------------------------------


@pytest.fixture(scope="module")
def jax_rows(raw):
    """The JAX package's rows: streamed (``Pipeline.process``) and
    block-parallel, for each form."""
    out = {}
    for planar in (False, True):
        ops = jchains.waterfall_chain(planar=planar)
        p = JaxPipeline(ops, block_in=BLOCK)
        out[planar] = (
            np.asarray(jax.jit(lambda v: p.process(v)[1])(raw)),
            np.asarray(jax.jit(
                lambda v: jax_run_time_batched(ops, v, NB))(raw)))
    return out


@pytest.mark.parametrize("planar", [False, True])
def test_waterfall_chain_matches_jax(raw, jax_rows, planar):
    ops = chains.waterfall_chain(planar=planar, device="cpu")
    p = Pipeline(ops, block_in=BLOCK, device="cpu")
    _, streamed = p.process(raw)
    batched = run_time_batched(ops, raw, NB, device="cpu")
    _, segments = p.process(raw, parallel_blocks=3)
    frames = NB * BLOCK // 2 // 512
    assert streamed.shape == (frames, 1024)
    want_streamed, want_batched = jax_rows[planar]
    assert_peak_close(streamed.numpy(), want_streamed)
    assert_peak_close(batched.numpy(), want_batched)
    assert torch.equal(batched, streamed)
    assert torch.equal(segments, streamed)
    # the rows of one block from run and the block-parallel carries
    blocks = [raw[i:i + BLOCK] for i in range(0, len(raw), BLOCK)]
    assert torch.equal(torch.cat(list(p.run(blocks)), dim=-2), streamed)
    assert torch.equal(torch.cat(list(p.run_batched(blocks, 3)), dim=-2),
                       streamed)


def test_waterfall_forms_agree(raw):
    """Planar and complex give the same rows (the JAX package's forms)."""
    rows = [run_time_batched(chains.waterfall_chain(planar=pl,
                                                    device="cpu"),
                             raw, NB, device="cpu").numpy()
            for pl in (False, True)]
    assert_peak_close(rows[1], rows[0])


def test_process_of_a_short_signal_is_empty():
    p = Pipeline(chains.waterfall_chain(device="cpu"), block_in=BLOCK,
                 device="cpu")
    _, y = p.process(np.full(BLOCK - 2, 128, np.uint8))
    assert tuple(y.shape) == (0, 1024) and y.dtype == torch.float32


# -- host I/O, the waterfall consumer and the CLI ------------------------


def test_follow_iq_file(tmp_path, rng):
    """Blocks of a growing file appear as they land, a trailing partial
    block waits, and the idle timeout ends the follow."""
    p = tmp_path / "grow.iq"
    data = rng.integers(0, 256, 4096, dtype=np.uint8)
    p.write_bytes(b"")

    def writer():
        with open(p, "ab") as fh:
            for i in range(0, 4096, 512):
                fh.write(data[i:i + 512].tobytes())
                fh.flush()
                time.sleep(0.02)

    t = threading.Thread(target=writer)
    t.start()
    blocks = list(follow_iq_file(p, 1024, poll=0.01, idle_timeout=0.5))
    t.join(timeout=10)
    assert not t.is_alive()
    assert len(blocks) == 4
    np.testing.assert_array_equal(np.concatenate(blocks), data)
    # from_end: only what lands after the start
    tail = list(follow_iq_file(p, 1024, poll=0.01, idle_timeout=0.05,
                               from_end=True))
    assert tail == []


def test_waterfall_consumer_matches_jax(rng):
    rows = rng.uniform(1e-6, 1.0, (40, 256)).astype(np.float32)
    rows[:, 100] = 1.0
    wf, jwf = Waterfall(256, rows=16), JaxWaterfall(256, rows=16)
    for k in (5, 3, 1, 20, 7):
        chunk, rows = rows[:k], rows[k:]
        wf.push(chunk)
        jwf.push(chunk)
        np.testing.assert_array_equal(wf.buf, jwf.buf)
    wf.push(rows[0])
    jwf.push(rows[0])
    np.testing.assert_array_equal(wf.buf, jwf.buf)
    assert wf.ansi_rows(wf.buf, cols=64) == jwf.ansi_rows(jwf.buf, cols=64)
    lines = wf.ansi_rows(wf.buf[:4], cols=64)
    assert len(lines) == 4 and all(len(line) == 64 for line in lines)
    assert all(line[100 * 64 // 256] == "@" for line in lines)


def test_waterfall_cli_on_cpu(raw, tmp_path, capsys):
    """One-shot: the PNG; --follow --term: the PNG and the text rows,
    which are the JAX Waterfall's text for the same rows."""
    src = tmp_path / "capture.u8"
    raw.tofile(src)
    out = tmp_path / "wf.png"
    assert waterfall.main(["--in", str(src), "--out", str(out), "--block",
                           str(BLOCK), "--device", "cpu"]) == 0
    said = capsys.readouterr().out
    assert f"wrote {NB * BLOCK // 1024}x1024 waterfall" in said
    assert out.stat().st_size > 1000

    live = tmp_path / "live.png"
    assert waterfall.main(["--in", str(src), "--out", str(live), "--block",
                           str(BLOCK), "--device", "cpu", "--follow",
                           "--term", "--refresh-rows", "32",
                           "--idle-timeout", "0.2"]) == 0
    lines = capsys.readouterr().out.splitlines()
    frames = NB * BLOCK // 1024
    assert lines[-1] == f"followed {frames} rows into {live}"
    assert live.stat().st_size > 1000
    rows = run_time_batched(chains.waterfall_chain(device="cpu"), raw, NB,
                            device="cpu").numpy()
    assert lines[:-1] == JaxWaterfall(1024).ansi_rows(rows)
