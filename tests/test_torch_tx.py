"""The port's transmit side against the JAX package: ``fm_mod`` (its
phase sum in the JAX function's order), ``FmMod``, ``stream/sources.py``,
the raw IQ file formats of ``io/files.py``, and ``apps/fm_tx.py``.

Tolerances (abs): ``cumsum`` bitwise (the same f32 adds in the same
order); ``fm_mod`` and ``FmMod`` 1e-5 on the samples and the carried phase
(``cos``/``sin`` an ulp apart), streamed against whole 1e-3 (the JAX
package's bound, tests/test_ops.py: the sum's order depends on the block
edges); ``fm_demod(fm_mod(x))`` 2e-3 of ``sensitivity*x``; sources
bitwise.  The transmitter CLI: its resamplers within 1e-6 of the JAX
chain's (K2's tap-order sums against the JAX package's), its modulator
within 1e-5 of JAX's on the same upsampled input, and the two CLIs'
i16 files transmit the same frequency within 2e-3 rad a sample.  The two
i16 files are not compared value by value: a 1-ulp change of one input
sample flips roundings of the f32 phase sum at |phi| ~ 60 rad, so the
phases of the two files part as the file goes on (ROADMAP H12;
``python tests/test_torch_tx.py`` prints how far).
"""

import wave

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from sdr_tpu.apps import fm_tx as jfm_tx
from sdr_tpu.io import files as jfiles
from sdr_tpu.ops import design as jdesign
from sdr_tpu.ops import demod as jdemod
from sdr_tpu.parallel.sharded import run_time_batched as jax_run_time_batched
from sdr_tpu.stream import Fir as JaxFir
from sdr_tpu.stream import FmMod as JaxFmMod
from sdr_tpu.stream import Pipeline as JaxPipeline
from sdr_tpu.stream import sources as jsources

from sdr_tpu_torch.apps import fm, fm_tx
from sdr_tpu_torch.io import files
from sdr_tpu_torch.ops import demod
from sdr_tpu_torch.parallel.sharded import run_time_batched
from sdr_tpu_torch.stream import FmMod, Pipeline, sources

ATOL = 1e-5
STREAM_ATOL = 1e-3
DEMOD_ATOL = 2e-3
TWO_PI = 2 * np.pi


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs in several worker processes
    (pytest-xdist), where PyTorch's idle OpenMP workers spinning would
    cost the other workers the CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _phase_diff(a, b):
    """Distance of two phases on the circle."""
    d = np.mod(np.asarray(a, np.float64) - np.asarray(b, np.float64), TWO_PI)
    return np.minimum(d, TWO_PI - d)


# -- fm_mod, FmMod -------------------------------------------------------


@pytest.mark.parametrize("n", [1, 7, 16, 17, 300, 4099, 70_000])
def test_cumsum_is_the_jax_order(rng, n):
    x = rng.uniform(-1, 1, (2, n)).astype(np.float32)
    want = jax.jit(lambda v: jnp.cumsum(v, axis=-1))(x)
    np.testing.assert_array_equal(demod.cumsum(torch.from_numpy(x)).numpy(),
                                  np.asarray(want))


@pytest.mark.parametrize("shape", [(2048,), (3, 5000)])
def test_fm_mod_matches_jax(rng, shape):
    x = rng.uniform(-1, 1, shape).astype(np.float32)
    phase = rng.uniform(0, TWO_PI, shape[:-1]).astype(np.float32)
    y, final = demod.fm_mod(torch.from_numpy(x), 0.3,
                            torch.from_numpy(phase), 0.9)
    jy, jfinal = jax.jit(lambda v, p: jdemod.fm_mod(v, 0.3, p, 0.9))(x,
                                                                     phase)
    assert y.dtype == torch.complex64 and final.dtype == torch.float32
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=0, atol=ATOL)
    assert _phase_diff(final.numpy(), jfinal).max() <= ATOL
    assert ((final >= 0) & (final < TWO_PI)).all()
    # a number as the entering phase
    y0, f0 = demod.fm_mod(torch.from_numpy(x), 0.3)
    jy0, jf0 = jax.jit(lambda v: jdemod.fm_mod(v, 0.3))(x)
    np.testing.assert_allclose(y0.numpy(), np.asarray(jy0), rtol=0,
                               atol=ATOL)
    assert _phase_diff(f0.numpy(), jf0).max() <= ATOL


def test_fm_mod_demod_roundtrip(rng):
    """tests/test_ops.py's case: the demodulator gives back
    ``sensitivity * x``."""
    x = rng.uniform(-1, 1, 2048).astype(np.float32)
    y, _ = demod.fm_mod(torch.from_numpy(x), 0.3)
    back, _ = demod.fm_demod(y)
    np.testing.assert_allclose(back.numpy()[1:], 0.3 * x[1:], rtol=0,
                               atol=DEMOD_ATOL)


def test_fm_mod_op_streams_as_jax(rng):
    """tests/test_ops.py's case: eight blocks of 256 with the phase carried
    against one block of 2,048 (1e-3), and each block and carry against
    the JAX op (1e-5)."""
    x = rng.uniform(-1, 1, 2048).astype(np.float32)
    op, jop = FmMod(0.25, device="cpu"), JaxFmMod(0.25)
    assert op.out_dtype(torch.float32) == torch.complex64
    _, whole = op.apply(op.init_carry(2048), torch.from_numpy(x))
    c, jc = op.init_carry(256), jop.init_carry(256, np.float32)
    step = jax.jit(jop.apply)
    parts = []
    for i in range(0, 2048, 256):
        c, y = op.apply(c, torch.from_numpy(x[i:i + 256]))
        jc, jy = step(jc, x[i:i + 256])
        np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=0,
                                   atol=ATOL)
        assert _phase_diff(c.numpy(), jc).max() <= ATOL
        parts.append(y)
    np.testing.assert_allclose(torch.cat(parts).numpy(), whole.numpy(),
                               rtol=0, atol=STREAM_ATOL)
    _, piped = Pipeline([op], block_in=256, in_dtype=torch.float32,
                        device="cpu").process(x)
    assert torch.equal(piped, torch.cat(parts))


def test_fm_mod_op_has_no_block_parallel_form(rng):
    """As in the JAX package: the phase entering a block is the whole
    stream's sum before it."""
    x = rng.uniform(-1, 1, 2048).astype(np.float32)
    op = FmMod(0.25, device="cpu")
    assert op.time_shardable
    with pytest.raises(NotImplementedError, match="FmMod"):
        run_time_batched([op], x, 4, device="cpu")
    with pytest.raises(NotImplementedError, match="FmMod"):
        jax_run_time_batched([JaxFmMod(0.25)], x, 4)


# -- sources -------------------------------------------------------------


def test_random_sources_match_jax():
    got, want = sources.stream_random(1000, seed=5), \
        jsources.stream_random(1000, seed=5)
    for _ in range(3):
        b = next(got)
        assert b.dtype == np.float32
        np.testing.assert_array_equal(b, next(want))
    for complex_ in (True, False):
        a = sources.noise(4096, 0.5, seed=3, complex_=complex_)
        b = jsources.noise(4096, 0.5, seed=3, complex_=complex_)
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(sources.tone(1000, 500, 48000, 0.7),
                                  jsources.tone(1000, 500, 48000, 0.7))
    np.testing.assert_array_equal(
        sources.tone(10, 64, 1000, dtype=np.complex128),
        jsources.tone(10, 64, 1000, dtype=np.complex128))
    audio = np.sin(np.arange(3000) * 0.01)
    np.testing.assert_array_equal(sources.fm_mod(audio, 75e3, 1.28e6),
                                  jsources.fm_mod(audio, 75e3, 1.28e6))


def test_stream_string_bit_order_and_wrap():
    """LSB first in each byte, +-1, wrapping to the first bit."""
    got = sources.stream_string(b"\x01\x80", 5)
    want = jsources.stream_string(b"\x01\x80", 5)
    blocks = [next(got) for _ in range(5)]
    for b in blocks:
        np.testing.assert_array_equal(b, next(want))
    bits = np.concatenate(blocks)
    expect = np.array([1, -1, -1, -1, -1, -1, -1, -1,
                       -1, -1, -1, -1, -1, -1, -1, 1], np.float32)
    np.testing.assert_array_equal(bits[:16], expect)
    np.testing.assert_array_equal(bits[16:25], expect[:9])
    with pytest.raises(ValueError, match="empty"):
        next(sources.stream_string(b"", 4))


def test_combinators(capsys):
    blocks = [np.arange(3), np.arange(3, 6)]
    seen_a, seen_b = [], []
    sources.fork(iter(blocks), seen_a.append, seen_b.append)
    assert seen_a == seen_b == blocks
    assert sources.combine is sources.fork
    assert sources.devnull(iter(blocks)) == 2
    sources.print_sink(iter(blocks), limit=1)
    assert capsys.readouterr().out.strip() == "[0 1 2]"


# -- io/files ------------------------------------------------------------


@pytest.mark.parametrize("fmt", ["u8", "i16", "f32", "c64"])
def test_iq_file_formats_round_trip(rng, fmt, tmp_path):
    dtype = files.IQ_DTYPES[fmt]
    assert dtype is jfiles.IQ_DTYPES[fmt]
    x = (rng.uniform(0, 200, 1000) + (1j if fmt == "c64" else 0)
         * rng.uniform(0, 200, 1000)).astype(dtype)
    path = tmp_path / f"x.{fmt}"
    files.write_iq_file(path, torch.from_numpy(x))     # a tensor
    np.testing.assert_array_equal(files.read_iq_file(path, fmt), x)
    np.testing.assert_array_equal(jfiles.read_iq_file(path, fmt), x)
    np.testing.assert_array_equal(
        files.read_iq_file(path, fmt, count=10,
                           offset=5 * np.dtype(dtype).itemsize), x[5:15])
    blocks = list(files.iq_file_source(path, 300, fmt))
    assert len(blocks) == 3 and blocks[0].dtype == dtype
    np.testing.assert_array_equal(np.concatenate(blocks), x[:900])
    followed = list(files.follow_iq_file(path, 300, fmt, poll=0.01,
                                         idle_timeout=0.02))
    np.testing.assert_array_equal(np.concatenate(followed), x[:900])
    # block_sink appends, converting to fmt
    out = tmp_path / "sink.raw"
    write, close = files.block_sink(out, fmt)
    write(x[:400].astype(np.float64) if fmt != "c64" else x[:400])
    write(torch.from_numpy(x[400:]))
    close()
    np.testing.assert_array_equal(files.read_iq_file(out, fmt), x)
    files.write_iq_file(out, x.astype(np.float64) if fmt != "c64" else x,
                        fmt)
    np.testing.assert_array_equal(jfiles.read_iq_file(out, fmt), x)


# -- the transmitter CLI -------------------------------------------------


def _tone_wav(path, seconds, freq, rate=48_000):
    n = int(rate * seconds)
    audio = 0.8 * np.sin(2 * np.pi * freq * np.arange(n) / rate)
    with wave.open(str(path), "wb") as wf:
        wf.setnchannels(1)
        wf.setsampwidth(2)
        wf.setframerate(rate)
        wf.writeframes((audio * 32767).astype("<i2").tobytes())
    return (audio * 32767).astype("<i2") / 32768.0


def _iq(path):
    raw = np.fromfile(path, np.int16).astype(np.float32) / 2048.0
    return torch.from_numpy((raw[0::2] + 1j * raw[1::2]).astype(
        np.complex64))


def test_fm_tx_taps_and_chain_match_jax():
    up1 = jdesign.windowed_sinc(31, 0.1 * 3, jdesign.hamming) * 10 / 3
    up2 = jdesign.windowed_sinc(51, 0.1, jdesign.hamming) * 8
    ops = fm_tx.tx_chain(48_000, 75_000, device="cpu")
    np.testing.assert_array_equal(ops[0].spec.taps, up1)
    np.testing.assert_array_equal(ops[1].spec.taps, up2)
    assert (ops[0].spec.interpolation, ops[0].spec.decimation) == (10, 3)
    assert (ops[1].spec.interpolation, ops[1].spec.decimation) == (8, 1)
    assert ops[2].sensitivity == float(2 * np.pi * 75_000 / 1_280_000)
    assert ops[2].amplitude == 0.9


def test_fm_tx_cli_matches_jax_and_decodes(tmp_path):
    """``fm_tx --device cpu`` against the JAX CLI on a 0.5 s, 1 kHz WAV at
    4,608-sample blocks, then the port's ``fm`` CLI decodes its file (as
    u8, tests/test_io_apps.py's conversion) to the tone."""
    wav = tmp_path / "tone.wav"
    audio = _tone_wav(wav, 0.5, 1000).astype(np.float32)
    ours, theirs = tmp_path / "t.iq", tmp_path / "j.iq"
    assert fm_tx.main(["--in", str(wav), "--out", str(ours), "--block",
                       "4608", "--device", "cpu"]) == 0
    assert jfm_tx.main(["--in", str(wav), "--out", str(theirs), "--block",
                        "4608"]) == 0
    a, b = _iq(ours), _iq(theirs)
    assert a.shape == b.shape == (5 * 4608 * 80 // 3,)
    # the same frequency trajectory, sample for sample
    np.testing.assert_allclose(demod.fm_demod(a)[0].numpy(),
                               demod.fm_demod(b)[0].numpy(), rtol=0,
                               atol=DEMOD_ATOL)
    # the chain's parts: the resamplers, then the modulator on JAX's input
    n = 5 * 4608
    ops = fm_tx.tx_chain(48_000, 75_000, device="cpu")
    jops = [JaxFir.resampler(op.spec.taps, op.spec.interpolation,
                             op.spec.decimation) for op in ops[:2]]
    _, up = Pipeline(ops[:2], block_in=4608, in_dtype=torch.float32,
                     device="cpu").process(audio[:n])
    _, jup = jax.jit(JaxPipeline(jops, block_in=4608,
                                 in_dtype=jnp.float32).process)(audio[:n])
    np.testing.assert_allclose(up.numpy(), np.asarray(jup), rtol=0,
                               atol=1e-6)
    m = 4608 * 80 // 3
    jop = JaxFmMod(ops[2].sensitivity, amplitude=0.9)
    c, jc = ops[2].init_carry(m), jop.init_carry(m, np.float32)
    step = jax.jit(jop.apply)
    for i in range(0, jup.shape[-1], m):
        blk = np.array(jup[i:i + m])
        c, y = ops[2].apply(c, torch.from_numpy(blk))
        jc, jy = step(jc, blk)
        np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=0,
                                   atol=ATOL)
        assert _phase_diff(c.numpy(), jc).max() <= ATOL
    # decode: i16 -> u8 as the JAX app test does, then the receiver CLI
    raw = np.fromfile(ours, np.int16).astype(np.float32) / 2048.0
    cap = tmp_path / "loop.u8"
    np.clip(np.round(raw * 128 + 128), 0, 255).astype(np.uint8).tofile(cap)
    out = tmp_path / "rx.wav"
    assert fm.main(["--in", str(cap), "--out", str(out), "--block",
                    "163840", "--device", "cpu"]) == 0
    with wave.open(str(out)) as wf:
        pcm = np.frombuffer(wf.readframes(wf.getnframes()), "<i2")
    seg = pcm[2000:].astype(np.float64)
    spec = np.abs(np.fft.rfft(seg * np.hanning(len(seg))))
    tone = (np.argmax(spec[5:]) + 5) * 48_000 / len(seg)
    assert abs(tone - 1000) < 10, f"tone {tone}"


def test_fm_tx_cli_refuses_what_the_jax_cli_refuses(tmp_path, capsys):
    stereo = tmp_path / "st.wav"
    with wave.open(str(stereo), "wb") as wf:
        wf.setnchannels(2)
        wf.setsampwidth(2)
        wf.setframerate(48_000)
        wf.writeframes(np.zeros(2 * 100, "<i2").tobytes())
    assert fm_tx.main(["--in", str(stereo), "--device", "cpu"]) == 1
    short = tmp_path / "short.wav"
    _tone_wav(short, 0.01, 1000)
    assert fm_tx.main(["--in", str(short), "--out", str(tmp_path / "x.iq"),
                       "--device", "cpu"]) == 1
    err = capsys.readouterr().err
    assert "mono WAV required" in err and "shorter than one block" in err


def agreement(seconds: float, block: int, tmp) -> dict:
    """How the two CLIs' i16 files agree on a ``seconds`` 1 kHz WAV: the
    largest difference and the share of equal values, and the largest
    difference of their demodulated phase steps."""
    from pathlib import Path
    tmp = Path(tmp)
    _tone_wav(tmp / "a.wav", seconds, 1000)
    fm_tx.main(["--in", str(tmp / "a.wav"), "--out", str(tmp / "t.iq"),
                "--block", str(block), "--device", "cpu"])
    jfm_tx.main(["--in", str(tmp / "a.wav"), "--out", str(tmp / "j.iq"),
                 "--block", str(block)])
    a = np.fromfile(tmp / "t.iq", np.int16).astype(np.int64)
    b = np.fromfile(tmp / "j.iq", np.int16).astype(np.int64)
    d = np.abs(a - b)
    dd = (demod.fm_demod(_iq(tmp / "t.iq"))[0]
          - demod.fm_demod(_iq(tmp / "j.iq"))[0]).abs().max().item()
    return {"seconds": seconds, "block": block, "i16_max_diff": int(d.max()),
            "i16_equal_share": float((d == 0).mean()),
            "demod_max_diff_rad": dd}


if __name__ == "__main__":
    # JAX_PLATFORMS=cpu PYTHONPATH=. python tests/test_torch_tx.py
    import tempfile
    for secs in (0.5, 1.0, 2.0):
        with tempfile.TemporaryDirectory() as d:
            print(agreement(secs, 4608, d))
