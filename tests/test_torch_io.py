"""The port's host I/O against the JAX package's: framed blocks, UDP over
loopback, the native ring loader, the live audio sink (a fake
``sounddevice``) and ``iq_file_source(repeat=True)``.

Every socket read has a timeout of at most 10 s and every thread is
joined with one, so a lost datagram fails its test instead of hanging.
"""

from __future__ import annotations

import io
import socket
import sys
import threading
import time
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from sdr_tpu.io import audio as jaudio
from sdr_tpu.io import files as jfiles
from sdr_tpu.io import native as jnative
from sdr_tpu.io import net as jnet
from sdr_tpu.io import serialize as jser

import sdr_tpu_torch
from sdr_tpu_torch.io import audio, files, native, net, serialize

ROOT = Path(sdr_tpu_torch.__file__).resolve().parent.parent
DTYPES = [np.uint8, np.int16, np.float32, np.complex64, np.float64,
          np.int32]


def _block(rng, dtype, n=37):
    if np.dtype(dtype).kind == "c":
        return (rng.normal(size=n) + 1j * rng.normal(size=n)).astype(dtype)
    if np.dtype(dtype).kind == "f":
        return rng.normal(size=n).astype(dtype)
    info = np.iinfo(dtype)
    return rng.integers(info.min, info.max, n, dtype=dtype, endpoint=True)


# -- serialize -----------------------------------------------------------


@pytest.mark.parametrize("dtype", DTYPES, ids=lambda d: np.dtype(d).name)
def test_frames_are_the_jax_packages_bytes(rng, dtype):
    b = _block(rng, dtype)
    assert serialize.frame_blocks(b) == jser.frame_blocks(b)
    assert serialize.to_bytes(b) == jser.to_bytes(b)
    # a tensor frames as its array does (complex64 included)
    assert serialize.frame_blocks(torch.from_numpy(b)) == jser.frame_blocks(b)
    np.testing.assert_array_equal(
        serialize.from_bytes(serialize.to_bytes(b), dtype), b)


def test_framed_files_cross_read(rng, tmp_path):
    blocks = [_block(rng, d, n) for d, n in zip(DTYPES, (5, 0, 9, 3, 1, 7))]
    mine, theirs = tmp_path / "port.sdrb", tmp_path / "jax.sdrb"
    assert serialize.write_framed(mine, blocks) == len(blocks)
    jser.write_framed(theirs, blocks)
    assert mine.read_bytes() == theirs.read_bytes()
    for got in (list(serialize.read_framed(theirs)),
                list(jser.read_framed(mine))):
        assert len(got) == len(blocks)
        for g, b in zip(got, blocks):
            assert g.dtype == b.dtype
            np.testing.assert_array_equal(g, b)


def test_truncated_frame_ends_the_stream_and_bad_magic_raises(rng):
    a, b = _block(rng, np.float32), _block(rng, np.int16)
    data = serialize.frame_blocks(a) + serialize.frame_blocks(b)
    for cut in (1, 11, 12 + 2 * b.size - 1):
        got = list(serialize.unframe_blocks(io.BytesIO(data[:-cut])))
        assert len(got) == 1
        np.testing.assert_array_equal(got[0], a)
    bad = b"SDRX" + data[4:]
    with pytest.raises(ValueError, match="magic"):
        list(serialize.unframe_blocks(io.BytesIO(bad)))
    with pytest.raises(ValueError, match="magic"):
        list(jser.unframe_blocks(io.BytesIO(bad)))
    with pytest.raises(KeyError):
        serialize.frame_blocks(np.zeros(3, np.uint16))


# -- UDP -----------------------------------------------------------------


def _free_udp_port() -> int:
    s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _send_later(send, blocks, delay=0.3, gap=0.01):
    """A thread sending ``blocks`` after the receiver has bound."""
    def run():
        time.sleep(delay)
        for b in blocks:
            send(b)
            time.sleep(gap)
    t = threading.Thread(target=run, daemon=True)
    t.start()
    return t


@pytest.mark.parametrize("direction", ["port_to_jax", "jax_to_port"])
def test_udp_loopback_between_the_packages(rng, direction):
    block, dtype = 1024, np.int16
    sent = [_block(rng, dtype, block) for _ in range(4)]
    port = _free_udp_port()
    sink, source = ((net.udp_sink, jnet.udp_source)
                    if direction == "port_to_jax"
                    else (jnet.udp_sink, net.udp_source))
    send, close = sink(("127.0.0.1", port))
    src = source(("127.0.0.1", port), block, dtype, timeout=5.0)
    # a tensor goes out as its array's bytes; a short datagram is dropped
    payload = ([torch.from_numpy(sent[0]), sent[1][:10], *sent[1:]]
               if direction == "port_to_jax" else [sent[0], *sent[1:]])
    t = _send_later(send, payload)
    got = [next(src) for _ in sent]
    t.join(timeout=10)
    assert not t.is_alive()
    src.close()
    close()
    for g, w in zip(got, sent):
        assert g.dtype == np.dtype(dtype)
        np.testing.assert_array_equal(g, w)


def test_udp_oversize_block_raises():
    send, close = net.udp_sink(("127.0.0.1", _free_udp_port()))
    with pytest.raises(ValueError, match="datagram max"):
        send(np.zeros(65_508, np.uint8))
    send(np.zeros(65_507, np.uint8))          # the largest one goes
    close()
    with pytest.raises(ValueError, match="datagram max"):
        next(net.udp_source(("127.0.0.1", 0), 32_754, np.int16))


def test_udp_source_times_out():
    src = net.udp_source(("127.0.0.1", _free_udp_port()), 64, timeout=0.2)
    assert list(src) == []


# -- iq_file_source(repeat=) ---------------------------------------------


@pytest.mark.parametrize("fmt,n,block", [("u8", 40_000, 8192),
                                         ("i16", 4096, 2048),
                                         ("u8", 100, 4096)])
def test_iq_file_source_repeat_matches_jax(rng, tmp_path, fmt, n, block):
    x = _block(rng, files.IQ_DTYPES[fmt], n)
    path = tmp_path / "x.iq"
    x.tofile(path)
    for repeat, take in ((False, 100), (True, 11)):
        a = list(zip(range(take), files.iq_file_source(path, block, fmt,
                                                       repeat=repeat)))
        b = list(zip(range(take), jfiles.iq_file_source(path, block, fmt,
                                                        repeat=repeat)))
        assert len(a) == len(b)
        for (_, u), (_, v) in zip(a, b):
            np.testing.assert_array_equal(u, v)
    whole = n // block
    if whole:
        got = [b for _, b in zip(range(2 * whole),
                                 files.iq_file_source(path, block, fmt,
                                                      repeat=True))]
        np.testing.assert_array_equal(np.concatenate(got),
                                      np.tile(x[:whole * block], 2))


# -- the native loader ---------------------------------------------------


def _tree(*dirs):
    """(path, size, mtime) of the files under ``dirs``, bytecode caches
    and the JAX package's own loader library (which its tests build
    beside ``native/sdr_loader.cpp``, perhaps in another worker) aside."""
    out = set()
    for d in dirs:
        for p in (ROOT / d).rglob("*"):
            if p.is_file() and "__pycache__" not in p.parts \
                    and p.name != "sdr_loader.so":
                st = p.stat()
                out.add((str(p), st.st_size, st.st_mtime_ns))
    return out


@pytest.fixture(scope="module")
def loader():
    """The loader built (or found) under build/native/."""
    before = _tree("native", "sdr_tpu", "sdr_tpu_torch")
    path = native.build_native()
    assert native.native_available()
    assert _tree("native", "sdr_tpu", "sdr_tpu_torch") == before
    return path


def test_native_builds_under_build_native(loader, tmp_path, monkeypatch):
    assert loader.parent == ROOT / "build" / "native"
    assert loader.name.startswith("libsdr_loader-") and loader.is_file()
    assert native.SOURCE == ROOT / "sdr_tpu_torch" / "native" / \
        "sdr_loader.cpp"
    # the port's copy holds the JAX loader's code: the same C interface
    mine = native.SOURCE.read_text()
    theirs = (ROOT / "native" / "sdr_loader.cpp").read_text()
    code = lambda s: s[s.index("#include <atomic>"):]  # noqa: E731
    assert code(mine) == code(theirs)
    # a forced build writes only under BUILD
    monkeypatch.setattr(native, "BUILD", tmp_path / "b")
    before = _tree("native", "sdr_tpu", "sdr_tpu_torch")
    out = native.build_native(force=True)
    assert out.parent == tmp_path / "b" and out.is_file()
    assert sorted(p.name for p in (tmp_path / "b").iterdir()) == [out.name]
    assert _tree("native", "sdr_tpu", "sdr_tpu_torch") == before
    # the name digests the flags as well as the source
    monkeypatch.setattr(native, "GXX_FLAGS", native.GXX_FLAGS + ["-g"])
    assert native.library_path() != out


def test_native_without_gxx_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(native, "BUILD", tmp_path)
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native.shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match="no g\\+\\+"):
        native.build_native()
    with pytest.raises(RuntimeError, match="no g\\+\\+"):
        native.native_file_source(tmp_path / "x.u8", 1024)
    assert not native.native_available()


@pytest.mark.parametrize("dtype,n,block", [(np.uint8, 40_000, 8192),
                                           (np.int16, 4096, 2048)])
def test_native_file_source_matches_python_and_jax(loader, rng, tmp_path,
                                                   dtype, n, block):
    x = _block(rng, dtype, n)
    path = tmp_path / "x.iq"
    x.tofile(path)
    fmt = "u8" if dtype == np.uint8 else "i16"
    got = list(native.native_file_source(path, block, dtype=dtype))
    want = list(files.iq_file_source(path, block, fmt))
    assert len(got) == len(want) == n // block
    for g, w in zip(got, want):
        assert g.dtype == np.dtype(dtype) and g.flags.writeable
        np.testing.assert_array_equal(g, w)
    if jnative.native_available():
        theirs = list(jnative.native_file_source(path, block, dtype=dtype))
        assert len(theirs) == len(got)
        for g, w in zip(got, theirs):
            np.testing.assert_array_equal(g, w)


def test_native_file_source_repeat(loader, rng, tmp_path):
    x = _block(rng, np.uint8, 8192)
    path = tmp_path / "x.iq"
    x.tofile(path)
    it = iter(native.native_file_source(path, 6000, repeat=True))
    got = np.concatenate([next(it) for _ in range(3)])
    np.testing.assert_array_equal(got, np.tile(x, 3)[:18_000])
    if jnative.native_available():
        jit = iter(jnative.native_file_source(path, 6000, repeat=True))
        np.testing.assert_array_equal(
            got, np.concatenate([next(jit) for _ in range(3)]))
    # a whole multiple of the block: the file twice over, as the Python
    # reader repeats it
    y = _block(rng, np.uint8, 4 * 4096)
    y.tofile(path)
    it = iter(native.native_file_source(path, 4096, repeat=True))
    a = [next(it) for _ in range(8)]
    b = [blk for _, blk in zip(range(8), files.iq_file_source(
        path, 4096, repeat=True))]
    np.testing.assert_array_equal(np.concatenate(a), np.tile(y, 2))
    np.testing.assert_array_equal(np.concatenate(a), np.concatenate(b))


def test_native_file_backpressure(loader, rng, tmp_path):
    """The bounded ring holds the producer back: a 2-slot ring over a
    1 MiB file loses nothing while the consumer waits."""
    x = _block(rng, np.uint8, 1 << 20)
    path = tmp_path / "big.iq"
    x.tofile(path)
    src = native.native_file_source(path, 4096, n_buffers=2)
    it = iter(src)
    first = next(it)
    time.sleep(0.1)               # the producer parks on the full ring
    rest = list(it)
    np.testing.assert_array_equal(np.concatenate([first] + rest), x)
    assert src.dropped == 0


def test_native_udp_source(loader, rng):
    block = 65_440                # the largest multiple of 160 in a datagram
    port = _free_udp_port()
    src = native.native_udp_source(port, block, timeout=5.0)
    sent = [_block(rng, np.uint8, block) for _ in range(4)]
    s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    t = _send_later(lambda b: s.sendto(b.tobytes(), ("127.0.0.1", port)),
                    [sent[0], sent[1][:100], *sent[1:]], gap=0.02)
    it = iter(src)
    got = [next(it) for _ in sent]
    t.join(timeout=10)
    s.close()
    for g, w in zip(got, sent):
        np.testing.assert_array_equal(g, w)
    assert src.dropped == 0
    src.close()


def test_native_udp_drops_and_counts_when_full(loader, rng):
    """A live source cannot be held back: with a 2-slot ring and no
    consumer, datagrams past the ring are dropped and counted."""
    port = _free_udp_port()
    src = native.native_udp_source(port, 1024, n_buffers=2, timeout=0.5)
    sent = [_block(rng, np.uint8, 1024) for _ in range(6)]
    s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    t = _send_later(lambda b: s.sendto(b.tobytes(), ("127.0.0.1", port)),
                    sent, gap=0.05)
    t.join(timeout=10)
    time.sleep(0.2)
    s.close()
    got = list(src)               # ends 0.5 s after the last block
    assert src.dropped == 4
    assert len(got) == 2
    for g, w in zip(got, sent[:2]):
        np.testing.assert_array_equal(g, w)


def test_fm_cli_native_gives_the_file_clis_wav(loader, tmp_path):
    from sdr_tpu_torch.apps import fm
    raw = np.random.default_rng(3).integers(0, 256, 3 * 81_920,
                                            dtype=np.uint8)
    src = tmp_path / "x.u8"
    raw.tofile(src)
    outs = []
    for extra in ([], ["--native"]):
        out = tmp_path / f"a{len(outs)}.wav"
        assert fm.main(["--in", str(src), "--out", str(out), "--block",
                        "81920", "--device", "cpu", *extra]) == 0
        outs.append(out.read_bytes())
    assert outs[0] == outs[1] and len(outs[0]) > 44


# -- live audio ----------------------------------------------------------


class _FakeStream:
    def __init__(self, log, **kw):
        self.log = log
        log.append(("open", kw))

    def start(self):
        self.log.append(("start",))

    def write(self, frames):
        self.log.append(("write", np.array(frames)))

    def stop(self):
        self.log.append(("stop",))

    def close(self):
        self.log.append(("close",))


def _fake_sounddevice(log):
    return types.SimpleNamespace(
        OutputStream=lambda **kw: _FakeStream(log, **kw))


@pytest.mark.parametrize("channels", [1, 2])
def test_audio_sink_plays_the_jax_sinks_frames(rng, monkeypatch, channels):
    logs = {}
    blocks = [rng.uniform(-1, 1, (channels, 480) if channels > 1 else 480)
              for _ in range(3)]
    for name, mod in (("port", audio), ("jax", jaudio)):
        log = logs[name] = []
        monkeypatch.setitem(sys.modules, "sounddevice",
                            _fake_sounddevice(log))
        assert mod.audio_available()
        write, close = mod.audio_sink(48_000, channels=channels)
        for b in blocks:
            write(torch.from_numpy(b) if name == "port" else b)
        close()
    a, b = logs["port"], logs["jax"]
    assert [e[0] for e in a] == [e[0] for e in b] == \
        ["open", "start", "write", "write", "write", "stop", "close"]
    assert a[0][1] == b[0][1] == {"samplerate": 48_000,
                                  "channels": channels, "dtype": "float32"}
    for u, v in zip(a[2:5], b[2:5]):
        assert u[1].dtype == v[1].dtype == np.float32
        assert u[1].shape == v[1].shape == (480, channels)
        np.testing.assert_array_equal(u[1], v[1])


def test_audio_sink_absent_raises(monkeypatch):
    monkeypatch.setitem(sys.modules, "sounddevice", None)
    assert not audio.audio_available()
    with pytest.raises(RuntimeError, match="sounddevice"):
        audio.audio_sink(48_000)

