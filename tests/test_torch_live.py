"""The port's rtl_tcp client and the FM CLI's live input, against a mock
rtl_tcp server on loopback and against the JAX package's client and CLI.

Every socket read has a timeout of at most 10 s and every server thread
is joined with one, so a hung connection fails its test instead of
eating the suite's clock.
"""

from __future__ import annotations

import os
import socket
import struct
import subprocess
import sys
import threading
import time
import wave
from pathlib import Path

import numpy as np
import pytest
import torch

from sdr_tpu.apps import fm as jfm
from sdr_tpu.io import rtl_tcp as jrtl

import sdr_tpu_torch
from sdr_tpu_torch.apps import fm
from sdr_tpu_torch.io import rtl_tcp
from sdr_tpu_torch.io.rtl_tcp import (RtlTcpParams, RtlTcpSource,
                                      parse_rtl_tcp_url, rtl_tcp_source)

ROOT = Path(sdr_tpu_torch.__file__).resolve().parent.parent
BLOCK = 81_920                 # u8 items a CLI block: 1,536 audio samples
AUDIO = 1_536


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs in several worker processes
    (pytest-xdist), where PyTorch's idle OpenMP workers spinning would
    cost the other workers the CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class MockRtlTcp:
    """One-connection rtl_tcp server (tests/test_rtl_tcp.py's): the
    header, the commands the client sends, a fixed payload, close.  Its
    socket waits at most 10 s for a client."""

    def __init__(self, payload: bytes, tuner_type: int = 5, gains: int = 29,
                 magic: bytes = b"RTL0"):
        self.payload = payload
        self.commands = []
        self._srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._srv.bind(("127.0.0.1", 0))
        self._srv.listen(1)
        self._srv.settimeout(10)
        self.port = self._srv.getsockname()[1]
        self.url = f"rtl_tcp://127.0.0.1:{self.port}"
        self._header = magic + struct.pack(">II", tuner_type, gains)
        self._thread = threading.Thread(target=self._serve, daemon=True)
        self._thread.start()

    def _serve(self):
        try:
            conn, _ = self._srv.accept()
        except socket.timeout:
            self._srv.close()
            return
        with conn:
            conn.sendall(self._header)
            # the commands arrive before the client drains samples
            conn.settimeout(0.5)
            buf = b""
            while True:
                try:
                    chunk = conn.recv(256)
                except socket.timeout:
                    break
                if not chunk:
                    break
                buf += chunk
            for i in range(0, len(buf) - len(buf) % 5, 5):
                self.commands.append(struct.unpack(">BI", buf[i:i + 5]))
            conn.settimeout(10)
            try:
                conn.sendall(self.payload)
                conn.shutdown(socket.SHUT_WR)
            except OSError:        # the client hung up first
                pass
        self._srv.close()

    def join(self):
        self._thread.join(timeout=10)
        assert not self._thread.is_alive(), "mock rtl_tcp server hung"


def _payload(n_blocks, block=BLOCK, seed=0):
    return np.random.default_rng(seed).integers(
        0, 256, n_blocks * block, dtype=np.uint8).tobytes()


def _broadcast_bytes(n_bytes):
    """u8 IQ of an FM broadcast carrying a 1 kHz tone (1.28 MS/s)."""
    fs, n = 1_280_000, n_bytes // 2
    t = np.arange(n) / fs
    iq = 0.9 * np.exp(1j * (2 * np.pi * 75e3 * np.cumsum(
        np.sin(2 * np.pi * 1000 * t)) / fs))
    raw = np.empty(2 * n, np.uint8)
    raw[0::2] = np.clip(np.round(iq.real * 128 + 128), 0, 255)
    raw[1::2] = np.clip(np.round(iq.imag * 128 + 128), 0, 255)
    return raw.tobytes()


# -- the client ----------------------------------------------------------


def test_url_parsing():
    assert parse_rtl_tcp_url("rtl_tcp://radio:1234") == ("radio", 1234)
    assert parse_rtl_tcp_url("127.0.0.1:99") == ("127.0.0.1", 99)
    assert parse_rtl_tcp_url("rtl_tcp://[::1]:7") == ("[::1]", 7)
    for bad in ("rtl_tcp://noport", "rtl_tcp://:1234", "host:12a", ""):
        with pytest.raises(ValueError, match="rtl_tcp://host:port"):
            parse_rtl_tcp_url(bad)
        with pytest.raises(ValueError):
            jrtl.parse_rtl_tcp_url(bad)
    assert rtl_tcp.TUNER_NAMES == jrtl.TUNER_NAMES


@pytest.mark.parametrize("params", [
    dict(center_freq=90_200_000, sample_rate=1_280_000, freq_correction=12,
         tuner_gain=297),
    dict(center_freq=100_000_000, sample_rate=2_048_000),
    dict(center_freq=90_200_000, sample_rate=1_280_000, freq_correction=-3),
], ids=["manual", "agc", "negative_ppm"])
def test_commands_equal_the_jax_clients(params):
    """The same settings send the same 5-byte commands in the same order
    as the JAX client, and the blocks are the payload's whole blocks."""
    logs = []
    for make in (RtlTcpSource, jrtl.RtlTcpSource):
        payload = _payload(3, 4096) + b"\x80" * 100
        srv = MockRtlTcp(payload)
        p = (RtlTcpParams if make is RtlTcpSource
             else jrtl.RtlTcpParams)(**params)
        src = make("127.0.0.1", srv.port, p, block=4096)
        assert (src.tuner_type, src.tuner_gain_count) == (5, 29)
        blocks = list(src)
        srv.join()
        src.close()
        assert len(blocks) == 3                 # the 100-byte tail dropped
        np.testing.assert_array_equal(
            np.concatenate(blocks), np.frombuffer(payload[:3 * 4096],
                                                  np.uint8))
        logs.append(srv.commands)
    assert logs[0] == logs[1]
    gain = params.get("tuner_gain")
    assert logs[0][-2:] == ([(3, 0), (8, 1)] if gain is None
                            else [(3, 1), (4, gain)])


def test_bad_magic_raises_connection_error():
    srv = MockRtlTcp(b"", magic=b"NOPE")
    with pytest.raises(ConnectionError, match="not an rtl_tcp server"):
        RtlTcpSource("127.0.0.1", srv.port,
                     RtlTcpParams(1_000_000, 1_000_000), block=512)
    srv.join()


def test_odd_block_rejected():
    with pytest.raises(ValueError, match="even"):
        RtlTcpSource("127.0.0.1", 1, RtlTcpParams(1, 2), block=511)


def test_mailbox_drops_oldest_and_counts():
    """A 2-deep mailbox that nobody drains: of 6 blocks the reader keeps
    the last 2 and counts 4 drops, as the JAX client does."""
    payload = _payload(6, 1024, seed=4)
    counts = []
    for make, params in ((RtlTcpSource, RtlTcpParams),
                         (jrtl.RtlTcpSource, jrtl.RtlTcpParams)):
        srv = MockRtlTcp(payload)
        src = make("127.0.0.1", srv.port, params(1, 2), block=1024,
                   n_buffers=2)
        srv.join()
        t0 = time.monotonic()
        while not src._eof and time.monotonic() - t0 < 10:
            time.sleep(0.01)
        assert src._eof
        got = list(src)
        src.close()
        assert len(got) == 2
        np.testing.assert_array_equal(
            np.concatenate(got), np.frombuffer(payload[4 * 1024:], np.uint8))
        counts.append(src.dropped)
    assert counts == [4, 4]


def test_blocks_are_writable_and_close_ends_iteration():
    srv = MockRtlTcp(_payload(2, 1024))
    with rtl_tcp_source(srv.url, RtlTcpParams(1, 2), block=1024) as src:
        blk = next(iter(src))
        assert blk.flags.writeable        # a tensor takes it without a copy
    srv.join()
    assert src._closed
    assert len(list(src)) <= 1            # what the reader had, then the end


# -- the FM CLI's live input ----------------------------------------------


def _wav(path):
    with wave.open(str(path), "rb") as wf:
        return (wf.getframerate(), wf.getnchannels(),
                np.frombuffer(wf.readframes(wf.getnframes()), "<i2"))


def _live(tmp_path, payload, *extra, name="live.wav", main=fm.main,
          args=("--freq", "90.2M", "--gain", "496", "--ppm", "1")):
    srv = MockRtlTcp(payload)
    out = tmp_path / name
    device = ["--device", "cpu"] if main is fm.main else []
    assert main(["--in", srv.url, "--out", str(out), "--block", str(BLOCK),
                 *args, *device, *extra]) == 0
    srv.join()
    return srv.commands, out


def _file(tmp_path, payload, *extra, name="file.wav"):
    src = tmp_path / "capture.u8"
    src.write_bytes(payload)
    out = tmp_path / name
    assert fm.main(["--in", str(src), "--out", str(out), "--block",
                    str(BLOCK), "--device", "cpu", *extra]) == 0
    return out


@pytest.mark.parametrize("extra", [[], ["--batched", "2"],
                                   ["--front", "quantized", "--stereo",
                                    "--deemphasis", "75e-6"]],
                         ids=["mono", "batched", "stereo"])
def test_live_cli_writes_the_file_clis_wav(tmp_path, extra):
    payload = _broadcast_bytes(3 * BLOCK)
    cmds, live = _live(tmp_path, payload, *extra)
    assert cmds == [(2, 1_280_000), (1, 90_200_000), (5, 1), (3, 1),
                    (4, 496)]
    recorded = _file(tmp_path, payload, *extra)
    assert live.read_bytes() == recorded.read_bytes()
    rate, ch, pcm = _wav(live)
    assert rate == 48_000 and ch == (2 if "--stereo" in extra else 1)
    assert len(pcm) == 3 * AUDIO * ch


def test_live_cli_defaults_ask_for_the_hardware_agc(tmp_path, capsys):
    cmds, out = _live(tmp_path, _payload(1), args=())
    assert cmds == [(2, 1_280_000), (1, 90_200_000), (3, 0), (8, 1)]
    assert "radio dropped" not in capsys.readouterr().err
    assert _wav(out)[2].shape == (AUDIO,)


def test_live_exact_front_within_one_lsb_of_the_jax_cli(tmp_path):
    payload = _broadcast_bytes(3 * BLOCK)
    cmds, mine = _live(tmp_path, payload, "--front", "exact")
    jcmds, theirs = _live(tmp_path, payload, "--front", "exact",
                          name="jax.wav", main=jfm.main)
    assert cmds == jcmds
    a, b = _wav(mine), _wav(theirs)
    assert a[:2] == b[:2] == (48_000, 1)
    assert a[2].shape == b[2].shape == (3 * AUDIO,)
    assert int(np.abs(a[2].astype(np.int32) - b[2]).max()) <= 1


def test_live_cli_reports_dropped_blocks(tmp_path, monkeypatch, capsys):
    """A consumer slower than the radio: the drops go to stderr."""
    real = rtl_tcp.RtlTcpSource.__init__

    def shallow(self, host, port, params, block, n_buffers=8):
        real(self, host, port, params, block, n_buffers=1)
        t0 = time.monotonic()       # let the reader overrun the mailbox
        while not self._eof and time.monotonic() - t0 < 10:
            time.sleep(0.01)

    monkeypatch.setattr(rtl_tcp.RtlTcpSource, "__init__", shallow)
    _, out = _live(tmp_path, _payload(4))
    assert "radio dropped 3 blocks" in capsys.readouterr().err
    assert _wav(out)[2].shape == (AUDIO,)


def test_live_audio_without_sounddevice_fails_and_writes_no_wav(
        tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "sounddevice", None)
    out = tmp_path / "never.wav"
    with pytest.raises(RuntimeError, match="sounddevice"):
        fm.main(["--in", "rtl_tcp://127.0.0.1:1", "--out", str(out),
                 "--audio", "--block", str(BLOCK), "--device", "cpu"])
    assert not out.exists()


def test_live_audio_command_exits_nonzero(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
    code = ("import sys; sys.modules['sounddevice'] = None\n"
            "from sdr_tpu_torch.apps.fm import main\n"
            "sys.exit(main(sys.argv[1:]))\n")
    out = tmp_path / "never.wav"
    proc = subprocess.run(
        [sys.executable, "-c", code, "--in", "rtl_tcp://127.0.0.1:1",
         "--out", str(out), "--audio", "--device", "cpu"], cwd=ROOT,
        env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert "sounddevice" in proc.stderr
    assert not out.exists()


def test_live_audio_plays_the_wavs_samples(tmp_path, monkeypatch):
    """With a (fake) backend, ``--audio`` plays what the WAV holds."""
    from test_torch_io import _fake_sounddevice
    log = []
    monkeypatch.setitem(sys.modules, "sounddevice", _fake_sounddevice(log))
    payload = _broadcast_bytes(2 * BLOCK)
    _live(tmp_path, payload, "--audio")
    played = np.concatenate([e[1] for e in log if e[0] == "write"])
    pcm = _wav(_file(tmp_path, payload))[2]
    assert played.shape == (len(pcm), 1)
    np.testing.assert_array_equal(
        np.clip(np.round(played[:, 0].astype(np.float64) * 32767), -32768,
                32767).astype("<i2"), pcm)
