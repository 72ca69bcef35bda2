"""The port's multi-process helpers (sdr_tpu_torch/parallel/multihost.py,
mesh.py) on the CPU over gloo: the counterpart of tests/test_multihost.py.

World 1 runs in this process on an in-memory store; world 2 spawns two
worker ranks (tests/torch_sharded_worker.py, mode ``multihost``), each
reading only its span of a recording from a file, and holds their joined
output bitwise against the one-process block-parallel run.
"""

from __future__ import annotations

import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist

from sdr_tpu_torch import parallel
from sdr_tpu_torch.apps import chains
from sdr_tpu_torch.parallel import (gather_time_sharded, global_time_sharded,
                                    host_block_iterator, init_distributed,
                                    local_time_span, run_time_batched,
                                    run_time_sharded, time_mesh)
from sdr_tpu_torch.parallel.halo import group_backend
from sdr_tpu_torch.parallel.sharded import _require_equal_shapes

import torch_sharded_worker as worker
from torch_sharded_worker import spawn

ROOT = Path(__file__).resolve().parent.parent
ROW = worker.MULTIHOST_ROW
ROWS = worker.MULTIHOST_ROWS


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
def world1():
    """A one-rank gloo group in this process, taken down afterwards."""
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        yield time_mesh(device_type="cpu")
    finally:
        dist.destroy_process_group()


def _broadcast(n_bytes, seed=0):
    """u8 IQ of an FM broadcast with a 1 kHz tone, with a little noise."""
    fs, n = 1_280_000, n_bytes // 2
    t = np.arange(n) / fs
    phase = 2 * np.pi * 75e3 * np.cumsum(np.sin(2 * np.pi * 1e3 * t)) / fs
    noise = 0.01 * np.random.default_rng(seed).normal(size=(2, n))
    raw = np.empty(2 * n, np.uint8)
    raw[0::2] = np.clip(np.round((0.9 * np.cos(phase) + noise[0]) * 128
                                 + 128), 0, 255)
    raw[1::2] = np.clip(np.round((0.9 * np.sin(phase) + noise[1]) * 128
                                 + 128), 0, 255)
    return raw


def test_init_distributed_is_a_noop_for_one_process(monkeypatch):
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    init_distributed()
    assert not dist.is_initialized()
    monkeypatch.setenv("WORLD_SIZE", "1")
    init_distributed("gloo")
    init_distributed(world_size=1, rank=0)
    assert not dist.is_initialized()


def test_mesh_entry_points_default_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for make in (lambda: parallel.make_mesh((1,), ("t",)),
                 lambda: parallel.time_mesh(1),
                 lambda: parallel.channel_time_mesh(1, 1)):
        with pytest.raises(RuntimeError, match="no CUDA GPU"):
            make()
    with pytest.raises(RuntimeError, match="no process group"):
        parallel.make_mesh((1,), ("t",), "cpu")


def test_local_time_span_one_process(world1):
    # one rank owns everything (world 2's spans: the worker checks them)
    assert local_time_span(world1, 8000) == (0, 8000)


def test_host_block_iterator_one_process(world1, tmp_path, rng):
    x = rng.integers(0, 256, 4096 + 100).astype(np.uint8)
    path = tmp_path / "x.iq"
    x.tofile(path)
    blocks = list(host_block_iterator(path, world1, 1024))
    assert len(blocks) == 4                  # the partial block dropped
    np.testing.assert_array_equal(np.concatenate(blocks), x[:4096])


def test_global_time_sharded_and_gather_one_process(world1, rng):
    x = rng.uniform(-1, 1, 4096).astype(np.float32)
    g = global_time_sharded(x, world1, 4096, device="cpu")
    assert isinstance(g, torch.Tensor) and g.device.type == "cpu"
    np.testing.assert_array_equal(g.numpy(), x)
    with pytest.raises(ValueError, match="this rank owns 4096"):
        global_time_sharded(x[:100], world1, 4096, device="cpu")
    torch.testing.assert_close(gather_time_sharded(g, world1), g,
                               rtol=0, atol=0)


@pytest.mark.parametrize("make", [
    lambda: chains.fm_chain(device="cpu"),
    lambda: chains.fm_chain(front="quantized", stereo=True,
                            deemphasis=75e-6, fuse_back=True, device="cpu"),
], ids=["mono", "stereo"])
def test_world_one_equals_one_process(world1, make):
    """One rank: its halos are the warmup fills and its prefixes compose
    nothing before its rows, so even the stereo chain's lock and IIR
    prefixes give the one-process run's bits (the collectives run all the
    same)."""
    raw = _broadcast(8 * ROW)
    got = run_time_sharded(make(), world1, raw, nblocks=8, device="cpu")
    want = run_time_batched(make(), raw, 8, device="cpu")
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_shape_check_reads_only_the_shape(world1):
    """The runners' shape check gathers host tensors over the group's CPU
    backend: on a ``meta`` tensor (no data, no device memory) it runs
    through, so it builds nothing on the input's device and never reads
    its data, and on the card never waits for it."""
    group = world1.get_group("t")
    _require_equal_shapes(torch.empty((8, 2, 1024), device="meta"), group)
    with pytest.raises(ValueError, match="at most 8"):
        _require_equal_shapes(torch.empty((1,) * 9, device="meta"), group)


def test_group_backend_reads_each_devices_backend(world1):
    group = world1.get_group("t")
    assert group_backend(group, "cpu") == "gloo"
    assert group_backend(group, "cuda") == "gloo"   # gloo serves both
    assert group_backend(group, "xpu") is None


def test_init_distributed_gives_nccl_a_host_side(monkeypatch):
    """'nccl' asks for NCCL on CUDA tensors and gloo on host ones, so the
    shape check has a host backend; other backends pass through."""
    got = []
    monkeypatch.setattr(dist, "init_process_group",
                        lambda backend, **kw: got.append(backend))
    init_distributed(world_size=2, rank=0, init_method="tcp://localhost:1")
    init_distributed("gloo", world_size=2, rank=0,
                     init_method="tcp://localhost:1")
    assert got == ["cpu:gloo,cuda:nccl", "gloo"]


def test_two_process_run_from_a_file(tmp_path):
    """Two gloo ranks, each reading only its half of each global block of
    the recording, run the mono chain time-sharded; rank 0's joined
    output equals the one-process run bit for bit, block by block."""
    n_global = 2 * ROWS * ROW
    raw = _broadcast(2 * n_global + 1000)    # two blocks and a partial one
    path = tmp_path / "x.u8"
    raw.tofile(path)
    outs = spawn("multihost", 2, path, tmp_path)
    spans = [dict(np.load(p)) for p in outs]
    assert "block0" in spans[0] and "block0" not in spans[1]
    ops = chains.fm_chain(device="cpu")
    for i in range(2):
        blk = raw[i * n_global:(i + 1) * n_global]
        np.testing.assert_array_equal(spans[0][f"span{i}"],
                                      blk[:n_global // 2])
        np.testing.assert_array_equal(spans[1][f"span{i}"],
                                      blk[n_global // 2:])
        want = run_time_batched(ops, blk, 2 * ROWS, device="cpu")
        np.testing.assert_array_equal(spans[0][f"block{i}"], want.numpy())
    assert "span2" not in spans[0]


def _exported(path: Path) -> set:
    names = set()
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, ast.ImportFrom):
            names |= {a.asname or a.name for a in node.names}
    return names


def test_parallel_exports_the_jax_packages_names():
    """Every name sdr_tpu.parallel exports has its counterpart here, and
    the JAX package's global-array assembly its gather."""
    want = _exported(ROOT / "sdr_tpu" / "parallel" / "__init__.py")
    assert {"make_mesh", "run_grid_sharded", "host_block_iterator",
            "mesh"} <= want
    for name in want:
        assert hasattr(parallel, name), name
    assert callable(parallel.gather_time_sharded)


@pytest.mark.parametrize("extra,nproc", [([], 2), (["--wideband"], 4)],
                         ids=["channels", "wideband"])
def test_channelizer_cli_under_torchrun(tmp_path, extra, nproc):
    """``torchrun`` ranks (gloo, the CPU) shard the bank as the JAX app
    shards it over devices, channels or wideband time; rank 0's WAVs are
    the one-process CLI's, byte for byte."""
    common = ["--synthetic", "--channels", "4", "--seconds", "0.05",
              "--device", "cpu", *extra]
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
    one = subprocess.run(
        [sys.executable, "-m", "sdr_tpu_torch.apps.channelizer", *common,
         "--out-prefix", str(tmp_path / "one")], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=300)
    assert one.returncode == 0, one.stderr
    run = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", str(nproc), "-m",
         "sdr_tpu_torch.apps.channelizer", "--backend", "gloo", *common,
         "--out-prefix", str(tmp_path / "ranks")], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=300)
    assert run.returncode == 0, run.stderr
    assert f"on {nproc} devices" in run.stdout
    assert run.stdout.count("wrote 4 WAV files") == 1     # rank 0 only
    for c in range(4):
        assert (tmp_path / f"ranks{c:03d}.wav").read_bytes() == \
            (tmp_path / f"one{c:03d}.wav").read_bytes()
