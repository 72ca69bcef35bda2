"""Ground rules of the port: no JAX, the card by default, TF32 off, and
kernel wrappers that take their plain versions only for CPU tensors."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import sdr_tpu_torch
from sdr_tpu_torch.apps import chains, fm
from sdr_tpu_torch.kernels import KERNELS, fir, resample, u8_front_demod
from sdr_tpu_torch.ops.quantized import u8_front_plan
from sdr_tpu_torch.parallel.sharded import run_time_batched
from sdr_tpu_torch.stream import Pipeline

PKG = Path(sdr_tpu_torch.__file__).resolve().parent
ROOT = PKG.parent


def _imports(path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_no_jax_or_sdr_tpu_imports():
    files = sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 15
    for path in files:
        for mod in _imports(path):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "sdr_tpu"), (path, mod)


def test_import_leaves_jax_out():
    code = ("import sys, pkgutil, importlib, sdr_tpu_torch\n"
            "for m in pkgutil.walk_packages(sdr_tpu_torch.__path__, "
            "'sdr_tpu_torch.'):\n"
            "    importlib.import_module(m.name)\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'sdr_tpu')]\n"
            "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                   check=True, timeout=120)


def test_tf32_off():
    assert torch.backends.cudnn.allow_tf32 is False
    assert torch.backends.cuda.matmul.allow_tf32 is False


def test_entry_points_raise_without_gpu(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        chains.fm_chain()
    ops = chains.fm_chain(device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        Pipeline(ops, block_in=163_840)
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        run_time_batched(ops, np.full(2 * 163_840, 128, np.uint8), 2)
    src = tmp_path / "x.u8"
    np.full(163_840, 128, np.uint8).tofile(src)
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        fm.main(["--in", str(src), "--out", str(tmp_path / "a.wav")])
    # the CPU runs only when asked for
    Pipeline(ops, block_in=163_840, device="cpu")


def test_pipeline_rejects_ops_on_another_device():
    ops = chains.fm_chain(device="cpu")
    ops[1].device = torch.device("meta")
    with pytest.raises(ValueError, match="stage 1"):
        Pipeline(ops, block_in=163_840, device="cpu")


def _wrapper_calls(device):
    tq, scale = u8_front_plan(chains.fm_taps()[0], "s8")
    u8 = dict(dtype=torch.uint8, device=device)
    f32 = dict(dtype=torch.float32, device=device)
    return [
        lambda: u8_front_demod.u8_front_demod(
            torch.as_tensor(tq, device=device), scale, 8,
            torch.full((2, 1024), 0x80, **u8), torch.full((2, 86), 0x80, **u8),
            torch.zeros((2, 2), **f32)),
        lambda: resample.resample(
            torch.ones((3, 11), **f32), 3, 10, torch.ones((2, 1000), **f32),
            torch.zeros((2, 5), **f32), 1, 250, 3),
        lambda: fir.fir_strided(torch.ones(64, **f32),
                                torch.ones((2, 1000), **f32), 400, 2, 7),
    ]


def test_cpu_tensors_take_plain_path_and_launch_nothing():
    for k in KERNELS:
        k.launches = 0
    plain = [u8_front_demod.u8_front_demod_reference,
             resample.resample_reference, fir.fir_strided_reference]
    for call, ref in zip(_wrapper_calls("cpu"), plain):
        out = call()
        assert out is not None
    assert [k.launches for k in KERNELS] == [0, 0, 0]
    assert all(k._lib is None for k in KERNELS)   # nothing built or loaded
    # and the wrappers give their plain versions' results
    y = fir.fir_strided(torch.arange(4.0), torch.arange(10.0), 3, 2, 1)
    assert torch.equal(y, plain[2](torch.arange(4.0), torch.arange(10.0), 3,
                                   2, 1))


def test_other_devices_raise():
    for call in _wrapper_calls("meta"):
        with pytest.raises(ValueError, match="unsupported device"):
            call()
