#!/usr/bin/env python3
"""Drive sdr_tpu_torch's broadcast-FM receive path on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N]

Run from the repository root on a machine with a CUDA GPU and ``nvcc``.
It builds the CUDA kernels K1-K3 from ``sdr_tpu_torch/csrc`` (one nvcc
per source, all at once), then:

1. prints the toolchain and the card's name and power limit;
2. holds each kernel against its plain PyTorch version on the card at the
   main path's shapes (32 rows of 10,485,760 u8 bytes -> 655,360 demod
   samples -> 196,671 resampled -> 196,608 audio samples per row, plus
   nonzero offset/start/stride geometries), and times the kernel, the
   plain version and, where one PyTorch call computes the same function,
   that call (``library_ms``, timed only);
3. runs the block-parallel FM chain (``run_time_batched``) on a synthetic
   1 kHz broadcast at 32 x 10,485,760 bytes with every launch counter set
   to 0 just before, checks the tone, the launch counts and agreement with
   the plain CPU run on a small input, times 20 more calls by CUDA events
   (median, min and max), and checks that the streamed
   ``Pipeline.run`` at 1,310,720-byte blocks gives the same samples;
4. runs the CLI ``python -m sdr_tpu_torch.apps.fm`` on a temporary file
   and checks the tone in the WAV;
5. prints ``{"kernels": [...]}``, the card line again, and last
   ``{"ok": true, "device": {...}}``.

Every failed check raises, so any failure exits nonzero.  Without a CUDA
GPU it exits nonzero before printing any result.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time
import wave
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
ROWS, ROW_BYTES = 32, 10_485_760      # block-parallel batch (bench.py's)
STREAM_BLOCK = 1_310_720              # the CLI's default block
CHAIN_REPS = 20                       # timed block-parallel chain calls
FS_IN = 1_280_000                     # complex S/s
HBM_BYTES_PER_S = 3.35e12             # H100 SXM data sheet
PEAK_OPS_PER_S = {"f32": 67e12, "int8": 1979e12}


def require(cond, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def time_ms(fn, reps: int, warmup: int = 2) -> float:
    """Mean ms per call by CUDA events over ``reps`` calls after warm-up."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def bound(nbytes: int, ops: int, kind: str):
    """(bound_ms, bound_by): the larger of bytes over the memory rate and
    operations over the peak rate of their type."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS_PER_S[kind] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def synth_broadcast(n_bytes: int, seed: int, device) -> torch.Tensor:
    """u8 interleaved IQ of an FM broadcast carrying a 1 kHz tone at 75 kHz
    deviation, sampled at 1.28 MS/s, with seeded Gaussian noise."""
    n = n_bytes // 2
    g = torch.Generator(device=device).manual_seed(seed)
    t = torch.arange(n, dtype=torch.float64, device=device) / FS_IN
    phase = (75e3 / 1e3) * (1 - torch.cos(2 * np.pi * 1e3 * t))
    del t
    raw = torch.empty(2 * n, dtype=torch.uint8, device=device)
    for c, fn in ((0, torch.cos), (1, torch.sin)):
        v = 0.9 * fn(phase) + 0.01 * torch.randn(
            n, generator=g, dtype=torch.float64, device=device)
        raw[c::2] = torch.clamp(torch.round(v * 128 + 128), 0, 255).to(
            torch.uint8)
    return raw


def tone_hz(y: np.ndarray, rate: int = 48_000) -> float:
    seg = y[2000:2000 + (1 << 20)]
    return float(np.argmax(np.abs(np.fft.rfft(seg))) * rate / len(seg))


def check_kernels(raw, ops):
    """Each kernel vs its plain version at the main path's shapes."""
    from sdr_tpu_torch.kernels import fir, resample, u8_front_demod
    from sdr_tpu_torch.ops.fir import _resample_positions

    front, back = ops
    rows = []
    x = raw.view(ROWS, ROW_BYTES)

    # K1 at the block-parallel batch, history and carry from the halos
    hist, liq = front.shard_carry(x)
    n1 = front.out_len(ROW_BYTES)
    args = (front.tq, front.scale, front.factor, x, hist, liq, n1)
    y1, iq1 = u8_front_demod.u8_front_demod(*args)
    r1, riq1 = u8_front_demod.u8_front_demod_reference(*args)
    torch.cuda.synchronize()
    err1 = max((y1 - r1).abs().max().item(), (iq1 - riq1).abs().max().item())
    require(torch.isfinite(y1).all().item(), "K1 output finite")
    require(err1 <= 2e-6, f"K1 vs plain {err1} rad > 2e-6")
    ops1 = 2 * 2 * front.n_taps * n1 * ROWS
    b1, by1 = bound(nbytes(x, hist, liq, front.tq, y1, iq1), ops1, "int8")
    rows.append(dict(
        name="K1 u8_front_demod", route="cuda",
        source="sdr_tpu_torch/csrc/u8_front_demod.cu",
        replaces="sdr_tpu/kernels/u8_front_demod_pallas.py:135",
        max_abs_err=err1,
        ms=time_ms(lambda: u8_front_demod.u8_front_demod(*args), 20),
        plain_ms=time_ms(
            lambda: u8_front_demod.u8_front_demod_reference(*args), 3, 1),
        bound_ms=b1, bound_by=by1, library_ms=None))

    # K2 at the chain's 3/10 stage, and at a rebased seam-like geometry
    I, D = back.spec.interpolation, back.spec.decimation
    Kf = back.taps_f.shape[0]
    h2 = back.shard_carry(y1)
    n2 = back.out_len(n1) + Kf - 1
    geoms = [(back._offset_k, 0, n2), (1, 37, n2 - 20), (2, 5, n2 - 3)]
    err2 = 0.0
    for off, start, num in geoms:
        a2 = (back._table, I, D, y1, h2, off, num, start)
        g = resample.resample(*a2)
        r = resample.resample_reference(*a2)
        err2 = max(err2, (g - r).abs().max().item())
    require(err2 <= 1e-6, f"K2 vs plain {err2} > 1e-6")
    a2 = (back._table, I, D, y1, h2, back._offset_k, n2, 0)
    yr = resample.resample(*a2)
    require(torch.isfinite(yr).all().item(), "K2 output finite")
    # library yardstick: one strided conv1d with I output channels over the
    # concatenated stream, then the [Q, I] -> [Q*I] interleave
    table = back.spec.phase_table
    Kp = table.shape[1]
    i_j, o_j = _resample_positions(I, I, D, back._offset_k)
    L =int(i_j.max() - i_j.min()) + Kp
    kmat = np.zeros((I, 1, L), np.float32)
    for j in range(I):
        s = int(i_j[j] - i_j.min())
        kmat[j, 0, s:s + Kp] = table[o_j[j]]
    kmat = torch.as_tensor(kmat, device=y1.device)
    q = -(-n2 // I)
    lo = int(i_j.min())
    v = torch.cat([h2, y1], dim=-1)     # made outside the timed call
    v = torch.nn.functional.pad(v, (0, max(0, lo + (q - 1) * D + L
                                           - v.shape[-1])))

    def lib2():
        z = torch.nn.functional.conv1d(v[:, None, lo:], kmat, stride=D)
        return z[..., :q].transpose(1, 2).reshape(ROWS, -1)[:, :n2]

    lib_err2 = (lib2() - yr).abs().max().item()
    ops2 = 2 * Kp * n2 * ROWS
    b2, by2 = bound(nbytes(y1, h2, back._table, yr), ops2, "f32")
    rows.append(dict(
        name="K2 resample", route="cuda",
        source="sdr_tpu_torch/csrc/resample.cu",
        replaces="sdr_tpu/kernels/resample_pallas.py:187",
        max_abs_err=err2, ms=time_ms(lambda: resample.resample(*a2), 20),
        plain_ms=time_ms(lambda: resample.resample_reference(*a2), 3, 1),
        bound_ms=b2, bound_by=by2, library_ms=time_ms(lib2, 20),
        library_max_abs_diff=lib_err2))

    # K3: the audio FIR on the resampled batch, and strided/offset cases
    n3 = back.out_len(n1)
    err3 = 0.0
    for f, start, num in [(1, 0, n3), (1, 5, n3 - 5), (2, 3, n3 // 2 - 40)]:
        a3 = (back._taps, yr, num, f, start)
        err3 = max(err3, (fir.fir_strided(*a3)
                          - fir.fir_strided_reference(*a3)).abs().max().item())
    require(err3 <= 1e-6, f"K3 vs plain {err3} > 1e-6")
    a3 = (back._taps, yr, n3, 1, 0)
    y3 = fir.fir_strided(*a3)
    require(torch.isfinite(y3).all().item(), "K3 output finite")
    w3 = back._taps.view(1, 1, -1)

    def lib3():
        return torch.nn.functional.conv1d(yr[:, None, :], w3)[:, 0, :n3]

    lib_err3 = (lib3() - y3).abs().max().item()
    b3, by3 = bound(nbytes(yr, back._taps, y3), 2 * Kf * n3 * ROWS, "f32")
    rows.append(dict(
        name="K3 fir", route="cuda", source="sdr_tpu_torch/csrc/fir.cu",
        replaces="sdr_tpu/kernels/fir_pallas.py:145",
        max_abs_err=err3, ms=time_ms(lambda: fir.fir_strided(*a3), 20),
        plain_ms=time_ms(lambda: fir.fir_strided_reference(*a3), 3, 1),
        bound_ms=b3, bound_by=by3, library_ms=time_ms(lib3, 20),
        library_max_abs_diff=lib_err3))
    return rows


def run_chain(raw, ops, kernels):
    """The block-parallel chain with the launch counters read around it,
    then the streamed run over the same signal."""
    from sdr_tpu_torch.parallel.sharded import run_time_batched
    from sdr_tpu_torch.stream import Pipeline

    run_time_batched(ops, raw, ROWS)               # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for k in kernels:
        k.launches = 0
    y = run_time_batched(ops, raw, ROWS)
    torch.cuda.synchronize()
    launches = {k.name: k.launches for k in kernels}
    peak = torch.cuda.max_memory_allocated()
    for name, n in launches.items():
        require(n > 0, f"kernel {name} not launched on the main path")
    out = y.cpu().numpy()
    per_row = ops[1].out_len(ops[0].out_len(ROW_BYTES))
    require(out.shape == (ROWS * per_row,), f"output shape {out.shape}")
    require(np.isfinite(out).all(), "chain output finite")
    hz = tone_hz(out)
    require(abs(hz - 1000) < 5, f"tone at {hz} Hz")
    print(f"block-parallel chain: {ROWS} x {ROW_BYTES} bytes; peak memory "
          f"{peak} bytes; tone {hz:.2f} Hz; launches in one call "
          f"{launches}")

    # each call between CUDA events: the span on the device's clock from
    # the call's first enqueue to its last kernel's end, host gaps included
    ev = [(torch.cuda.Event(enable_timing=True),
           torch.cuda.Event(enable_timing=True)) for _ in range(CHAIN_REPS)]
    for a, b in ev:
        a.record()
        run_time_batched(ops, raw, ROWS)
        b.record()
    torch.cuda.synchronize()
    times = sorted(a.elapsed_time(b) for a, b in ev)
    ms = float(np.median(times))
    print(f"block-parallel chain over {CHAIN_REPS} calls by CUDA events: "
          f"median {ms} ms (min {times[0]}, max {times[-1]}); "
          f"{raw.numel() // 2 / (ms * 1e-3):.6e} complex input samples/s "
          "(median)")

    pipe = Pipeline(ops, block_in=STREAM_BLOCK)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    blocks = list(pipe.run(raw[i:i + STREAM_BLOCK] for i in
                           range(0, raw.numel(), STREAM_BLOCK)))
    torch.cuda.synchronize()
    t_stream = time.perf_counter() - t0
    streamed = torch.cat(blocks)
    require(torch.equal(streamed, y),
            "streamed Pipeline.run != block-parallel output (max diff "
            f"{(streamed - y).abs().max().item()})")
    print(f"streamed Pipeline.run at {STREAM_BLOCK}-byte blocks: equal to "
          f"block-parallel; {raw.numel() // 2 / t_stream:.6e} complex input "
          "samples/s")

    # agreement with the plain versions on the CPU, on a small input
    from sdr_tpu_torch.apps.chains import fm_chain
    small = raw[:4 * STREAM_BLOCK].cpu()
    _, ref = Pipeline(fm_chain(device="cpu"), block_in=STREAM_BLOCK,
                      device="cpu").process(small)
    n = ref.shape[-1]
    diff = (streamed[:n].cpu() - ref).abs().max().item()
    require(diff <= 1e-5, f"card vs CPU plain chain {diff} > 1e-5")
    print(f"card vs CPU plain chain on 4 blocks: max abs diff {diff}")
    return launches


def run_cli(raw):
    """The CLI on a temporary recording, streamed and block-parallel."""
    wavs = []
    with tempfile.TemporaryDirectory() as tmp:
        src = os.path.join(tmp, "capture.u8")
        raw[:16 * STREAM_BLOCK].cpu().numpy().tofile(src)
        env = dict(os.environ, PYTHONPATH=str(ROOT) + os.pathsep
                   + os.environ.get("PYTHONPATH", ""))
        for extra in ([], ["--batched", "4"]):
            out = os.path.join(tmp, f"audio{len(wavs)}.wav")
            proc = subprocess.run(
                [sys.executable, "-m", "sdr_tpu_torch.apps.fm", "--in", src,
                 "--out", out, *extra], cwd=ROOT, env=env,
                capture_output=True, text=True, timeout=300)
            print(f"cli {' '.join(extra) or '(streamed)'}: rc "
                  f"{proc.returncode} {proc.stdout.strip()}")
            require(proc.returncode == 0, f"cli failed: {proc.stderr}")
            with wave.open(out, "rb") as wf:
                require(wf.getframerate() == 48_000, "WAV rate")
                pcm = np.frombuffer(wf.readframes(wf.getnframes()), "<i2")
            hz = tone_hz(pcm.astype(np.float64))
            require(abs(hz - 1000) < 5, f"cli tone at {hz} Hz")
            wavs.append(pcm)
    require(np.array_equal(wavs[0], wavs[1]),
            "cli streamed and --batched WAVs differ")
    print(f"cli: {len(wavs[0])} samples, tone {hz:.2f} Hz, streamed == "
          "batched")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA GPU available", file=sys.stderr)
        return 1

    from sdr_tpu_torch.apps.chains import fm_chain
    from sdr_tpu_torch.kernels import KERNELS
    from sdr_tpu_torch.kernels._build import _nvcc, build_all
    from sdr_tpu_torch.utils.device import strict_fp32

    strict_fp32()
    card = card_line()
    nvcc = subprocess.run([_nvcc(), "--version"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()
    print(f"python {sys.version.split()[0]}; torch {torch.__version__}; "
          f"torch.version.cuda {torch.version.cuda}; nvcc: {nvcc[-1]}")
    print(f"card: {card}")
    t0 = time.perf_counter()
    build_all(KERNELS)
    print(f"kernels built in {time.perf_counter() - t0:.1f} s")
    for k in KERNELS:
        for line in k.build_log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {k.name}: {line.strip()}")

    device = torch.device("cuda")
    raw = synth_broadcast(ROWS * ROW_BYTES, args.seed, device)
    ops = fm_chain(device=device)
    rows = check_kernels(raw, ops)
    for r in rows:
        print(f"{r['name']}: max_abs_err {r['max_abs_err']}, {r['ms']} ms, "
              f"plain {r['plain_ms']} ms, library {r['library_ms']} ms, "
              f"bound {r['bound_ms']} ms ({r['bound_by']}) on {card}")
    launches = run_chain(raw, ops, KERNELS)
    for r, k in zip(rows, KERNELS):
        r["launches"] = launches[k.name]
    run_cli(raw)

    print(json.dumps({"kernels": rows}))
    print(f"card: {card}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
