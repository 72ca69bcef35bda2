"""Where the time of a block-parallel chain goes on the card.

    python -m sdr_tpu_torch.profile_fm [--chain mono|stereo|stereo_fused|
                                        exact|am|am_approx|waterfall|
                                        waterfall_complex|channelizer|
                                        channelizer_nb]
                                       [--save FILE | --compare FILE]

Runs ``run_time_batched`` over the chain's input (the main path's 32
blocks of 10,485,760 bytes of random u8 IQ, drawn from PyTorch's
generator seeded with 0; for the channelizers random complex64: 32
blocks of 4,096,000 wideband samples, or [64, 2,621,440] channel
basebands in 4 blocks) once to warm up (its peak device memory read
around it, ``torch.cuda.max_memory_allocated``; ``--save`` writes that
call's output to FILE, ``--compare`` holds it bitwise against a FILE
that ``--save`` wrote, another tree's) and counts the port's kernel
launches of one call by kernel (``KERNELS``' counters, set to 0 just
before it), then in one process:

1. ``REPS`` calls unprofiled, each between CUDA events: the call's span on
   the device's clock, host gaps included; then ``SPLIT_REPS`` calls each
   queued behind a device-side sleep (:func:`queued_split`): the device's
   time for a call without host gaps, and the host's time to enqueue it;
   then the same for the compiled call (``compile_time_batched``: a CUDA
   graph captured on the input and replayed, :func:`time_compiled`), its
   capture's time, its memory pool's bytes and the host time of the
   graph's launch alone (``cudaGraphLaunch``), in turns with the eager
   call (eager, compiled, compiled, eager);
2. ``REPS`` calls under ``torch.profiler``: the device time of each kernel
   by name and their sum (busy), the kernels a call (the profiler's count,
   memsets included), the device time of the PyTorch ops each
   stream op's ``shard_carry`` and ``apply`` launch (a ``record_function``
   range around each, set up here; the port's own kernels are launched
   through ctypes, which the profiler does not link to a range, so they
   count only by name), and the profiled wall time, which carries the
   profiler's own overhead;
3. one call under ``cProfile``: the host functions that take the most
   time;
4. each stream op alone (its ``shard_carry`` and ``apply`` on the batch
   the op before it made), ``SPLIT_REPS`` calls queued behind a sleep:
   its device time beside its floor on the H100 SXM data sheet's
   ceilings (``utils/roofline.py``) and ``pct_of_floor`` (floor over
   time), as the JAX package's ``bench.py`` records its stages.

The idle share is ``1 - busy / span``, busy from 2 and the unprofiled
median span from 1; the stage-sum share is the chain's floor
(``chain_roofline``, the data sheet) over the device time from 1.  The
chain (``--chain``) is ``fm_chain()`` (mono, the fused front, the
default), ``stereo``: ``fm_chain(front='quantized', stereo=True,
deemphasis=75e-6)``, ``stereo_fused``: the same with its back half on K5
(``ResampleFirScale(fused=True)``), ``exact``: ``fm_chain(front='exact')``
(the complex f32 front), ``am``: ``am_chain()``, ``am_approx``:
``am_chain(agc_approx=1)`` (the sequential AGC on K6), ``waterfall``:
``waterfall_chain()``, ``waterfall_complex``:
``waterfall_chain(planar=False)`` (the CLI's form), ``channelizer``:
``channelizer_chain(64, wideband=True)``, or ``channelizer_nb``:
``channelizer_chain(64)``.  No
chain's work depends on the data but through the stereo pilot lock,
which gates no kernel.  Needs a CUDA GPU.  The script reads only the
package's public chains and runners, so a copy of it in another
checkout (an earlier commit's, unpacked with ``git archive``) times that
package with the same measurement.
"""

from __future__ import annotations

import argparse
import cProfile
import functools
import io
import json
import pstats
import time
from pathlib import Path

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile, record_function

from sdr_tpu_torch.apps.chains import (am_chain, channelizer_chain,
                                       fm_chain, fm_taps, waterfall_chain)
from sdr_tpu_torch.kernels import KERNELS
from sdr_tpu_torch.measure_ceilings import card_line
from sdr_tpu_torch.parallel.sharded import run_time_batched
from sdr_tpu_torch.stream import ResampleFirScale
from sdr_tpu_torch.utils.roofline import chain_roofline

ROWS, ROW_BYTES = 32, 10_485_760      # the block-parallel main path
REPS = 20
SPLIT_REPS, SPLIT_SLEEP_CYCLES = 5, 200_000_000     # ~0.1 s head start


def _u8():
    return torch.randint(0, 256, (ROWS * ROW_BYTES,), dtype=torch.uint8,
                         device="cuda")


def _complex(*shape):
    return torch.randn(shape, dtype=torch.complex64, device="cuda")


def _fused(ops):
    """The stereo chain's back half on K5 (``ResampleFirScale(fused=
    True)``) in place of K2 -> K3."""
    _, taps, audio = fm_taps()
    return [*ops[:3], ResampleFirScale(taps, 3, 10, audio, 1.0, fused=True),
            *ops[4:]]


# name: (the chain's ops, its input, its blocks)
CHAINS = {
    "mono": (fm_chain, _u8, ROWS),
    "stereo": (lambda: fm_chain(front="quantized", stereo=True,
                                deemphasis=75e-6), _u8, ROWS),
    "stereo_fused": (lambda: _fused(fm_chain(front="quantized", stereo=True,
                                             deemphasis=75e-6)), _u8, ROWS),
    "exact": (lambda: fm_chain(front="exact"), _u8, ROWS),
    "am": (am_chain, _u8, ROWS),
    "am_approx": (lambda: am_chain(agc_approx=1), _u8, ROWS),
    "waterfall": (waterfall_chain, _u8, ROWS),
    "waterfall_complex": (lambda: waterfall_chain(planar=False), _u8, ROWS),
    "channelizer": (lambda: channelizer_chain(64, wideband=True),
                    lambda: _complex(ROWS * 4_096_000), ROWS),
    "channelizer_nb": (lambda: channelizer_chain(64),
                       lambda: _complex(64, 2_621_440), 4),
}


def queued_split(fn, reps: int = SPLIT_REPS) -> dict:
    """Medians over ``reps`` calls of ``fn``, each enqueued behind a
    device-side sleep: ``device_ms``, CUDA events around the call (the
    card's time for the call's work, back to back, with no host gap),
    ``enqueue_ms``, the host's clock around the call (its Python and
    launch overhead alone), and ``sleep_ms``, the sleep's own span, which
    must exceed ``enqueue_ms`` for ``device_ms`` to hold no host gap."""
    dev, host, head = [], [], []
    for _ in range(reps):
        e0, a, b = (torch.cuda.Event(enable_timing=True) for _ in range(3))
        torch.cuda.synchronize()
        e0.record()
        torch.cuda._sleep(SPLIT_SLEEP_CYCLES)
        a.record()
        t0 = time.perf_counter()
        fn()
        host.append((time.perf_counter() - t0) * 1e3)
        b.record()
        b.synchronize()
        dev.append(a.elapsed_time(b))
        head.append(e0.elapsed_time(a))
    out = {"device_ms": float(np.median(dev)),
           "enqueue_ms": float(np.median(host)),
           "enqueue_max_ms": max(host), "sleep_ms": min(head)}
    if out["enqueue_max_ms"] >= out["sleep_ms"]:
        raise RuntimeError(f"enqueue outlasted the sleep: {out}")
    return out


def time_compiled(ops, raw, nblocks: int):
    """The compiled block-parallel call beside the eager one: ``(capture
    ms, bitwise equal to the eager call, pool bytes, the call)``."""
    from sdr_tpu_torch.parallel.sharded import compile_time_batched
    from sdr_tpu_torch.utils.graphs import pool_bytes
    t0 = time.perf_counter()
    call = compile_time_batched(ops, raw, nblocks)
    torch.cuda.synchronize()
    capture_ms = (time.perf_counter() - t0) * 1e3
    same = torch.equal(call(), run_time_batched(ops, raw, nblocks))
    return capture_ms, same, pool_bytes(call.pool), call


def span_ms(fn) -> float:
    """Median ms of REPS back-to-back calls, each between CUDA events."""
    ev = [(torch.cuda.Event(enable_timing=True),
           torch.cuda.Event(enable_timing=True)) for _ in range(REPS)]
    for a, b in ev:
        a.record()
        fn()
        b.record()
    torch.cuda.synchronize()
    return float(np.median([a.elapsed_time(b) for a, b in ev]))


def _ranged(label, fn, *args):
    with record_function(label):
        return fn(*args)


def label_ops(ops) -> list:
    """Wrap each op's ``shard_carry`` and ``apply`` in a profiler range
    named ``<i> <Op>.<method>`` (on the instances; nothing else changes)."""
    labels = []
    for i, op in enumerate(ops):
        for meth in ("shard_carry", "apply"):
            label = f"{i} {type(op).__name__}.{meth}"
            setattr(op, meth, functools.partial(_ranged, label,
                                                getattr(op, meth)))
            labels.append(label)
    return labels


def stage_times(ops, x, nblocks: int) -> list:
    """Each op's device time (ms, :func:`queued_split`) on the batch
    ``run_time_batched`` hands it: the rows ``[B, *lead, n/B]``, then each
    op's output in turn.  Its floor from ``chain_roofline`` beside it."""
    n, lead = x.shape[-1], x.shape[:-1]
    batch = nblocks * int(np.prod(lead, dtype=np.int64))
    roof = chain_roofline(ops, n // nblocks, x.dtype, batch)["stages"]
    xb = x.reshape(lead + (nblocks, n // nblocks)).movedim(-2, 0)
    xb = xb.contiguous()
    rows = []
    for op, st in zip(ops, roof):
        def call(op=op, xb=xb):
            return op.apply(op.shard_carry(xb), xb)[1]
        ms = queued_split(call)["device_ms"]
        rows.append({"op": st["op"], "device_ms": ms,
                     "floor_ms": st["floor_s"] * 1e3,
                     "bound_by": st["bound_by"],
                     "pct_of_floor": 100 * st["floor_s"] * 1e3 / ms})
        xb = call()
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--chain", default="mono", choices=sorted(CHAINS),
                    help="the chain to profile (default: mono)")
    io_args = ap.add_mutually_exclusive_group()
    io_args.add_argument("--save", type=Path, default=None,
                         help="write the warm-up call's output here")
    io_args.add_argument("--compare", type=Path, default=None,
                         help="hold the warm-up call's output bitwise "
                              "against a file --save wrote")
    args = ap.parse_args(argv)
    card = card_line()
    make_ops, make_input, nblocks = CHAINS[args.chain]
    torch.manual_seed(0)
    ops, raw = make_ops(), make_input()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    y = run_time_batched(ops, raw, nblocks)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    same = None
    if args.save is not None:
        torch.save(y.cpu(), args.save)
    elif args.compare is not None:
        ref = torch.load(args.compare)
        same = (tuple(ref.shape) == tuple(y.shape)
                and torch.equal(ref.view(torch.int32),
                                y.cpu().view(torch.int32)))
        print(f"output bitwise equal to {args.compare}: {same}")
    del y
    for k in KERNELS:
        k.launches = 0
    run_time_batched(ops, raw, nblocks)
    torch.cuda.synchronize()
    launches = {k.name: k.launches for k in KERNELS if k.launches}
    print(f"the port's kernel launches in one call: {launches}")

    def eager():
        return run_time_batched(ops, raw, nblocks)

    span = span_ms(eager)
    split = queued_split(eager)
    capture_ms, same_compiled, pool, call = time_compiled(ops, raw, nblocks)
    turns = [(label, span_ms(fn), queued_split(fn)) for label, fn in
             (("compiled", call), ("compiled", call), ("eager", eager))]
    # the graph's launch alone: what a replay's enqueue is made of
    launch = queued_split(call.graph.graph.replay)
    compiled = {"capture_ms": capture_ms, "pool_bytes": pool,
                "bitwise_equal_to_eager": same_compiled,
                "graph_launch_enqueue_ms": launch["enqueue_ms"],
                "turns": [{"call": label, "span_ms": ms, "queued": q}
                          for label, ms, q in turns]}
    print(f"compiled call: capture {capture_ms:.1f} ms, pool {pool} "
          f"bytes, bitwise the eager call: {same_compiled}; the graph's "
          f"launch alone enqueues in {launch['enqueue_ms']} ms; in turns "
          f"(eager first, above): " + "; ".join(
              f"{label} span {ms} ms, device {q['device_ms']} ms, "
              f"enqueue {q['enqueue_ms']} ms" for label, ms, q in turns))
    del call
    torch.cuda.empty_cache()

    labels = label_ops(ops)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(REPS):
            run_time_batched(ops, raw, nblocks)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) / REPS * 1e3
    kernels, by_op = {}, {}
    for e in prof.key_averages():
        if e.key in labels:
            # the range on the host holds the device time of the PyTorch
            # ops it launched; the profiler also records each range on the
            # device's timeline, which is not a kernel
            if e.device_type == DeviceType.CPU:
                by_op[e.key] = e.device_time_total / 1e3 / REPS
        elif e.device_type == DeviceType.CUDA:
            kernels[e.key] = (e.self_device_time_total / 1e3 / REPS,
                              e.count / REPS)
    busy = sum(ms for ms, _ in kernels.values())

    pr = cProfile.Profile()
    pr.enable()
    run_time_batched(ops, raw, nblocks)
    torch.cuda.synchronize()
    pr.disable()
    s = io.StringIO()
    pstats.Stats(pr, stream=s).sort_stats("cumulative").print_stats(15)
    stages = stage_times(ops, raw, nblocks)
    floor_ms = chain_roofline(
        ops, raw.shape[-1] // nblocks, raw.dtype,
        nblocks * int(np.prod(raw.shape[:-1], dtype=np.int64))
    )["total_floor_s"] * 1e3

    print(f"card: {card}")
    for name, (ms, n) in sorted(kernels.items(), key=lambda kv: -kv[1][0]):
        print(f"  {ms:10.4f} ms  x{n:g}  {name[:100]}")
    print("device time of the PyTorch ops each stream op launches (the "
          "port's kernels, launched through ctypes, are not linked to a "
          "range; they are listed by name above):")
    for label in labels:
        print(f"  {by_op.get(label, 0.0):10.4f} ms  {label}")
    print(s.getvalue())
    print("each op alone, device time beside its floor (H100 SXM data "
          "sheet):")
    for st in stages:
        print(f"  {st['device_ms']:10.4f} ms  floor {st['floor_ms']:.4f} ms "
              f"({st['bound_by']})  {st['pct_of_floor']:6.2f} % of floor  "
              f"{st['op']}")
    print(json.dumps({"chain": args.chain, "input": list(raw.shape),
                      "input_dtype": str(raw.dtype), "blocks": nblocks,
                      "reps": REPS,
                      "span_ms": span, "device_busy_ms": busy,
                      "compiled": compiled,
                      "idle_share": 1 - busy / span, "queued": split,
                      "profiled_wall_ms": wall, "ops_ms": by_op,
                      "kernels_ms": {k: v[0] for k, v in kernels.items()},
                      "kernels_per_call": sum(n for _, n in
                                              kernels.values()),
                      "stages": stages, "peak_bytes": peak,
                      "stage_sum_floor_ms": floor_ms,
                      "stage_sum_share": floor_ms / split["device_ms"],
                      "bitwise_equal_to_compare": same,
                      "launches": launches,
                      "card": card}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
