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
2. with tracing on (``utils/profiling.py``): ``REPS`` eager calls under
   ``torch.profiler``: the device time of each kernel by name and their
   sum (busy), the kernels a call (the profiler's count, memsets
   included), the device time of the PyTorch ops each stage of the call
   launches (the program's ``sdr.<stage>`` ranges: ``input``, each op's
   ``<i>.<Op>.carry`` and ``.apply``, ``output``; the port's own kernels
   are launched through ctypes, which the profiler does not link to a
   range, so they count only by name), and the profiled wall time, which
   carries the profiler's own overhead; then the compiled call built with
   tracing on (:func:`stage_split`): each stage's device time inside the
   graph (``stage_ms()``), ``STAGE_REPS`` calls each queued behind a
   device-side sleep, their sum against CUDA events around the call, and
   the ops' inner stages (``inner_ms()``: ``Agc``'s and ``DcBlocker``'s)
   beside the stage they partition; the counters of one such call
   (``profiling.counts()``: ``agc.premise_breaks``); the
   cost of the stage events and host spans (:func:`tracing_cost`: device
   and enqueue ms of the call built with tracing off and on, in turns);
   and ``REPS`` compiled calls, two in flight, under the profiler
   (:func:`call_gaps`): the card's idle gaps, each labelled by the
   innermost program span (``sdr.*``) open on the host at its start, and
   the share of the window the card idled inside the host's ``call``
   span; the set-up totals (``profiling.totals()``: ``design``,
   ``capture``);
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
package's public chains, runners and tracing, so a copy of it in another
checkout that has them (an earlier commit's, unpacked with ``git
archive``) times that package with the same measurement.
"""

from __future__ import annotations

import argparse
import cProfile
import io
import json
import pstats
import time
from pathlib import Path

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from sdr_tpu_torch.apps.chains import (am_chain, channelizer_chain,
                                       fm_chain, fm_taps, waterfall_chain)
from sdr_tpu_torch.kernels import KERNELS
from sdr_tpu_torch.measure_ceilings import card_line
from sdr_tpu_torch.parallel.sharded import (compile_time_batched,
                                             run_time_batched)
from sdr_tpu_torch.stream import ResampleFirScale
from sdr_tpu_torch.utils import profiling
from sdr_tpu_torch.utils.roofline import chain_roofline

ROWS, ROW_BYTES = 32, 10_485_760      # the block-parallel main path
REPS = 20
STAGE_REPS = 64
GAP_WARMUP = 16     # profiled calls before call_gaps' window opens
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


def op_ms(stages: dict | None, op: str) -> float | None:
    """The ms of the stages of the ops of class ``op`` (``<i>.<op>.carry``
    and ``.apply``) in ``stages`` (a ``stage_ms()``), matched by class
    name, not index; None where there is none, or no stages."""
    got = [ms for name, ms in (stages or {}).items()
           if name.split(".")[1:2] == [op]]
    return sum(got) if got else None


def runner_ms(stages: dict | None) -> float | None:
    """The ms of the stages the block-parallel runner adds over a
    streamed run: ``input``, ``output`` and every op's ``carry`` (so an
    op's carry counts both here and in :func:`op_ms`); None without
    stages or without ``input``."""
    if not stages or "input" not in stages:
        return None
    return sum(ms for name, ms in stages.items()
               if name in ("input", "output") or name.endswith(".carry"))


def idle_gaps(device, host) -> dict | None:
    """The card's idle gaps from the first ``call`` span's start to the
    last device record's end: ``device`` the records' ``(start, end)``,
    ``host`` the program's spans ``(name, start, end)`` (us, one clock).
    Each gap is labelled by the innermost span open at its start
    (``outside`` where none is); ``call_idle_share`` is the share of the
    window in which the card idled while a ``call`` span was open.  None
    without a ``call`` span or a device record."""
    inside = sorted((s, e) for n, s, e in host if n == "call")
    if not inside or not device:
        return None
    device = sorted(device)
    lo, hi = inside[0][0], max(e for _, e in device)
    gaps, end = [], lo
    for s, e in device:
        if s > end:
            gaps.append((end, s))
        end = max(end, e)
    labelled, idle = [], 0.0
    for a, b in gaps:
        open_ = [(e - s, n) for n, s, e in host if s <= a < e]
        labelled.append((min(open_)[1] if open_ else "outside",
                         (b - a) / 1e3))
        idle += sum(max(0.0, min(b, e) - max(a, s)) for s, e in inside)
    return {"window_ms": (hi - lo) / 1e3,
            "idle_ms": sum(ms for _, ms in labelled),
            "call_idle_share": idle / (hi - lo),
            "gaps": sorted(labelled, key=lambda g: -g[1])[:10]}


def stage_split(call, reps: int = STAGE_REPS) -> dict:
    """A compiled call built with tracing on: medians over ``reps`` calls,
    each queued behind a device-side sleep, of each stage's device ms
    (``call.stage_ms()``), of the stages' sum and of the call's span
    between CUDA events recorded around it outside the graph, the median
    of each call's sum over its span (``sum_share``), and the medians of
    :func:`runner_ms` and of each op class's :func:`op_ms`, and each
    inner stage's median (``inner_ms``, by the stage holding it)."""
    stages, inner, sums, outside = [], [], [], []
    for _ in range(reps):
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        torch.cuda.synchronize()
        torch.cuda._sleep(SPLIT_SLEEP_CYCLES)
        a.record()
        call()
        b.record()
        b.synchronize()
        ms = call.stage_ms()
        stages.append(ms)
        inner.append(call.inner_ms())
        sums.append(sum(ms.values()))
        outside.append(a.elapsed_time(b))
    classes = dict.fromkeys(name.split(".")[1] for name in stages[0]
                            if name.count(".") == 2)
    return {"stage_ms": {k: float(np.median([m[k] for m in stages]))
                         for k in stages[0]},
            "inner_ms": {k: {n: float(np.median([i[k][n] for i in inner]))
                             for n in v} for k, v in inner[0].items()},
            "sum_ms": float(np.median(sums)),
            "outside_ms": float(np.median(outside)),
            "sum_share": float(np.median([s / o for s, o in
                                          zip(sums, outside)])),
            "runner_ms": float(np.median([runner_ms(m) for m in stages])),
            "op_ms": {op: float(np.median([op_ms(m, op) for m in stages]))
                      for op in classes}}


def tracing_cost(off, on) -> dict:
    """:func:`queued_split` of a compiled call built with tracing off and
    of one built with it on (called with tracing on: its host spans
    too), in turns (off, on, on, off)."""
    def traced():
        with profiling.tracing():
            return on()

    turns = [(label, queued_split(fn)) for label, fn in
             (("off", off), ("on", traced), ("on", traced), ("off", off))]
    return {label: {k: [q[k] for lab, q in turns if lab == label]
                    for k in ("device_ms", "enqueue_ms")}
            for label in ("off", "on")}


def call_gaps(call, reps: int = REPS) -> dict:
    """``reps`` calls of a compiled call, two in flight, with tracing on
    under ``torch.profiler``, after ``GAP_WARMUP`` more (the first
    launches under a profiler pay its start-up): :func:`idle_gaps` of the
    card's records against the program's spans, from the first call
    after the warm-up."""
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof, \
            profiling.tracing():
        pending = []
        for _ in range(GAP_WARMUP + reps):
            if len(pending) == 2:
                pending.pop(0).synchronize()
            call()
            e = torch.cuda.Event()
            e.record()
            pending.append(e)
        torch.cuda.synchronize()
    device, host = [], []
    for e in prof.events():
        tr = e.time_range
        if e.name.startswith("sdr."):
            # the profiler shows each range on the device's timeline too,
            # as an annotation: no device work
            if e.device_type == DeviceType.CPU:
                host.append((e.name[4:], tr.start, tr.end))
        elif e.device_type == DeviceType.CUDA:
            device.append((tr.start, tr.end))
    start = sorted(s for n, s, _ in host if n == "call")[GAP_WARMUP]
    return idle_gaps([d for d in device if d[0] >= start],
                     [h for h in host if h[1] >= start])


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
    with profiling.tracing():
        traced = compile_time_batched(ops, raw, nblocks)
    staged = stage_split(traced)
    profiling.clear()
    traced()
    counted = profiling.counts()        # one traced call's counters
    cost = tracing_cost(call, traced)
    del call
    gaps = call_gaps(traced)
    del traced
    torch.cuda.empty_cache()

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof, \
            profiling.tracing():
        t0 = time.perf_counter()
        for _ in range(REPS):
            run_time_batched(ops, raw, nblocks)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) / REPS * 1e3
    kernels, by_stage = {}, {}
    for e in prof.key_averages():
        if e.key.startswith("sdr."):
            # the range on the host holds the device time of the PyTorch
            # ops it launched; the profiler also records each range on the
            # device's timeline, which is not a kernel
            if e.device_type == DeviceType.CPU:
                by_stage[e.key[4:]] = e.device_time_total / 1e3 / REPS
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
    print("device time of the PyTorch ops each stage of the eager call "
          "launches (the port's kernels, launched through ctypes, are not "
          "linked to a range; they are listed by name above):")
    for stage, ms in by_stage.items():
        print(f"  {ms:10.4f} ms  {stage}")
    print(f"the compiled call's stages inside the graph (median of "
          f"{STAGE_REPS} calls): sum {staged['sum_ms']:.4f} ms against "
          f"{staged['outside_ms']:.4f} ms between events outside it "
          f"(each call's sum over its span: {staged['sum_share']:.4f})")
    for stage, ms in staged["stage_ms"].items():
        print(f"  {ms:10.4f} ms  {stage}")
    print(f"  runner (input, output, every carry) {staged['runner_ms']:.4f}"
          f" ms; by op class {staged['op_ms']}")
    for stage, inner in staged["inner_ms"].items():
        print(f"  {stage} {staged['stage_ms'][stage]:.4f} ms, its inner "
              f"stages {sum(inner.values()):.4f} ms: " + ", ".join(
                  f"{name} {ms:.4f}" for name, ms in inner.items()))
    print(f"counters of one traced compiled call: {counted}")
    print(f"tracing's cost: device ms off {cost['off']['device_ms']}, on "
          f"{cost['on']['device_ms']}; enqueue ms off "
          f"{cost['off']['enqueue_ms']}, on {cost['on']['enqueue_ms']}")
    print(f"the compiled call's idle gaps, two in flight: "
          f"{gaps['idle_ms']:.4f} of {gaps['window_ms']:.4f} ms, inside "
          f"the host's call span {100 * gaps['call_idle_share']:.3f} %; "
          f"the longest, by the innermost program span: {gaps['gaps']}")
    print(f"set-up totals (s): {profiling.totals()}")
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
                      "profiled_wall_ms": wall, "stages_eager_ms": by_stage,
                      "stages_compiled": staged, "tracing_cost": cost,
                      "call_gaps": gaps, "setup_totals": profiling.totals(),
                      "counters": counted,
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
