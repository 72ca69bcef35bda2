"""The benchmark's clocks: the measured window, its CUDA-event spans, the
profiled window, the spin-bracketed kernel count, and the last line.

The window is a closed loop of one client that dispatches ahead: call
``i + 1`` is enqueued while call ``i`` runs, and before call ``i + 2`` the
host waits on call ``i``'s end event (``in_flight`` calls at most).  A
CUDA event is recorded on the call's stream before and after each call,
so a call's span is its device time plus any wait for the card.
"""

from __future__ import annotations

import collections
import contextlib
import gc
import json
import re
import sys
import time
from pathlib import Path

import torch

__all__ = ["Window", "window", "profiled_window", "kernel_count",
           "port_kernel_names", "quantile", "emit"]

SPIN_CYCLES = 500_000               # ~0.25 ms a spin kernel
PROFILE_LEAD = PROFILE_TAIL = 32    # spin kernels around a counted call
PROFILE_SESSIONS = 6                # counted calls; the same on every rank
PROFILE_WARMUP = 16                 # profiled calls before the window opens


class Window:
    """What one window recorded: its host times, each call's span and
    enqueue time, and the outputs sampled."""

    def __init__(self):
        self.calls = 0
        self.t0 = self.t1 = 0.0             # time.time() at the ends
        self.spans_ms: list = []
        self.enqueue_ms: list = []
        self.last = None                    # the last call's output


def window(call, seconds: float, in_flight: int, samples=None,
           stop=None, span=None) -> Window:
    """Run ``call()`` in the closed loop until ``seconds`` have passed (or
    ``stop(i)`` says so before call ``i``), then wait for the last call.
    ``samples`` maps a call's index to a buffer its output is copied into
    on the stream, after the call's end event.  ``span(name)`` is a
    context around the host's dispatch and wait, and around the whole
    loop as ``span("window")``, opened once the collector has run (the
    profiled window's record_function)."""
    span = span or (lambda name: contextlib.nullcontext())
    samples = samples or {}
    stream = torch.cuda.current_stream()
    pending = collections.deque()
    events = []
    w = Window()
    perf, ns = time.perf_counter, time.perf_counter_ns
    # the harness's own objects pile up over the window: the cyclic
    # collector's pauses would stall the dispatch, so it waits
    collecting = gc.isenabled()
    gc.collect()
    gc.disable()
    deadline = perf() + seconds
    w.t0 = time.time()
    i = 0
    opened = span("window")
    opened.__enter__()
    try:
        while not (stop(i) if stop is not None else perf() >= deadline):
            if len(pending) == in_flight:
                with span("wait"):
                    pending.popleft().synchronize()
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            with span("dispatch"):
                s.record(stream)
                a = ns()
                y = call()
                b = ns()
                e.record(stream)
            w.enqueue_ms.append((b - a) * 1e-6)
            if i in samples:
                samples[i].copy_(y)
            pending.append(e)
            events.append((s, e))
            i += 1
        with span("wait"):
            torch.cuda.current_stream().synchronize()
    finally:
        opened.__exit__(None, None, None)
        if collecting:
            gc.enable()
    w.t1 = time.time()
    w.calls = i
    w.last = y if i else None
    w.spans_ms = [s.elapsed_time(e) for s, e in events]
    return w


def profiled_window(call, calls: int, in_flight: int):
    """``calls`` calls of the same loop under ``torch.profiler``: the
    device records ``[(name, start_us, end_us)]``, the harness's host spans
    ``[(name, start_us, end_us)]`` and the window ``(start_us, end_us)``, on
    the profiler's clock."""
    from torch.autograd import DeviceType
    from torch.autograd.profiler import record_function
    from torch.profiler import ProfilerActivity, profile

    def span(name):
        return record_function(f"portbench.{name}")

    def stop(i):
        return i >= calls

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        # the session's first launches pay the profiler's own start-up:
        # they run before the window opens
        window(call, 0.0, in_flight, stop=lambda i: i >= PROFILE_WARMUP)
        w = window(call, 0.0, in_flight, stop=stop, span=span)
    device, host, win = [], [], None
    for e in prof.events():
        tr = e.time_range
        if e.device_type == DeviceType.CUDA:
            # the harness's own ranges also show on the device's
            # timeline, as annotations: they are not device work
            if not e.name.startswith("portbench."):
                device.append((e.name, tr.start, tr.end))
        elif e.name == "portbench.window":
            win = (tr.start, tr.end)
        elif e.name.startswith("portbench."):
            host.append((e.name[len("portbench."):], tr.start, tr.end))
    device.sort(key=lambda r: r[1])
    host.sort(key=lambda r: r[1])
    return {"calls": w.calls, "device": device, "host": host,
            "window": win}


def kernel_count(call):
    """The device records of one call, ``{name: count}``: each session waits,
    runs PROFILE_LEAD spin kernels each waited for, the call, and
    PROFILE_TAIL more (the profiler can lose a session's first and last
    records); a session is whole when recorded spins stand before the
    call's first record and after its last with none between.  Runs
    PROFILE_SESSIONS sessions (a fixed number: a sharded call is a
    collective) and returns the first reading two whole ones agree on, or
    None."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def spin(n):
        for _ in range(n):
            torch.cuda._sleep(SPIN_CYCLES)
            torch.cuda.synchronize()

    readings, found = [], None
    for _ in range(PROFILE_SESSIONS):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            time.sleep(0.02)
            spin(PROFILE_LEAD)
            call()
            torch.cuda.synchronize()
            spin(PROFILE_TAIL)
        ran = sorted((e for e in prof.events()
                      if e.device_type == DeviceType.CUDA),
                     key=lambda e: e.time_range.start)
        spun = ["spin_kernel" in e.name for e in ran]
        if False not in spun:
            continue
        lead, tail = spun.index(False), spun[::-1].index(False)
        inner = ran[lead:len(ran) - tail]
        if not lead or not tail or any("spin_kernel" in e.name
                                       for e in inner):
            continue
        got = collections.Counter(e.name for e in inner)
        if found is None and got in readings:
            found = dict(got)
        readings.append(got)
    return found


def port_kernel_names(csrc: Path) -> set:
    """The ``__global__`` kernels the program's CUDA sources define."""
    names = set()
    pat = re.compile(r"__global__\s+void\s+(?:__launch_bounds__\s*\([^)]*\)"
                     r"\s*)?(\w+)\s*\(")
    for src in sorted(csrc.glob("*.cu")):
        names.update(pat.findall(src.read_text()))
    return names


def quantile(values, q: float) -> float:
    """The ``q`` quantile with linear interpolation between order
    statistics (numpy's default)."""
    v = sorted(values)
    if not v:
        raise ValueError("no values")
    pos = q * (len(v) - 1)
    lo = int(pos)
    hi = min(lo + 1, len(v) - 1)
    return v[lo] + (v[hi] - v[lo]) * (pos - lo)


def emit(line: dict, checks: dict) -> None:
    """The run's end: each number compared, beside its limit, as the last
    lines of standard error, then the result as the last line of standard
    output with the same under ``checked``, its last key."""
    for name, c in checks.items():
        print(f"check {name} = {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    sys.stderr.flush()
    out = dict(line)
    out["checked"] = checks
    print(json.dumps(out), flush=True)


def busy_us(device, lo: float, hi: float) -> float:
    """Microseconds of ``[lo, hi)`` covered by the union of the device
    records' intervals (``device`` sorted by start)."""
    total, end = 0.0, lo
    for _, s, e in device:
        s, e = max(s, end), min(e, hi)
        if e > s:
            total += e - s
            end = e
    return total


def idle_gaps(device, lo: float, hi: float):
    """The intervals of ``[lo, hi)`` in which no device record runs."""
    gaps, end = [], lo
    for _, s, e in device:
        if s > end and s < hi:
            gaps.append((end, min(s, hi)))
        end = max(end, e)
    if end < hi:
        gaps.append((end, hi))
    return gaps


def device_us(profile, keep) -> float:
    """Microseconds of the profiled window spent in the device records
    whose names ``keep(name)`` accepts (each record cut to the window)."""
    lo, hi = profile["window"]
    return sum(min(e, hi) - max(s, lo) for n, s, e in profile["device"]
               if e > lo and s < hi and keep(n))


def is_kernel(name: str, kernel: str) -> bool:
    """Whether a device record is the program's kernel ``kernel`` (and
    not one of PyTorch's, which live in ``at::``)."""
    return "at::" not in name and re.search(rf"\b{kernel}\b", name) \
        is not None


def is_port_kernel(name: str, port: set) -> bool:
    """Whether a device record is one of the program's own CUDA kernels
    (PyTorch's kernels live in ``at::``; its copies and fills are
    ``Memcpy`` and ``Memset`` records)."""
    if name.startswith(("Memcpy", "Memset")):
        return False
    return any(is_kernel(name, k) for k in port)


def is_collective(name: str) -> bool:
    return "nccl" in name.lower()
