"""The port's tracing, and timing helpers on ``torch.profiler``
(counterpart of sdr_tpu/utils/profiling.py).

Tracing is off by default and costs one flag check a span while it is
off.  :func:`tracing` turns it on for a block (so does :func:`profile`).
While it is on:

* each span (:func:`trace`, a caller's region; :func:`span`, the
  program's own at its layer boundaries) records its name, its start and
  end on the host's ``perf_counter_ns``, its parent span and the compiled
  call's index (``graphs.replays`` at its start: spans of one call share
  it) into a bounded buffer that :func:`spans` returns and :func:`clear`
  empties, and, while ``torch.profiler`` records, is emitted as a
  ``record_function`` range on the profiler's clock: ``<name>`` for a
  caller's region, ``sdr.<name>`` for the program's;
* a call built while it is on times its stages (:class:`Stages`): a
  CUDA event at each stage boundary, which ``torch.cuda.graph`` captures
  as an event-record node, so every replay times the stages inside the
  graph (the host clock on the CPU); the compiled calls' ``stage_ms()``
  reads them.

An op splits its stage into inner stages (:func:`inner`,
``<i>.<Op>.<name>``: ``Agc``'s ``affine``, ``prefix``, ``premise`` and
``gains``, ``DcBlocker``'s ``halo``, ``state`` and ``prefix``), timed the
same way inside the stage of the call running it; :meth:`Stages.inner_ms`
reads them.

Counters (:func:`count`, read by :func:`counts`): while tracing is on, a
named number the program adds to at each run, on the device where it is
a device tensor (inside a graph a captured add, read after the replay);
while it is off, nothing is read, computed or launched.  The program's
one counter is ``agc.premise_breaks`` (stream/ops.py ``Agc``).

Set-up spans (:func:`setup`: the filter designs, ``design``; the graph
captures, ``capture``, ``capture.warmup``, ``capture.graph``) add their
duration to :func:`totals` on every run, traced or not: two clock reads a
set-up.

``profile`` records a Perfetto trace (``chrome://tracing``) of a block
and writes it under a directory; ``timed`` reports a region's wall time
after waiting for the card.
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import os
import threading
import time
from pathlib import Path
from typing import Iterator, NamedTuple

import torch

from sdr_tpu_torch.utils import graphs
from sdr_tpu_torch.utils.device import resolve_device

__all__ = ["trace", "span", "setup", "tracing", "enabled", "spans", "clear",
           "totals", "count", "counts", "Span", "Stages", "stage", "inner",
           "op_stages", "profile", "timed", "SPAN_LIMIT"]

SPAN_LIMIT = 65_536     # spans the buffer keeps; the oldest go first

_on = False
_buffer: collections.deque = collections.deque(maxlen=SPAN_LIMIT)
_ids = itertools.count()
_local = threading.local()          # each thread's open spans
_totals: dict = {}
_totals_lock = threading.Lock()
_counters: dict = {}                # (name, device) -> an int64 tensor
_NULL = contextlib.nullcontext()


class Span(NamedTuple):
    """One finished span.  ``parent``: the ``id`` of the span open around
    it on its thread, or None; ``call``: the compiled calls' replay count
    at its start."""
    id: int
    name: str
    parent: int | None
    call: int
    start_ns: int
    end_ns: int

    @property
    def ms(self) -> float:
        return (self.end_ns - self.start_ns) / 1e6


def _open() -> list:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


class _Region:
    """A span being recorded (made only while tracing is on)."""

    __slots__ = ("name", "label", "id", "parent", "call", "start", "_range")

    def __init__(self, name: str, label: str):
        self.name, self.label = name, label

    def __enter__(self):
        stack = _open()
        self.parent = stack[-1].id if stack else None
        self.id = next(_ids)
        self.call = graphs.replays
        stack.append(self)
        # a range costs microseconds of the host's time: only a running
        # profiler records one
        self._range = None
        if torch.autograd._profiler_enabled():
            self._range = torch.profiler.record_function(self.label)
            self._range.__enter__()
        self.start = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        end = time.perf_counter_ns()
        if self._range is not None:
            self._range.__exit__(*exc)
        _open().pop()
        _buffer.append(Span(self.id, self.name, self.parent, self.call,
                            self.start, end))
        return False


def enabled() -> bool:
    """Whether tracing is on."""
    return _on


@contextlib.contextmanager
def tracing() -> Iterator[None]:
    """Tracing on for the block (and back to what it was after)."""
    global _on
    was, _on = _on, True
    try:
        yield
    finally:
        _on = was


def trace(name: str):
    """A caller's named region: while tracing is on, a span ``name`` (and
    under a running profiler a range of the same name); nothing
    otherwise."""
    return _Region(name, name) if _on else _NULL


def span(name: str):
    """The program's span ``name`` at a layer boundary: while tracing is
    on, a span (and under a running profiler the range ``sdr.<name>``);
    nothing otherwise."""
    return _Region(name, "sdr." + name) if _on else _NULL


@contextlib.contextmanager
def setup(name: str) -> Iterator[None]:
    """A set-up span: its host time is added to ``totals()[name]`` on
    every run; while tracing is on it is also the span ``name``."""
    t0 = time.perf_counter_ns()
    try:
        with span(name):
            yield
    finally:
        dt = time.perf_counter_ns() - t0
        with _totals_lock:
            _totals[name] = _totals.get(name, 0) + dt


def spans() -> list:
    """The recorded spans (:class:`Span`), oldest first, each after every
    span inside it."""
    return list(_buffer)


def clear() -> None:
    """Empty the span buffer and zero the counters in place (a graph adds
    to their tensors); the totals stay."""
    _buffer.clear()
    with _totals_lock:
        for t in _counters.values():
            t.zero_()


def totals() -> dict:
    """Seconds spent in each set-up span since import, by name."""
    with _totals_lock:
        return {k: v / 1e9 for k, v in _totals.items()}


def count(name: str, n) -> None:
    """Add ``n`` to the counter ``name`` while tracing is on; nothing
    otherwise.  ``n``: a number, a tensor (a device tensor adds on its
    device, a captured add inside a graph), or a function of no arguments
    giving one, called only while tracing is on, so that an untraced run
    computes nothing.  A device counter is made at its first traced run
    outside a capture (a compiled call's warm-up): every run adds to it,
    the warm-ups included, until :func:`clear`."""
    if not _on:
        return
    if callable(n):
        n = n()
    n = torch.as_tensor(n, dtype=torch.int64)
    key = (name, n.device)
    with _totals_lock:
        acc = _counters.get(key)
        if acc is None:
            if n.device.type == "cuda" and \
                    torch.cuda.is_current_stream_capturing():
                raise RuntimeError(f"counter {name!r} first counted inside "
                                   "a capture: a graph would zero it at "
                                   "every replay")
            acc = _counters[key] = torch.zeros((), dtype=torch.int64,
                                               device=n.device)
    acc.add_(n)


def counts() -> dict:
    """Each counter's total since the last :func:`clear`, by name, summed
    over devices (reading a device counter waits for the work queued
    before it)."""
    with _totals_lock:
        items = list(_counters.items())
    out: dict = {}
    for (name, _), t in items:
        out[name] = out.get(name, 0) + int(t.item())
    return out


class Stages:
    """The stages of one call: ``names`` in the order the call runs them,
    each entered as ``with stage(stages):`` in that order; a stage ends
    where the next begins, the last at its own end.

    A call builds one only while tracing is on (:func:`enabled`), so a
    call built with tracing off makes and records nothing.  On the card
    each boundary is a CUDA event (``enable_timing``, ``external``: under
    ``torch.cuda.graph`` an event-record node), recorded on the current
    stream; on the CPU the host clock.  Each stage is also the span
    ``<name>`` while tracing is on when it runs.  :meth:`ms` reads the
    last run's times: after a run ends and before the next records into
    the same events.

    Inside a stage the op may open inner stages (:func:`inner`), each
    named ``<i>.<Op>.<name>`` after the stage ``<i>.<Op>.<carry|apply>``
    holding it: the first begins at its stage's start, each later one at
    a boundary of its own (an event made at its first run), each ends
    where the next inner stage of the same stage begins, the last at its
    stage's end.  So they partition their stage, with one boundary less
    than they number (an event-record node costs the card ~3 us);
    :meth:`inner_ms` reads them."""

    def __init__(self, names, device):
        self.names = tuple(names)
        n = len(self.names) + 1
        self._events = ([torch.cuda.Event(enable_timing=True, external=True)
                         for _ in range(n)]
                        if torch.device(device).type == "cuda" else None)
        self._host = [0] * n
        self._k = 0
        self._span = None
        self._inner: dict = {}      # inner stage -> its event or host ns
        self._entered: list = []    # (stage index, inner stage), this run
        self._last_inner: list = []     # the same, of the last whole run

    def _mark(self, k: int) -> None:
        if self._events is None:
            self._host[k] = time.perf_counter_ns()
        else:
            self._events[k].record()

    def _mark_inner(self, name: str) -> str:
        """Enter the inner stage ``name`` of the stage running: the first
        of its stage starts at the stage's own boundary, a later one
        records its own.  Returns its full name."""
        full = f"{self.names[self._k].rsplit('.', 1)[0]}.{name}"
        if self._entered and self._entered[-1][0] == self._k:
            if self._events is None:
                self._inner[full] = time.perf_counter_ns()
            else:
                ev = self._inner.get(full)
                if ev is None:
                    ev = self._inner[full] = torch.cuda.Event(
                        enable_timing=True, external=True)
                ev.record()
        self._entered.append((self._k, full))
        return full

    def __enter__(self):
        if self._k == 0:
            self._entered = []
        self._mark(self._k)
        self._span = span(self.names[self._k])
        self._span.__enter__()
        _local.stages = self
        return self

    def __exit__(self, exc_type, *exc):
        _local.stages = None
        self._span.__exit__(exc_type, *exc)
        self._k += 1
        if exc_type is not None:
            self._k = 0
        elif self._k == len(self.names):
            self._mark(self._k)
            self._k = 0
            self._last_inner = self._entered
        return False

    def ms(self) -> dict:
        """``{stage: ms}`` of the last run (waits for its last event)."""
        if self._events is None:
            t = self._host
            return {name: (t[k + 1] - t[k]) / 1e6
                    for k, name in enumerate(self.names)}
        ev = self._events
        ev[-1].synchronize()
        return {name: ev[k].elapsed_time(ev[k + 1])
                for k, name in enumerate(self.names)}

    def inner_ms(self) -> dict:
        """``{stage: {inner stage: ms}}`` of the last run, each stage that
        held inner stages with them in the order it ran them (waits for
        its last event); empty where no op opened one."""
        got = self._last_inner
        if self._events is None:
            t, start = self._host, self._inner

            def ms(a, b):
                return (b - a) / 1e6
        else:
            self._events[-1].synchronize()
            t, start = self._events, self._inner

            def ms(a, b):
                return a.elapsed_time(b)
        out: dict = {}
        for j, (k, name) in enumerate(got):
            nxt = got[j + 1] if j + 1 < len(got) else None
            end = start[nxt[1]] if nxt and nxt[0] == k else t[k + 1]
            first = self.names[k] not in out
            out.setdefault(self.names[k], {})[name] = ms(
                t[k] if first else start[name], end)
        return out


def stage(stages: Stages | None):
    """The next stage of ``stages``; nothing for a call built with tracing
    off."""
    return _NULL if stages is None else stages


class _Inner:
    """An inner stage being entered (made only inside a timed stage)."""

    __slots__ = ("stages", "name", "_span")

    def __init__(self, stages: Stages, name: str):
        self.stages, self.name = stages, name

    def __enter__(self):
        self._span = span(self.stages._mark_inner(self.name))
        self._span.__enter__()
        return self

    def __exit__(self, *exc):
        return self._span.__exit__(*exc)


def inner(name: str):
    """The inner stage ``name`` of the stage running on this thread
    (``<i>.<Op>.<name>``, and while tracing is on its span); nothing
    outside a timed stage, so an op in a call built with tracing off
    records nothing."""
    stages = getattr(_local, "stages", None)
    return _NULL if stages is None else _Inner(stages, name)


def op_stages(ops, carried: bool) -> list:
    """The stage names of an op loop: ``<i>.<Op>.carry`` (``carried``: the
    block-parallel runner's ``shard_carry``) and ``<i>.<Op>.apply``."""
    names = []
    for i, op in enumerate(ops):
        name = f"{i}.{type(op).__name__}"
        if carried:
            names.append(name + ".carry")
        names.append(name + ".apply")
    return names


@contextlib.contextmanager
def profile(logdir, device="cuda") -> Iterator[torch.profiler.profile]:
    """Record a ``torch.profiler`` trace of the block, the card's kernels
    included (``device='cpu'``: the host only), with tracing on (the
    program's spans are its ``sdr.*`` ranges), and write it on exit as
    ``trace-<pid>-<ns>.json`` under ``logdir``.  Raises without a GPU
    unless ``device='cpu'``."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if resolve_device(device).type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    out = Path(logdir)
    out.mkdir(parents=True, exist_ok=True)
    prof = torch.profiler.profile(activities=acts)
    with prof, tracing():
        yield prof
    prof.export_chrome_trace(
        str(out / f"trace-{os.getpid()}-{time.time_ns()}.json"))


@contextlib.contextmanager
def timed(label: str, sink=print, device="cuda") -> Iterator[None]:
    """Report ``label: <seconds>s`` to ``sink`` after the block, waiting
    first for the work queued on ``device``.  Raises without a GPU unless
    ``device='cpu'``."""
    dev = resolve_device(device)
    t0 = time.perf_counter()
    try:
        yield
    finally:
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        sink(f"{label}: {time.perf_counter() - t0:.4f}s")
