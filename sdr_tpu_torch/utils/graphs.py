"""Compiled calls: a function of static tensors captured once as a CUDA
graph and replayed (the counterpart of what ``jax.jit`` gives the JAX
package: a compiled executable, run again on new contents of its
buffers).

:class:`Captured` takes a function of no arguments that reads and writes
tensors it holds (its static inputs and carries) and returns its outputs.
On the card it runs the function ``WARMUP`` times on a side stream, so
that every lazy cache a launch reads is filled (the kernels' tap words,
period tables, twiddles and power tables, ``Mix``'s oscillator tables, the
launch paths' occupancy answers and shared-memory attributes), restores
the tensors the function writes, and captures one more run under
``torch.cuda.graph`` into ``pool``.  :meth:`Captured.replay` launches the
graph on the caller's current stream; the outputs are the same tensors
every time, overwritten by each replay.

What capture must respect (ROADMAP H10):

* anything the function waits on the host for (``.item()``, a read back,
  a host-to-device copy from pageable memory) fails the capture, which
  raises; nothing runs eagerly in its place;
* every tensor the function allocates comes from the graph's pool, so a
  launch's scratch and a kernel's ticket counters (zeroed by
  ``cudaMemsetAsync`` on the stream) are replayed in place;
* a cached tensor the graph reads must outlive it: each cache hands its
  tensors to :func:`keep`, which holds them for the graph being made;
* no graph may be destroyed during a capture, so the cyclic garbage
  collector is off while one runs;
* Python values are frozen at capture, so the function must read every
  value that changes from call to call from a tensor;
* ``Kernel.launches`` counts Python calls, so a replay counts nothing:
  launch checks run on eager calls.

A function that holds a process group's collectives (a sharded call,
parallel/sharded.py) is captured the same way, with three more rules
(ROADMAP H25):

* every rank of the group warms up and captures the same function, so its
  collectives run in the same order on every rank (H14); the warm-up's
  first collective creates the NCCL communicator, which must exist before
  the capture;
* after the capture the ranks agree that each captured (the caller makes
  the ``Captured`` under ``parallel.halo.on_every_rank``, one small gather
  over the group's CPU backend): where a rank's warm-up or capture raised,
  every rank raises, and no rank waits at its first replay for a peer
  that never replays;
* the capture runs in ``torch.cuda.graph``'s default mode, "global",
  as every other: the NCCL watchdog thread, which polls the events of the
  warm-up's collectives while the capture runs, does not invalidate it
  (``chip_smoke.py`` phase 11 holds a capture of a gather open on the
  host and replays it).

A replay of such a graph is a collective: every rank of the group replays
its graph, in the same order as its other collectives.

The making of a ``Captured`` is the set-up span ``capture`` (its
warm-up runs ``capture.warmup``, the capture itself ``capture.graph``),
counted in ``profiling.totals()``.

On the CPU, asked for explicitly (``device='cpu'``), there is no graph:
:class:`Captured` keeps the function and each replay runs it again on the
same static buffers, so the CPU tests exercise the buffer handling the
card runs (inputs copied in, carries written back, outputs handed out).
"""

from __future__ import annotations

import gc

import torch

from sdr_tpu_torch.utils import profiling

__all__ = ["Captured", "keep", "new_pool", "pool_bytes", "write_back",
           "WARMUP"]

WARMUP = 2          # runs on a side stream before the capture

# graphs captured (and CPU forms made) and replays, since import: a live
# stream that was primed replays only
captures = 0
replays = 0

_KEEP: list | None = None


def keep(t: torch.Tensor) -> torch.Tensor:
    """``t``, held alive by the graph being captured, if any.  Every cache
    of device tensors that a launch reads returns through it: an evicted
    entry is then still the memory a graph reads."""
    if _KEEP is not None:
        _KEEP.append(t)
    return t


def new_pool(device: torch.device):
    """A private memory pool for the graphs of one pipeline (None on the
    CPU)."""
    return torch.cuda.graph_pool_handle() if device.type == "cuda" else None


def pool_bytes(pool) -> int:
    """Device bytes the caching allocator holds for ``pool`` (its
    segments' total size, from ``torch.cuda.memory_snapshot``)."""
    if pool is None:
        return 0
    return sum(s["total_size"] for s in torch.cuda.memory_snapshot()
               if tuple(s.get("segment_pool_id", ())) == tuple(pool))


def _storage(t: torch.Tensor) -> int:
    return t.untyped_storage().data_ptr() if t.numel() else 0


def write_back(bufs, leaves) -> None:
    """Copy each new carry leaf into its static buffer.  A leaf that
    shares memory with any buffer (a view of one) goes through a
    temporary first, so no copy reads what another has written."""
    if len(leaves) != len(bufs):
        raise ValueError(f"{len(leaves)} carry leaves, {len(bufs)} buffers")
    held = {_storage(b) for b in bufs} - {0}
    staged = []
    for b, leaf in zip(bufs, leaves):
        if tuple(leaf.shape) != tuple(b.shape):
            raise ValueError(f"a carry leaf changed shape in the step: "
                             f"{tuple(b.shape)} -> {tuple(leaf.shape)}")
        if leaf is b:
            continue
        staged.append((b, leaf.clone() if _storage(leaf) in held else leaf))
    for b, leaf in staged:
        b.copy_(leaf)


class Captured:
    """``fn()`` compiled once and replayed (see the module docstring).

    ``mutated``: the tensors ``fn`` writes in place (the carries it writes
    back); the warm-up runs restore them, so the first replay starts
    from their contents at construction.  ``pool``: the graph's memory
    pool (:func:`new_pool`), shared by one pipeline's shapes."""

    def __init__(self, fn, device: torch.device, pool=None, mutated=()):
        global captures
        self.fn = fn
        self.device = torch.device(device)
        self.graph = None
        self.outputs = None
        self._kept = []
        with profiling.setup("capture"):
            if self.device.type == "cuda":
                self._capture(pool, list(mutated))
        captures += 1

    def _capture(self, pool, mutated) -> None:
        global _KEEP
        kept = _KEEP = []
        try:
            saved = [t.clone() for t in mutated]
            current = torch.cuda.current_stream(self.device)
            side = torch.cuda.Stream(self.device)
            side.wait_stream(current)
            with profiling.setup("capture.warmup"), torch.cuda.stream(side):
                for _ in range(WARMUP):
                    self.fn()
                for t, s in zip(mutated, saved):
                    t.copy_(s)
            current.wait_stream(side)
            graph = torch.cuda.CUDAGraph()
            # a graph that the cyclic collector frees during a capture
            # resets itself, which invalidates the capture: the collector
            # waits until the capture ends
            collecting = gc.isenabled()
            gc.disable()
            try:
                with profiling.setup("capture.graph"), \
                        torch.cuda.graph(graph, pool=pool):
                    self.outputs = self.fn()
            finally:
                if collecting:
                    gc.enable()
        finally:
            _KEEP = None
        self.graph = graph
        self._kept = kept

    def replay(self):
        """Run the compiled call; returns its outputs (the same tensors at
        every replay)."""
        global replays
        if self.graph is None:
            self.outputs = self.fn()
        else:
            self.graph.replay()
        replays += 1
        return self.outputs
