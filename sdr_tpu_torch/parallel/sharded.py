"""Block-parallel and sharded processing of a recorded stream (counterpart
of sdr_tpu/parallel/sharded.py).

A recording ``[*lead, N]`` (``lead`` the channels of a bank, or none)
becomes a ``[B, *lead, N/B]`` batch of consecutive blocks.  Every op takes
the state entering each row from the row before it (``shard_carry``: halo
shifts along the batch axis, parallel/halo.py) and then runs once over the
whole batch, so each kernel launch covers all B blocks.  The output equals
the streamed run sample for sample: the kernels' per-output sums do not
depend on how the outputs are batched.

Over several processes (``torch.distributed``, one rank a card):

* **time sharding** (:func:`run_time_sharded`): each rank holds a
  contiguous span of the stream and runs it as B rows of the same batch
  form; the rows of rank r follow those of every rank before it, so row 0
  of rank r takes its seam state from rank r-1's last row (one
  ``all_gather`` a halo) and the affine prefixes compose the whole maps of
  the ranks before it.  The sharded output equals the one-process
  block-parallel run's: bit for bit where the chain has no affine prefix,
  to f32 rounding where it does (the maps compose in another order).
* **channel sharding** (:func:`run_channel_sharded`): independent channels
  ``[..., C, N]`` split over the ranks, each run from warmup with no
  communication (the 64-channel bank, BASELINE config #5).
* **grid sharding** (:func:`run_grid_sharded`): both on a 2-D
  {channel, time} mesh, the halos on the time axis only.

Each runner returns the rank's own output; ``multihost.gather_time_sharded``
joins them on one rank for a sink.

:func:`compile_time_batched` is the call compiled: the dry run and the
chain's function built once, the call captured as a CUDA graph on its
input tensor and replayed (what ``jax.jit`` of ``run_time_batched`` is to
the JAX package's bench).  With a group the graph holds the runner's NCCL
gathers (utils/graphs.py), and :func:`compile_time_sharded`,
:func:`compile_grid_sharded` and :func:`compile_channel_sharded` are the
sharded runners compiled, the counterparts of the JAX package's
``jax.jit(lambda g: run_*_sharded(...))``: one compiled program a rank with
its collectives inside.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.distributed as dist

from sdr_tpu_torch.parallel.halo import (capturable, gather_ranks,
                                         group_backend, host_gather,
                                         on_every_rank)
from sdr_tpu_torch.stream.block import StreamOp
from sdr_tpu_torch.stream.pipeline import (Pipeline, StaticCarries,
                                           _clone_tree, _unflatten,
                                           as_input, as_tensor,
                                           flatten_carries)
from sdr_tpu_torch.utils import profiling
from sdr_tpu_torch.utils.device import resolve_device
from sdr_tpu_torch.utils.graphs import Captured, new_pool
from sdr_tpu_torch.utils.profiling import Stages, span, stage

__all__ = ["time_sharded_fn", "run_time_batched", "compile_time_batched",
           "CompiledBatched", "run_time_sharded",
           "run_channel_sharded", "run_grid_sharded", "compile_time_sharded",
           "compile_channel_sharded", "compile_grid_sharded"]

_MAX_DIMS = 8       # dims of a local input the shape check carries


def time_sharded_fn(ops: Sequence[StreamOp], initials=None,
                    return_carries: bool = False, group=None, stages=None):
    """``fn(xb[B, *lead, n]) -> y[B, *lead, ...per-block output]`` running
    the chain block-parallel.

    ``initials``: per-op carries entering the stream's first row (a
    previous segment's final state).  ``return_carries``: ``fn`` returns
    ``(carries, y)`` with each op's carry after every row, stacked on the
    [B] axis.  ``group``: the process group whose ranks hold consecutive
    batches of the stream (none: this batch is the whole stream).
    ``stages``: the call's :class:`~sdr_tpu_torch.utils.profiling.Stages`
    (:func:`batched_stages`), whose ``<i>.<Op>.carry`` and
    ``<i>.<Op>.apply`` stages ``fn`` runs, or None.

    Raises ``ValueError`` before running anything, so before any
    collective and on every rank, when an op has no block-parallel form
    (``time_shardable`` False)."""
    ops = list(ops)
    for i, op in enumerate(ops):
        if not op.time_shardable:
            raise ValueError(
                f"stage {i} ({op!r}) does not support time sharding "
                "(nonlinear carry). For Agc, construct it with "
                "approx_time_sharding=R to enable the documented "
                "approximate mode, or shard channels instead.")

    def fn(xb):
        new = []
        for i, op in enumerate(ops):
            with stage(stages):             # <i>.<Op>.carry
                carry = op.shard_carry(xb, None if initials is None
                                       else initials[i], group)
            with stage(stages):             # <i>.<Op>.apply
                c2, xb = op.apply(carry, xb)
            new.append(c2)
        return (new, xb) if return_carries else xb

    return fn


def batched_stages(ops, device) -> Stages | None:
    """The stages of a block-parallel call while tracing is on (else
    None): ``input`` (the rows' reshape and copy), each op's ``carry`` and
    ``apply``, ``output`` (the restack, and the carries' last row and
    write-back)."""
    if not profiling.enabled():
        return None
    return Stages(["input", *profiling.op_stages(ops, carried=True),
                   "output"], device)


def _last_row(tree):
    if isinstance(tree, (list, tuple)):
        return type(tree)(_last_row(t) for t in tree)
    return tree[-1].clone()


def _from_last_rank(tree, group):
    """Every leaf of ``tree`` as the group's last rank holds it, on every
    rank: one gather a leaf, none at world size 1."""
    if dist.get_world_size(group) == 1:
        return tree
    return _unflatten(tree, iter([gather_ranks(leaf, group)[-1]
                                  for leaf in flatten_carries(tree)]))


def _restack(yb, time_axis_out: int = -1):
    """``[B, *lead, ...per-block]`` -> ``[*lead, ...]`` with the block axis
    merged into the stream axis ``time_axis_out`` (negative, of the
    per-block output): the rows are consecutive blocks of each stream
    (``Pipeline._restack`` of the JAX package).  ``[B, *planes, n]`` ->
    ``[*planes, B*n]`` for sample streams, ``[B, frames, size]`` ->
    ``[B*frames, size]`` for FFT frames.  A flat reshape would interleave
    blocks with channels or frames.  A view where the block axis is
    already outermost, a copy otherwise."""
    t = yb.ndim + time_axis_out          # the stream axis in yb
    out = yb.movedim(0, t - 1)
    return out.reshape(out.shape[:t - 1] + (-1,) + out.shape[t + 1:])


def _require_equal_shapes(x: torch.Tensor, group) -> None:
    """Raise on every rank unless every rank of ``group`` holds an input
    of ``x``'s shape: the ranks' collectives move rows of equal shapes,
    and the closed-form seams (the resampler's phase, ``Mix``'s row
    phasors) assume equal spans.  One gather of the shapes (the rank
    count of dims and the first _MAX_DIMS), then every rank raises alike.

    Only ``x.shape`` is read.  The shapes travel as a host tensor over the
    group's CPU backend (gloo; ``init_distributed`` asks NCCL groups for
    ``'cpu:gloo,cuda:nccl'``), so the check never waits for the card.  A
    group with no CPU backend (NCCL alone) gathers them on ``x``'s device
    and reads them back, which waits for the card's queued work
    (:func:`host_gather`)."""
    dims = x.shape[:_MAX_DIMS]
    meta = torch.full((_MAX_DIMS + 1,), -1, dtype=torch.int64)
    meta[0] = x.ndim
    meta[1:len(dims) + 1] = torch.tensor(dims, dtype=torch.int64)
    shapes = host_gather(meta, group, x.device)
    if not bool((shapes == shapes[0]).all()):
        got = [tuple(s[1:min(s[0], _MAX_DIMS) + 1].tolist()) for s in shapes]
        raise ValueError(f"the ranks' local inputs differ in shape: {got}")
    if x.ndim > _MAX_DIMS:
        raise ValueError(f"a local input of {x.ndim} dims (at most "
                         f"{_MAX_DIMS})")


def run_time_batched(ops: Sequence[StreamOp], x, nblocks: int,
                     carries=None, return_carries: bool = False,
                     device="cuda", group=None):
    """Block-parallel processing of a recorded signal ``x[*lead, N]`` as
    ``nblocks`` blocks of ``N / nblocks`` of each stream.  The output is
    the streamed run's, joined along the last op's stream axis:
    ``[*lead, *planes, M]`` (``[2, M]`` for the stereo chain, ``[C, M]``
    for a channel bank), ``[*lead, frames, size]`` for FFT frames.

    ``carries`` (per-op state from a previous segment) and
    ``return_carries=True`` continue a stream exactly across segments;
    the returned carries are the state after the last block.

    ``group``: ``x`` is this rank's span of a stream whose spans the
    group's ranks hold in rank order, all of one shape (checked); the
    output is this rank's span of the whole run's, and ``carries`` enter
    the stream's first block (rank 0's row 0)."""
    device = resolve_device(device)
    stages = batched_stages(ops, device)
    fn = time_sharded_fn(ops, initials=carries,
                         return_carries=return_carries, group=group,
                         stages=stages)
    x = as_input(x, device)
    if group is not None:
        _require_equal_shapes(x, group)
    n, lead = x.shape[-1], x.shape[:-1]
    if n % nblocks:
        raise ValueError(f"signal length {n} not divisible by {nblocks}")
    t_axis = Pipeline(ops, block_in=n // nblocks, batch_shape=lead,
                      in_dtype=x.dtype, device=device).time_axis_out
    with stage(stages):                     # input
        # [B, *lead, n]: the kernels take contiguous rows (a copy only
        # when there are leading dims and more than one block)
        xb = x.reshape(lead + (nblocks, n // nblocks)).movedim(-2, 0)
        xb = xb.contiguous()
    out = fn(xb)
    with stage(stages):                     # output
        if not return_carries:
            return _restack(out, t_axis)
        cb, yb = out
        return _last_row(cb), _restack(yb, t_axis)


def _write_spans(x: torch.Tensor, parts) -> None:
    """Copy ``parts`` (tensors ``[*lead, k]``) into consecutive spans of
    ``x``'s last axis, which they fill."""
    pos = 0
    for part in parts:
        k = part.shape[-1]
        x[..., pos:pos + k].copy_(part)
        pos += k
    if pos != x.shape[-1]:
        raise ValueError(f"{pos} samples written into {x.shape[-1]}")


class CompiledBatched:
    """:func:`compile_time_batched`'s call: ``call(x=None, carries=None)``
    replays the block-parallel run of ``ops`` on :attr:`x`, the input it
    was captured on.  ``x`` (a tensor of that shape and dtype, or an
    array) is copied into it first, counted in ``input_copies``; with no
    argument the call runs on ``x``'s current contents.  Returns the
    output, and with ``return_carries`` the carries after the last block
    first.  The output is the graph's own tensor, as a donated buffer is:
    the next call overwrites it, so clone what must outlive it (a copy
    at every call would cost the card a pass over the output: 1.34 GB of
    the waterfall's frames).

    Made with ``carries``, the call holds one static buffer a carry leaf
    (:class:`StaticCarries`): the graph reads them as the stream state
    entering the first block, and with ``return_carries`` writes the
    state after the last block back into them, at its end, and returns
    them (donated: the next call continues from them; other carries
    passed as ``carries`` are copied in, counted in ``carry_copies``).
    Made without, the stream starts from its warm-up state at every call,
    and returned carries are fresh copies.

    Built while tracing is on (``profiling.tracing()``), the call times its
    stages inside the graph at every replay (:func:`batched_stages`), and
    :meth:`stage_ms` reads them (:meth:`inner_ms` the ops' inner
    stages).  While tracing is on, a call is the span ``call``, with
    ``call.copy_in`` (an input or carries copied in) and ``call.replay``
    inside it.

    Made with ``group``, the call is this rank's part of a sharded call
    (``run_time_batched(group=)``): the graph holds the group's gathers,
    ``carries`` enter the stream's first block (rank 0's row 0), and
    with ``return_carries`` each rank returns the state after its own last
    block, in fresh copies.  The static buffers then take the state after
    the stream's last block, the last rank's (one gather a leaf, in the
    graph), so the next call continues the stream on every rank: with no
    ``carries``, or with the carries the last call returned, which are
    not copied in.  A call is a collective: every rank of the group calls
    its compiled call, in the same order as its other collectives."""

    def __init__(self, ops, x: torch.Tensor, nblocks: int, carries,
                 return_carries: bool, device: torch.device, pool,
                 group=None):
        ops = list(ops)
        n, lead = x.shape[-1], x.shape[:-1]
        if n % nblocks:
            raise ValueError(f"signal length {n} not divisible by {nblocks}")
        self.x = x
        self.nblocks = nblocks
        self.pool = pool
        self.return_carries = bool(return_carries)
        self.input_copies = 0
        self.static = (None if carries is None
                       else StaticCarries(carries, device))
        self.grouped = group is not None
        self._returned = None       # the own rows the last call returned
        t_axis = Pipeline(ops, block_in=n // nblocks, batch_shape=lead,
                          in_dtype=x.dtype, device=device).time_axis_out
        self.stages = stages = batched_stages(ops, device)
        fn = time_sharded_fn(
            ops, initials=None if self.static is None else _unflatten(
                self.static.tree, iter(self.static.bufs)),
            return_carries=return_carries, group=group, stages=stages)
        static = self.static

        def call():
            with stage(stages):             # input
                xb = x.reshape(lead + (nblocks, n // nblocks)).movedim(-2, 0)
                xb = xb.contiguous()
            out = fn(xb)
            with stage(stages):             # output
                if not return_carries:
                    return _restack(out, t_axis), None
                cb, yb = out
                last = _last_row(cb)
                if static is None:
                    return _restack(yb, t_axis), last
                if group is None:
                    static.write(last)
                    return _restack(yb, t_axis), None
                static.write(_from_last_rank(last, group))
                return _restack(yb, t_axis), last

        def capture():
            return Captured(call, device, pool, mutated=(
                static.bufs if static is not None and return_carries
                else ()))

        # with a group, a rank whose capture raised makes every rank raise
        self.graph = (capture() if group is None
                      else on_every_rank(capture, group, device))

    @property
    def carry_copies(self) -> int:
        return 0 if self.static is None else self.static.copies

    def write(self, parts) -> None:
        """Copy ``parts`` into consecutive spans of :attr:`x` (a group's
        blocks), each counted in ``input_copies``."""
        _write_spans(self.x, [as_tensor(p) for p in parts])
        self.input_copies += len(parts)

    def stage_ms(self) -> dict | None:
        """``{stage: ms}`` of the last replay that finished (it waits for
        it): read after a call and before the next, which records into
        the same events.  None for a call built with tracing off."""
        return None if self.stages is None else self.stages.ms()

    def inner_ms(self) -> dict | None:
        """The ops' inner stages of the same replay, ``{stage: {inner
        stage: ms}}`` (``Stages.inner_ms``); None where :meth:`stage_ms`
        is None."""
        return None if self.stages is None else self.stages.inner_ms()

    def __call__(self, x=None, carries=None):
        if profiling.enabled():
            return self._traced(x, carries)
        if x is not None or carries is not None:
            self._copy_in(x, carries)
        y, last = self.graph.replay()
        return self._result(y, last) if self.return_carries else y

    def _traced(self, x, carries):
        """The call as the span ``call``, holding ``call.copy_in`` (where
        anything is copied in) and ``call.replay``."""
        with span("call"):
            if (x is not None and x is not self.x) or carries is not None:
                with span("call.copy_in"):
                    self._copy_in(x, carries)
            with span("call.replay"):
                out = self.graph.replay()
            return self._result(*out)

    def _copy_in(self, x, carries) -> None:
        """``x`` (unless it is :attr:`x`) and ``carries`` into the call's
        buffers."""
        if x is not None and x is not self.x:
            x = as_tensor(x)
            if tuple(x.shape) != tuple(self.x.shape) or \
                    x.dtype != self.x.dtype:
                raise ValueError(
                    f"input {x.dtype} {tuple(x.shape)}, the compiled call "
                    f"takes {self.x.dtype} {tuple(self.x.shape)}")
            self.x.copy_(x)
            self.input_copies += 1
        if carries is not None:
            if self.static is None:
                raise ValueError("carries given to a call compiled without "
                                 "them: compile with carries=")
            if not self._continues(carries):
                self.static.load(carries)

    def _result(self, y, last):
        if not self.return_carries:
            return y
        if self.static is None:
            return _clone_tree(last), y
        if not self.grouped:
            return self.static.result(), y
        self._returned = _clone_tree(last)
        return self._returned, y

    def _continues(self, carries) -> bool:
        """Whether ``carries`` are, leaf for leaf, the own rows the last
        call of a group's call returned: the static buffers already hold
        the stream's state after that call."""
        if self._returned is None:
            return False
        leaves, mine = flatten_carries(carries), flatten_carries(
            self._returned)
        return len(leaves) == len(mine) and all(
            a is b for a, b in zip(leaves, mine))


def compile_time_batched(ops: Sequence[StreamOp], x, nblocks: int,
                         carries=None, return_carries: bool = False,
                         device="cuda", group=None) -> CompiledBatched:
    """:func:`run_time_batched` compiled (its ``jax.jit`` in the JAX
    package's bench): the Pipeline dry run and the chain's function are
    built once, then the call is captured as a CUDA graph on ``x``
    itself (a tensor on ``device``; an array or a tensor elsewhere is
    copied there first) and replayed by the returned
    :class:`CompiledBatched`, whose output is bitwise the eager call's on
    the same input and carries, in a tensor the next call overwrites, its
    graph in a memory pool of its own.  On the CPU the call keeps the
    function and runs it again on the same buffers.

    ``group``: ``run_time_batched(group=)`` compiled, this rank's part of
    a sharded call whose graph holds the group's NCCL gathers.  Every rank
    of the group compiles the same chain at the same shape and then calls
    its compiled call in step with the others.  Before any collective, and
    so on every rank alike, it raises ``ValueError`` on the card for a
    group whose CUDA collectives cannot be captured (gloo, which goes
    through the host: ``init_distributed`` asks for
    ``'cpu:gloo,cuda:nccl'``).  The ranks' input shapes are checked once,
    here, outside the capture (a replay gathers no shape).  A capture
    that fails on any rank raises on every rank; nothing falls back to an
    eager run."""
    if group is not None and not capturable(group, device):
        raise ValueError(
            f"a compiled sharded call on the card captures the group's "
            f"collectives, which needs NCCL for CUDA tensors; this group "
            f"runs {group_backend(group, 'cuda')!r} for them: make it with "
            f"the backend 'cpu:gloo,cuda:nccl' (init_distributed())")
    device = resolve_device(device)
    x = as_input(x, device)
    if group is not None:
        _require_equal_shapes(x, group)
    return CompiledBatched(ops, x, nblocks, carries, return_carries, device,
                           new_pool(device), group)


def run_time_sharded(ops: Sequence[StreamOp], mesh, x_local,
                     axis_name: str = "t", nblocks: int = 1,
                     device="cuda"):
    """Process a stream time-sharded over the ranks of ``mesh``'s
    ``axis_name`` (a ``DeviceMesh``, parallel/mesh.py): ``x_local[*lead,
    N/world]`` is this rank's contiguous span, run as ``nblocks``
    block-parallel rows after the rows of the ranks before it.  Every
    rank's span has the same shape, and each block satisfies the chain's
    divisibility (the Pipeline dry run on the local block length checks
    it, as the JAX package's does).  Returns this rank's output span."""
    return run_time_batched(ops, x_local, nblocks, device=device,
                            group=mesh.get_group(axis_name))


def run_channel_sharded(ops: Sequence[StreamOp], mesh, x_local,
                        axis_name: str = "c", device="cuda"):
    """Process this rank's channels ``x_local[..., C/world, N]`` of a bank
    channel-sharded over ``mesh``'s ``axis_name``: pure data parallelism,
    every channel from warmup as one block, no communication.  To continue
    a stream across segments, run :func:`run_time_batched` per channel
    group with ``carries`` instead."""
    mesh.get_group(axis_name)           # the axis must exist
    return run_time_batched(ops, x_local, 1, device=device)


def run_grid_sharded(ops: Sequence[StreamOp], mesh, x_local,
                     channel_axis: str = "c", time_axis: str = "t",
                     nblocks: int = 1, device="cuda"):
    """2-D sharding: this rank's ``x_local[..., C/n_c, N/n_t]``, channels
    over ``channel_axis`` and time over ``time_axis``, the halos exchanged
    within the time axis's group only."""
    mesh.get_group(channel_axis)        # the axis must exist
    return run_time_sharded(ops, mesh, x_local, time_axis, nblocks, device)


def compile_time_sharded(ops: Sequence[StreamOp], mesh, x_local,
                         axis_name: str = "t", nblocks: int = 1,
                         carries=None, return_carries: bool = False,
                         device="cuda") -> CompiledBatched:
    """:func:`run_time_sharded` compiled (``jax.jit`` of the JAX package's
    runner): :func:`compile_time_batched` of this rank's span ``x_local``
    over the group of ``mesh``'s ``axis_name``.  Each call returns this
    rank's output span, bitwise the eager runner's on the same input, in
    the graph's own tensor, which the next call overwrites.  Every rank
    of the axis compiles and calls it together."""
    return compile_time_batched(ops, x_local, nblocks, carries=carries,
                                return_carries=return_carries, device=device,
                                group=mesh.get_group(axis_name))


def compile_channel_sharded(ops: Sequence[StreamOp], mesh, x_local,
                            axis_name: str = "c",
                            device="cuda") -> CompiledBatched:
    """:func:`run_channel_sharded` compiled: this rank's channels as one
    block from warmup, no collective, so any group will do."""
    mesh.get_group(axis_name)           # the axis must exist
    return compile_time_batched(ops, x_local, 1, device=device)


def compile_grid_sharded(ops: Sequence[StreamOp], mesh, x_local,
                         channel_axis: str = "c", time_axis: str = "t",
                         nblocks: int = 1, device="cuda") -> CompiledBatched:
    """:func:`run_grid_sharded` compiled: the halos gathered within the
    time axis's group only."""
    mesh.get_group(channel_axis)        # the axis must exist
    return compile_time_sharded(ops, mesh, x_local, time_axis, nblocks,
                                device=device)
