"""Block-parallel processing of a recorded stream on one device
(counterpart of sdr_tpu/parallel/sharded.py:time_sharded_fn and
run_time_batched).

A recording ``[*lead, N]`` (``lead`` the channels of a bank, or none)
becomes a ``[B, *lead, N/B]`` batch of consecutive blocks.  Every op takes
the state entering each row from the row before it (``shard_carry``: halo
shifts along the batch axis, parallel/halo.py) and then runs once over the
whole batch, so each kernel launch covers all B blocks.  The output equals
the streamed run sample for sample: the kernels' per-output sums do not
depend on how the outputs are batched.
"""

from __future__ import annotations

from typing import Sequence

from sdr_tpu_torch.stream.block import StreamOp
from sdr_tpu_torch.stream.pipeline import Pipeline, as_input
from sdr_tpu_torch.utils.device import resolve_device

__all__ = ["time_sharded_fn", "run_time_batched"]


def time_sharded_fn(ops: Sequence[StreamOp], initials=None,
                    return_carries: bool = False):
    """``fn(xb[B, *lead, n]) -> y[B, *lead, ...per-block output]`` running
    the chain block-parallel.

    ``initials``: per-op carries entering row 0 (a previous segment's final
    state).  ``return_carries``: ``fn`` returns ``(carries, y)`` with each
    op's carry after every row, stacked on the [B] axis.

    Raises ``ValueError`` before running anything when an op has no
    block-parallel form (``time_shardable`` False)."""
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
            carry = op.shard_carry(xb, None if initials is None
                                   else initials[i])
            c2, xb = op.apply(carry, xb)
            new.append(c2)
        return (new, xb) if return_carries else xb

    return fn


def _last_row(tree):
    if isinstance(tree, (list, tuple)):
        return type(tree)(_last_row(t) for t in tree)
    return tree[-1].clone()


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


def run_time_batched(ops: Sequence[StreamOp], x, nblocks: int,
                     carries=None, return_carries: bool = False,
                     device="cuda"):
    """Block-parallel processing of a recorded signal ``x[*lead, N]`` as
    ``nblocks`` blocks of ``N / nblocks`` of each stream.  The output is
    the streamed run's, joined along the last op's stream axis:
    ``[*lead, *planes, M]`` (``[2, M]`` for the stereo chain, ``[C, M]``
    for a channel bank), ``[*lead, frames, size]`` for FFT frames.

    ``carries`` (per-op state from a previous segment) and
    ``return_carries=True`` continue a stream exactly across segments;
    the returned carries are the state after the last block."""
    fn = time_sharded_fn(ops, initials=carries,
                         return_carries=return_carries)
    device = resolve_device(device)
    x = as_input(x, device)
    n, lead = x.shape[-1], x.shape[:-1]
    if n % nblocks:
        raise ValueError(f"signal length {n} not divisible by {nblocks}")
    t_axis = Pipeline(ops, block_in=n // nblocks, batch_shape=lead,
                      in_dtype=x.dtype, device=device).time_axis_out
    # [B, *lead, n]: the kernels take contiguous rows (a copy only when
    # there are leading dims and more than one block)
    xb = x.reshape(lead + (nblocks, n // nblocks)).movedim(-2, 0)
    out = fn(xb.contiguous())
    if not return_carries:
        return _restack(out, t_axis)
    cb, yb = out
    return _last_row(cb), _restack(yb, t_axis)
