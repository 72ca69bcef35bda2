"""Block-parallel processing of a recorded stream on one device
(counterpart of sdr_tpu/parallel/sharded.py:time_sharded_fn and
run_time_batched).

A recording ``[N]`` becomes a ``[B, N/B]`` batch of consecutive blocks.
Every op takes the state entering each row from the row before it
(``shard_carry``: halo shifts along the batch axis, parallel/halo.py) and
then runs once over the whole batch, so each kernel launch covers all B
blocks.  The output equals the streamed run sample for sample: the kernels'
per-output sums do not depend on how the outputs are batched.
"""

from __future__ import annotations

from typing import Sequence

from sdr_tpu_torch.stream.block import StreamOp
from sdr_tpu_torch.stream.pipeline import Pipeline, as_input
from sdr_tpu_torch.utils.device import resolve_device

__all__ = ["time_sharded_fn", "run_time_batched"]


def time_sharded_fn(ops: Sequence[StreamOp], initials=None,
                    return_carries: bool = False):
    """``fn(xb[B, n]) -> y[B, n_out]`` running the chain block-parallel.

    ``initials``: per-op carries entering row 0 (a previous segment's final
    state).  ``return_carries``: ``fn`` returns ``(carries, y)`` with each
    op's carry after every row, stacked on the [B] axis."""
    ops = list(ops)

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


def run_time_batched(ops: Sequence[StreamOp], x, nblocks: int,
                     carries=None, return_carries: bool = False,
                     device="cuda"):
    """Block-parallel processing of a recorded 1-D signal ``x[N]`` as
    ``nblocks`` blocks of ``N / nblocks``.

    ``carries`` (per-op state from a previous segment) and
    ``return_carries=True`` continue a stream exactly across segments;
    the returned carries are the state after the last block."""
    device = resolve_device(device)
    x = as_input(x, device)
    if x.ndim != 1:
        raise ValueError(f"run_time_batched takes a 1-D signal, got shape "
                         f"{tuple(x.shape)}")
    n = x.shape[-1]
    if n % nblocks:
        raise ValueError(f"signal length {n} not divisible by {nblocks}")
    Pipeline(ops, block_in=n // nblocks, device=device)
    xb = x.reshape(nblocks, n // nblocks)
    out = time_sharded_fn(ops, initials=carries,
                          return_carries=return_carries)(xb)
    if not return_carries:
        return out.reshape(-1)
    cb, yb = out
    return _last_row(cb), yb.reshape(-1)
