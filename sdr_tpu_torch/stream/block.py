"""Streaming block-operator protocol (counterpart of sdr_tpu/stream/block.py).

Every operator is a function

    apply(carry, x[..., n_in]) -> (carry', y[..., n_out])

with static block lengths and the carry a tuple of tensors (filter
history, demod last sample).  The carry holds the trailing history samples
and each block is processed as if it followed them (overlap-save), so
blockwise processing equals one-shot processing of the concatenated
stream, including the warmup: each FIR-family op starts from
``history_len`` neutral samples (zeros, or 0x80 bytes for u8 IQ).

Carry tensors are never views of one another or of an input block: an
op returns fresh tensors, so a caller may keep, save or reuse them.
"""

from __future__ import annotations

from typing import Any

import torch

__all__ = ["StreamOp"]


class StreamOp:
    """Base class for stream operators.

    Subclasses define ``out_len(n_in)`` (may raise on an incompatible
    block), ``out_dtype(in_dtype)``, ``init_carry(n_in, batch_shape,
    in_dtype)``, ``apply(carry, x)`` and ``shard_carry(xb, initial, group)``,
    and hold ``device``.  An op that emits or consumes a plane axis (the
    planar I/Q pair, the stereo L/R pair) says so in
    ``map_batch_shape``."""

    device: torch.device
    # False where no block-parallel form exists (the sequential Agc
    # without its approximate sweeps): runners refuse the op up front
    time_shardable: bool = True

    def out_tail(self) -> tuple:
        """The output's dims after its stream axis: ``()`` for sample
        streams and channel banks (``[..., C, n]``), ``(size,)`` for FFT
        frames (``[..., frames, size]``)."""
        return ()

    @property
    def time_axis_out(self) -> int:
        """The output's stream axis (negative): blocks join along it, and
        a block-parallel run merges its rows into it.  -1, or -2 for FFT
        frames."""
        return -1 - len(self.out_tail())

    def out_len(self, n_in: int) -> int:
        return n_in

    def out_dtype(self, in_dtype: torch.dtype) -> torch.dtype:
        """This op's output dtype given its input's: the ops after it
        make their carries in it (``Pipeline.init``), e.g. a complex64
        filter history after a complex convert."""
        return in_dtype

    def map_batch_shape(self, batch_shape: tuple) -> tuple:
        """Leading dims of this op's output given its input's: the ops
        after it shape their carries by them (``Pipeline.init``)."""
        return batch_shape

    def init_carry(self, n_in: int, batch_shape=(), in_dtype=None) -> Any:
        return ()

    def apply(self, carry, x):
        raise NotImplementedError

    def shard_carry(self, xb: torch.Tensor, initial=None, group=None):
        """Carries for block-parallel execution: ``xb[B, ..., n]`` holds B
        consecutive blocks of each stream of the leading dims; return the
        carry entering each row, stacked on a leading [B] axis (row 0 gets
        ``initial``, or the warmup carry when it is None).  With ``group``
        (a ``torch.distributed`` process group) the rows of each rank
        follow those of the ranks before it, row 0 of rank 0 being the
        stream's first: the op passes ``group`` to the halo helpers
        (parallel/halo.py), and every rank makes the same collectives."""
        if type(self).init_carry is StreamOp.init_carry:
            return ()
        raise NotImplementedError(
            f"{type(self).__name__} does not support block-parallel runs")

    def __repr__(self):
        return type(self).__name__
