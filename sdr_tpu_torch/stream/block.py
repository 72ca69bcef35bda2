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
    block), ``init_carry(n_in, batch_shape)``, ``apply(carry, x)`` and
    ``shard_carry(xb, initial)``, and hold ``device``."""

    device: torch.device

    def out_len(self, n_in: int) -> int:
        return n_in

    def init_carry(self, n_in: int, batch_shape=()) -> Any:
        return ()

    def apply(self, carry, x):
        raise NotImplementedError

    def shard_carry(self, xb: torch.Tensor, initial=None):
        """Carries for block-parallel execution: ``xb[B, n]`` holds B
        consecutive blocks of one stream; return the carry entering each
        row, stacked on a leading [B] axis (row 0 gets ``initial``, or
        the warmup carry when it is None)."""
        if type(self).init_carry is StreamOp.init_carry:
            return ()
        raise NotImplementedError(
            f"{type(self).__name__} does not support block-parallel runs")

    def __repr__(self):
        return type(self).__name__
