"""Halo primitives for block-parallel runs on one device (counterpart of
sdr_tpu/parallel/halo.py).

The JAX package fetches a shard's seam state from its left neighbour with
``ppermute``.  Here the "shards" are the rows of one ``[B, n]`` batch, so
the same exchange is a shift along the batch axis: no collective.
"""

from __future__ import annotations

import torch

__all__ = ["left_halo", "substitute_first"]


def left_halo(xb: torch.Tensor, h: int, fill=0) -> torch.Tensor:
    """``[B, ..., h]``: row b gets the last ``h`` samples of row b-1; row 0
    gets ``fill`` (the stream's warmup value).  A new tensor."""
    n = xb.shape[-1]
    if not 0 <= h <= n:
        raise ValueError(f"halo of {h} samples from blocks of {n}")
    out = torch.empty(xb.shape[:-1] + (h,), dtype=xb.dtype, device=xb.device)
    out[0] = fill
    out[1:] = xb[:-1, ..., n - h:]
    return out


def substitute_first(value, initial):
    """Replace, in place, row 0 of each tensor in ``value`` (a tensor or
    tuple of fresh tensors stacked on a leading [B] axis) with the
    matching tensor of ``initial``: the stream state entering a segmented
    run.  Returns ``value``."""
    if initial is None:
        return value
    if isinstance(value, tuple):
        return tuple(substitute_first(v, i) for v, i in zip(value, initial))
    value[0] = torch.as_tensor(initial, dtype=value.dtype,
                               device=value.device)
    return value
