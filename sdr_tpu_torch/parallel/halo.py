"""Halo primitives for block-parallel runs on one device (counterpart of
sdr_tpu/parallel/halo.py).

The JAX package fetches a shard's seam state from its left neighbour with
``ppermute``.  Here the "shards" are the rows of one ``[B, n]`` batch, so
the same exchange is a shift along the batch axis: no collective.  The
affine prefixes, which the JAX package builds from an ``all_gather`` and a
sequential scan, are an exclusive composition over the B rows ("all
shards to my left" is rows ``< b``), computed by doubling in ``log2(B)``
whole-batch steps: each op is a launch on the card, so a loop over the 32
rows would cost the host ~100 launches.
"""

from __future__ import annotations

import torch

__all__ = ["left_halo", "right_shift_scalar", "substitute_first",
           "exclusive_affine_prefix", "exclusive_matrix_affine_prefix"]


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


def right_shift_scalar(v: torch.Tensor) -> torch.Tensor:
    """``[B, ...]``: row b gets row b-1's value, row 0 zeros."""
    out = torch.zeros_like(v)
    out[1:] = v[:-1]
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


def _exclusive_scan(compose, identity, maps):
    """Exclusive prefix composition over the leading [B] axis of ``maps``
    (a tuple of tensors, one map per row), by doubling: ``log2(B)`` steps
    of whole-batch ops rather than B steps of row ops.  ``compose(later,
    earlier)`` composes two batches of maps; ``identity`` is one map."""
    cur = maps
    d = 1
    while d < cur[0].shape[0]:
        new = compose(tuple(t[d:] for t in cur), tuple(t[:-d] for t in cur))
        cur = tuple(torch.cat([t[:d], n]) for t, n in zip(cur, new))
        d *= 2
    # cur[b] composes rows 0..b; row b enters with rows 0..b-1
    return tuple(torch.cat([i.expand_as(t[:1]), t[:-1]])
                 for i, t in zip(identity, cur))


def exclusive_affine_prefix(a: torch.Tensor, b: torch.Tensor):
    """Exclusive prefix composition of the rows' affine maps
    ``y -> a*y + b`` (``a``, ``b`` ``[B, ...]``): ``(A, B)`` with row b the
    composition of the maps of rows ``< b`` (the identity for row 0), so
    the state entering row b is ``A[b] * y0 + B[b]``."""
    one = torch.ones((1,) + a.shape[1:], dtype=a.dtype, device=a.device)
    return _exclusive_scan(
        lambda late, early: (late[0] * early[0],
                             late[0] * early[1] + late[1]),
        (one, torch.zeros_like(one)), (a, b))


def exclusive_matrix_affine_prefix(M: torch.Tensor, v: torch.Tensor):
    """The order-p form of :func:`exclusive_affine_prefix`: the rows' maps
    ``s -> M @ s + v`` with ``M [B, ..., p, p]`` and ``v [B, ..., p]``.
    Returns ``(A, c)``, row b the composition of the maps of rows ``< b``
    (the identity for row 0): the state entering row b is
    ``A[b] @ s0 + c[b]``."""
    p = M.shape[-1]
    eye = torch.eye(p, dtype=M.dtype, device=M.device).expand(
        (1,) + M.shape[1:])
    return _exclusive_scan(
        lambda late, early: (late[0] @ early[0],
                             (late[0] @ early[1][..., None])[..., 0]
                             + late[1]),
        (eye, torch.zeros((1,) + v.shape[1:], dtype=v.dtype,
                          device=v.device)), (M, v))
