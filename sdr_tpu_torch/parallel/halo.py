"""Halo primitives for block-parallel runs (counterpart of
sdr_tpu/parallel/halo.py).

The JAX package fetches a shard's seam state from its left neighbour with
``ppermute``.  Here the "shards" are the rows of a ``[B, n]`` batch, so
the same exchange is a shift along the batch axis.  The affine prefixes,
which the JAX package builds from an ``all_gather`` and a sequential scan,
are an exclusive composition over the B rows ("all shards to my left" is
rows ``< b``), computed by doubling (``log2(B)`` levels) in one launch of
K15 (kernels/affine_prefix.py), with the state entering each row
(:func:`entering_state`) in the same launch.

``group`` (a ``torch.distributed`` process group, e.g. a ``DeviceMesh``
axis) spreads one stream's rows over its ranks: the rows of rank r follow
every row of the ranks before it.  Row 0 of rank r > 0 then takes its
halo from rank r-1's last row, and the prefixes compose the whole maps of
the ranks before r ahead of the local ones (a K15 launch for the rank's
whole map, the gather, a K15 launch for the prefixes).  Every exchange is one
gather of every rank's message (:func:`gather_ranks`), which serves world
size 1, gloo and NCCL alike (a send to one's own rank is refused).  The
messages are small (a halo row, a few scalars a map) and travel on the
group's device: CUDA tensors for NCCL, into one buffer that a CUDA graph
captures (:func:`capturable`), host tensors for gloo; the data and the
kernels stay where they are.

Every rank of a group must make the same calls in the same order: a
collective that some ranks skip hangs the group.  ``group=None`` is the
single-process form, bit for bit the same as before groups existed.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from sdr_tpu_torch.kernels import affine_prefix

__all__ = ["left_halo", "right_shift_scalar", "substitute_first",
           "exclusive_affine_prefix", "exclusive_matrix_affine_prefix",
           "entering_state", "first_row", "gather_ranks", "group_backend",
           "capturable", "host_gather", "on_every_rank"]


def group_rank(group=None) -> int:
    """This process's rank in ``group`` (0 without a group)."""
    return 0 if group is None else dist.get_rank(group)


def first_row(rows: int, group=None) -> int:
    """The stream index of this rank's row 0 when every rank of ``group``
    holds ``rows`` consecutive rows: ``rank * rows``."""
    return group_rank(group) * rows


def group_backend(group, device_type: str):
    """The backend ``group`` runs for tensors of ``device_type`` ('nccl',
    'gloo'), from its configuration (``'cpu:gloo,cuda:nccl'``); None when
    it has none for that device."""
    for item in dist.get_backend_config(group).split(","):
        dev, _, name = item.partition(":")
        if dev == device_type:
            return name
    return None


def gather_ranks(t: torch.Tensor, group) -> torch.Tensor:
    """``[world, *t.shape]``: every rank's ``t`` in rank order, on
    ``t``'s device.  Where the group runs NCCL for ``t``'s device the
    ranks' messages land in one buffer (``all_gather_into_tensor``: one
    NCCL launch, no copy), which a CUDA graph can capture; otherwise
    (gloo) each message goes through the host, which a graph cannot."""
    world = dist.get_world_size(group)
    if group_backend(group, t.device.type) == "nccl":
        out = t.new_empty((world,) + tuple(t.shape))
        dist.all_gather_into_tensor(out, t.contiguous(), group=group)
        return out
    wire = t.contiguous().cpu()
    out = [torch.empty_like(wire) for _ in range(world)]
    dist.all_gather(out, wire, group=group)
    return torch.stack(out).to(t.device)


def capturable(group, device) -> bool:
    """Whether ``group``'s collectives on ``device`` can run inside a CUDA
    graph: on the card only where the group runs NCCL for CUDA tensors
    (gloo sends every message through the host); on the CPU always, since
    there is no graph there."""
    return (torch.device(device).type != "cuda"
            or group_backend(group, "cuda") == "nccl")


def host_gather(t: torch.Tensor, group, device) -> torch.Tensor:
    """``[world, *t.shape]`` on the host: every rank's small host tensor
    ``t``, gathered over the group's CPU backend (gloo), so the gather
    never waits for the card; a group with no CPU backend (NCCL alone)
    gathers it on ``device`` and reads it back, which waits for the card's
    queued work (never call it inside a capture)."""
    if group_backend(group, "cpu") is None:
        t = t.to(device)
    return gather_ranks(t, group).cpu()


def on_every_rank(fn, group, device):
    """``fn()`` on this rank, then one :func:`host_gather` of whether it
    raised: where it raised on any rank of ``group`` it raises on every
    rank (the rank's own error, or a ``RuntimeError`` naming the ranks
    where it raised), so no rank goes on to a collective that a peer will
    never make.  Every rank must make the same collectives inside ``fn``
    (H14): a rank that raises before one of them leaves its peers waiting
    there.  Returns ``fn()``'s result."""
    try:
        out, err = fn(), None
    except Exception as e:  # noqa: BLE001 - raised again below, on every rank
        out, err = None, e
    raised = host_gather(torch.tensor([err is not None]), group, device)
    failed = [r for r, bad in enumerate(raised[:, 0].tolist()) if bad]
    if err is not None:
        raise err
    if failed:
        raise RuntimeError(f"ranks {failed} of the group failed where this "
                           f"rank succeeded: every rank raises")
    return out


def _from_left(last: torch.Tensor, group):
    """Rank r-1's ``last`` row, which row 0 of rank r receives; None on
    rank 0, and everywhere without a group or at world size 1, where no
    collective runs (as the JAX package's ``_rotate_right``): row 0 then
    keeps the stream's warmup value."""
    if group is None or dist.get_world_size(group) == 1:
        return None
    got = gather_ranks(last, group)
    r = dist.get_rank(group)
    return got[r - 1] if r > 0 else None


def left_halo(xb: torch.Tensor, h: int, fill=0, group=None) -> torch.Tensor:
    """``[B, ..., h]``: row b gets the last ``h`` samples of row b-1; row 0
    gets ``fill`` (the stream's warmup value), or with ``group`` the last
    row of the rank before (``fill`` on rank 0).  A new tensor."""
    n = xb.shape[-1]
    if not 0 <= h <= n:
        raise ValueError(f"halo of {h} samples from blocks of {n}")
    out = torch.empty(xb.shape[:-1] + (h,), dtype=xb.dtype, device=xb.device)
    # h is the same on every rank: all gather or none
    left = _from_left(xb[-1, ..., n - h:], group) if h else None
    out[0] = fill if left is None else left
    out[1:] = xb[:-1, ..., n - h:]
    return out


def right_shift_scalar(v: torch.Tensor, group=None) -> torch.Tensor:
    """``[B, ...]``: row b gets row b-1's value, row 0 zeros (or with
    ``group`` the last row of the rank before; zeros on rank 0).  (Row 0
    is not set from a Python number: on a one-dim tensor on the card that
    assignment waits for the card.)"""
    out = torch.zeros_like(v)
    left = _from_left(v[-1], group)
    if left is not None:
        out[0] = left
    out[1:] = v[:-1]
    return out


def substitute_first(value, initial, group=None):
    """Replace, in place, row 0 of each tensor in ``value`` (a tensor or
    tuple of fresh tensors stacked on a leading [B] axis) with the
    matching tensor of ``initial``: the stream state entering a segmented
    run.  With ``group`` only rank 0 holds the stream's first row, so only
    it substitutes.  Returns ``value``."""
    if initial is None or group_rank(group) != 0:
        return value
    if isinstance(value, tuple):
        return tuple(substitute_first(v, i) for v, i in zip(value, initial))
    value[0] = torch.as_tensor(initial, dtype=value.dtype,
                               device=value.device)
    return value


def _ranks_before(m: torch.Tensor, v: torch.Tensor, group):
    """The whole maps of the ranks before this one, in rank order (K15's
    ``pre``), or None without a group.  Each rank's inclusive total (one
    K15 launch) is gathered, at every world size, 1 included: first its
    ``m``, then its ``v``, so every rank makes the same collectives in the
    same order (H14)."""
    if group is None:
        return None
    tm, tv = affine_prefix.inclusive_total(m, v)
    gm, gv = gather_ranks(tm[None], group), gather_ranks(tv[None], group)
    r = dist.get_rank(group)
    return gm[:r, 0], gv[:r, 0]


def exclusive_affine_prefix(a: torch.Tensor, b: torch.Tensor, group=None):
    """Exclusive prefix composition of the rows' affine maps
    ``y -> a*y + b`` (``a``, ``b`` ``[B, ...]``): ``(A, B)`` with row b the
    composition of the maps of rows ``< b`` (the identity for row 0), so
    the state entering row b is ``A[b] * y0 + B[b]``.  With ``group`` the
    rows of the ranks before this one come first.  One K15 launch (two
    with a group) on the card."""
    return affine_prefix.exclusive_prefix(a, b, _ranks_before(a, b, group))


def exclusive_matrix_affine_prefix(M: torch.Tensor, v: torch.Tensor,
                                   group=None):
    """The order-p form of :func:`exclusive_affine_prefix`: the rows' maps
    ``s -> M @ s + v`` with ``M [B, ..., p, p]`` and ``v [B, ..., p]``.
    Returns ``(A, c)``, row b the composition of the maps of rows ``< b``
    (the identity for row 0): the state entering row b is
    ``A[b] @ s0 + c[b]``.  With ``group`` the rows of the ranks before
    this one come first.  A map the same on every row may come expanded
    (a row stride of 0): K15 reads it in place."""
    return affine_prefix.exclusive_prefix(M, v, _ranks_before(M, v, group))


def entering_state(m: torch.Tensor, v: torch.Tensor, s0, group=None):
    """The state entering each row of a block-parallel run from ``s0``,
    the state before the stream's first row (a tensor, or a number): in
    the scalar form (``m``, ``v`` ``[B, ...]``) ``A * s0 + B``, in the
    matrix form (``[B, ..., p, p]``, ``[B, ..., p]``) ``c + A @ s0``, of
    the prefixes of :func:`exclusive_affine_prefix` (with ``group`` the
    ranks before this one first), in one K15 launch (two with a
    group)."""
    return affine_prefix.entering_state(m, v, s0,
                                        _ranks_before(m, v, group))
