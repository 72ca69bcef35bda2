"""Multi-process execution support (counterpart of
sdr_tpu/parallel/multihost.py).

One process a card, started by ``torchrun`` (or by hand with explicit
arguments).  Each process ingests only the time span its rank owns
(``local_time_span``, ``host_block_iterator``), runs it with the sharded
runners (parallel/sharded.py), whose halos and prefixes travel over the
process group, and ``gather_time_sharded`` joins the ranks' outputs on one
rank for a sink: the JAX package's global array, assembled with
``make_array_from_process_local_data``, has no counterpart, since each
rank's tensor is its own.

One process needs none of this: ``init_distributed`` is then a no-op and
the one-process runners (``run_time_batched``) run the whole stream.
"""

from __future__ import annotations

import os
from typing import Iterator, Optional

import numpy as np
import torch
import torch.distributed as dist

from sdr_tpu_torch.parallel.halo import gather_ranks
from sdr_tpu_torch.stream.pipeline import as_input
from sdr_tpu_torch.utils.device import resolve_device

__all__ = ["init_distributed", "local_time_span", "global_time_sharded",
           "gather_time_sharded", "host_block_iterator"]


def init_distributed(backend: str = "nccl", init_method: Optional[str] = None,
                     world_size: Optional[int] = None,
                     rank: Optional[int] = None) -> None:
    """Join the process group (a no-op for one process, or when the group
    exists).  With no arguments it reads ``torchrun``'s environment
    (``WORLD_SIZE``, ``RANK``, and ``MASTER_ADDR``/``MASTER_PORT`` through
    the ``env://`` method); pass them for a manual bring-up, e.g.
    ``init_method='tcp://localhost:29500'`` or ``'file:///tmp/store'``.
    ``backend``: 'nccl' (the default: CUDA tensors between cards) or
    'gloo' (host tensors).  'nccl' asks for ``'cpu:gloo,cuda:nccl'``: the
    same NCCL for CUDA tensors, and gloo beside it for the host tensors
    of the runners' shape check, which then never waits for the card;
    every subgroup (a mesh's axes) inherits both."""
    if dist.is_initialized():
        return
    if world_size is None:
        world_size = int(os.environ.get("WORLD_SIZE", "1"))
    if world_size <= 1:
        return
    if rank is None:
        rank = int(os.environ["RANK"])
    if backend == "nccl":
        backend = "cpu:gloo,cuda:nccl"
    dist.init_process_group(backend, init_method=init_method or "env://",
                            world_size=world_size, rank=rank)


def local_time_span(mesh, n_global: int, axis: str = "t"):
    """``(offset, length)`` of the time span this rank ingests of a
    ``[..., n_global]`` stream sharded over ``mesh``'s ``axis``: a file
    reader seeks to ``offset`` items and reads ``length``.  ``(0, 0)`` on
    a rank outside the mesh."""
    if mesh.get_coordinate() is None:
        return 0, 0
    n_shards = mesh[axis].size()
    if n_global % n_shards:
        raise ValueError(f"global length {n_global} not divisible by "
                         f"{n_shards} time shards")
    chunk = n_global // n_shards
    return mesh.get_local_rank(axis) * chunk, chunk


def global_time_sharded(local, mesh, n_global: int, axis: str = "t",
                        device="cuda") -> torch.Tensor:
    """This rank's span ``local[..., n_global / shards]`` as a tensor on
    ``device``, after checking its length: the input of
    ``run_time_sharded``.  (The JAX function assembles a global array;
    here each rank keeps its own, and ``gather_time_sharded`` joins the
    outputs.)"""
    _, length = local_time_span(mesh, n_global, axis)
    if local.shape[-1] != length:
        raise ValueError(f"local span of {local.shape[-1]} items, this "
                         f"rank owns {length} of {n_global}")
    return as_input(local, resolve_device(device))


def gather_time_sharded(y_local: torch.Tensor, mesh, axis: str = "t",
                        dim: int = -1) -> Optional[torch.Tensor]:
    """Join the outputs of ``mesh``'s ``axis`` ranks along ``dim`` (the
    stream axis; -2 for FFT frames, or the channel axis of a
    channel-sharded bank) on the axis's rank 0, which gets the whole
    output on ``y_local``'s device; the other ranks get None.  Every rank
    of the axis calls it with an output of the same shape."""
    group = mesh.get_group(axis)
    got = gather_ranks(y_local, group)
    if dist.get_rank(group) != 0:
        return None
    return torch.cat(list(got.unbind(0)), dim=dim)


def host_block_iterator(path, mesh, block_global: int, dtype=np.uint8,
                        axis: str = "t") -> Iterator[np.ndarray]:
    """This rank's span of each global block of a recorded stream (offset
    and length from :func:`local_time_span`): each rank reads only its
    own items of the file.  A trailing partial block is dropped."""
    data = np.memmap(path, dtype=dtype, mode="r")
    n = (len(data) // block_global) * block_global
    off, length = local_time_span(mesh, block_global, axis)
    for i in range(0, n, block_global):
        # a copy: the map's pages are read-only, and torch takes arrays
        # it may write
        yield np.array(data[i + off: i + off + length])
