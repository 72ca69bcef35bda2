"""Device meshes over ``torch.distributed`` ranks (counterpart of
sdr_tpu/parallel/mesh.py).

A ``DeviceMesh`` is the JAX ``Mesh``'s counterpart with one rank a device,
and ``mesh.get_group(name)`` the process group of an axis name, which the
runners (parallel/sharded.py) hand to the halo helpers.  The topology is
the JAX package's: a 2-D {channel, time} mesh, independent channels (the
data-parallel axis) outermost and time-block shards of one stream inside,
so a channel's halo exchanges stay among neighbouring ranks.

The process group must exist first (``multihost.init_distributed`` under
``torchrun``, or ``torch.distributed.init_process_group``), and each rank
should have chosen its card (``torch.cuda.set_device``) before it builds a
mesh: a mesh otherwise picks ``cuda:LOCAL_RANK`` itself.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from sdr_tpu_torch.utils.device import resolve_device

__all__ = ["make_mesh", "time_mesh", "channel_time_mesh", "DeviceMesh"]


def make_mesh(shape: Sequence[int], names: Sequence[str],
              device_type: str = "cuda") -> DeviceMesh:
    """A mesh of ``shape`` over the first ``prod(shape)`` ranks, its axes
    named ``names``; every rank of the process group calls it (ranks past
    the mesh then hold no coordinate).  ``device_type`` 'cuda' (the
    default; raises without a GPU) or 'cpu'."""
    resolve_device(device_type)
    if not dist.is_initialized():
        raise RuntimeError("no process group: call init_distributed() (or "
                           "torch.distributed.init_process_group) first")
    n, world = math.prod(shape), dist.get_world_size()
    if n > world:
        raise ValueError(f"need {n} ranks, have {world}")
    return init_device_mesh(device_type, tuple(shape),
                            mesh_dim_names=tuple(names))


def time_mesh(n: Optional[int] = None,
              device_type: str = "cuda") -> DeviceMesh:
    """1-D mesh over the time axis ``"t"`` (all ranks by default)."""
    if n is None:
        n = dist.get_world_size() if dist.is_initialized() else 1
    return make_mesh((n,), ("t",), device_type)


def channel_time_mesh(n_channel: int, n_time: int,
                      device_type: str = "cuda") -> DeviceMesh:
    """2-D {channel ``"c"``, time ``"t"``} mesh, channels outermost: the
    ranks of one channel group are consecutive."""
    return make_mesh((n_channel, n_time), ("c", "t"), device_type)
