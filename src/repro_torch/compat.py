"""Version compatibility shims for the installed torch (port of
``repro.compat``).

The reference shims ``shard_map`` and ``jax.make_mesh`` across jax
releases.  Here the moving parts are torch's: ``DTensor`` and its
placements left ``torch.distributed._tensor`` for the public
``torch.distributed.tensor`` in 2.4, and the fake process group (one
process standing in for a world of any size, whose collectives do
nothing) lives in ``torch.testing._internal``.  Callers import them from
here and :func:`make_mesh` builds a ``DeviceMesh`` with named axes, as
``jax.make_mesh`` does.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from repro_torch.device import DeviceLike, resolve_device

try:                                        # torch >= 2.4
    from torch.distributed.tensor import (DTensor, Replicate, Shard,
                                          distribute_tensor)
except ImportError:                         # torch 2.2-2.3
    from torch.distributed._tensor import (DTensor, Replicate, Shard,
                                           distribute_tensor)

__all__ = ["DeviceMesh", "DTensor", "Replicate", "Shard", "distribute_tensor",
           "init_device_mesh", "fake_store", "init_fake_world", "make_mesh"]


def fake_store():
    """The fake process group's store; importing its module registers the
    ``"fake"`` backend with ``torch.distributed``."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    return FakeStore()


def init_fake_world(world_size: int, rank: int = 0) -> None:
    """Make this process rank ``rank`` of a fake world of ``world_size``
    ranks: enough to build a ``DeviceMesh`` of that size and to place
    tensors on it, with no other process and no communication."""
    dist.init_process_group("fake", store=fake_store(), rank=rank,
                            world_size=world_size)


def make_mesh(axis_shapes: Sequence[int], axis_names: Sequence[str],
              device: DeviceLike = None) -> DeviceMesh:
    """A ``DeviceMesh`` of ``axis_shapes`` over the whole default process
    group, its dims named ``axis_names``; the device type from
    ``device`` (``None`` means ``cuda``).  The process group must exist
    and hold ``prod(axis_shapes)`` ranks."""
    dev = resolve_device(device)
    shape, names = tuple(int(s) for s in axis_shapes), tuple(axis_names)
    if len(shape) != len(names):
        raise ValueError(f"mesh shape {shape} and names {names} differ in "
                         f"length")
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs torch.distributed's default "
                           "process group; init_process_group first")
    if dist.get_world_size() != math.prod(shape):
        raise ValueError(f"mesh {shape} needs {math.prod(shape)} ranks, the "
                         f"world has {dist.get_world_size()}")
    return init_device_mesh(dev.type, shape, mesh_dim_names=names)
