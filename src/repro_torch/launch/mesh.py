"""Mesh factories (port of ``repro.launch.mesh``).

Functions, not module state: importing this module creates no process
group and touches no device.  Both need ``torch.distributed``'s default
process group, of the mesh's size, to exist already.

Production shapes, the reference's:
  single pod:  (data=16, model=16)           = 256 GPUs
  multi-pod:   (pod=2, data=16, model=16)    = 512 GPUs

On HGX H100 nodes of 8 GPUs, ``model = 16`` spans two NVLink domains: its
collectives cross the nodes' network as well as NVLink.  Axis roles:
``pod`` pure data parallelism, ``data`` FSDP batch and parameter shards,
``model`` tensor / expert / sequence parallelism.  A world of 256 or 512
ranks exists on one machine only as the fake process group
(``repro_torch.compat.init_fake_world``), where the mesh can be built and
tensors placed on it but nothing runs.
"""

from __future__ import annotations

import torch.distributed as dist

from repro_torch.compat import DeviceMesh, make_mesh
from repro_torch.device import DeviceLike, resolve_device


def make_production_mesh(*, multi_pod: bool = False,
                         device: DeviceLike = None) -> DeviceMesh:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device)


def make_host_mesh(model: int = 1, device: DeviceLike = None) -> DeviceMesh:
    """The world's ranks as (world // model, model) over ("data",
    "model"); ``device=None`` means ``cuda``."""
    dev = resolve_device(device)
    world = dist.get_world_size() if dist.is_initialized() else 1
    if world % model:
        raise ValueError(f"model={model} does not divide the world's "
                         f"{world} ranks")
    return make_mesh((world // model, model), ("data", "model"), dev)
