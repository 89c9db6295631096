"""Logical-axis sharding rules (port of ``repro.parallel.sharding``).

Physical mesh axes (``launch/mesh.py``):
  'pod'   — pure data parallelism across pods
  'data'  — FSDP/ZeRO-3: batch *and* parameter shards
  'model' — tensor/expert parallelism within a pod row

A *logical* axis name maps to zero or more physical axes.  Rules are
best-effort, as in the reference: a physical axis is dropped from a
dimension's spec when it does not divide the dimension, and a physical
axis is used by one dimension at most.  Parameter placement is decided by
path-pattern rules over the parameter dict's "/"-joined path, which is
the reference's pytree path.

A spec is the reference's ``PartitionSpec`` as a tuple: per tensor
dimension None, one axis name, or a tuple of names.  :class:`NamedSharding`
pairs it with a mesh and gives the ``DTensor`` placements.  A mesh is a
``DeviceMesh`` with named dims, or any object with ``axis_names`` and
``devices`` (the reference's meshes and its tests' stand-ins).

:func:`constrain` redistributes a ``DTensor`` to a logical spec and
returns any other tensor unchanged; values never change.  The port's
model code calls it nowhere yet: without GSPMD its non-expert layers run
replicated on every rank, and the FSDP/TP placements that the
reference's ``constrain`` calls steer wait for the dry-run that reads
them.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.compat import DTensor, Replicate, Shard

# logical axis -> physical mesh axes (tuple => sharded over several)
LOGICAL_RULES: Dict[str, Tuple[str, ...]] = {
    "batch": ("pod", "data"),
    "fsdp": ("data",),          # parameter dim sharded ZeRO-3 style
    "model": ("model",),        # TP: heads / mlp hidden / vocab
    "expert": ("model",),       # EP
    "seq": ("model",),          # SP (long-context KV/state sharding)
    "none": (),
}

# (path regex, per-dim logical axes).  First match wins.  Stacked layer
# params get an extra leading repeat dim handled automatically.
PARAM_RULES: List[Tuple[str, Tuple[str, ...]]] = [
    (r"embed$",                     ("model", "fsdp")),       # (V, D)
    (r"(wq|wk|wv)$",                ("fsdp", "model")),
    (r"wo$",                        ("model", "fsdp")),
    (r"(w_gate|w_up)$",             ("fsdp", "model")),       # dense mlp
    (r"w_down$",                    ("model", "fsdp")),
    (r"moe/(w_gate|w_up)$",         ("expert", "fsdp", "model")),
    (r"moe/w_down$",                ("expert", "model", "fsdp")),
    (r"moe/router$",                ("none", "none")),
    (r"w_in$",                      ("fsdp", "model")),       # mamba in-proj
    (r"w_out$",                     ("model", "fsdp")),
    (r"conv_w$",                    ("none", "model")),
    (r"conv_b$",                    ("model",)),
    # everything else (norm scales, a_log, biases): replicated
]

# 'dp_only': replicate every parameter
RULE_SETS: Dict[str, List[Tuple[str, Tuple[str, ...]]]] = {
    "default": PARAM_RULES,
    "dp_only": [],
}
_ACTIVE_PARAM_RULES: List[Tuple[str, Tuple[str, ...]]] = PARAM_RULES

Spec = Tuple[Any, ...]


def set_param_rules(name: str) -> None:
    global _ACTIVE_PARAM_RULES
    _ACTIVE_PARAM_RULES = RULE_SETS[name]


def mesh_axes(mesh: Any) -> Dict[str, int]:
    """{axis name: size} of a ``DeviceMesh`` or a reference-style mesh."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, mesh.shape))
    return dict(zip(mesh.axis_names, np.shape(mesh.devices)))


def _axes_for(path_s: str, ndim: int, stacked: bool) -> Tuple[str, ...]:
    for pat, axes in _ACTIVE_PARAM_RULES:
        if re.search(pat, path_s):
            if stacked and len(axes) == ndim - 1:
                return ("none",) + axes
            if len(axes) == ndim:
                return axes
    return ("none",) * ndim


def logical_to_spec(axes: Sequence[str], shape: Sequence[int],
                    mesh: Any) -> Spec:
    """Resolve logical axes to a spec, dropping physical axes that do not
    divide the corresponding dimension (best-effort sharding)."""
    out: List[Any] = []
    sizes = mesh_axes(mesh)
    used: set = set()
    for dim, name in zip(shape, axes):
        phys = [a for a in LOGICAL_RULES.get(name, ()) if a in sizes]
        keep: List[str] = []
        prod = 1
        for a in phys:
            if a in used:
                continue
            if dim % (prod * sizes[a]) == 0:
                keep.append(a)
                prod *= sizes[a]
        for a in keep:
            used.add(a)
        out.append(tuple(keep) if len(keep) > 1 else (keep[0] if keep else None))
    return tuple(out)


def spec_placements(spec: Spec, mesh) -> list:
    """The ``DTensor`` placements of ``spec`` on a ``DeviceMesh``: per mesh
    dim ``Shard(d)`` where the spec puts that axis on tensor dim ``d``,
    else ``Replicate()``.  A dim over several axes is split in mesh order,
    outer axis first, as the reference's tuple entries are."""
    names = list(mesh.mesh_dim_names)
    out: list = [Replicate()] * len(names)
    for d, entry in enumerate(spec):
        for a in ((entry,) if isinstance(entry, str) else entry or ()):
            out[names.index(a)] = Shard(d)
    return out


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A mesh and a spec over its axes (``jax.sharding.NamedSharding``)."""

    mesh: Any
    spec: Spec

    @property
    def placements(self) -> list:
        return spec_placements(self.spec, self.mesh)


def param_shardings(params: Any, mesh: Any) -> Any:
    """A tree of :class:`NamedSharding` mirroring ``params`` (nested dicts
    of tensors) by the PARAM_RULES table."""
    def one(path: str, leaf: torch.Tensor) -> NamedSharding:
        stacked = "layers/" in path or "encoder/" in path
        axes = _axes_for(path, leaf.dim(), stacked)
        return NamedSharding(mesh, logical_to_spec(axes, leaf.shape, mesh))

    def build(tree: Any, path: str) -> Any:
        if isinstance(tree, dict):
            return {k: build(v, f"{path}/{k}" if path else str(k))
                    for k, v in tree.items()}
        return one(path, tree)
    return build(params, "")


# ---------------------------------------------------------------------------
# the active mesh
# ---------------------------------------------------------------------------

_ACTIVE_MESH: Optional[Any] = None


class use_rules:
    """Context manager under which the model's MoE layers take their
    expert-parallel paths over ``mesh`` (``models/model.py``).  Without
    it everything runs as on one device."""

    def __init__(self, mesh: Optional[Any]):
        self.mesh = mesh
        self._prev: Optional[Any] = None

    def __enter__(self):
        global _ACTIVE_MESH
        self._prev, _ACTIVE_MESH = _ACTIVE_MESH, self.mesh
        return self

    def __exit__(self, *exc):
        global _ACTIVE_MESH
        _ACTIVE_MESH = self._prev
        return False


def active_mesh() -> Optional[Any]:
    return _ACTIVE_MESH


def axis_size(logical: str) -> int:
    """Product of active-mesh sizes behind a logical axis (1 if no mesh)."""
    mesh = _ACTIVE_MESH
    if mesh is None:
        return 1
    sizes = mesh_axes(mesh)
    n = 1
    for a in LOGICAL_RULES.get(logical, ()):
        n *= sizes.get(a, 1)
    return n


def constrain(x: torch.Tensor, *axes: str) -> torch.Tensor:
    """A ``DTensor`` redistributed to the logical spec on its own mesh;
    any other tensor, or any tensor outside :class:`use_rules`,
    unchanged."""
    if _ACTIVE_MESH is None or not isinstance(x, DTensor):
        return x
    spec = logical_to_spec(axes, x.shape, x.device_mesh)
    return x.redistribute(x.device_mesh, spec_placements(spec, x.device_mesh))


def batch_spec(mesh: Any, shape: Sequence[int]) -> NamedSharding:
    """Sharding for a (B, S, ...) host batch: batch over ('pod','data')."""
    axes = ("batch",) + ("none",) * (len(shape) - 1)
    return NamedSharding(mesh, logical_to_spec(axes, shape, mesh))


def replicated(mesh: Any) -> NamedSharding:
    return NamedSharding(mesh, ())


def expert_slabs(params: Any, mesh) -> Any:
    """``params`` with every MoE expert leaf (``moe/{w_gate, w_up,
    w_down}``) cut to this rank's slab of experts over the mesh's
    ``model`` axis (the expert dim of :func:`param_shardings`; its FSDP
    split over ``data`` waits for A8.2), every other leaf as it is.  The
    slabs are views of the full leaves."""
    tp = mesh_axes(mesh)["model"]
    rank = mesh.get_local_rank("model")

    def build(tree: Any, path: str) -> Any:
        if isinstance(tree, dict):
            return {k: build(v, f"{path}/{k}" if path else k)
                    for k, v in tree.items()}
        if not re.search(r"moe/(w_gate|w_up|w_down)$", path):
            return tree
        dim = 1 if "layers/" in path else 0
        e_loc = tree.shape[dim] // tp
        return tree.narrow(dim, rank * e_loc, e_loc)
    return build(params, "")
