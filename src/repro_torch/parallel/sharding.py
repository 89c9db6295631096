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
model code does not call it: with no GSPMD to place a layer, each of the
reference's ``constrain`` sites is written out as its collective in
``models/placed.py``, which runs under ``use_rules(mesh, placed=True)``
on the rank's state:

  * :func:`shard_params` gives this rank's block of every leaf by
    :func:`param_shardings` (``data``: FSDP, ``model``: TP / EP; a
    stacked leaf's repeat dim whole), :func:`gather_params` its inverse;
  * :func:`shard_batch` gives the rank's rows of a batch by
    :func:`batch_spec` (over ``pod`` and ``data``).

  * :func:`shard_cache` gives the rank's block of a decode cache by
    :func:`cache_shardings` (the reference's ``cache_specs``: the KV
    length over ``model``, the Mamba SSM state's heads over ``model``,
    the rows over ``pod`` and ``data``), :func:`gather_cache` its
    inverse.

Training, prefill and the decode step take the placements (ROADMAP A8.2
and A8.3).  Plain ``use_rules(mesh)`` keeps the layers replicated on
every rank over whole parameters and the whole batch, the MoE layers'
expert-parallel paths over :func:`expert_slabs`.
"""

from __future__ import annotations

import dataclasses
import math
import re
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

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

# the decode cache's leaves ((repeats, B, ...), ``models.init_cache``) by
# their path's last two names: the reference's ``cache_specs``
CACHE_RULES: Dict[str, Tuple[str, ...]] = {
    "attn/k": ("none", "batch", "seq", "none", "none"),
    "attn/v": ("none", "batch", "seq", "none", "none"),
    "mamba/conv": ("none", "batch", "none", "model"),
    "mamba/ssm": ("none", "batch", "model", "none", "none"),
}

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
    of tensors, or of shapes: ``models.param_shapes``) by the PARAM_RULES
    table."""
    def one(path: str, leaf: Any) -> NamedSharding:
        shape = tuple(leaf.shape if isinstance(leaf, torch.Tensor) else leaf)
        stacked = "layers/" in path or "encoder/" in path
        axes = _axes_for(path, len(shape), stacked)
        return NamedSharding(mesh, logical_to_spec(axes, shape, mesh))

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
_PLACED = False


class use_rules:
    """Context manager under which the model runs over ``mesh``.  With
    ``placed`` (training and prefill) each rank holds its shards
    (:func:`shard_params`, :func:`shard_batch`) and every layer runs its
    FSDP/TP placement (``models/placed.py``); without it the layers run
    replicated and only the MoE layers take their expert-parallel paths
    (``models/model.py``).  Outside it everything runs as on one device."""

    def __init__(self, mesh: Optional[Any], placed: bool = False):
        self.mesh = mesh
        self.placed = placed
        self._prev: Tuple[Optional[Any], bool] = (None, False)

    def __enter__(self):
        global _ACTIVE_MESH, _PLACED
        self._prev = (_ACTIVE_MESH, _PLACED)
        _ACTIVE_MESH, _PLACED = self.mesh, self.placed and self.mesh is not None
        return self

    def __exit__(self, *exc):
        global _ACTIVE_MESH, _PLACED
        _ACTIVE_MESH, _PLACED = self._prev
        return False


def active_mesh() -> Optional[Any]:
    return _ACTIVE_MESH


def placed() -> bool:
    """Does the model run its FSDP/TP placements (``use_rules(mesh,
    placed=True)``)?"""
    return _PLACED


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
    ``model`` axis (the expert dim of :func:`param_shardings`), every
    other leaf as it is: the replicated mode's state (``use_rules(mesh)``
    without ``placed``; :func:`shard_params` gives the placed path every
    leaf's FSDP/TP block).  The slabs are views of the full leaves."""
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


# ---------------------------------------------------------------------------
# the rank's state
# ---------------------------------------------------------------------------

def spec_axes(entry: Any) -> Tuple[str, ...]:
    """The mesh axes of one spec entry (None, a name or a tuple)."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def local_shape(shape: Sequence[int], spec: Spec, mesh: Any
                ) -> Tuple[int, ...]:
    """The block of ``shape`` that one rank holds under ``spec``."""
    sizes = mesh_axes(mesh)
    out = list(shape)
    for d, entry in enumerate(spec):
        out[d] //= math.prod(sizes[a] for a in spec_axes(entry))
    return tuple(out)


def local_block(t: torch.Tensor, spec: Spec, mesh) -> torch.Tensor:
    """This rank's block of ``t`` under ``spec`` (a view): along a dim
    split over several axes the block index runs over them outer axis
    first, as a ``NamedSharding`` places it."""
    sizes = mesh_axes(mesh)
    for d, entry in enumerate(spec):
        axes = spec_axes(entry)
        if not axes:
            continue
        idx = 0
        for a in axes:
            idx = idx * sizes[a] + mesh.get_local_rank(a)
        size = t.shape[d] // math.prod(sizes[a] for a in axes)
        t = t.narrow(d, idx * size, size)
    return t


def _own(block: torch.Tensor, whole: torch.Tensor) -> torch.Tensor:
    """``block`` as a tensor of its own storage where it is a part of
    ``whole`` (a shard's bytes are the shard's)."""
    return block if block.numel() == whole.numel() else block.clone()


def _map2(fn, tree: Any, specs: Any, path: str = "") -> Any:
    if isinstance(tree, dict):
        return {k: _map2(fn, v, specs[k], f"{path}/{k}" if path else k)
                for k, v in tree.items()}
    return fn(path, tree, specs)


def shard_params(params: Any, mesh) -> Any:
    """This rank's shard of every leaf of ``params`` (the whole tree) by
    :func:`param_shardings`: split over ``data`` (FSDP) and ``model``
    (TP / EP) where the rules put them and the axis divides the dim, a
    stacked leaf's repeat dim whole.  Each shard owns its storage."""
    specs = param_shardings(params, mesh)
    return _map2(lambda _p, t, s: _own(local_block(t, s.spec, mesh), t),
                 params, specs)


def gather_params(shards: Any, mesh, shapes: Any) -> Any:
    """The whole tree from every rank's :func:`shard_params` (for
    checkpoints and tests; no autograd): ``shapes`` the whole tree's
    shapes (``models.param_shapes(cfg)``).  Every rank gets the whole
    tree."""
    specs = param_shardings(shapes, mesh)

    return _map2(lambda _p, t, s: _gather_leaf(t, s.spec, mesh), shards,
                 specs)


def cache_shardings(cache: Any, mesh: Any) -> Any:
    """A tree of :class:`NamedSharding` mirroring a decode cache (nested
    dicts of tensors or shapes, ``models.init_cache``'s layout) by
    :data:`CACHE_RULES`: the reference's ``cache_specs``."""
    def build(tree: Any, path: str) -> Any:
        if isinstance(tree, dict):
            return {k: build(v, f"{path}/{k}" if path else k)
                    for k, v in tree.items()}
        shape = tuple(tree.shape if isinstance(tree, torch.Tensor) else tree)
        axes = CACHE_RULES["/".join(path.split("/")[-2:])]
        return NamedSharding(mesh, logical_to_spec(axes, shape, mesh))
    return build(cache, "")


def mamba_head_tp(n_heads: int, tp: int) -> bool:
    """Does a Mamba mixer of ``n_heads`` heads split by head over ``tp``
    ``model`` ranks (head-parallel TP, ``models/placed.py``)?  Where its
    heads divide: exactly there :data:`CACHE_RULES` puts the SSM state's
    heads over ``model`` (:func:`logical_to_spec` keeps an axis that
    divides its dim and drops one that does not)."""
    return n_heads % tp == 0


def mamba_conv_channels(d_inner: int, state: int, tp: int, rank: int
                        ) -> Tuple[Tuple[int, int], ...]:
    """The (start, length) ranges of the Mamba conv's ``d_inner + 2 *
    state`` channels (x | B | C) that ``model`` rank ``rank`` of ``tp``
    holds under head-parallel TP: its heads' x channels, then the whole B
    and C.  Adjacent ranges are merged (one rank: the whole)."""
    n = d_inner // tp
    return merge_ranges(((rank * n, n), (d_inner, 2 * state)))


def mamba_columns(d_inner: int, state: int, n_heads: int, tp: int,
                  rank: int) -> Tuple[Tuple[int, int], ...]:
    """The (start, length) columns of the Mamba fused in-projection (z |
    x | B | C | dt) that ``model`` rank ``rank`` of ``tp`` computes under
    head-parallel TP: its heads of z, the conv's channels
    (:func:`mamba_conv_channels`), its heads of dt (one rank: every
    column, one range)."""
    n, hl = d_inner // tp, n_heads // tp
    conv = tuple((d_inner + a, k) for a, k in mamba_conv_channels(
        d_inner, state, tp, rank))
    return merge_ranges(((rank * n, n), *conv,
                         (2 * d_inner + 2 * state + rank * hl, hl)))


def merge_ranges(ranges) -> Tuple[Tuple[int, int], ...]:
    """``(start, length)`` ranges with each one that starts where the one
    before ends merged into it."""
    out: List[List[int]] = []
    for start, n in ranges:
        if out and out[-1][0] + out[-1][1] == start:
            out[-1][1] += n
        else:
            out.append([start, n])
    return tuple((a, n) for a, n in out)


def take(t: torch.Tensor, dim: int, ranges) -> torch.Tensor:
    """The ``(start, length)`` ranges of ``t`` along ``dim``, in order
    (one range: a view)."""
    parts = [t.narrow(dim, a, n) for a, n in ranges]
    return parts[0] if len(parts) == 1 else torch.cat(parts, dim=dim)


def shard_cache(cache: Any, mesh) -> Any:
    """This rank's block of every leaf of a decode cache (the whole
    cache, ``models.init_cache``'s layout) by :func:`cache_shardings`:
    the rows over ``pod`` and ``data`` where they divide, a KV cache's
    length over ``model`` (it must divide: a length that does not raises
    with the lengths), a Mamba SSM state's heads over ``model`` where they
    divide.  A Mamba conv state departs from the reference's contiguous
    cut of its ``d_inner + 2 * state`` channels (ROADMAP C14): where the
    heads split, the rank holds its heads' x channels and the whole B and
    C channels (:func:`mamba_conv_channels`), the channels its head-TP
    conv reads; else every channel.  The values are the same.  Each
    block owns its storage."""
    specs = cache_shardings(cache, mesh)
    tp = mesh_axes(mesh).get("model", 1)

    def kv(path: str, t: torch.Tensor, s: NamedSharding) -> torch.Tensor:
        if t.shape[2] % tp:
            raise NotImplementedError(
                f"placed path: the cache length ({t.shape[2]}) of {path} "
                f"must divide over model = {tp}")
        return _own(local_block(t, s.spec, mesh), t)

    def build(tree: Any, spec: Any, path: str) -> Any:
        if isinstance(tree, dict) and "ssm" in tree:    # a Mamba position
            conv, ssm = tree["conv"], tree["ssm"]
            rows = local_block(conv, (None, spec["conv"].spec[1]), mesh)
            H, P, S = ssm.shape[2:]
            if tp > 1 and mamba_head_tp(H, tp):
                rows = take(rows, 3, mamba_conv_channels(
                    H * P, S, tp, mesh.get_local_rank("model")))
            return {"conv": _own(rows, conv),
                    "ssm": _own(local_block(ssm, spec["ssm"].spec, mesh),
                                ssm)}
        if isinstance(tree, dict):
            return {k: build(v, spec[k], f"{path}/{k}" if path else k)
                    for k, v in tree.items()}
        return kv(path, tree, spec)
    return build(cache, specs, "")


def _gather_leaf(t: torch.Tensor, spec: Spec, mesh) -> torch.Tensor:
    """The whole leaf from every rank's ``spec`` block (no autograd)."""
    for d, entry in enumerate(spec):
        for a in reversed(spec_axes(entry)):      # inner axis first
            group = mesh.get_group(a)
            parts = [torch.empty_like(t)
                     for _ in range(dist.get_world_size(group))]
            dist.all_gather(parts, t.contiguous(), group=group)
            t = torch.cat(parts, dim=d)
    return t


def gather_cache(shards: Any, mesh, shapes: Any) -> Any:
    """The whole cache from every rank's :func:`shard_cache` (for tests;
    no autograd): ``shapes`` the whole cache's shapes or tensors
    (``configs.shapes.cache_specs``).  Every rank gets the whole cache."""
    specs = cache_shardings(shapes, mesh)
    tp = mesh_axes(mesh).get("model", 1)

    def build(tree: Any, spec: Any) -> Any:
        if isinstance(tree, dict) and "ssm" in tree:
            conv = _gather_leaf(tree["conv"], (None, spec["conv"].spec[1]),
                                mesh)
            ssm = _gather_leaf(tree["ssm"], spec["ssm"].spec, mesh)
            H, P, S = ssm.shape[2:]
            if tp > 1 and mamba_head_tp(H, tp):
                # each rank's channels back to their place
                parts = [torch.empty_like(conv) for _ in range(tp)]
                dist.all_gather(parts, conv.contiguous(),
                                group=mesh.get_group("model"))
                conv = conv.new_empty((*conv.shape[:3], H * P + 2 * S))
                for r, part in enumerate(parts):
                    at = 0
                    for a, n in mamba_conv_channels(H * P, S, tp, r):
                        conv.narrow(3, a, n).copy_(part.narrow(3, at, n))
                        at += n
            return {"conv": conv, "ssm": ssm}
        if isinstance(tree, dict):
            return {k: build(v, spec[k]) for k, v in tree.items()}
        return _gather_leaf(tree, spec.spec, mesh)
    return build(shards, specs)


def batch_axes(mesh: Any) -> Tuple[str, ...]:
    """The mesh's data-parallel axes, over which a batch is split."""
    return tuple(a for a in LOGICAL_RULES["batch"] if a in mesh_axes(mesh))


def shard_batch(batch: Dict[str, Any], mesh, whole_rows: bool = False
                ) -> Dict[str, Any]:
    """This rank's rows of every (B, ...) entry of ``batch`` (``tokens``,
    ``targets``, ``loss_mask``, ``patch_embeds``, ``encoder_embeds``; a
    decode step's per-slot ``index`` and ``memory``) by
    :func:`batch_spec`.  Training and prefill want the batch split over
    every data-parallel axis: B must divide by their product.  With
    ``whole_rows`` (a decode step, whose layers are per row) rows that do
    not divide stay whole over an axis, as the spec places them and as
    :func:`shard_cache` places the cache's rows."""
    out = {}
    for k, v in batch.items():
        v = torch.as_tensor(v)
        spec = batch_spec(mesh, v.shape).spec
        if not whole_rows and set(spec_axes(spec[0])) != set(
                batch_axes(mesh)):
            raise ValueError(f"batch {k!r} of {tuple(v.shape)} rows does not "
                             f"split over the mesh's {batch_axes(mesh)} axes")
        out[k] = local_block(v, spec, mesh)
    return out
