"""Multi-pod dry-run: every (arch x shape x mesh) cell's step on meta tensors
(port of ``repro.launch.dryrun``).

For each cell the production step (a training step with its microbatches
and AdamW, a prefill, or a decode step) runs once on ``meta`` tensors, as
rank 0 of a fake world of the mesh's size: the tensors have shapes and
dtypes but no storage, so nothing is allocated and nothing runs on a
device.  The fake mesh is built over the CPU device type
(``make_production_mesh(device="cpu")``) because nothing is placed on it,
and the fake process group's collectives do nothing.  Where the reference
lowers and compiles, the port counts every op as it runs, per rank:

  * FLOPs: the aten ops by ``torch.utils.flop_counter``'s formulas (those
    of ``FlopCounterMode``: the tied head's ``torch.matmul``, attention's
    einsums, the MoE ``torch.bmm``s), plus 2*M*N*K once per tuned GEMM
    call;
  * bytes: each aten op's operand and result bytes (a view, an empty
    allocation: 0), plus each GEMM call's A, B and k_split partials and
    each split-K pass's partials and result, under the config dispatch
    resolved;
  * collectives: ``analysis.comm.record()``, per kind and total, in the
    reference's convention;
  * memory: ``argument`` (the rank's parameters, AdamW state, gradient
    accumulators, inputs, cache) and ``temp`` (the peak of the storages
    made during the step and alive at once), against the card's 80 GB.

``kernels.matmul.gemm`` and ``splitk_reduce`` each count as one op on
every device: on the card the kernel is a ctypes launch that no mode
sees, and on the CPU the ops of their plain versions are hidden from the
count, so one step counts the same on meta, on the CPU and on the card.
On meta an op that neither aliases nor writes its arguments runs once per
input metadata and is replayed after (a step repeats each layer's ops
over its repeats and microbatches, and meta kernels are Python).
The reference compiles each cell three times because XLA's
``cost_analysis`` counts a while body once; the port counts one pass at
full depth, and its artifact says so.

Every CLI cell runs the FSDP/TP placements (ROADMAP A8.2, A8.3;
``build_cell(placed=True)``) under ``use_rules(mesh, placed=True)``
(``models/placed.py``): the rank's block of every parameter
(``parallel.sharding.shard_params``) and AdamW state, its rows of the
batch (``shard_batch``; microbatches split those rows; a decode step's
tokens, per-slot index and memory whole over an axis its B does not
divide, as ``long_500k``'s one row) and its block of the cache
(``shard_cache``: its rows, the KV length over ``model``, a Mamba
state's heads over ``model``).  ``build_cell`` without ``placed`` builds
the replicated mode: every rank holds the whole model but its expert
slabs (a decode step: every leaf whole, ``moe_decode`` running every
expert) and the whole batch.

A dry-run leaves the process's serving state as it found it: dispatch's
``tier_counts``, the shape telemetry, the degraded-tier counter and the
warn-once set: it dispatches inside ``kernels.dispatch.quiet``, whose
own tier count the artifact keeps as its resolutions.  It resolves
configs through whatever store, models or plan is installed; with none,
the ops defaults.  ``dispatch.quiet`` and ``kernels.matmul.observed``
cover the whole process, so run it where nothing else dispatches at the
same time.

Artifacts land in ``results/dryrun_torch/<arch>--<shape>--<mesh>.json``
(never ``results/dryrun/``, the reference's) in the reference's layout,
which ``analysis.roofline.roofline_from_artifacts`` reads.

Usage:
  python -m repro_torch.launch.dryrun --all              # every cell, resumable
  python -m repro_torch.launch.dryrun --arch qwen3-14b --shape train_4k --mesh pod
  python -m repro_torch.launch.dryrun ... --override remat=False --tag exp1
  python -m repro_torch.launch.dryrun --cell smollm-135m:train_4k:pod \\
      --cell dbrx-132b:prefill_32k:multipod --out DIR
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import functools
import json
import pathlib
import time
import traceback
import weakref
from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch.utils.flop_counter import flop_registry

from repro_torch import compat
from repro_torch.analysis import comm
from repro_torch.analysis.roofline import (format_table, model_flops,
                                           roofline_from_artifacts)
from repro_torch.configs import ARCH_NAMES, SHAPES, applicable, get_config
from repro_torch.configs.shapes import Shape, input_specs
from repro_torch.kernels import dispatch
from repro_torch.kernels import matmul as _matmul
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import (ModelConfig, decode_step, init_cache,
                                init_params, loss_fn, prefill, tree_leaves,
                                tree_map)
from repro_torch.models.model import param_shapes
from repro_torch.optim import AdamWConfig, adamw_init, adamw_update
from repro_torch.parallel import sharding as shd

RESULTS = pathlib.Path(__file__).resolve().parents[3] / "results" / \
    "dryrun_torch"

# the card's memory (H100 SXM 80GB, the data sheet's 80 GB)
DEVICE_BYTES = 80 * 10**9

MESH_WORLD = {"pod": 256, "multipod": 512}

MEMORY_NOTE = ("argument + temp, storages' bytes as the ops make them; "
               "leaves out the caching allocator's rounding and "
               "fragmentation, workspaces inside kernels (cuBLAS, NCCL, "
               "sort), the CUDA context, and the plain GEMM's temporaries "
               "on the CPU")

COUNT_NOTE = ("one pass at full depth: every op counted as it ran (no "
              "depth-1/depth-2 extrapolation); per rank")


def opt_config_for(cfg: ModelConfig) -> AdamWConfig:
    """bf16 optimizer states above ~20B params (the reference's rule)."""
    big = cfg.param_count > 2e10
    return AdamWConfig(state_dtype=torch.bfloat16 if big else torch.float32)


def train_microbatches(cfg: ModelConfig) -> int:
    """Gradient-accumulation factor for the dry-run training step: bounds
    live activation memory for the huge configs (the reference's)."""
    if cfg.param_count > 2e11:
        return 8
    if cfg.param_count > 5e10:
        return 4
    return 1


def grad_accum_dtype(cfg: ModelConfig) -> torch.dtype:
    """fp32 gradient accumulators except at 405B scale, where the extra
    params-sized fp32 buffer alone would blow the budget; bf16
    accumulation over <= 8 microbatches is the reference's trade."""
    return torch.bfloat16 if cfg.param_count > 2e11 else torch.float32


# ---------------------------------------------------------------------------
# the steps (one per shape kind)
# ---------------------------------------------------------------------------

def build_train(cfg: ModelConfig, mesh, placed: bool = False) -> Callable:
    """``step(state, inputs)``: ``train_microbatches(cfg)`` microbatches of
    the batch (with ``placed``, of the rank's rows) through ``loss_fn``
    and its backward, gradients summed into the state's accumulators
    (``grad_accum_dtype``) and divided by the count, then ``adamw_update``
    in place (its global norm over the shards); one microbatch takes its
    gradients as they come, as the reference's does."""
    opt_cfg, nm = opt_config_for(cfg), train_microbatches(cfg)
    specs = (shd.param_shardings(param_shapes(cfg), mesh) if placed
             else None)

    def step(state: Dict[str, Any], batch: Dict[str, Any]):
        params = state["params"]
        leaves = tree_leaves(params)
        B = batch["tokens"].shape[0]
        if B % nm:
            raise ValueError(f"batch {B} does not split into {nm} "
                             f"microbatches")
        mb = B // nm
        with shd.use_rules(mesh, placed=placed):
            losses, accs = [], []
            acc = tree_leaves(state["acc"]) if nm > 1 else None
            if acc is not None:
                for a in acc:
                    a.zero_()
            for i in range(nm):
                part = {k: v[i * mb:(i + 1) * mb] for k, v in batch.items()}
                loss, aux = loss_fn(params, cfg, part)
                grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                            materialize_grads=True)
                losses.append(loss.detach())
                accs.append(aux["acc"].detach())
                if acc is not None:
                    with torch.no_grad():
                        for a, g in zip(acc, grads):
                            a.add_(g)
                    del grads
            if acc is not None:
                with torch.no_grad():
                    grads = [a / nm for a in acc]
            it = iter(grads)
            g_tree = tree_map(lambda _: next(it), params)
            _, state["opt"], om = adamw_update(params, g_tree, state["opt"],
                                               opt_cfg, shardings=specs)
        loss = losses[0] if nm == 1 else torch.stack(losses).mean()
        acc_m = accs[0] if nm == 1 else torch.stack(accs).mean()
        return {"loss": loss, "acc": acc_m, **om}
    return step


def build_prefill(cfg: ModelConfig, mesh, placed: bool = False) -> Callable:
    def step(state: Dict[str, Any], inputs: Dict[str, Any]):
        batch = {k: v for k, v in inputs.items() if k != "cache"}
        with torch.no_grad(), shd.use_rules(mesh, placed=placed):
            return prefill(state["params"], cfg, batch, inputs["cache"])
    return step


def build_decode(cfg: ModelConfig, mesh, placed: bool = False) -> Callable:
    def step(state: Dict[str, Any], inputs: Dict[str, Any]):
        with torch.no_grad(), shd.use_rules(mesh, placed=placed):
            return decode_step(state["params"], cfg, inputs["tokens"],
                               inputs["cache"], inputs["index"],
                               memory=inputs.get("memory"))
    return step


BUILDERS = {"train": build_train, "prefill": build_prefill,
            "decode": build_decode}


# ---------------------------------------------------------------------------
# state and inputs, on meta or on a device
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=16)
def _param_shapes(cfg: ModelConfig) -> Dict[str, Any]:
    """``init_params``' tree as (shape, dtype) leaves, built under
    ``FakeTensorMode`` (no storage; ``torch.Generator`` has no meta
    device).  Kept per config: the init's ops take seconds at 128
    experts, and every cell of an arch shares the tree."""
    with compat.fake_tensor_mode():
        fake = init_params(cfg, torch.Generator())
    return tree_map(lambda t: (tuple(t.shape), t.dtype), fake)


def meta_params(cfg: ModelConfig) -> Dict[str, Any]:
    """``init_params``' tree as new meta tensors of its shapes and
    dtypes."""
    return tree_map(lambda sd: torch.empty(sd[0], dtype=sd[1],
                                           device="meta"),
                    _param_shapes(cfg))


def _slabs(params: Dict[str, Any], mesh, rules: str) -> Dict[str, Any]:
    """This rank's expert slabs (``parallel.sharding.expert_slabs``) under
    the default rules, each a tensor of its own so its storage is the
    slab's; under ``dp_only`` every leaf whole."""
    if mesh is None or rules != "default":
        return params
    whole = tree_leaves(params)
    cut = shd.expert_slabs(params, mesh)
    owned = [t if t.numel() == w.numel() else t.clone()
             for t, w in zip(tree_leaves(cut), whole)]
    it = iter(owned)
    return tree_map(lambda _: next(it), cut)


def _realize(cfg: ModelConfig, shape: Shape, specs: Dict[str, Any],
             device: torch.device, seed: int) -> Dict[str, Any]:
    """Inputs on ``device`` of ``specs``' shapes and dtypes: tokens below
    the vocab and embeddings N(0, 1) from a numpy seed, a zero cache
    (``init_cache``), each slot's decode index at the cache's last
    position."""
    rng = np.random.default_rng(seed)
    out: Dict[str, Any] = {}
    for k, s in specs.items():
        if k == "cache":
            B = tree_leaves(s)[0].shape[1]
            out[k] = init_cache(cfg, B, shape.seq_len, device)
        elif k == "index":
            out[k] = torch.full(s.shape, shape.seq_len - 1, dtype=s.dtype,
                                device=device)
        elif s.dtype.is_floating_point:
            out[k] = torch.as_tensor(rng.normal(0, 1, s.shape)).to(
                device=device, dtype=s.dtype)
        else:
            out[k] = torch.as_tensor(rng.integers(0, cfg.vocab, s.shape)).to(
                device=device, dtype=s.dtype)
    return out


@dataclasses.dataclass
class Cell:
    """One step ready to run: ``step(state, inputs)``."""

    step: Callable
    state: Dict[str, Any]
    inputs: Dict[str, Any]

    def run(self):
        return self.step(self.state, self.inputs)


def build_cell(cfg: ModelConfig, shape: Shape, mesh=None, *,
               device: Any = "meta", seed: int = 0, rules: str = "default",
               placed: bool = False) -> Cell:
    """The cell's step, its state and its inputs on ``device``: ``meta``
    (the dry-run; parameters by :func:`meta_params`) or a real device
    (``init_params`` from a ``torch.Generator`` seeded ``seed`` on it).
    Under ``mesh`` a train or prefill step holds this rank's expert slabs
    and the rest whole (a decode step every leaf whole), with the whole
    batch; with ``placed`` it holds the rank's shard of every leaf
    (``shard_params``), its rows of the batch (``shard_batch``; a decode
    step's whole over an axis its B does not divide) and its block of
    the cache (``shard_cache``), and runs the FSDP/TP placements.  A
    training state holds
    the parameters (requiring grad), the AdamW state (``opt_config_for``)
    and, over more than one microbatch, the gradient accumulators
    (``grad_accum_dtype``), each beside the rank's parameters."""
    dev = torch.device(device)
    placed = placed and mesh is not None
    decode = shape.kind == "decode"
    if dev.type == "meta":
        params = meta_params(cfg)
    else:
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
        params = init_params(cfg, gen)
    if placed:
        params = shd.shard_params(params, mesh)
    elif not decode:
        # the replicated mode's decode step runs every expert of
        # ``moe_decode`` on every rank, so its leaves stay whole
        params = _slabs(params, mesh, rules)
    state: Dict[str, Any] = {"params": params}
    if shape.kind == "train":
        for t in tree_leaves(params):
            t.requires_grad_(True)
        state["opt"] = adamw_init(params, opt_config_for(cfg))
        if train_microbatches(cfg) > 1:
            acc_dt = grad_accum_dtype(cfg)
            state["acc"] = tree_map(lambda p: torch.zeros(
                p.shape, dtype=acc_dt, device=p.device), params)
    specs = input_specs(cfg, shape)
    if shape.kind == "decode":
        # one index per slot, as the engine's tick passes it: a scalar
        # index is read on the host (``int(idx)``), which meta cannot do
        specs["index"] = torch.empty((shape.global_batch,),
                                     dtype=specs["index"].dtype,
                                     device="meta")
    cache = specs.pop("cache", None) if placed else None
    inputs = specs if dev.type == "meta" else _realize(cfg, shape, specs,
                                                       dev, seed)
    if placed:
        # the rank's rows, each a tensor of its own, and its block of the
        # cache
        inputs = {k: v.clone() for k, v in shd.shard_batch(
            inputs, mesh, whole_rows=decode).items()}
        if cache is not None:
            inputs["cache"] = shd.shard_cache(
                cache if dev.type == "meta" else _realize(
                    cfg, shape, {"cache": cache}, dev, seed)["cache"], mesh)
    return Cell(BUILDERS[shape.kind](cfg, mesh, placed), state, inputs)


def _tensors(tree: Any) -> Iterator[torch.Tensor]:
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)


def _storages(tree: Any) -> Dict[int, int]:
    """{storage key: bytes} of the distinct storages behind ``tree``."""
    return {t.untyped_storage()._cdata: t.untyped_storage().nbytes()
            for t in _tensors(tree)}


def storage_bytes(*trees: Any) -> int:
    """Bytes of the distinct storages behind the tensors of ``trees``."""
    return sum(_storages(trees).values())


def argument_bytes(cell: Cell) -> int:
    """The rank's parameters, AdamW state, accumulators, inputs and
    cache."""
    return storage_bytes(cell.state["params"], cell.state.get("opt"),
                         cell.state.get("acc"), cell.inputs)


# ---------------------------------------------------------------------------
# counting
# ---------------------------------------------------------------------------

_ATEN = torch.ops.aten
# allocations: a new storage, no data moved
_ALLOC = {_ATEN.empty.memory_format, _ATEN.empty_strided.default,
          _ATEN.empty_like.default, _ATEN.new_empty.default,
          _ATEN.new_empty_strided.default}
# a reshape that shares its input's storage, which the schema does not mark
# as a view: no data moved, no new storage
_UNSAFE_VIEW = _ATEN._unsafe_view.default
# marks a constant made from host data as a fresh tensor: seen on some
# devices only, and no op of its own
_UNCOUNTED = {_ATEN.lift_fresh.default}


def _tensor_bytes(x: Any) -> int:
    if isinstance(x, torch.Tensor):
        return x.numel() * x.element_size()
    if isinstance(x, (list, tuple)):
        return sum(_tensor_bytes(v) for v in x)
    return 0


@dataclasses.dataclass
class Counts:
    """What one step did, per rank."""

    flops_aten: int = 0
    bytes_aten: int = 0
    aten_ops: int = 0
    gemm_calls: int = 0
    flops_gemm: int = 0
    bytes_gemm: int = 0
    reduce_calls: int = 0
    flops_reduce: int = 0
    bytes_reduce: int = 0
    live: int = 0
    temp: int = 0
    # aten op name -> [calls, flops, bytes]
    by_op: Dict[str, List[int]] = dataclasses.field(default_factory=dict)

    @property
    def flops(self) -> int:
        return self.flops_aten + self.flops_gemm + self.flops_reduce

    @property
    def bytes(self) -> int:
        return self.bytes_aten + self.bytes_gemm + self.bytes_reduce


class _NoKey(Exception):
    pass


_KEY_SCALARS = (bool, int, float, str, type(None), torch.dtype, torch.device,
                torch.layout, torch.memory_format)


def _meta_key(x: Any) -> Any:
    """The metadata a meta op's outputs are made from: each tensor's
    shape, strides and dtype (not its offset into its storage: a layer's
    weights are slices of the stacked repeats), the other arguments as
    they are (``_NoKey`` for a tensor off meta or an argument of another
    kind)."""
    if isinstance(x, torch.Tensor):
        if x.device.type != "meta":
            raise _NoKey
        return (tuple(x.shape), x.stride(), x.dtype)
    if isinstance(x, (list, tuple)):
        return (type(x), tuple(_meta_key(v) for v in x))
    if isinstance(x, _KEY_SCALARS):
        return (type(x), x)
    raise _NoKey


def _out_spec(out: Any, inputs: Any) -> Optional[Tuple[type, tuple]]:
    """``out``'s tensors as (shape, strides, dtype) where each is a meta
    tensor that owns a storage of its own exactly, as ``empty_strided``
    makes one, and none of ``inputs``' (``_unsafe_view`` aliases its
    input unannounced); else None."""
    outs = (out,) if isinstance(out, torch.Tensor) else out
    if not isinstance(outs, (list, tuple)) or not outs:
        return None
    spec, seen = [], set(_storages(inputs))
    for t in outs:
        if not isinstance(t, torch.Tensor) or t.device.type != "meta":
            return None
        st = t.untyped_storage()
        span = sum((n - 1) * s for n, s in zip(t.shape, t.stride()))
        if (st._cdata in seen or t.storage_offset()
                or st.nbytes() != (span + 1) * t.element_size() * (
                    t.numel() > 0)):
            return None
        seen.add(st._cdata)
        spec.append((tuple(t.shape), t.stride(), t.dtype))
    return type(out), tuple(spec)


@functools.lru_cache(maxsize=None)
def _replayable(func) -> bool:
    """An aten op that neither aliases nor writes its arguments: its
    outputs are new tensors made from its inputs' metadata alone."""
    schema = func._schema
    return (not func.is_view
            and all(a.alias_info is None for a in schema.arguments)
            and all(r.alias_info is None for r in schema.returns))


def _counting_mode(counts: Counts, known: set):
    """A dispatch mode that counts every aten op into ``counts`` and keeps
    the live bytes of the storages made under it (``known``: storages that
    existed before, never counted).  On meta tensors an op that neither
    aliases nor writes its arguments runs once per input metadata: its
    outputs, FLOPs and bytes are kept and later calls with the same
    metadata get new empty tensors of the kept shapes and strides (the
    meta kernels are Python, ~0.2 ms an op, and a step repeats each
    layer's ops over its repeats and microbatches)."""
    refs: Dict[int, Any] = {}
    memo: Dict[Any, Any] = {}

    class _Mode(compat.dispatch_mode_base()):
        def track(self, out: Any) -> None:
            for t in _tensors(out):
                st = t.untyped_storage()
                key = st._cdata
                if key in known or key in refs:
                    continue
                nb = st.nbytes()
                counts.live += nb
                counts.temp = max(counts.temp, counts.live)

                def freed(_ref, key=key, nb=nb):
                    counts.live -= nb
                    refs.pop(key, None)
                refs[key] = weakref.ref(st, freed)

        def count(self, func, flops: int, nbytes: int) -> None:
            counts.aten_ops += 1
            counts.flops_aten += flops
            counts.bytes_aten += nbytes
            row = counts.by_op.setdefault(str(func._overloadpacket), [0, 0, 0])
            row[0] += 1
            row[1] += flops
            row[2] += nbytes

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            if (func.namespace != "aten" or func in _UNCOUNTED
                    or comm.in_collective()):
                return func(*args, **kwargs)   # collectives: analysis.comm
            key = None
            if _replayable(func):
                try:
                    key = (func, _meta_key(args),
                           _meta_key(tuple(sorted(kwargs.items()))))
                except _NoKey:
                    pass
            hit = memo.get(key) if key is not None else None
            if hit is not None:
                kind, spec, flops, nbytes = hit
                outs = [torch.empty_strided(shape, stride, dtype=dtype,
                                            device="meta")
                        for shape, stride, dtype in spec]
                out = outs[0] if kind is torch.Tensor else kind(outs)
                self.track(out)
                self.count(func, flops, nbytes)
                return out
            out = func(*args, **kwargs)
            fn = flop_registry.get(func._overloadpacket)
            flops = int(fn(*args, **kwargs, out_val=out)) if fn else 0
            nbytes = 0
            if not func.is_view and func is not _UNSAFE_VIEW:
                if func not in _ALLOC:
                    nbytes = (_tensor_bytes(args) + _tensor_bytes(
                        list(kwargs.values())) + _tensor_bytes(out))
                if all(r.alias_info is None for r in func._schema.returns):
                    self.track(out)         # a new storage, not an alias
            if key is not None:
                spec = _out_spec(out, (args, kwargs))
                if spec is not None:
                    memo[key] = (*spec, flops, nbytes)
            self.count(func, flops, nbytes)
            return out
    return _Mode()


@contextlib.contextmanager
def counting(known: Any = ()) -> Iterator[Counts]:
    """Count every op run inside the block (on any device) into the
    :class:`Counts` it yields.  ``known``: tensors whose storages existed
    before (the step's arguments).  ``kernels.matmul.gemm`` and
    ``splitk_reduce`` count as one op each (through
    ``kernels.matmul.observed``): their own formula, their output's
    storage, none of their plain version's ops."""
    counts = Counts()
    mode = _counting_mode(counts, set(_storages(known)))

    def observe(name, body, *args):
        with compat.no_dispatch_modes():
            out = body(*args)
        if name == "gemm":
            a, b, cfg = args
            M, K = a.shape
            N = b.shape[1]
            counts.gemm_calls += 1
            counts.flops_gemm += 2 * M * N * K
            counts.bytes_gemm += (M * K + K * N + cfg["k_split"] * M * N) \
                * a.element_size()
        else:
            ks, M, N = args[0].shape
            counts.reduce_calls += 1
            counts.flops_reduce += (ks - 1) * M * N
            counts.bytes_reduce += (ks + 1) * M * N * args[0].element_size()
        mode.track(out)
        return out

    with _matmul.observed(observe), mode:
        yield counts


def count_step(cell: Cell) -> Dict[str, Any]:
    """Run ``cell``'s step once, counted: the artifact's ``cost``,
    ``memory``, ``collectives``, ``resolutions`` and the run's
    ``wall_s``."""
    arg = argument_bytes(cell)
    t0 = time.perf_counter()
    with dispatch.quiet() as tiers, comm.record() as ops, \
            counting(known=(cell.state, cell.inputs)) as c:
        out = cell.run()
    wall = time.perf_counter() - t0
    args = _storages((cell.state, cell.inputs))
    out_bytes = sum(nb for key, nb in _storages(out).items()
                    if key not in args)
    cost = {"flops": c.flops, "bytes_accessed": c.bytes,
            "flops_aten": c.flops_aten, "bytes_aten": c.bytes_aten,
            "aten_ops": c.aten_ops, "gemm_calls": c.gemm_calls,
            "flops_gemm": c.flops_gemm, "bytes_gemm": c.bytes_gemm,
            "reduce_calls": c.reduce_calls, "flops_reduce": c.flops_reduce,
            "bytes_reduce": c.bytes_reduce, "counting": COUNT_NOTE,
            "by_op": dict(sorted(c.by_op.items()))}
    peak = arg + c.temp
    memory = {"argument": arg, "output": out_bytes, "temp": c.temp,
              "alias": 0, "peak_per_device": peak,
              "device_bytes": DEVICE_BYTES, "fits": peak <= DEVICE_BYTES,
              "note": MEMORY_NOTE}
    return {"cost": cost, "memory": memory,
            "collectives": comm.collective_bytes(ops),
            "resolutions": {f"{s}/{t}": n for (s, t), n in sorted(
                tiers.items())},
            "wall_s": wall}


# ---------------------------------------------------------------------------
# one cell
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def fake_world(world: int) -> Iterator[None]:
    """This process as rank 0 of a fake world of ``world`` ranks, for the
    block."""
    compat.init_fake_world(world)
    try:
        yield
    finally:
        dist.destroy_process_group()


def production_mesh(mesh_name: str):
    """The cell's mesh over the fake world (which must exist)."""
    return make_production_mesh(multi_pod=(mesh_name == "multipod"),
                                device="cpu")


def cell_artifact(cfg: ModelConfig, shape: Shape, mesh=None, *,
                  arch: Optional[str] = None, mesh_name: str = "none",
                  tag: str = "", rules: str = "default",
                  overrides: Optional[Dict[str, Any]] = None,
                  placed: bool = False) -> Dict[str, Any]:
    """The dry-run of any ``(cfg, shape, mesh or None)`` on meta tensors,
    as an artifact in the reference's layout (``wall_s``: the cell built
    and counted, host seconds; ``placed``: whether the step ran the
    FSDP/TP placements, :func:`build_cell`); a skipped cell carries
    ``applicable``'s reason and no measurement."""
    chips = (int(np.prod(list(shd.mesh_axes(mesh).values())))
             if mesh is not None else 1)
    art: Dict[str, Any] = {
        "arch": arch or cfg.name, "shape": shape.name, "mesh": mesh_name,
        "chips": chips, "kind": shape.kind, "tag": tag,
        "params": cfg.param_count, "active_params": cfg.active_param_count,
        "model_flops": model_flops(cfg, shape, kind=shape.kind),
        "overrides": {k: str(v) for k, v in (overrides or {}).items()},
    }
    ok, reason = applicable(cfg, shape.name)
    if not ok:
        art["skipped"] = reason
        return art
    shd.set_param_rules(rules)
    placed = placed and mesh is not None
    art["placed"] = placed
    t0 = time.perf_counter()
    art.update(count_step(build_cell(cfg, shape, mesh, rules=rules,
                                     placed=placed)))
    art["wall_s"] = time.perf_counter() - t0
    return art


def run_cell(arch: str, shape_name: str, mesh_name: str, *,
             overrides: Optional[Dict[str, Any]] = None,
             tag: str = "", rules: str = "default", mesh: Any = None,
             verbose: bool = True) -> Dict[str, Any]:
    """One production cell's artifact, every kind placed.
    ``mesh``: the production mesh of ``mesh_name`` already built
    (``main`` builds one a world); else the cell makes its fake world and
    mesh and destroys the world after."""
    if mesh is None:
        with fake_world(MESH_WORLD[mesh_name]):
            return run_cell(arch, shape_name, mesh_name, overrides=overrides,
                            tag=tag, rules=rules, verbose=verbose,
                            mesh=production_mesh(mesh_name))
    cfg = get_config(arch)
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    art = cell_artifact(cfg, SHAPES[shape_name], mesh, arch=arch,
                        mesh_name=mesh_name, tag=tag, rules=rules,
                        overrides=overrides, placed=True)
    if verbose and "skipped" not in art:
        mem = art["memory"]
        print(f"[{arch} | {shape_name} | {mesh_name}] "
              f"wall {art['wall_s']:.1f}s  "
              f"flops/dev {art['cost']['flops']:.3e}  "
              f"bytes/dev {art['cost']['bytes_accessed']:.3e}  "
              f"peak/dev {mem['peak_per_device'] / 2**30:.2f} GiB "
              f"(fits {mem['fits']})  "
              f"coll/dev {art['collectives']['total'] / 2**20:.1f} MiB",
              flush=True)
    return art


def artifact_path(arch: str, shape_name: str, mesh_name: str,
                  tag: str = "", out: pathlib.Path = RESULTS
                  ) -> pathlib.Path:
    t = f"--{tag}" if tag else ""
    return pathlib.Path(out) / f"{arch}--{shape_name}--{mesh_name}{t}.json"


def parse_override(ov: str) -> Tuple[str, Any]:
    k, v = ov.split("=", 1)
    return k, (False if v == "False" else True if v == "True"
               else int(v) if v.lstrip("-").isdigit() else
               float(v) if "." in v else v)


def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser(prog="python -m repro_torch.launch.dryrun")
    p.add_argument("--arch", choices=ARCH_NAMES)
    p.add_argument("--shape", choices=list(SHAPES))
    p.add_argument("--mesh", choices=list(MESH_WORLD), default="pod")
    p.add_argument("--all", action="store_true")
    p.add_argument("--cell", action="append", default=[],
                   metavar="ARCH:SHAPE:MESH",
                   help="a cell to run (repeatable; port-only)")
    p.add_argument("--force", action="store_true")
    p.add_argument("--tag", default="")
    p.add_argument("--rules", default="default",
                   choices=["default", "dp_only"],
                   help="parameter-sharding rule set (perf experiments)")
    p.add_argument("--override", action="append", default=[],
                   help="ModelConfig field override, e.g. remat=False")
    p.add_argument("--out", type=pathlib.Path, default=RESULTS,
                   help="artifact directory (default results/dryrun_torch)")
    args = p.parse_args(argv)
    overrides = dict(parse_override(ov) for ov in args.override)

    if args.all:
        cells = [(a, s, m) for a in ARCH_NAMES for s in SHAPES
                 for m in MESH_WORLD]
    elif args.cell:
        cells = [tuple(c.split(":")) for c in args.cell]
        for a, s, m in cells:
            if a not in ARCH_NAMES or s not in SHAPES or m not in MESH_WORLD:
                p.error(f"no cell {a}:{s}:{m}")
    else:
        if not (args.arch and args.shape):
            p.error("--arch and --shape, --cell or --all")
        cells = [(args.arch, args.shape, args.mesh)]

    args.out.mkdir(parents=True, exist_ok=True)
    failures, rows = 0, []
    t_all = time.perf_counter()
    for mesh_name in MESH_WORLD:            # one world at a time
        todo = []
        for a, s, m in cells:
            if m != mesh_name:
                continue
            if not args.force and artifact_path(a, s, m, args.tag,
                                                args.out).exists():
                print(f"[skip existing] {a}--{s}--{m}")
            else:
                todo.append((a, s))
        if not todo:
            continue
        with fake_world(MESH_WORLD[mesh_name]):
            mesh = production_mesh(mesh_name)
            for arch, s in todo:
                path = artifact_path(arch, s, mesh_name, args.tag, args.out)
                try:
                    art = run_cell(arch, s, mesh_name,
                                   overrides=overrides or None,
                                   tag=args.tag, rules=args.rules, mesh=mesh)
                    art["rules"] = args.rules
                    path.write_text(json.dumps(art, indent=1))
                    if "skipped" not in art:
                        rows.append(roofline_from_artifacts(art))
                except Exception:           # noqa: BLE001 — next cell
                    failures += 1
                    print(f"[FAIL] {arch} {s} {mesh_name}")
                    traceback.print_exc()
    if rows:
        print(format_table(rows, title="dry-run roofline (model figures at "
                           "H100 SXM peaks, not card measurements)"))
    print(f"dry-run: {len(cells)} cells, {len(rows)} run, {failures} failed, "
          f"wall {time.perf_counter() - t_all:.1f} s", flush=True)
    return 1 if failures else 0


if __name__ == "__main__":
    raise SystemExit(main())
