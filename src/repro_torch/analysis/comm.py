"""Collective-communication byte accounting (the port's counterpart of
``repro.analysis.hlo``).

The reference parses the collectives out of partitioned HLO text.  The
port has no compiler between it and the wire: every collective it issues
goes through ``repro_torch.parallel.collectives``, which reports each one
here as it is issued.  Inside :func:`record` those reports are kept.

Byte counting keeps the reference's convention: per collective, the
RESULT buffer on one device (all-gather: the gathered buffer; all-reduce:
the reduced buffer; all-to-all: the received buffer; a ring shift: the
received block).  No dtype is rescaled: the reference's
``normalize_bits`` corrects XLA:CPU's f32 lowering of bf16 programs, and
the port sends what it computes in.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Dict, Iterable, Iterator, List, Tuple

import numpy as np
import torch

COLLECTIVE_KINDS = ("all-gather", "all-reduce", "reduce-scatter",
                    "all-to-all", "collective-permute")

# torch dtype -> the HLO element type name the reference prints
_HLO_NAMES = {torch.bool: "pred", torch.int8: "s8", torch.uint8: "u8",
              torch.int16: "s16", torch.bfloat16: "bf16",
              torch.float16: "f16", torch.int32: "s32",
              torch.float32: "f32", torch.int64: "s64",
              torch.float64: "f64"}


@dataclasses.dataclass
class CollectiveOp:
    kind: str
    dtype: str
    shape: Tuple[int, ...]
    bytes: int


_RECORDINGS: List[List[CollectiveOp]] = []
_ISSUING = 0


@contextlib.contextmanager
def issuing() -> Iterator[None]:
    """The block runs a collective's backend call: the tensor ops the
    backend makes inside it (gloo's flattening copies, the fake process
    group's) are the transport's, not the program's, and a counter of
    the program's ops (``launch.dryrun.counting``) skips them."""
    global _ISSUING
    _ISSUING += 1
    try:
        yield
    finally:
        _ISSUING -= 1


def in_collective() -> bool:
    """Is a collective's backend call running (:func:`issuing`)?"""
    return _ISSUING > 0


@contextlib.contextmanager
def record() -> Iterator[List[CollectiveOp]]:
    """Collect every collective the port issues inside the block, in
    order, into the list it yields (nested blocks each see all of them)."""
    ops: List[CollectiveOp] = []
    _RECORDINGS.append(ops)
    try:
        yield ops
    finally:
        _RECORDINGS.remove(ops)


def note(kind: str, result: torch.Tensor) -> None:
    """Report one collective whose per-device result is ``result``."""
    if kind not in COLLECTIVE_KINDS:
        raise ValueError(f"unknown collective kind {kind!r}")
    if not _RECORDINGS:
        return
    op = CollectiveOp(kind=kind, dtype=_HLO_NAMES.get(result.dtype,
                                                      str(result.dtype)),
                      shape=tuple(result.shape),
                      bytes=result.numel() * result.element_size())
    for ops in _RECORDINGS:
        ops.append(op)


def collective_bytes(ops: Iterable[CollectiveOp]) -> Dict[str, int]:
    """Per-kind byte totals (+ 'total'), as the reference's
    ``collective_bytes`` gives them for an HLO module."""
    totals: Dict[str, int] = {}
    for op in ops:
        totals[op.kind] = totals.get(op.kind, 0) + op.bytes
    return _sum(totals)


def _sum(totals: Dict[str, int]) -> Dict[str, int]:
    """Every kind (0 where absent) and their 'total'."""
    out = {k: totals.get(k, 0) for k in COLLECTIVE_KINDS}
    out["total"] = sum(out.values())
    return out


def moe_bytes(path: str, *, B: int, S: int, D: int, n_experts: int,
              top_k: int, capacity_factor: float, tp: int,
              itemsize: int) -> Dict[str, int]:
    """The forward collectives of one MoE layer's mesh path on one rank
    (``models/moe.py``), x (B, S, D) whole on every rank:

      moe_ep      all-reduce of the (B, S, D) partial output;
      moe_ep_a2a  two all-to-alls of (tp, B, E/tp, C, D) buffers, C the
                  capacity at S/tp; the fp32 aux loss's all-reduce; the
                  all-gather of the (B, S, D) output."""
    act = B * S * D * itemsize
    if path == "moe_ep":
        return _sum({"all-reduce": act})
    if path != "moe_ep_a2a":
        raise ValueError(f"no mesh path {path!r}")
    C = max(int(math.ceil((S // tp) * top_k * capacity_factor / n_experts)),
            1)
    return _sum({"all-to-all": 2 * tp * B * (n_experts // tp) * C * D
                 * itemsize, "all-reduce": 4, "all-gather": act})


def pipeline_bytes(*, n_micro: int, n_stages: int, micro_bytes: int
                   ) -> Dict[str, int]:
    """The collectives of ``parallel.pipeline.pipeline_apply`` on one
    rank: a ring shift of one microbatch's activation a tick (none on one
    stage) and the all-reduce of the (n_micro, ...) outputs."""
    ticks = n_micro + n_stages - 1
    return _sum({"collective-permute": ticks * micro_bytes
                 if n_stages > 1 else 0,
                 "all-reduce": n_micro * micro_bytes})


def placed_bytes(cfg, *, B: int, S: int, sizes: Dict[str, int],
                 kind: str, adamw: bool = False) -> Dict[str, int]:
    """The collectives of one rank's placed step (``models/placed.py``)
    for a decoder of (attention, SwiGLU) layers with no frontend: a
    ``train`` step (``loss_fn`` forward and backward, and with ``adamw``
    the update's global norm, as the dry-run's train cell runs it), a
    ``prefill`` or a ``decode`` step, on B rows of S tokens (the whole
    batch; a decode step's one token a row, B divided by the batch axes)
    over a mesh of ``sizes`` ({axis: size}; ``data``, ``model`` and
    optionally ``pod``).  Where
    ``cfg.remat``, each repeat's forward collectives run again in its
    recompute, but for its last ``seq_scatter``: ``torch.utils.checkpoint``
    stops the recompute once every tensor the backward needs is back, as
    it does the logit chunk's before its argmax.

    Forward: each weight's gathers (``fsdp_gather``: the gathered block),
    the residual's ``seq_gather`` (all-gather) and ``seq_scatter``
    (reduce-scatter of the rank's chunk) around a TP block, K and V
    gathered, the head's vocab-parallel all-reduces a logit chunk (max,
    sum of exponentials, target logit, argmax: fp32 and int64), the loss
    sums and the aux mean over the batch axes.  Backward: a
    reduce-scatter of each gather's input, an all-gather for each
    ``seq_scatter``, and an all-reduce of each leaf over every axis it is
    not split on (``Placement.enter``).  The global norm
    (``optim.adamw.global_norm``): an fp32 scalar all-reduced over each
    axis of each set of axes that leaves are split on.

    Decode: each weight's gathers; the lookup's all-reduce over
    ``model``; q, K and V gathered over their heads where they are
    column-parallel; the log-sum-exp combine's three all-reduces (the
    max and the sum of exponentials, fp32 (B/dp, H), the accumulator
    fp32 (B/dp, H, hd)); an all-reduce of the (B/dp, 1, D) output after
    a row-parallel ``wo`` and ``w_down``; the logits' vocab slices
    gathered, fp32."""
    from repro_torch.models.model import ATTN, DENSE, param_shapes
    from repro_torch.parallel import sharding as shd
    if cfg.pattern != ((ATTN, DENSE),) or cfg.is_encdec or \
            cfg.frontend != "none":
        raise NotImplementedError("placed_bytes covers (attention, dense) "
                                  "decoders with no frontend")

    class _Mesh:
        axis_names = tuple(sizes)
        devices = np.empty(tuple(sizes.values()))
    mesh = _Mesh()
    tp = sizes.get("model", 1)
    bat = [a for a in ("pod", "data") if a in sizes]
    dp = math.prod(sizes[a] for a in bat)
    e = torch.finfo(cfg.dtype).bits // 8
    Bl, D, H, G, hd, F = (B // dp, cfg.d_model, cfg.n_heads, cfg.n_kv,
                          cfg.hd, cfg.d_ff)
    train = kind == "train"
    tot = {k: 0 for k in COLLECTIVE_KINDS}

    def weight(path: str, shape, model_dim=None) -> Tuple[int, int]:
        spec = shd.logical_to_spec(shd._axes_for(path, len(shape), False),
                                   shape, mesh)
        cur = list(shd.local_shape(shape, spec, mesh))
        fwd = bwd = 0
        for d, entry in enumerate(spec):
            for a in reversed(shd.spec_axes(entry)):
                if a == "model" and d == model_dim:
                    continue
                bwd += math.prod(cur) * e
                cur[d] *= sizes[a]
                fwd += math.prod(cur) * e
        return fwd, bwd

    def add(fwd: Dict[str, int], bwd: Dict[str, int], times: int = 1
            ) -> None:
        for k, v in fwd.items():
            tot[k] += times * v
        if train:
            for k, v in bwd.items():
                tot[k] += times * v

    if kind == "decode":
        return _decode_bytes(cfg, weight, Bl=Bl, tp=tp, e=e)
    act, chunk = Bl * S * D * e, Bl * (S // tp) * D * e
    kv = 2 * Bl * S * G * hd * e
    # one repeat: attention, MLP
    f = {"all-gather": 0, "reduce-scatter": 0}
    b = {"all-gather": 0, "reduce-scatter": 0}
    head_tp = H % tp == 0
    kv_tp = head_tp and G % tp == 0
    shapes = {"wq": (D, H * hd), "wk": (D, G * hd), "wv": (D, G * hd),
              "wo": (H * hd, D)}
    for name, shape in shapes.items():
        col = {"wq": 1, "wk": 1, "wv": 1, "wo": 0}[name]
        tp_dim = col if (head_tp if name in ("wq", "wo") else kv_tp) else None
        wf, wb = weight(f"attn/{name}", shape, tp_dim)
        f["all-gather"] += wf
        b["reduce-scatter"] += wb
    f["all-gather"] += kv                   # K and V, every head/position
    b["reduce-scatter"] += kv // tp
    if head_tp:
        f["all-gather"] += act
        f["reduce-scatter"] += chunk
        b["reduce-scatter"] += chunk
        b["all-gather"] += act
    mlp_tp = cfg.mlp_tp and F % tp == 0
    for name, shape, dim in (("w_gate", (D, F), 1), ("w_up", (D, F), 1),
                             ("w_down", (F, D), 0)):
        wf, wb = weight(f"mlp/{name}", shape, dim if mlp_tp else None)
        f["all-gather"] += wf
        b["reduce-scatter"] += wb
    if mlp_tp:
        f["all-gather"] += act
        f["reduce-scatter"] += chunk
        b["reduce-scatter"] += chunk
        b["all-gather"] += act
    add(f, b, cfg.n_repeats)
    if train and cfg.remat:
        add({**f, "reduce-scatter": f["reduce-scatter"]
             - (chunk if mlp_tp else 0)}, {}, cfg.n_repeats)

    # the embedding (vocab-parallel), then the head
    V = cfg.padded_vocab
    ef, eb = weight("embed", (V, D), 0)
    add({"all-gather": ef, "reduce-scatter": chunk},
        {"reduce-scatter": eb, "all-gather": act})
    if train:
        n = S - 1
        add({"all-gather": act + ef}, {"reduce-scatter": chunk + eb})
        # a chunk's max, sum of exponentials, target logit (fp32) and
        # argmax (int64); the recompute stops before the argmax
        tot["all-reduce"] += Bl * n * (2 * 3 * 4 + 8)
        tot["all-reduce"] += 4 * len(bat)    # aux mean
        tot["all-reduce"] += 3 * 4 * len(bat)  # mask count, loss, correct
        shapes_tree = param_shapes(cfg)
        split_on = set()
        for shape, ns in zip(_leaves(shapes_tree),
                             _leaves(shd.param_shardings(shapes_tree, mesh))):
            spec = ns.spec
            axes = {a for en in spec for a in shd.spec_axes(en)}
            split_on.add(frozenset(axes))
            local = math.prod(shd.local_shape(shape, spec, mesh)) * e
            tot["all-reduce"] += local * sum(
                1 for a in (*bat, "model") if a in sizes and a not in axes)
        if adamw:
            tot["all-reduce"] += 4 * sum(len(a) for a in split_on)
    else:
        tot["all-gather"] += Bl * tp * D * e + ef + Bl * V * 4
    return _sum(tot)


def _decode_bytes(cfg, weight, *, Bl: int, tp: int, e: int
                  ) -> Dict[str, int]:
    """:func:`placed_bytes` of a decode step (``weight``: its gather
    bytes of a leaf)."""
    D, H, G, hd, F = cfg.d_model, cfg.n_heads, cfg.n_kv, cfg.hd, cfg.d_ff
    q_tp, kv_tp = H % tp == 0, G % tp == 0
    mlp_tp = cfg.mlp_tp and F % tp == 0
    out = Bl * D * e
    ag = ar = 0
    for name, shape, col, split in (
            ("wq", (D, H * hd), 1, q_tp), ("wk", (D, G * hd), 1, kv_tp),
            ("wv", (D, G * hd), 1, kv_tp), ("wo", (H * hd, D), 0, q_tp)):
        ag += weight(f"attn/{name}", shape, col if split else None)[0]
    ag += Bl * H * hd * e * q_tp + 2 * Bl * G * hd * e * kv_tp
    ar += 2 * Bl * H * 4 + Bl * H * hd * 4 + out * q_tp
    for name, shape, col in (("w_gate", (D, F), 1), ("w_up", (D, F), 1),
                             ("w_down", (F, D), 0)):
        ag += weight(f"mlp/{name}", shape, col if mlp_tp else None)[0]
    ar += out * mlp_tp
    ef = weight("embed", (cfg.padded_vocab, D), 0)[0]
    return _sum({"all-gather": cfg.n_repeats * ag + 2 * ef
                 + Bl * cfg.padded_vocab * 4,
                 "all-reduce": cfg.n_repeats * ar + out})


def _leaves(tree) -> list:
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    return [tree]
