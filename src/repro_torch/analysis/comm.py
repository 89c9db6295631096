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
