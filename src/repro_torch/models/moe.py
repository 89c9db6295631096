"""Mixture-of-Experts layer on tensors (dbrx / arctic / jamba; port of
``repro.models.moe``).

The reference's four execution paths, chosen by the model's layer walk:

  moe()        — the no-mesh path: top-k routing, then the capacity
                 dispatch (a stable sort of the (token, expert) pairs by
                 expert, each expert's first C of them kept) into (B, E, C,
                 D) buffers, the expert FFN on them, and the combine.
  moe_ep()     — expert parallelism over a mesh's ``model`` axis: every
                 rank routes the whole sequence, keeps the pairs of its
                 own E/tp experts, runs them and combines its partial
                 output; one all-reduce over ``model`` sums the partials.
  moe_ep_a2a() — the sequence split over ``model``: each rank routes its
                 S/tp positions into capacity-bounded buffers for all E
                 experts (C the capacity at S/tp), one all-to-all ships
                 them to the experts' owners, a second brings the outputs
                 back, and the output's slices are gathered.
  moe_decode() — the decode path: every expert runs on every token and a
                 sparse (T, E) weight matrix combines them.

The mesh paths take ``x`` whole, the same on every rank of the mesh, and
return the whole output on every rank: the port has no GSPMD, so the
layers around them run replicated (``models/model.py``).  They do not
split the batch over the mesh's other axes.  Their collectives are the
conjugate pairs of ``repro_torch.parallel.collectives``, so the gradients
through them are the no-mesh path's where the loss is the same on every
rank.  The expert weights may be whole (E, ...) or this rank's slab of
E/tp experts (``parallel.sharding.expert_slabs``).

The expert FFN is three batched products, ``torch.bmm`` here as they are
``jnp.einsum`` there: the reference does not route them through its GEMM
kernel or dispatch, so neither does the port.

Every op here can be captured in a CUDA graph: C comes from the static
sequence length, expert counts are a ``scatter_add_`` into a fixed-size
tensor (``bincount`` and ``one_hot`` read their input on the host), and no
boolean-mask indexing is used.  The combine is deterministic: each token
adds its k expert outputs one at a time in ascending expert id, the order
in which the reference's slot-major scatter-add adds them, with no atomics.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.parallel import collectives as col
from repro_torch.parallel.sharding import mesh_axes

from .layers import Params, dense_init, stacked_init

MOE_KEYS = ("router", "w_gate", "w_up", "w_down")


def init_moe(gen: torch.Generator, d_model: int, d_ff: int, n_experts: int,
             dtype: torch.dtype, stack: Tuple[int, ...] = ()) -> Params:
    """Random MoE parameters from ``gen``, each leaf with the leading dims
    ``stack``: the router (d, E) in fp32, ``w_gate`` and ``w_up`` (E, d, f)
    and ``w_down`` (E, f, d) in ``dtype``.  The experts are filled one
    (d, f) slice at a time, so no fp32 copy of a whole stacked expert
    tensor is ever made."""
    experts = (*stack, n_experts)
    return {
        "router": dense_init(gen, (*stack, d_model, n_experts),
                             torch.float32, fan_in=d_model),
        "w_gate": stacked_init(gen, experts, (d_model, d_ff), dtype),
        "w_up": stacked_init(gen, experts, (d_model, d_ff), dtype),
        "w_down": stacked_init(gen, experts, (d_ff, d_model), dtype),
    }


def _route(router_logits: torch.Tensor, top_k: int
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(T, E) -> (weights (T, k), expert ids (T, k)), the weights in
    descending order and renormalised to sum to 1."""
    probs = torch.softmax(router_logits.float(), dim=-1)
    w, idx = torch.topk(probs, top_k, dim=-1)
    w = w / torch.clamp(w.sum(-1, keepdim=True), min=1e-9)
    return w, idx


def _aux_loss(logits: torch.Tensor, idx: torch.Tensor, n_experts: int
              ) -> torch.Tensor:
    """Switch load-balancing loss: E * sum_e f_e * p_e, f_e the share of
    tokens whose first choice is expert e."""
    me = torch.softmax(logits.float(), dim=-1).reshape(-1, n_experts).mean(0)
    first = idx[..., 0].reshape(-1)
    fe = torch.zeros(n_experts, dtype=torch.float32, device=idx.device
                     ).scatter_add_(0, first, torch.ones_like(
                         first, dtype=torch.float32)) / first.numel()
    return n_experts * torch.sum(me * fe)


def _capacity(S: int, top_k: int, n_experts: int, cf: float) -> int:
    return max(int(math.ceil(S * top_k * cf / n_experts)), 1)


def _dispatch(x: torch.Tensor, idx: torch.Tensor, *, n_experts: int,
              C: int, e_first: int = 0, e_count: Optional[int] = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B, S, D), idx (B, S, k) -> (buffers (B, e_count, C, D) of the
    experts e_first .. e_first + e_count - 1 (all E by default), the slot
    of each (token, choice) pair (B, S, k), e_count*C where it was dropped
    or its expert is not in the range), each row on its own as the
    reference's ``_dispatch_row``.

    The (token, choice) pairs, token-major, are sorted by expert (stable);
    a pair's rank inside its expert is its slot there, and a pair ranked C
    or later is dropped.  Each kept pair's token fills its slot by one
    gather; an empty slot holds zeros."""
    B, S, D = x.shape
    E, k = n_experts, idx.shape[-1]
    e_count = E if e_count is None else e_count
    dev = x.device
    n_slots = e_count * C
    flat_e = idx.reshape(B, S * k)
    flat_t = torch.arange(S * k, device=dev) // k           # (S*k,)
    order = torch.argsort(flat_e, dim=-1, stable=True)       # (B, S*k)
    sorted_e = torch.gather(flat_e, 1, order)
    counts = torch.zeros((B, E), dtype=torch.long, device=dev).scatter_add_(
        1, flat_e, torch.ones_like(flat_e))
    start = torch.cumsum(counts, dim=1) - counts
    pos = torch.arange(S * k, device=dev)[None, :] - torch.gather(
        start, 1, sorted_e)                                  # slot in expert
    keep = pos < C
    if e_count != E:                    # a rank's slab of the experts
        keep = keep & (sorted_e >= e_first) & (sorted_e < e_first + e_count)
    slot = torch.where(keep, (sorted_e - e_first) * C + pos,
                       torch.full_like(pos, n_slots))
    # which token fills each slot (the sentinel slot n_slots takes every
    # dropped pair and is cut off; the kept slots are unique)
    slot_tok = torch.zeros((B, n_slots + 1), dtype=torch.long,
                           device=dev).scatter_(1, slot, flat_t[order])
    slot_valid = torch.zeros((B, n_slots + 1), dtype=torch.bool,
                             device=dev).scatter_(1, slot, keep)
    slot_tok, slot_valid = slot_tok[:, :-1], slot_valid[:, :-1]
    rows = torch.arange(B, device=dev)[:, None]
    buf = x[rows, slot_tok] * slot_valid[..., None].to(x.dtype)
    # the combine's inverse
    pair_slot = torch.empty_like(slot).scatter_(1, order, slot)
    return buf.reshape(B, e_count, C, D), pair_slot.reshape(B, S, k)


def _combine(ye: torch.Tensor, w: torch.Tensor, idx: torch.Tensor,
             pair_slot: torch.Tensor) -> torch.Tensor:
    """ye (B, E*C, D) expert outputs -> out (B, S, D) in ye's dtype: each
    token's kept outputs, weighted (the weight rounded to ye's dtype
    first, as the reference does), summed one ``+`` at a time in ascending
    expert id.  A dropped pair (the sentinel slot, ye's length) adds
    zero."""
    B, n_slots, D = ye.shape
    k = idx.shape[2]
    ye = torch.cat([ye, ye.new_zeros((B, 1, D))], dim=1)     # sentinel row
    by_expert = torch.argsort(idx, dim=-1)                   # k distinct ids
    wt = torch.gather(w * (pair_slot < n_slots), 2, by_expert).to(ye.dtype)
    pair_slot = torch.gather(pair_slot, 2, by_expert)
    rows = torch.arange(B, device=ye.device)[:, None, None]
    contrib = ye[rows, pair_slot] * wt[..., None]            # (B, S, k, D)
    out = contrib[:, :, 0]
    for j in range(1, k):
        out = out + contrib[:, :, j]
    return out


def _expert_ffn(buffers: torch.Tensor, wg: torch.Tensor, wu: torch.Tensor,
                wd: torch.Tensor) -> torch.Tensor:
    """(B, E, C, D) x (E, D, F) -> (B, E, C, D): three batched products
    over the experts, on the (B*C, D) rows of each."""
    B, E, C, D = buffers.shape
    xe = buffers.transpose(0, 1).reshape(E, B * C, D)
    g = torch.bmm(xe, wg)
    u = torch.bmm(xe, wu)
    y = torch.bmm(F.silu(g) * u, wd)
    return y.reshape(E, B, C, D).transpose(0, 1)


def moe(p: Params, x: torch.Tensor, *, n_experts: int, top_k: int,
        capacity_factor: float = 1.25) -> Tuple[torch.Tensor, torch.Tensor]:
    """The capacity path: x (B, S, D) -> (out (B, S, D) in x's dtype, the
    fp32 load-balancing loss)."""
    B, S, D = x.shape
    E = n_experts
    C = _capacity(S, top_k, E, capacity_factor)
    logits = torch.matmul(x.float(), p["router"])            # (B, S, E)
    w, idx = _route(logits.reshape(B * S, E), top_k)
    w, idx = w.reshape(B, S, top_k), idx.reshape(B, S, top_k)
    aux = _aux_loss(logits, idx, E)
    buffers, pair_slot = _dispatch(x, idx, n_experts=E, C=C)
    ye = _expert_ffn(buffers, p["w_gate"], p["w_up"], p["w_down"])
    out = _combine(ye.reshape(B, E * C, D), w, idx, pair_slot)
    return out.to(x.dtype), aux


def _mesh_rank(mesh, model_axis: str) -> Tuple[object, int, int]:
    """(the ``model_axis`` group, its size, this rank's place in it)."""
    return (mesh.get_group(model_axis), mesh_axes(mesh)[model_axis],
            mesh.get_local_rank(model_axis))


def _slab(w: torch.Tensor, n_experts: int, e_first: int, e_loc: int
          ) -> torch.Tensor:
    """The (e_loc, ...) slab of experts from ``e_first`` of an expert
    leaf given whole (E, ...) or as that slab already."""
    if w.shape[0] == e_loc:
        return w
    if w.shape[0] != n_experts:
        raise ValueError(f"expert leaf of {w.shape[0]} experts, neither "
                         f"{n_experts} nor a slab of {e_loc}")
    return w.narrow(0, e_first, e_loc)


def moe_ep(p: Params, x: torch.Tensor, *, n_experts: int, top_k: int,
           capacity_factor: float, mesh, model_axis: str = "model"
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Expert-parallel path: x (B, S, D), the same on every rank, -> (out
    (B, S, D) on every rank, the fp32 aux loss).  Each rank routes every
    position (so the aux loss is the no-mesh path's), dispatches the
    pairs of its experts e_first = rank * E/tp onwards at the no-mesh
    capacity, runs them and combines its partial output; one all-reduce
    over ``model_axis`` sums the partials (the reference's ``psum``)."""
    B, S, D = x.shape
    E = n_experts
    group, tp, rank = _mesh_rank(mesh, model_axis)
    e_loc = E // tp
    e_first = rank * e_loc
    C = _capacity(S, top_k, E, capacity_factor)
    logits = torch.matmul(x.float(), p["router"])            # (B, S, E)
    w, idx = _route(logits.reshape(B * S, E), top_k)
    w, idx = w.reshape(B, S, top_k), idx.reshape(B, S, top_k)
    aux = _aux_loss(logits, idx, E)
    # the routing is the same on every rank; what enters the rank's
    # experts is a part of the whole, so its gradient sums over the group
    xp, wp = col.copy_to(x, group), col.copy_to(w, group)
    buffers, pair_slot = _dispatch(xp, idx, n_experts=E, C=C,
                                   e_first=e_first, e_count=e_loc)
    ye = _expert_ffn(buffers, *(_slab(p[k], E, e_first, e_loc)
                                for k in ("w_gate", "w_up", "w_down")))
    part = _combine(ye.reshape(B, e_loc * C, D), wp, idx, pair_slot)
    return col.reduce_from(part, group).to(x.dtype), aux


def moe_ep_a2a(p: Params, x: torch.Tensor, *, n_experts: int, top_k: int,
               capacity_factor: float, mesh, model_axis: str = "model"
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """All-to-all expert parallelism: x (B, S, D), the same on every rank,
    -> (out (B, S, D) on every rank, the aux loss).  Each rank takes its
    S/tp positions, routes them (its aux loss averaged over ``model_axis``,
    the reference's ``pmean``) and dispatches them into (E, C) buffers, C
    the capacity at S/tp per (source rank, expert), so a pair the no-mesh
    path keeps may be dropped here.  One all-to-all ships each expert's
    buffers to its owner, the owner runs its E/tp experts on the tp*C rows
    it received, a second all-to-all returns them, and each rank combines
    its positions; the slices are gathered over ``model_axis``."""
    B, S, D = x.shape
    E = n_experts
    group, tp, rank = _mesh_rank(mesh, model_axis)
    e_loc, S_loc = E // tp, S // tp
    C = _capacity(S_loc, top_k, E, capacity_factor)   # per (src, expert)
    x_loc = col.split_to(x, group, 1)                 # (B, S_loc, D)
    router = col.copy_to(p["router"], group)
    logits = torch.matmul(x_loc.float(), router)
    w, idx = _route(logits.reshape(B * S_loc, E), top_k)
    w, idx = w.reshape(B, S_loc, top_k), idx.reshape(B, S_loc, top_k)
    aux = col.mean_from(_aux_loss(logits, idx, E), group)
    buffers, pair_slot = _dispatch(x_loc, idx, n_experts=E, C=C)
    # (tp = destination, B, e_loc, C, D) -> (tp = source, ...)
    send = buffers.reshape(B, tp, e_loc, C, D).transpose(0, 1)
    recv = col.all_to_all(send, group)
    xe = recv.permute(1, 2, 0, 3, 4).reshape(B, e_loc, tp * C, D)
    ye = _expert_ffn(xe, *(_slab(p[k], E, rank * e_loc, e_loc)
                           for k in ("w_gate", "w_up", "w_down")))
    back = ye.reshape(B, e_loc, tp, C, D).permute(2, 0, 1, 3, 4)
    ret = col.all_to_all(back, group)                 # the slot layout again
    y = ret.transpose(0, 1).reshape(B, E * C, D)
    out = _combine(y, w, idx, pair_slot)
    return col.gather_from(out, group, 1).to(x.dtype), aux


def moe_decode(p: Params, x: torch.Tensor, *, n_experts: int, top_k: int
               ) -> torch.Tensor:
    """The decode path: x (B, S, D) -> out (B, S, D).  Every expert runs
    on every token; the outputs combine in fp32 through the (T, E) matrix
    of the routing weights."""
    B, S, D = x.shape
    T = B * S
    logits = torch.matmul(x.float(), p["router"]).reshape(T, n_experts)
    w, idx = _route(logits, top_k)                           # (T, k)
    # the tokens broadcast over the experts; the expert weights are read
    # in place (E, D, F)
    xt = x.reshape(T, D).expand(n_experts, T, D)
    g = torch.bmm(xt, p["w_gate"])                           # (E, T, F)
    u = torch.bmm(xt, p["w_up"])
    y = torch.bmm(F.silu(g) * u, p["w_down"])                # (E, T, D)
    # the k ids of a token are distinct: a scatter, no accumulation
    we = torch.zeros((T, n_experts), dtype=torch.float32,
                     device=x.device).scatter_(1, idx, w)
    out = torch.einsum("etd,te->td", y.float(), we)
    return out.reshape(B, S, D).to(x.dtype)
