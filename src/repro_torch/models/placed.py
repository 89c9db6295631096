"""The FSDP/TP placements of training, prefill and the decode step, each
of the reference's ``constrain`` sites written out as its collective
(ROADMAP A8.2 slice 2, A8.3).

Under ``parallel.sharding.use_rules(mesh, placed=True)`` the model runs
here on the rank's state: its block of every parameter
(``sharding.shard_params``: ``data`` FSDP, ``model`` TP / EP), its rows
of the batch (``sharding.shard_batch``: B over ``pod`` and ``data``) and
its block of the decode cache (``sharding.shard_cache``: the rows over
``pod`` and ``data``, a KV cache's length over ``model``, a Mamba
state's heads over ``model``).  dp is the product of ``pod`` and
``data``, tp the ``model`` axis.

Training and prefill.  The residual stream between blocks is the
reference's ``("batch", "seq", "none")``: x is (B/dp, S/tp, D) on every
rank, so the sequence must divide by tp.  ``rms_norm`` is per token and
runs on the rank's chunk.  Per site (reference lines in
``src/repro/models``):

  * embedding (``model.py:367``): ``embed`` (V, D) is ``("model",
    "fsdp")``; its D is gathered over ``data`` and the lookup is
    vocab-parallel (a token outside the rank's slice gives zero), then a
    ``seq_scatter`` over ``model`` sums the slices onto the rank's
    sequence chunk.  A vision frontend's patch embeddings come in on
    ``model`` rank 0 only, so the sum counts them once.
  * attention (``layers.py:253-269``): with ``n_heads % tp == 0``,
    Megatron head-TP: ``seq_gather`` x, ``wq`` column-parallel (the
    rank's ``n_heads/tp`` heads), K and V gathered to every KV head over
    ``model``, each local query head mapped to its global KV head
    ``h // group``, ``wo`` row-parallel and a ``seq_scatter``.  Else the
    reference's fallback, sequence-parallel queries: the rank's S/tp
    queries with ``wq`` and ``wo`` gathered over ``model``, the causal
    mask from ``q_start = rank * S/tp``, the output left on the rank's
    chunk.  K and V are column-parallel and gathered over their heads
    where ``n_kv % tp == 0`` (head-TP only), else each rank projects its
    own chunk with the weights gathered and K and V are gathered over
    the sequence.  Prefill writes the rank's L/tp block of the cache
    (positions ``rank * L/tp`` on) from the K and V gathered over the
    sequence, so decode takes the cache as prefill leaves it.
    Cross-attention takes K and V from the encoder memory, whole over the
    sequence on every ``model`` rank.
  * MLP (``layers.py:358-380``): with ``cfg.mlp_tp`` (and d_ff dividing
    by tp), ``seq_gather``, ``w_gate`` / ``w_up`` column-parallel,
    ``w_down`` row-parallel, ``seq_scatter``; else pure SP, the weights
    gathered whole and the tokens left on the chunk.
  * head and loss (``model.py`` ``_chunked_xent``): vocab-parallel, the
    sequence gathered, the logits of the rank's vocab slice formed
    ``logit_chunk`` positions at a time; the max, the sum of
    exponentials and the target's logit combined over ``model``
    (``_VocabLSE``: ``torch.logsumexp``'s forward and backward steps); the
    masked sum and its count summed over the data axes (the reference's
    global mean, not a mean of shard means).  Prefill's last-position
    logits are gathered over ``model``.
  * MoE (``model.py:281-307``): ``moe_ep`` / ``moe_ep_a2a`` take the
    rank's B/dp rows gathered over the sequence, the expert slabs'
    ``fsdp`` dim gathered on use; the aux loss is the mean over the data
    shards of each shard's (ROADMAP C13).
  * Mamba (``ssm.py:160-173``): where its heads H = 2·d_model /
    ``ssm_head_dim`` divide by tp, head-parallel TP (:func:`mamba`):
    ``seq_gather`` x, the fused in-projection on the rank's head-aligned
    columns (its heads of z, x and dt, the whole B and C), the conv, the
    scan and the gated norm on its H/tp heads (the norm's sum of squares
    all-reduced over ``model``), ``w_out`` row-parallel and a
    ``seq_scatter``.  Else every rank runs the mixer whole on its rows.
  * the encoder runs data-parallel: its weights gathered whole, each
    rank's rows whole over the sequence.

The decode step (``layers.py:331-339, 369-378``, ``moe.py:263-278``).  x
is the rank's (B/dp, 1, D), whole over ``model``; each block is a
column-parallel / row-parallel pair and an all-reduce over ``model``:

  * the lookup is vocab-parallel and all-reduced over ``model``; the
    head forms the rank's vocab slice of the logits, gathered over
    ``model``;
  * attention: q, K and V column-parallel where their heads divide by tp
    (else their weights gathered) and gathered over ``model`` to every
    head; the new K/V written by the rank that owns the slot's position
    in its L/tp block; each rank's partial softmax over its block (the
    max, the sum of exponentials and the accumulator of
    ``serve/flash_decode.py``) combined over ``model`` by the log-sum-exp
    (an all-reduce of the max, then of the rescaled sums), which moves
    O(B/dp·H·hd), never the cache (``flash_decode.py:69-73, 88-93``);
    ``wo`` row-parallel over the rank's heads and an all-reduce.
    Cross-attention projects the memory to K/V every step, on the rank's
    heads where they divide;
  * the MLP column / row-parallel and all-reduced where ``cfg.mlp_tp``
    and d_ff divides, else gathered whole;
  * ``moe_decode`` on the rank's slab of E/tp experts and an all-reduce
    where E divides by tp, else whole;
  * the Mamba mixer on the rank's heads with its conv and SSM state,
    ``w_out`` row-parallel and an all-reduce.

Every weight is gathered over ``data`` on use, as in training.  The
reference's ``decode_replicate_acts`` (each decode projection contracted
against the FSDP shard in place, the activations moved instead) has no
counterpart: no configuration sets it.

Gradients follow ``parallel.collectives``' placed convention: each rank
computes the gradient of its own share, a gathered tensor's gradient is
reduce-scattered back, and :meth:`Placement.enter` all-reduces every
leaf over each axis it is not split on (the batch axes: the ranks saw
other rows; ``model``: other positions, heads or vocab).  The MoE paths,
and the Mamba layers where their heads do not divide, run whole on every
``model`` rank under the conjugate pairs instead (``gather_from`` in,
``split_to`` out): their gradients come out whole and the same on every
``model`` rank, so their leaves (:attr:`Placement.whole_over_model`) are
not summed over ``model``.
"""

from __future__ import annotations

import functools
from typing import Any, Dict, Optional, Tuple

import torch
import torch.distributed as dist

from repro_torch.kernels import dispatch
from repro_torch.parallel import collectives as col
from repro_torch.parallel import sharding as shd

from . import layers as L
from . import moe as MOE
from . import ssm as SSM

Params = Dict[str, Any]

def mamba_heads(cfg) -> int:
    """The heads of ``cfg``'s Mamba mixer (0: it has none)."""
    return 2 * cfg.d_model // cfg.ssm_head_dim if cfg.ssm_state else 0


class Placement:
    """The active mesh as the placed layers read it: axis sizes, groups
    and this rank's place, and the spec of every leaf of ``cfg``'s tree
    (from ``models.param_shapes``)."""

    def __init__(self, cfg, mesh):
        from .model import param_shapes
        self.cfg, self.mesh = cfg, mesh
        self.sizes = shd.mesh_axes(mesh)
        self.tp = self.sizes.get("model", 1)
        self.batch_axes = shd.batch_axes(mesh)
        self.shapes = param_shapes(cfg)
        self.specs = shd.param_shardings(self.shapes, mesh)
        self._spec: Dict[Tuple[str, Tuple[int, ...]], Any] = {}
        # leaves whose gradient is whole on every ``model`` rank (the
        # layer runs whole there under the conjugate pairs): not
        # all-reduced over ``model``
        self.whole_over_model = ("moe/router",) + (
            () if shd.mamba_head_tp(mamba_heads(cfg), self.tp)
            else ("mamba/",))

    def group(self, axis: str):
        return self.mesh.get_group(axis)

    def rank(self, axis: str) -> int:
        return self.mesh.get_local_rank(axis) if axis in self.sizes else 0

    @property
    def mgroup(self):
        return self.group("model")

    def spec(self, path: str, shape: Tuple[int, ...]) -> shd.Spec:
        """The spec of a per-repeat leaf (``path`` relative to its repeat,
        e.g. ``attn/wq``) of global ``shape``: the stacked leaf's without
        its repeat dim."""
        key = (path, tuple(shape))
        if key not in self._spec:
            axes = shd._axes_for(path, len(shape), False)
            self._spec[key] = shd.logical_to_spec(axes, shape, self.mesh)
        return self._spec[key]

    def check(self, params: Params) -> None:
        """Raise unless every leaf of ``params`` is this rank's block."""
        def walk(tree, shapes, specs, path):
            if isinstance(tree, dict):
                for k, v in tree.items():
                    walk(v, shapes[k], specs[k], f"{path}/{k}" if path else k)
                return
            want = shd.local_shape(shapes, specs.spec, self.mesh)
            if tuple(tree.shape) != want:
                raise ValueError(
                    f"placed path: leaf {path} is {tuple(tree.shape)}, this "
                    f"rank's block is {want}: pass "
                    f"parallel.sharding.shard_params(params, mesh)")
        walk(params, self.shapes, self.specs, "")

    def enter(self, params: Params) -> Params:
        """``params`` with every leaf's gradient all-reduced over each
        mesh axis it is not split on (``collectives.copy_to``: identity
        forward), the leaves of :attr:`whole_over_model` not over
        ``model``.  Applied where autograd records only."""
        def one(path, t, s):
            axes = {a for e in s.spec for a in shd.spec_axes(e)}
            for a in (*self.batch_axes, "model"):
                if a not in self.sizes or a in axes:
                    continue
                if a == "model" and any(w in path
                                        for w in self.whole_over_model):
                    continue
                t = col.copy_to(t, self.group(a))
            return t
        return shd._map2(one, params, self.specs)

    def data_mean(self, t: torch.Tensor) -> torch.Tensor:
        """The mean of ``t`` over the batch axes (gradient / n back)."""
        for a in self.batch_axes:
            t = col.mean_from(t, self.group(a))
        return t

    def data_sum(self, t: torch.Tensor, grad: bool = True) -> torch.Tensor:
        """The sum of ``t`` over the batch axes (with ``grad`` the
        gradient passes unchanged, ``collectives.reduce_from``)."""
        for a in self.batch_axes:
            t = (col.reduce_from(t, self.group(a)) if grad
                 else col.all_reduce(t, self.group(a)))
        return t


@functools.lru_cache(maxsize=32)
def _placement(cfg, mesh) -> Placement:
    return Placement(cfg, mesh)


def placement(cfg) -> Optional[Placement]:
    """The active placement, or None outside ``use_rules(mesh,
    placed=True)``."""
    if not shd.placed():
        return None
    return _placement(cfg, shd.active_mesh())


def weight(pl: Placement, w: torch.Tensor, path: str,
           shape: Tuple[int, ...], model_dim: Optional[int] = None,
           whole_grads: bool = False) -> torch.Tensor:
    """The rank's block ``w`` of a per-repeat leaf of global ``shape``,
    gathered over every axis its spec splits it on (``fsdp_gather``),
    except ``model`` on ``model_dim``: there the rank keeps (or, where
    the leaf is whole over ``model``, takes) its own chunk.
    ``whole_grads``: the layer's gradients are the same on every
    ``model`` rank (the MoE paths' conjugate pairs), so the gather over
    ``model`` keeps the rank's chunk of the gradient and does not sum."""
    spec = pl.spec(path, shape)
    for d, entry in enumerate(spec):
        for a in reversed(shd.spec_axes(entry)):        # inner axis first
            if a == "model" and d == model_dim:
                continue
            if a == "model" and whole_grads:
                w = col.gather_from(w, pl.group(a), d)
            else:
                w = col.fsdp_gather(w, pl.group(a), d)
    if model_dim is not None and "model" not in shd.spec_axes(
            spec[model_dim]):
        n = w.shape[model_dim] // pl.tp
        w = w.narrow(model_dim, pl.rank("model") * n, n)
    return w


def project(pl: Placement, x: torch.Tensor, w: torch.Tensor, path: str,
            shape: Tuple[int, ...], model_dim: Optional[int] = None,
            cols=None) -> torch.Tensor:
    """x @ the rank's block of a per-repeat weight through
    ``dispatch.matmul2``: the block gathered as :func:`weight` gathers it
    (``model_dim``: the rank's own TP chunk), ``cols`` its ``(start,
    length)`` column ranges (``sharding.take``)."""
    wb = weight(pl, w, path, shape, model_dim)
    if cols is not None:
        wb = shd.take(wb, -1, cols)
    return dispatch.matmul2(x, wb)


def gather_whole(pl: Placement, p: Params, shapes: Params, path: str = "",
                 whole_grads: bool = False) -> Params:
    """Every leaf of a repeat's subtree ``p`` gathered whole
    (``whole_grads`` as for :func:`weight`)."""
    if isinstance(p, dict):
        return {k: gather_whole(pl, v, shapes[k], f"{path}/{k}" if path
                                else k, whole_grads) for k, v in p.items()}
    return weight(pl, p, path, shapes, whole_grads=whole_grads)


def repeat_shapes(tree: Params) -> Params:
    """A stacked subtree's shapes without the repeat dim."""
    if isinstance(tree, dict):
        return {k: repeat_shapes(v) for k, v in tree.items()}
    return tuple(tree[1:])


# ---------------------------------------------------------------------------
# embedding, head, loss
# ---------------------------------------------------------------------------

def _vocab_slice(pl: Placement, embed: torch.Tensor) -> Tuple[torch.Tensor,
                                                               int]:
    """(the rank's (V/tp, D) rows of the embedding, gathered over
    ``data``; its first vocab id)."""
    shape = pl.shapes["embed"]
    e = weight(pl, embed, "embed", shape, model_dim=0)
    return e, pl.rank("model") * e.shape[0]


def embed(pl: Placement, cfg, params: Params, batch: Dict[str, Any]
          ) -> torch.Tensor:
    """The rank's (B/dp, S/tp, D) chunk of the decoder's input."""
    tokens = batch["tokens"]
    e, v0 = _vocab_slice(pl, params["embed"])
    ids = tokens.to(e.device).long() - v0
    ok = (ids >= 0) & (ids < e.shape[0])
    x = e[torch.where(ok, ids, torch.zeros_like(ids))] * ok[..., None].to(
        e.dtype)
    if cfg.frontend == "vision" and "patch_embeds" in batch:
        pe = batch["patch_embeds"].to(device=x.device, dtype=cfg.dtype)
        if pl.rank("model"):
            pe = torch.zeros_like(pe)
        x = torch.cat([pe, x], dim=1)
    _check_seq(pl, x.shape[1])
    return col.seq_scatter(x, pl.mgroup, 1)


def embed_decode(pl: Placement, cfg, params: Params, tokens: torch.Tensor
                 ) -> torch.Tensor:
    """A decode step's input (B/dp, 1, D), whole over ``model``: the
    vocab-parallel lookup all-reduced over ``model``."""
    e, v0 = _vocab_slice(pl, params["embed"])
    ids = tokens.to(e.device).long() - v0
    ok = (ids >= 0) & (ids < e.shape[0])
    x = e[torch.where(ok, ids, torch.zeros_like(ids))] * ok[..., None].to(
        e.dtype)
    return col.all_reduce(x, pl.mgroup)


def decode_logits(pl: Placement, cfg, params: Params, x: torch.Tensor
                  ) -> torch.Tensor:
    """A decode step's (B/dp, V) logits of x (B/dp, 1, D): the rank's
    vocab slice, gathered over ``model``."""
    e, _ = _vocab_slice(pl, params["embed"])
    logits = torch.matmul(x, e.to(cfg.dtype).t()).float()
    return col.gather_from(logits, pl.mgroup, 2)[:, -1]


def _check_seq(pl: Placement, S: int) -> None:
    if S % pl.tp:
        raise NotImplementedError(
            f"placed path: the sequence ({S}) must divide over model = "
            f"{pl.tp}")


class _VocabLSE(torch.autograd.Function):
    """(logsumexp over the whole vocab, its max) from the rank's (...,
    V/tp) logits: the max all-reduced (MAX) and the sum of exponentials
    (SUM) over ``model``, then ``torch.logsumexp``'s own steps (an
    infinite max taken as 0, log of the sum plus the max); the gradient
    of the rank's logits is ``torch.logsumexp``'s backward on its slice,
    grad * exp(logits - lse), so one rank gives the no-mesh numbers."""

    @staticmethod
    def forward(ctx, logits, group):
        gmax = col.all_reduce(logits.amax(dim=-1), group,
                              op=dist.ReduceOp.MAX)
        gmax = gmax.masked_fill(gmax.abs() == float("inf"), 0.0)
        se = col.all_reduce((logits - gmax[..., None]).exp().sum(dim=-1),
                            group)
        lse = se.log() + gmax
        ctx.save_for_backward(logits, lse)
        ctx.mark_non_differentiable(gmax)
        return lse, gmax

    @staticmethod
    def backward(ctx, g, _g_max):
        logits, lse = ctx.saved_tensors
        return g[..., None] * (logits - lse[..., None]).exp(), None


def chunked_xent(pl: Placement, cfg, x: torch.Tensor, embed: torch.Tensor,
                 targets: torch.Tensor, mask: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``model._chunked_xent`` vocab-parallel: x the rank's (B/dp, S/tp,
    D) chunk of the final hidden states, targets and mask its rows (B/dp,
    S) aligned with the sequence; position t predicts t+1.  Returns the
    global (mean cross-entropy, accuracy) over the masked positions."""
    mg = pl.mgroup
    xs = col.seq_gather(x, mg, 1)[:, :-1]
    targets, mask = targets[:, 1:].long(), mask[:, 1:].float()
    B, S, _ = xs.shape
    ck = min(cfg.logit_chunk, S)
    e, v0 = _vocab_slice(pl, embed)
    w_t = e.to(cfg.dtype).t()
    vl = e.shape[0]
    record = L.recording(xs, e)

    def body(xc, tc, mc):
        logits = torch.matmul(xc, w_t).float()              # (B, ck, V/tp)
        lse, gmax = _VocabLSE.apply(logits, mg)
        ids = tc - v0
        ok = (ids >= 0) & (ids < vl)
        tl = torch.gather(logits, -1, torch.where(ok, ids, torch.zeros_like(
            ids))[..., None])[..., 0] * ok
        loss = torch.sum((lse - col.reduce_from(tl, mg)) * mc)
        # the first id that reaches the global max, as argmax gives it
        lmax, larg = logits.detach().max(dim=-1)
        cand = torch.where(lmax == gmax, larg + v0,
                           torch.full_like(larg, cfg.padded_vocab))
        pred = col.all_reduce(cand, mg, op=dist.ReduceOp.MIN)
        correct = torch.sum((pred == tc).float() * mc)
        return loss, correct

    loss_sum = torch.zeros((), dtype=torch.float32, device=x.device)
    correct = torch.zeros((), dtype=torch.float32, device=x.device)
    for lo in range(0, S, ck):
        sl = slice(lo, lo + ck)
        ls, c = L.maybe_checkpoint(body, xs[:, sl], targets[:, sl],
                                   mask[:, sl], record=record)
        loss_sum = loss_sum + ls
        correct = correct + c
    denom = torch.clamp(pl.data_sum(mask.sum(), grad=False), min=1.0)
    return (pl.data_sum(loss_sum) / denom,
            pl.data_sum(correct, grad=False) / denom)


def last_logits(pl: Placement, cfg, params: Params, x: torch.Tensor
                ) -> torch.Tensor:
    """Prefill's (B/dp, V) logits of the last position: x the rank's
    final hidden chunk; the last position (on the last ``model`` rank)
    gathered, its vocab slices gathered over ``model``."""
    mg = pl.mgroup
    last = col.gather_from(x[:, -1:], mg, 1)[:, -1:]
    e, _ = _vocab_slice(pl, params["embed"])
    logits = torch.matmul(last, e.to(cfg.dtype).t()).float()
    return col.gather_from(logits, mg, 2)[:, -1]


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------

def _kv_heads(k: torch.Tensor, h0: int, n_q: int, group: int
              ) -> torch.Tensor:
    """The KV heads of the query heads h0 .. h0+n_q-1 (head h reads KV
    head h // group), laid out so that local query head i reads head
    i // (n_q / heads kept) as ``_chunked_attention`` maps them."""
    if n_q % group == 0:
        return k.narrow(2, h0 // group, n_q // group)
    if group % n_q == 0:
        return k.narrow(2, h0 // group, 1)
    idx = torch.div(torch.arange(h0, h0 + n_q, device=k.device), group,
                    rounding_mode="floor")
    return k.index_select(2, idx)


def attention(pl: Placement, cfg, p: Params, shapes: Params,
              x: torch.Tensor, *, positions: torch.Tensor, causal: bool,
              qk_norm: bool, cache: Optional[Params] = None,
              memory: Optional[torch.Tensor] = None,
              path: str = "attn") -> torch.Tensor:
    """``layers.attention`` on the rank's chunk x (B/dp, S/tp, D): the
    chunk of the block's output.  ``positions`` (S,) are the global ones;
    ``cache`` (prefill, index 0) the rank's (B/dp, L/tp, G, hd) block,
    written from position ``rank * L/tp`` on; ``memory`` (B/dp, L_enc,
    D), whole on every rank, makes it cross-attention."""
    mg, tp, m = pl.mgroup, pl.tp, pl.rank("model")
    B, Sl, D = x.shape
    S = Sl * tp
    H, G, hd = cfg.n_heads, cfg.n_kv, cfg.hd
    eps, theta = cfg.norm_eps, cfg.rope_theta
    W = functools.partial(weight, pl)
    head_tp = H % tp == 0
    kv_tp = head_tp and G % tp == 0

    if head_tp:
        hl = H // tp
        xf = col.seq_gather(x, mg, 1)
        q = dispatch.matmul2(xf, W(p["wq"], f"{path}/wq", shapes["wq"],
                                   model_dim=1)).reshape(B, S, hl, hd)
        q_pos, q_start = positions, 0
    else:
        q = dispatch.matmul2(x, W(p["wq"], f"{path}/wq", shapes["wq"])
                             ).reshape(B, Sl, H, hd)
        q_start = m * Sl
        q_pos = positions[q_start:q_start + Sl]
    if qk_norm:
        q = L.rms_norm(q, p["q_norm"], eps)
    if memory is None:
        q = L.apply_rope(q, q_pos, theta)

    def kv(name: str, norm: Optional[torch.Tensor]) -> torch.Tensor:
        wname = f"{path}/{name}"
        if kv_tp:
            src = memory if memory is not None else xf
            t = dispatch.matmul2(src, W(p[name], wname, shapes[name],
                                        model_dim=1))
            t = t.reshape(B, src.shape[1], G // tp, hd)
        else:
            src = memory if memory is not None else x
            t = dispatch.matmul2(src, W(p[name], wname, shapes[name]))
            t = t.reshape(B, src.shape[1], G, hd)
        if norm is not None:
            t = L.rms_norm(t, norm, eps)
        if memory is None and name == "wk":
            pos = positions if kv_tp else positions[m * Sl:(m + 1) * Sl]
            t = L.apply_rope(t, pos, theta)
        if kv_tp:
            return col.seq_gather(t, mg, 2)             # every KV head
        if memory is None:
            return col.seq_gather(t, mg, 1)             # every position
        return t

    k = kv("wk", p["k_norm"] if qk_norm else None)
    v = kv("wv", None)
    kv_len = None
    if cache is not None:
        # the rank's L/tp block: positions m * L/tp onwards
        Lb = cache["k"].shape[1]
        lo = min(m * Lb, S)
        n = min(S - lo, Lb)
        cache["k"][:, :n] = k[:, lo:lo + n].to(cache["k"].dtype)
        cache["v"][:, :n] = v[:, lo:lo + n].to(cache["v"].dtype)
        kv_len = S
    if head_tp:
        k = _kv_heads(k, m * hl, hl, H // G)
        v = _kv_heads(v, m * hl, hl, H // G)
    is_causal = causal and memory is None
    if (head_tp and cfg.causal_block_skip and is_causal and cache is None
            and S % min(cfg.attn_chunk, S) == 0):
        out = L._block_causal_attention(q, k, v, chunk=cfg.attn_chunk)
    else:
        out = L._chunked_attention(q, k, v, causal=is_causal,
                                   q_start=q_start, kv_len=kv_len,
                                   chunk=cfg.attn_chunk)
    if head_tp:
        out = out.reshape(B, S, hl * hd)
        part = dispatch.matmul2(out, W(p["wo"], f"{path}/wo", shapes["wo"],
                                       model_dim=0))
        return col.seq_scatter(part, mg, 1)
    out = out.reshape(B, Sl, H * hd)
    return dispatch.matmul2(out, W(p["wo"], f"{path}/wo", shapes["wo"]))


def _write_owned(cache: torch.Tensor, new: torch.Tensor, idx, lo: int
                 ) -> None:
    """Write the new position ``new`` (B, 1, G, hd) of each slot into
    the rank's block ``cache`` (B, L/tp, G, hd) of a cache cut over its
    length, where the block (positions ``lo`` onwards) owns the slot's
    position ``idx`` (an int or per-slot (B,)); elsewhere the block keeps
    its value.  No collective: the owner alone writes."""
    Lb = cache.shape[1]
    new = new.to(cache.dtype)
    if not isinstance(idx, torch.Tensor):
        if lo <= int(idx) < lo + Lb:
            cache[:, int(idx) - lo:int(idx) - lo + 1] = new
        return
    rows = torch.arange(cache.shape[0], device=cache.device)[:, None]
    cols = idx.to(cache.device).reshape(-1, 1) - lo
    keep = ((cols >= 0) & (cols < Lb))[..., None, None]
    colc = cols.clamp(0, Lb - 1)
    cache[rows, colc] = torch.where(keep, new, cache[rows, colc])


def decode_splits(cfg, B: int, L: int, dtype: torch.dtype, tp: int) -> int:
    """The splits of a rank's L/tp block of the KV cache: the split count
    resolved on the cache's whole length L (``resolve_decode_splits``, as
    the path with no mesh resolves it), n/tp of them a rank where tp
    divides it, else one.  The combine over ``model`` then merges the
    same partials in another order.  B is the rank's rows, not the
    batch's: a decode step takes no batch size, and its rows cannot tell
    a batch split over the batch axes from one kept whole there
    (``sharding.shard_batch(whole_rows=True)``: B/dp rows of a split
    batch can be any count).  So at dp > 1 the lookup and its telemetry
    see (B/dp, L), the rows each rank reduces."""
    if cfg.decode_kv_splits <= 1:
        return 1
    from repro_torch.serve.flash_decode import resolve_decode_splits
    n = resolve_decode_splits(
        B=B, Hq=cfg.n_heads, Hkv=cfg.n_kv, Lkv=L, D=cfg.hd,
        dtype_bits=dispatch._dtype_bits(dtype), causal=1,
        default=cfg.decode_kv_splits)
    if n <= 1 or L % n or n % tp:
        return 1
    return n // tp


def attention_decode(pl: Placement, cfg, p: Params, shapes: Params,
                     x: torch.Tensor, *, positions: torch.Tensor, index,
                     qk_norm: bool, cache: Optional[Params] = None,
                     memory: Optional[torch.Tensor] = None,
                     path: str = "attn") -> torch.Tensor:
    """``layers.attention`` at a decode step on the rank's x (B/dp, 1,
    D), whole over ``model``: the block's output, whole over ``model``.
    ``positions`` (B/dp, 1) and ``index`` (an int or (B/dp,)) are the
    slots' global ones, ``cache`` the rank's (B/dp, L/tp, G, hd) block;
    ``memory`` (B/dp, L_enc, D) makes it cross-attention (no cache, no
    combine: the rank's heads attend to the whole memory)."""
    from repro_torch.serve.flash_decode import (flash_decode_out,
                                                flash_decode_partials)
    mg, tp, m = pl.mgroup, pl.tp, pl.rank("model")
    B = x.shape[0]
    H, G, hd = cfg.n_heads, cfg.n_kv, cfg.hd
    eps, theta = cfg.norm_eps, cfg.rope_theta
    proj = functools.partial(project, pl)
    q_tp, kv_tp = H % tp == 0, G % tp == 0
    cross = memory is not None

    def heads(name: str, src: torch.Tensor, split: bool,
              norm: Optional[torch.Tensor]) -> torch.Tensor:
        t = proj(src, p[name], f"{path}/{name}", shapes[name],
                 model_dim=1 if split else None)
        t = t.reshape(B, src.shape[1], -1, hd)
        if norm is not None:
            t = L.rms_norm(t, norm, eps)
        if not cross:
            t = L.apply_rope(t, positions, theta)
        return t

    q = heads("wq", x, q_tp, p["q_norm"] if qk_norm else None)
    src = memory if cross else x
    k = heads("wk", src, kv_tp, p["k_norm"] if qk_norm else None)
    v = proj(src, p["wv"], f"{path}/wv", shapes["wv"],
             model_dim=1 if kv_tp else None).reshape(B, src.shape[1], -1, hd)
    hl = H // tp if q_tp else H
    if cross:
        # the rank's query heads read their own KV heads where both split
        if kv_tp and not q_tp:
            k, v = col.gather_from(k, mg, 2), col.gather_from(v, mg, 2)
        elif q_tp and not kv_tp:
            k = _kv_heads(k, m * hl, hl, H // G)
            v = _kv_heads(v, m * hl, hl, H // G)
        out = L._chunked_attention(q, k, v, causal=False, q_start=0,
                                   chunk=cfg.attn_chunk)
    else:
        if q_tp:
            q = col.gather_from(q, mg, 2)               # every head
        if kv_tp:
            k, v = col.gather_from(k, mg, 2), col.gather_from(v, mg, 2)
        Lb = cache["k"].shape[1]
        _write_owned(cache["k"], k, index, m * Lb)
        _write_owned(cache["v"], v, index, m * Lb)
        kv_len = index + 1
        n = decode_splits(cfg, B, Lb * tp, q.dtype, tp)
        mx, l, acc = flash_decode_partials(q, cache["k"], cache["v"], kv_len,
                                           n_splits=n, pos0=m * Lb)
        gmax = col.all_reduce(mx, mg, op=dist.ReduceOp.MAX)
        corr = torch.exp(mx - gmax)[:, 0]
        l = col.all_reduce(l * corr, mg)
        acc = col.all_reduce(acc * corr[..., None], mg)
        out = flash_decode_out(q, l, acc)               # (B, 1, H, hd)
        if q_tp:
            out = out.narrow(2, m * hl, hl)
    out = out.reshape(B, 1, hl * hd)
    y = proj(out, p["wo"], f"{path}/wo", shapes["wo"],
             model_dim=0 if q_tp else None)
    return col.all_reduce(y, mg) if q_tp else y


# ---------------------------------------------------------------------------
# MLP, MoE, Mamba
# ---------------------------------------------------------------------------

def mlp(pl: Placement, cfg, p: Params, shapes: Params, x: torch.Tensor
        ) -> torch.Tensor:
    """The SwiGLU MLP on the rank's chunk: Megatron TP where
    ``cfg.mlp_tp`` and d_ff divides by tp, else pure SP."""
    W = functools.partial(weight, pl)
    if cfg.mlp_tp and cfg.d_ff % pl.tp == 0:
        xf = col.seq_gather(x, pl.mgroup, 1)
        g = dispatch.matmul2(xf, W(p["w_gate"], "mlp/w_gate",
                                   shapes["w_gate"], model_dim=1))
        u = dispatch.matmul2(xf, W(p["w_up"], "mlp/w_up", shapes["w_up"],
                                   model_dim=1))
        part = dispatch.matmul2(torch.nn.functional.silu(g) * u,
                                W(p["w_down"], "mlp/w_down",
                                  shapes["w_down"], model_dim=0))
        return col.seq_scatter(part, pl.mgroup, 1)
    whole = gather_whole(pl, p, shapes, "mlp")
    return L.mlp(whole, x)


def mlp_decode(pl: Placement, cfg, p: Params, shapes: Params,
               x: torch.Tensor) -> torch.Tensor:
    """The SwiGLU MLP at a decode step on x (B/dp, 1, D), whole over
    ``model``: column / row-parallel and an all-reduce over ``model``
    where ``cfg.mlp_tp`` and d_ff divides by tp, else the weights
    gathered whole."""
    proj = functools.partial(project, pl)
    tp = cfg.mlp_tp and cfg.d_ff % pl.tp == 0
    g = proj(x, p["w_gate"], "mlp/w_gate", shapes["w_gate"],
             model_dim=1 if tp else None)
    u = proj(x, p["w_up"], "mlp/w_up", shapes["w_up"],
             model_dim=1 if tp else None)
    y = proj(torch.nn.functional.silu(g) * u, p["w_down"], "mlp/w_down",
             shapes["w_down"], model_dim=0 if tp else None)
    return col.all_reduce(y, pl.mgroup) if tp else y


def moe_decode(pl: Placement, cfg, p: Params, shapes: Params,
               h: torch.Tensor) -> torch.Tensor:
    """``moe_decode`` on h (B/dp, 1, D), whole over ``model``: where the
    experts divide by tp, the rank's slab of E/tp experts (their
    ``fsdp`` dim gathered) on every token and an all-reduce over
    ``model`` of the slabs' shares; else every expert gathered."""
    ep = cfg.n_experts % pl.tp == 0
    pp = {k: weight(pl, p[k], f"moe/{k}", shapes[k],
                    model_dim=0 if ep else None)
          for k in ("w_gate", "w_up", "w_down")}
    return MOE.moe_decode({"router": p["router"], **pp}, h,
                          n_experts=cfg.n_experts, top_k=cfg.top_k,
                          group=pl.mgroup if ep else None)


def moe(pl: Placement, cfg, p: Params, shapes: Params, h: torch.Tensor
        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The capacity path on the rank's chunk h (B/dp, S/tp, D): the
    rank's rows gathered over the sequence, then ``moe_ep_a2a`` (with
    ``cfg.moe_a2a``) or ``moe_ep`` where the experts divide by tp, else
    ``moe`` with every expert gathered; the rank's chunk of the output
    and this data shard's aux loss."""
    mg = pl.mgroup
    kw = dict(n_experts=cfg.n_experts, top_k=cfg.top_k,
              capacity_factor=cfg.capacity_factor)
    ep = cfg.n_experts % pl.tp == 0
    hf = col.gather_from(h, mg, 1)
    experts = {k: weight(pl, p[k], f"moe/{k}", shapes[k],
                         model_dim=0 if ep else None, whole_grads=True)
               for k in ("w_gate", "w_up", "w_down")}
    pp = {"router": p["router"], **experts}
    if ep and cfg.moe_a2a:
        out, aux = MOE.moe_ep_a2a(pp, hf, mesh=pl.mesh, **kw)
    elif ep:
        out, aux = MOE.moe_ep(pp, hf, mesh=pl.mesh, **kw)
    else:
        out, aux = MOE.moe(pp, hf, **kw)
    return col.split_to(out, mg, 1), aux


def mamba(pl: Placement, cfg, p: Params, shapes: Params, h: torch.Tensor,
          cache: Optional[Params], decode: bool = False) -> torch.Tensor:
    """The Mamba-2 mixer on the rank's h: its chunk (B/dp, S/tp, D) in
    training and prefill, its (B/dp, 1, D) whole over ``model`` at a
    decode step.  Where the heads divide by tp
    (``sharding.mamba_head_tp``), head-parallel TP (``ssm.py:160-173``):
    the sequence gathered (``seq_gather``), then ``ssm.mamba_block`` on
    the rank's heads: the in-projection on its head-aligned columns
    (``sharding.mamba_columns``; ``w_in``, ``conv_w`` and ``conv_b`` are
    gathered whole and sliced: their contiguous TP cut does not fall on
    head boundaries, and the gather's reduce-scatter sums the B and C
    columns' gradients over the ranks), the depthwise conv on its heads'
    x channels and the whole B and C, the scan on its H/tp heads with
    their ``a_log``, ``dt_bias`` and ``d_skip``, the gated RMSNorm's sum
    of squares over ``d_inner`` all-reduced over ``model`` (both ways:
    every rank's channels use the total), ``w_out`` row-parallel, then a
    ``seq_scatter`` (an all-reduce at a decode step).  The cache is the
    rank's: its heads' SSM state, its conv channels
    (``sharding.shard_cache``).  Else every rank runs the mixer whole on
    its rows, the weights gathered whole: in training and prefill under
    the conjugate pairs (``gather_from`` the sequence, ``split_to`` its
    own chunk of the output, so its backward is the whole layer's), the
    cache's state whole over ``model``."""
    mg, tp, m = pl.mgroup, pl.tp, pl.rank("model")
    kw = dict(d_model=cfg.d_model, state=cfg.ssm_state,
              head_dim=cfg.ssm_head_dim, chunk=cfg.ssd_chunk, cache=cache)
    H = mamba_heads(cfg)
    if not shd.mamba_head_tp(H, tp):
        whole = gather_whole(pl, p, shapes, "mamba", whole_grads=not decode)
        hf = h if decode else col.gather_from(h, mg, 1)
        out, _ = SSM.mamba_block(whole, hf, **kw)
        return out if decode else col.split_to(out, mg, 1)
    di, S = 2 * cfg.d_model, cfg.ssm_state
    hl, dl = H // tp, di // tp
    ch = shd.mamba_conv_channels(di, S, tp, m)
    local = {k: shd.take(weight(pl, p[k], f"mamba/{k}", shapes[k]), -1, ch)
             for k in ("conv_w", "conv_b")}
    local.update({k: p[k].narrow(-1, m * hl, hl) for k in SSM.FP32_LEAVES})
    local["norm"] = p["norm"].narrow(-1, m * dl, dl)
    x = h if decode else col.seq_gather(h, mg, 1)
    out, _ = SSM.mamba_block(
        local, x, **kw,
        project_in=lambda t: project(pl, t, p["w_in"], "mamba/w_in",
                                     shapes["w_in"],
                                     cols=shd.mamba_columns(di, S, H, tp, m)),
        project_out=lambda t: project(pl, t, p["w_out"], "mamba/w_out",
                                      shapes["w_out"], model_dim=0),
        sum_sq=lambda t: col.psum(t, mg))
    return col.all_reduce(out, mg) if decode else col.seq_scatter(out, mg, 1)
