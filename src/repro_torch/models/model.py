"""Unified LM over a repeating pattern of (mixer, MLP) layers (port of
``repro.models.model``): the dense, Mamba-2, MoE, hybrid, encoder-decoder
and stub-frontend families.

A layer's mixer is GQA attention (``attn``) or a Mamba-2 SSD mixer
(``mamba``, ``models/ssm.py``); its MLP is SwiGLU (``dense``), a
mixture of experts (``moe``, ``models/moe.py``), both summed
(``moe+dense``), or none (``none``).  Parameters keep the reference's
pytree layout (``embed``, ``final_norm`` and ``layers.pos{i}.*`` per
pattern position, stacked over the repeats; an encoder-decoder adds
``cross`` and ``norm_cross`` to each decoder layer and an ``encoder``
tree, ``{"pos0": (attn, dense) layers stacked over encoder_layers,
"norm": ...}``), so a reference parameter tree converts leaf by leaf
(``repro_torch.weights``), and the decode cache has the reference's
layout: ``pos{i}.attn.{k, v}`` (repeats, B, L, G, D) or
``pos{i}.mamba.{conv, ssm}`` (repeats, B, W-1, C) / (repeats, B, H, P, S).
MoE layers add no cache, and neither does cross-attention: as in the
reference, the encoder memory is projected to K/V again at every step.
The forward pass is a Python loop over the repeats in place of
``jax.lax.scan``; every cache write is in place.

Entry points:
  init_params(cfg, gen)                         -> params
  forward(params, cfg, batch)                  -> (final hidden (B,S,D), aux)
  loss_fn(params, cfg, batch, aux_weight=0.01) -> (loss, metrics)
  init_cache(cfg, batch, max_len, device)      -> decode cache
  encode(cfg, params, frames)                  -> encoder memory (B, L_enc, D)
  prefill(params, cfg, batch, cache)           -> (last logits (B, V), cache)
  decode_step(params, cfg, tokens, cache, index, memory=None)
                                               -> (logits (B, V), cache)

Training: ``loss_fn`` is the reference's next-token cross-entropy (plus
``aux_weight`` times the MoE layers' summed load-balancing loss), the
logits formed ``logit_chunk`` positions at a time (``_chunked_xent``).
Where autograd records (grad mode on and a parameter requiring grad),
each repeat of the stack runs under ``torch.utils.checkpoint`` when
``cfg.remat`` (the reference's ``jax.checkpoint(body)``), as does each
logit chunk and each attention chunk.  The stacked parameters are split
into their repeats with one ``unbind`` a leaf (views, no kernel), whose
backward stacks the repeats' grads in one op.  Without autograd (the
serving engine, a CUDA graph capture) no checkpoint runs.

``prefill``'s batch holds ``tokens`` and, for an encoder-decoder,
``encoder_embeds`` (B, L_enc, D), which it encodes itself; for a vision
frontend optionally ``patch_embeds`` (B, Np, D), prepended to the token
embeddings (positions 0..Np+T-1).  An encoder-decoder's ``decode_step``
wants the memory from ``encode``.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Dict, List, Optional, Tuple

import torch

from repro_torch.parallel import sharding as shd

from . import layers as L
from . import moe as MOE
from . import ssm as SSM

Params = Dict[str, Any]

ATTN, MAMBA = "attn", "mamba"
DENSE, MOE_MLP, MOE_DENSE, NONE = "dense", "moe", "moe+dense", "none"


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv: int
    d_ff: int
    vocab: int
    head_dim: int = 0                      # 0 => d_model // n_heads
    pattern: Tuple[Tuple[str, str], ...] = ((ATTN, DENSE),)
    n_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssd_chunk: int = 256
    encoder_layers: int = 0                # > 0: encoder + cross-attention
    encoder_len: int = 0                   # stub frame count
    frontend: str = "none"                 # 'none' | 'audio' | 'vision'
    n_frontend_tokens: int = 0             # vision: patch embeds prepended
    qk_norm: bool = False
    rope_theta: float = 1e4
    norm_eps: float = 1e-5
    dtype: torch.dtype = torch.bfloat16
    remat: bool = True                     # training: recompute each repeat
    attn_chunk: int = 1024
    logit_chunk: int = 512                 # training: positions per logit chunk
    tie_embeddings: bool = True
    decode_kv_splits: int = 1      # >1: flash-decoding over the KV cache
    causal_block_skip: bool = False        # skip attention blocks past the
    #   diagonal (causal self-attention without a cache)
    moe_a2a: bool = False                  # under a mesh: all-to-all EP
    #   (moe_ep_a2a) in place of the all-reduce one (moe_ep)

    @property
    def hd(self) -> int:
        return self.head_dim or (self.d_model // max(self.n_heads, 1))

    @property
    def padded_vocab(self) -> int:
        return _round_up(self.vocab, 256)

    @property
    def n_repeats(self) -> int:
        return self.n_layers // len(self.pattern)

    @property
    def is_encdec(self) -> bool:
        return self.encoder_layers > 0

    @property
    def param_count(self) -> int:
        """Total parameters."""
        return self._count_params(active=False)

    @property
    def active_param_count(self) -> int:
        """Active parameters per token (MoE: only top_k experts count)."""
        return self._count_params(active=True)

    def _count_params(self, active: bool) -> int:
        n = self.padded_vocab * self.d_model      # embed (tied head)
        if not self.tie_embeddings:
            n *= 2
        n += self.d_model                         # final norm
        n += self.n_repeats * sum(self._layer_params(active=active))
        if self.is_encdec:
            # decoder cross-attention blocks (+ their norms)
            n += self.n_layers * (self._attn_params() + self.d_model)
            # encoder stack: plain (attn, dense) layers + final norm
            enc = (self._attn_params() + 3 * self.d_model * self.d_ff
                   + 2 * self.d_model)
            n += self.encoder_layers * enc + self.d_model
        return n

    def _attn_params(self) -> int:
        d, hd = self.d_model, self.hd
        return d * (self.n_heads + 2 * self.n_kv) * hd + self.n_heads * hd * d

    def _layer_params(self, active: bool = False) -> Tuple[int, ...]:
        d, f = self.d_model, self.d_ff
        out = []
        for mixer, mlp_kind in self.pattern:
            n = 2 * d                                        # norms
            if mixer == ATTN:
                n += self._attn_params()
            else:
                di = 2 * d
                nh = di // self.ssm_head_dim
                n += d * (2 * di + 2 * self.ssm_state + nh) + di * d
            if mlp_kind in (DENSE, MOE_DENSE):
                n += 3 * d * f
            if mlp_kind in (MOE_MLP, MOE_DENSE):
                e = self.top_k if active else self.n_experts
                n += d * self.n_experts + e * 3 * d * f
            out.append(n)
        return tuple(out)

    def check_supported(self) -> None:
        """The port's model covers patterns of attention or Mamba-2 mixers
        with SwiGLU, MoE, both or no MLPs, with a tied embedding; an
        encoder (``encoder_layers`` > 0) with the stub audio frontend, or
        the stub vision frontend's prepended patch embeddings."""
        mixers = {m for m, _ in self.pattern}
        mlps = {f for _, f in self.pattern}
        frontend_ok = (self.frontend == "audio" if self.is_encdec
                       else self.frontend in ("none", "vision"))
        if (not mixers <= {ATTN, MAMBA}
                or not mlps <= {DENSE, MOE_MLP, MOE_DENSE, NONE}
                or not frontend_ok or not self.tie_embeddings):
            raise NotImplementedError(
                f"{self.name}: only attention / Mamba-2 mixers with SwiGLU, "
                "MoE or no MLPs, a tied embedding, and the frontends 'none', "
                "'vision' or 'audio' (with an encoder) are ported")
        if mlps & {MOE_MLP, MOE_DENSE} and not (
                0 < self.top_k <= self.n_experts):
            raise ValueError(f"{self.name}: MoE layers want 0 < top_k <= "
                             f"n_experts, got top_k {self.top_k} of "
                             f"{self.n_experts} experts")
        if self.n_layers % len(self.pattern):
            raise ValueError(f"{self.name}: {self.n_layers} layers are not "
                             f"a whole number of {len(self.pattern)}-layer "
                             "patterns")


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def _attn_init(gen: torch.Generator, cfg: ModelConfig, R: int,
               qk_norm: bool) -> Params:
    d, hd, dt = cfg.d_model, cfg.hd, cfg.dtype
    attn = {
        "wq": L.stacked_init(gen, (R,), (d, cfg.n_heads * hd), dt),
        "wk": L.stacked_init(gen, (R,), (d, cfg.n_kv * hd), dt),
        "wv": L.stacked_init(gen, (R,), (d, cfg.n_kv * hd), dt),
        "wo": L.stacked_init(gen, (R,), (cfg.n_heads * hd, d), dt),
    }
    if qk_norm:
        attn["q_norm"] = torch.ones((R, hd), dtype=dt, device=gen.device)
        attn["k_norm"] = torch.ones((R, hd), dtype=dt, device=gen.device)
    return attn


def _init_layer(cfg: ModelConfig, gen: torch.Generator, mixer: str,
                mlp_kind: str, cross: bool, R: int) -> Params:
    """One pattern position's parameters, stacked over ``R`` repeats.  As
    in the reference, ``norm2`` exists even where the MLP is ``none``, and
    cross-attention (``cross``, never qk-normed) has its own norm.  Every
    stacked matrix is filled one repeat at a time: a draw of a whole
    stacked tensor would make an fp32 copy of it."""
    d, f, dt = cfg.d_model, cfg.d_ff, cfg.dtype
    ones = lambda *shape: torch.ones(shape, dtype=dt, device=gen.device)
    layer: Params = {"norm1": ones(R, d), "norm2": ones(R, d)}
    if mixer == ATTN:
        layer["attn"] = _attn_init(gen, cfg, R, cfg.qk_norm)
    else:
        layer["mamba"] = SSM.init_mamba(gen, d, cfg.ssm_state,
                                        cfg.ssm_head_dim, dt, stack=(R,))
    if cross:
        layer["cross"] = _attn_init(gen, cfg, R, False)
        layer["norm_cross"] = ones(R, d)
    if mlp_kind in (DENSE, MOE_DENSE):
        layer["mlp"] = {
            "w_gate": L.stacked_init(gen, (R,), (d, f), dt),
            "w_up": L.stacked_init(gen, (R,), (d, f), dt),
            "w_down": L.stacked_init(gen, (R,), (f, d), dt)}
    if mlp_kind in (MOE_MLP, MOE_DENSE):
        layer["moe"] = MOE.init_moe(gen, d, f, cfg.n_experts, dt, stack=(R,))
    return layer


def init_params(cfg: ModelConfig, gen: torch.Generator) -> Params:
    """Random parameters from ``gen`` (on the generator's device).

    Not the reference's numbers: ``jax.random`` and ``torch.Generator``
    differ.  Parity tests convert a reference tree with
    ``repro_torch.weights.params_from_jax`` instead.
    """
    cfg.check_supported()
    layers = {f"pos{i}": _init_layer(cfg, gen, mixer, mlp_kind,
                                     cross=cfg.is_encdec, R=cfg.n_repeats)
              for i, (mixer, mlp_kind) in enumerate(cfg.pattern)}
    params = {"embed": L.embed_init(gen, cfg.padded_vocab, cfg.d_model,
                                    cfg.dtype),
              "final_norm": torch.ones(cfg.d_model, dtype=cfg.dtype,
                                       device=gen.device),
              "layers": layers}
    if cfg.is_encdec:
        params["encoder"] = {
            "pos0": _init_layer(cfg, gen, ATTN, DENSE, cross=False,
                                R=cfg.encoder_layers),
            "norm": torch.ones(cfg.d_model, dtype=cfg.dtype,
                               device=gen.device)}
    return params


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               device: torch.device) -> Params:
    """Decode cache, stacked over repeats like the params: a zero KV cache
    per attention position, zero conv (model dtype) and SSM (fp32) state
    per Mamba position."""
    cfg.check_supported()
    cache: Params = {}
    for i, (mixer, _) in enumerate(cfg.pattern):
        if mixer == ATTN:
            shape = (cfg.n_repeats, batch, max_len, cfg.n_kv, cfg.hd)
            cache[f"pos{i}"] = {"attn": {
                "k": torch.zeros(shape, dtype=cfg.dtype, device=device),
                "v": torch.zeros(shape, dtype=cfg.dtype, device=device)}}
        else:
            cache[f"pos{i}"] = {"mamba": SSM.init_mamba_cache(
                batch, cfg.d_model, cfg.ssm_state, cfg.ssm_head_dim,
                cfg.dtype, device, stack=(cfg.n_repeats,))}
    return cache


def tree_map(fn, tree: Any) -> Any:
    """``fn`` applied to every tensor of a nested dict (params, a cache)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def tree_leaves(tree: Any) -> List[torch.Tensor]:
    """The tensors of a nested dict in its insertion order (two caches
    that ``init_cache`` built for one config list theirs alike)."""
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in tree_leaves(v)]
    return [tree]


def recurrent_leaves(cache: Params) -> List[torch.Tensor]:
    """The cache tensors a forward updates by a recurrence (the Mamba
    conv and SSM state), whose writes, unlike a KV cache's, are not
    idempotent: running a step twice advances them twice."""
    return [t for pos in cache.values() if "mamba" in pos
            for t in pos["mamba"].values()]


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------

def _slice(tree: Any, r: int) -> Any:
    if isinstance(tree, dict):
        return {k: _slice(v, r) for k, v in tree.items()}
    return tree[r]


def _unstack(tree: Any, n: int) -> List[Any]:
    """The ``n`` repeats of a stacked tree, each leaf split by one
    ``unbind``: under autograd its backward stacks the repeats' grads in
    one op, where ``n`` selects would each add a zero-filled copy of the
    whole stacked leaf."""
    if isinstance(tree, dict):
        parts = {k: _unstack(v, n) for k, v in tree.items()}
        return [{k: parts[k][r] for k in parts} for r in range(n)]
    return list(torch.unbind(tree))


def _apply_repeat(cfg: ModelConfig, p_r: Params, c_r: Params,
                  x: torch.Tensor, *, pattern: Tuple[Tuple[str, str], ...],
                  positions: torch.Tensor, causal: bool,
                  memory: Optional[torch.Tensor], has_cache: bool,
                  cache_index, want_aux: bool) -> Tuple[torch.Tensor, Any]:
    """One repeat of the stack: ``pattern``'s layers in order.  Returns
    (x, the summed fp32 aux loss of its capacity-path MoE layers where
    ``want_aux``, else 0.0: the serving path adds no op for it)."""
    aux: Any = 0.0
    for i, (mixer, mlp_kind) in enumerate(pattern):
        p = p_r[f"pos{i}"]
        c = c_r.get(f"pos{i}", {})
        h = L.rms_norm(x, p["norm1"], cfg.norm_eps)
        if mixer == ATTN:
            out, _ = L.attention(
                p["attn"], h, n_heads=cfg.n_heads, n_kv=cfg.n_kv,
                head_dim=cfg.hd, positions=positions, causal=causal,
                rope_theta=cfg.rope_theta, qk_norm=cfg.qk_norm,
                norm_eps=cfg.norm_eps, cache=c.get("attn"),
                cache_index=cache_index, attn_chunk=cfg.attn_chunk,
                decode_kv_splits=cfg.decode_kv_splits,
                causal_block_skip=cfg.causal_block_skip)
        else:
            out, _ = SSM.mamba_block(
                p["mamba"], h, d_model=cfg.d_model, state=cfg.ssm_state,
                head_dim=cfg.ssm_head_dim, chunk=cfg.ssd_chunk,
                cache=c.get("mamba"))
        x = x + out
        if memory is not None and "cross" in p:
            h = L.rms_norm(x, p["norm_cross"], cfg.norm_eps)
            out, _ = L.attention(
                p["cross"], h, n_heads=cfg.n_heads, n_kv=cfg.n_kv,
                head_dim=cfg.hd, positions=positions, causal=False,
                rope_theta=cfg.rope_theta, qk_norm=False,
                norm_eps=cfg.norm_eps, memory=memory,
                attn_chunk=cfg.attn_chunk)
            x = x + out
        if mlp_kind == NONE:
            continue
        h = L.rms_norm(x, p["norm2"], cfg.norm_eps)
        out = None
        if mlp_kind in (DENSE, MOE_DENSE):
            out = L.mlp(p["mlp"], h)
        if mlp_kind in (MOE_MLP, MOE_DENSE):
            if has_cache and h.shape[1] == 1:
                mo = MOE.moe_decode(p["moe"], h, n_experts=cfg.n_experts,
                                    top_k=cfg.top_k)
            else:
                mo, a = _moe(cfg, p["moe"], h)
                if want_aux:
                    aux = aux + a
            out = mo if out is None else out + mo
        x = x + out
    return x, aux


def _moe(cfg: ModelConfig, p: Params, h: torch.Tensor
         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The capacity path of a MoE layer, chosen as the reference chooses
    it.  Under ``parallel.sharding.use_rules(mesh)`` with a ``model``
    axis that divides the experts and a batch that divides over the
    mesh's other axes: ``moe_ep_a2a`` where ``cfg.moe_a2a`` and the
    sequence divides over ``model``, else ``moe_ep``; otherwise ``moe``.

    Every rank holds the whole batch here: the port has no GSPMD, so the
    layers around the MoE run replicated on every rank, and the batch is
    not split over the other axes.  The batch condition is kept so that
    the port takes the reference's path, whose drops differ.  Only the
    expert slabs can be sharded (``parallel.sharding.expert_slabs``); the
    FSDP/TP placement of the other parameters waits for A8.2."""
    mesh = shd.active_mesh()
    kw = dict(n_experts=cfg.n_experts, top_k=cfg.top_k,
              capacity_factor=cfg.capacity_factor)
    sizes = shd.mesh_axes(mesh) if mesh is not None else {}
    tp = sizes.get("model", 0)
    ep_ok = bool(tp) and cfg.n_experts % tp == 0
    if ep_ok:
        bsz = 1
        for a, n in sizes.items():
            if a != "model":
                bsz *= n
        ep_ok = h.shape[0] % bsz == 0
    if ep_ok and cfg.moe_a2a and h.shape[1] % tp == 0:
        return MOE.moe_ep_a2a(p, h, mesh=mesh, **kw)
    if ep_ok:
        return MOE.moe_ep(p, h, mesh=mesh, **kw)
    return MOE.moe(p, h, **kw)


def _run_stack(cfg: ModelConfig, stack: Params, x: torch.Tensor, *,
               pattern: Tuple[Tuple[str, str], ...], positions: torch.Tensor,
               causal: bool, memory: Optional[torch.Tensor] = None,
               cache: Optional[Params] = None, cache_index=None,
               want_aux: bool = False) -> Tuple[torch.Tensor, Any]:
    """Pre-norm residual blocks over the repeats of ``stack`` (its leaves'
    leading dim), ``pattern``'s positions in order inside each; with a
    ``cache``, each repeat's slices are written in place.  Where a layer
    has ``cross`` and ``memory`` is given, cross-attention into it comes
    between the mixer's and the MLP's residual adds.  An MLP of kind
    ``none`` is skipped with its norm; a dense MLP and a MoE in one layer
    are summed before the residual add.  The MoE takes its decode path
    where the reference's does: with a cache and one position (a tick, or
    a 1-token prompt's prefill), else the capacity path.  Returns (x, aux):
    with ``want_aux`` the capacity-path MoE layers' load-balancing losses
    summed in fp32, as the reference's scan carries them (0.0 where there
    are none); without it 0.0, and no op is added for it.  Where autograd
    records and ``cfg.remat``, each repeat runs under a checkpoint."""
    n = tree_leaves(stack)[0].shape[0]
    record = L.recording(x, stack, memory)
    reps = _unstack(stack, n)
    aux: Any = 0.0
    for r, p_r in enumerate(reps):
        c_r = _slice(cache, r) if cache is not None else {}
        fn = functools.partial(
            _apply_repeat, cfg, p_r, c_r, pattern=pattern,
            positions=positions, causal=causal, memory=memory,
            has_cache=cache is not None, cache_index=cache_index,
            want_aux=want_aux)
        x, a = L.maybe_checkpoint(fn, x, record=record and cfg.remat)
        aux = aux + a
    return x, aux


def _logits(cfg: ModelConfig, params: Params, x: torch.Tensor) -> torch.Tensor:
    """Tied-embedding head: a plain product outside the tuned GEMM path, as
    in the reference (which leaves it to XLA)."""
    return torch.matmul(x, params["embed"].to(cfg.dtype).t()).float()


def _frontend_concat(cfg: ModelConfig, params: Params, batch: Dict[str, Any]
                     ) -> torch.Tensor:
    """The decoder's input (B, S, D): the token embeddings, behind the
    vision frontend's ``patch_embeds`` (B, Np, D) where the batch has
    them."""
    x = params["embed"][batch["tokens"]]
    if cfg.frontend == "vision" and "patch_embeds" in batch:
        pe = batch["patch_embeds"].to(device=x.device, dtype=cfg.dtype)
        x = torch.cat([pe, x], dim=1)
    return x


def _frontend_concat_shapes(cfg: ModelConfig, batch: Dict[str, Any],
                            device: torch.device
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(targets (B, S), loss mask (B, S) fp32) aligned with the decoder's
    sequence: the batch's ``targets`` (default: the tokens) and
    ``loss_mask`` (default: ones), behind zeros for the vision frontend's
    patch positions, without running the embedding again."""
    tokens = torch.as_tensor(batch["tokens"], device=device)
    targets = torch.as_tensor(batch.get("targets", tokens), device=device)
    mask = batch.get("loss_mask")
    mask = (torch.ones(tokens.shape, dtype=torch.float32, device=device)
            if mask is None else torch.as_tensor(mask, device=device))
    if cfg.frontend == "vision" and "patch_embeds" in batch:
        B, npatch = tokens.shape[0], batch["patch_embeds"].shape[1]
        targets = torch.cat([targets.new_zeros((B, npatch)), targets], dim=1)
        mask = torch.cat([mask.new_zeros((B, npatch)), mask], dim=1)
    return targets, mask


def _chunked_xent(cfg: ModelConfig, x: torch.Tensor, embed: torch.Tensor,
                  targets: torch.Tensor, mask: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(mean cross-entropy, accuracy) over the masked positions, without
    the whole (B, S, V) logits: ``logit_chunk`` positions at a time, each
    chunk's fp32 logits formed (the tied head in the model dtype, a plain
    ``torch.matmul`` as the reference's ``einsum``), reduced and dropped;
    where autograd records each chunk runs under a checkpoint, so the
    backward pass recomputes it.  A last chunk shorter than the rest is
    the reference's zero-padded one without its pad (masked rows add
    nothing)."""
    B, S, _ = x.shape
    ck = min(cfg.logit_chunk, S)
    w_t = embed.to(cfg.dtype).t()
    targets = targets.long()
    mask = mask.float()
    record = L.recording(x, embed)

    def body(xc, tc, mc):
        logits = torch.matmul(xc, w_t).float()
        lse = torch.logsumexp(logits, dim=-1)
        tgt = torch.gather(logits, -1, tc[..., None])[..., 0]
        loss = torch.sum((lse - tgt) * mc)
        correct = torch.sum((logits.argmax(-1) == tc).float() * mc)
        return loss, correct

    loss_sum = torch.zeros((), dtype=torch.float32, device=x.device)
    correct = torch.zeros((), dtype=torch.float32, device=x.device)
    for lo in range(0, S, ck):
        sl = slice(lo, lo + ck)
        ls, c = L.maybe_checkpoint(body, x[:, sl], targets[:, sl],
                                   mask[:, sl], record=record)
        loss_sum = loss_sum + ls
        correct = correct + c
    denom = torch.clamp(mask.sum(), min=1.0)
    return loss_sum / denom, correct / denom


def forward(params: Params, cfg: ModelConfig, batch: Dict[str, Any]
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The training forward: ``batch`` as for :func:`prefill`, no cache.
    Returns (final hidden (B, S, D), the MoE layers' summed load-balancing
    loss, fp32)."""
    x = _frontend_concat(cfg, params, batch)
    positions = torch.arange(x.shape[1], device=x.device)
    memory = (encode(cfg, params, batch["encoder_embeds"])
              if cfg.is_encdec else None)
    x, aux = _run_stack(cfg, params["layers"], x, pattern=cfg.pattern,
                        positions=positions, causal=True, memory=memory,
                        want_aux=True)
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    return x, torch.as_tensor(aux, dtype=torch.float32, device=x.device)


def loss_fn(params: Params, cfg: ModelConfig, batch: Dict[str, Any],
            aux_weight: float = 0.01
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Next-token loss: position t predicts t+1.  ``batch`` holds
    ``tokens`` (B, T) and optionally ``targets``, ``loss_mask``,
    ``patch_embeds`` and ``encoder_embeds``.  Returns (loss, {"loss",
    "xent", "aux", "acc"}), loss = xent + ``aux_weight`` * aux."""
    x, aux = forward(params, cfg, batch)
    targets, mask = _frontend_concat_shapes(cfg, batch, x.device)
    xent, acc = _chunked_xent(cfg, x[:, :-1], params["embed"],
                              targets[:, 1:], mask[:, 1:])
    loss = xent + aux_weight * aux
    return loss, {"loss": loss, "xent": xent, "aux": aux, "acc": acc}


def encode(cfg: ModelConfig, params: Params, frames: torch.Tensor
           ) -> torch.Tensor:
    """The encoder stack over stub frame embeddings (B, L_enc, D): its
    (attn, dense) layers, non-causal with RoPE at positions 0..L_enc-1 as
    in the reference, no cache, then the encoder's final norm."""
    enc = params["encoder"]
    x = frames.to(device=enc["norm"].device, dtype=cfg.dtype)
    positions = torch.arange(x.shape[1], device=x.device)
    x, _ = _run_stack(cfg, {"pos0": enc["pos0"]}, x,
                      pattern=((ATTN, DENSE),), positions=positions,
                      causal=False)
    return L.rms_norm(x, enc["norm"], cfg.norm_eps)


def decode_step(params: Params, cfg: ModelConfig, tokens: torch.Tensor,
                cache: Params, index, memory: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, Params]:
    """One decode step.  tokens (B, 1); index = current length, an int or
    a per-slot (B,) tensor; ``memory`` the encoder output (B, L_enc, D),
    which an encoder-decoder requires.  Returns (logits (B, V), cache)."""
    if cfg.is_encdec and memory is None:
        raise ValueError("enc-dec decode requires encoder memory")
    x = params["embed"][tokens]
    dev = x.device
    idx = torch.as_tensor(index, device=dev)
    positions = idx.reshape(-1, 1) + torch.arange(tokens.shape[1],
                                                  device=dev)[None, :]
    x, _ = _run_stack(cfg, params["layers"], x, pattern=cfg.pattern,
                      positions=positions, causal=True, memory=memory,
                      cache=cache, cache_index=index)
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    return _logits(cfg, params, x)[:, -1], cache


def prefill(params: Params, cfg: ModelConfig, batch: Dict[str, Any],
            cache: Params) -> Tuple[torch.Tensor, Params]:
    """Run the prompt through the stack, filling the cache from position 0:
    the patch embeddings first where the batch has them, and for an
    encoder-decoder cross-attention into ``encode(encoder_embeds)``.
    Returns (last-position logits (B, V), cache)."""
    x = _frontend_concat(cfg, params, batch)
    positions = torch.arange(x.shape[1], device=x.device)
    memory = (encode(cfg, params, batch["encoder_embeds"])
              if cfg.is_encdec else None)
    x, _ = _run_stack(cfg, params["layers"], x, pattern=cfg.pattern,
                      positions=positions, causal=True, memory=memory,
                      cache=cache, cache_index=0)
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    return _logits(cfg, params, x[:, -1:])[:, -1], cache
