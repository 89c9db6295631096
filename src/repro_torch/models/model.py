"""Decoder LM over a repeating pattern of (mixer, MLP) layers (port of
``repro.models.model`` for the dense, Mamba-2, MoE and hybrid families).

A layer's mixer is GQA attention (``attn``) or a Mamba-2 SSD mixer
(``mamba``, ``models/ssm.py``); its MLP is SwiGLU (``dense``), a
mixture of experts (``moe``, ``models/moe.py``), both summed
(``moe+dense``), or none (``none``).  Parameters keep the reference's
pytree layout (``embed``, ``final_norm`` and ``layers.pos{i}.*`` per
pattern position, stacked over the repeats), so a reference parameter
tree converts leaf by leaf
(``repro_torch.weights``), and the decode cache has the reference's
layout: ``pos{i}.attn.{k, v}`` (repeats, B, L, G, D) or
``pos{i}.mamba.{conv, ssm}`` (repeats, B, W-1, C) / (repeats, B, H, P, S).
MoE layers add no cache.
The forward pass is a Python loop over the repeats in place of
``jax.lax.scan``; every cache write is in place.

Entry points:
  init_params(cfg, gen)                         -> params
  init_cache(cfg, batch, max_len, device)      -> decode cache
  prefill(params, cfg, batch, cache)           -> (last logits (B, V), cache)
  decode_step(params, cfg, tokens, cache, index) -> (logits (B, V), cache)

Encoder-decoder and frontend configurations raise
``NotImplementedError``: they arrive with later slices.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Tuple

import torch

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
    encoder_layers: int = 0
    frontend: str = "none"
    qk_norm: bool = False
    rope_theta: float = 1e4
    norm_eps: float = 1e-5
    dtype: torch.dtype = torch.bfloat16
    attn_chunk: int = 1024
    tie_embeddings: bool = True
    decode_kv_splits: int = 1      # >1: flash-decoding over the KV cache

    @property
    def hd(self) -> int:
        return self.head_dim or (self.d_model // max(self.n_heads, 1))

    @property
    def padded_vocab(self) -> int:
        return _round_up(self.vocab, 256)

    @property
    def n_repeats(self) -> int:
        return self.n_layers // len(self.pattern)

    def check_supported(self) -> None:
        """The port's model covers patterns of attention or Mamba-2 mixers
        with SwiGLU, MoE, both or no MLPs, with a tied embedding."""
        mixers = {m for m, _ in self.pattern}
        mlps = {f for _, f in self.pattern}
        if (not mixers <= {ATTN, MAMBA}
                or not mlps <= {DENSE, MOE_MLP, MOE_DENSE, NONE}
                or self.encoder_layers or self.frontend != "none"
                or not self.tie_embeddings):
            raise NotImplementedError(
                f"{self.name}: only attention / Mamba-2 mixers with SwiGLU, "
                "MoE or no MLPs are ported (enc-dec and frontends arrive "
                "with later slices)")
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

def _init_layer(cfg: ModelConfig, gen: torch.Generator, mixer: str,
                mlp_kind: str) -> Params:
    """One pattern position's parameters, stacked over the repeats.  As in
    the reference, ``norm2`` exists even where the MLP is ``none``."""
    R, d, f, hd, dt = cfg.n_repeats, cfg.d_model, cfg.d_ff, cfg.hd, cfg.dtype
    ones = lambda *shape: torch.ones(shape, dtype=dt, device=gen.device)
    layer: Params = {"norm1": ones(R, d), "norm2": ones(R, d)}
    if mixer == ATTN:
        attn = {
            "wq": L.dense_init(gen, (R, d, cfg.n_heads * hd), dt, fan_in=d),
            "wk": L.dense_init(gen, (R, d, cfg.n_kv * hd), dt, fan_in=d),
            "wv": L.dense_init(gen, (R, d, cfg.n_kv * hd), dt, fan_in=d),
            "wo": L.dense_init(gen, (R, cfg.n_heads * hd, d), dt,
                               fan_in=cfg.n_heads * hd),
        }
        if cfg.qk_norm:
            attn["q_norm"] = ones(R, hd)
            attn["k_norm"] = ones(R, hd)
        layer["attn"] = attn
    else:
        layer["mamba"] = SSM.init_mamba(gen, d, cfg.ssm_state,
                                        cfg.ssm_head_dim, dt, stack=(R,))
    if mlp_kind in (DENSE, MOE_DENSE):
        layer["mlp"] = {
            "w_gate": L.dense_init(gen, (R, d, f), dt, fan_in=d),
            "w_up": L.dense_init(gen, (R, d, f), dt, fan_in=d),
            "w_down": L.dense_init(gen, (R, f, d), dt, fan_in=f)}
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
    layers = {f"pos{i}": _init_layer(cfg, gen, mixer, mlp_kind)
              for i, (mixer, mlp_kind) in enumerate(cfg.pattern)}
    return {"embed": L.embed_init(gen, cfg.padded_vocab, cfg.d_model,
                                  cfg.dtype),
            "final_norm": torch.ones(cfg.d_model, dtype=cfg.dtype,
                                     device=gen.device),
            "layers": layers}


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


def _run_stack(cfg: ModelConfig, params: Params, x: torch.Tensor, *,
               positions: torch.Tensor, cache: Params, cache_index
               ) -> torch.Tensor:
    """Pre-norm residual blocks over the repeats, the pattern's positions
    in order inside each; the cache slices of each repeat are written in
    place.  An MLP of kind ``none`` is skipped with its norm; a dense MLP
    and a MoE in one layer are summed before the residual add.  The MoE
    takes its decode path where the reference's does: with a cache and
    one position (a tick, or a 1-token prompt's prefill), else the
    capacity path."""
    for r in range(cfg.n_repeats):
        for i, (mixer, mlp_kind) in enumerate(cfg.pattern):
            p = _slice(params["layers"][f"pos{i}"], r)
            c = _slice(cache[f"pos{i}"], r)
            h = L.rms_norm(x, p["norm1"], cfg.norm_eps)
            if mixer == ATTN:
                out, _ = L.attention(
                    p["attn"], h, n_heads=cfg.n_heads, n_kv=cfg.n_kv,
                    head_dim=cfg.hd, positions=positions, causal=True,
                    rope_theta=cfg.rope_theta, qk_norm=cfg.qk_norm,
                    norm_eps=cfg.norm_eps, cache=c["attn"],
                    cache_index=cache_index, attn_chunk=cfg.attn_chunk,
                    decode_kv_splits=cfg.decode_kv_splits)
            else:
                out, _ = SSM.mamba_block(
                    p["mamba"], h, d_model=cfg.d_model, state=cfg.ssm_state,
                    head_dim=cfg.ssm_head_dim, chunk=cfg.ssd_chunk,
                    cache=c["mamba"])
            x = x + out
            if mlp_kind == NONE:
                continue
            h = L.rms_norm(x, p["norm2"], cfg.norm_eps)
            out = None
            if mlp_kind in (DENSE, MOE_DENSE):
                out = L.mlp(p["mlp"], h)
            if mlp_kind in (MOE_MLP, MOE_DENSE):
                if h.shape[1] == 1:
                    mo = MOE.moe_decode(p["moe"], h, n_experts=cfg.n_experts,
                                        top_k=cfg.top_k)
                else:
                    mo, _ = MOE.moe(p["moe"], h, n_experts=cfg.n_experts,
                                    top_k=cfg.top_k,
                                    capacity_factor=cfg.capacity_factor)
                out = mo if out is None else out + mo
            x = x + out
    return x


def _logits(cfg: ModelConfig, params: Params, x: torch.Tensor) -> torch.Tensor:
    """Tied-embedding head: a plain product outside the tuned GEMM path, as
    in the reference (which leaves it to XLA)."""
    return torch.matmul(x, params["embed"].to(cfg.dtype).t()).float()


def decode_step(params: Params, cfg: ModelConfig, tokens: torch.Tensor,
                cache: Params, index) -> Tuple[torch.Tensor, Params]:
    """One decode step.  tokens (B, 1); index = current length, an int or
    a per-slot (B,) tensor.  Returns (logits (B, V), cache)."""
    x = params["embed"][tokens]
    dev = x.device
    idx = torch.as_tensor(index, device=dev)
    positions = idx.reshape(-1, 1) + torch.arange(tokens.shape[1],
                                                  device=dev)[None, :]
    x = _run_stack(cfg, params, x, positions=positions, cache=cache,
                   cache_index=index)
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    return _logits(cfg, params, x)[:, -1], cache


def prefill(params: Params, cfg: ModelConfig, batch: Dict[str, Any],
            cache: Params) -> Tuple[torch.Tensor, Params]:
    """Run the prompt through the stack, filling the cache from position 0.
    Returns (last-position logits (B, V), cache)."""
    tokens = batch["tokens"]
    x = params["embed"][tokens]
    positions = torch.arange(x.shape[1], device=x.device)
    x = _run_stack(cfg, params, x, positions=positions, cache=cache,
                   cache_index=0)
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    return _logits(cfg, params, x[:, -1:])[:, -1], cache
