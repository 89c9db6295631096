"""Dense decoder LM (port of the dense path of ``repro.models.model``).

Parameters keep the reference's pytree layout — ``embed``, ``final_norm``
and ``layers.pos0.*`` stacked over the repeats — so a reference parameter
tree converts leaf by leaf (``repro_torch.weights``) and the decode cache
has the reference's ``(repeats, B, L, G, D)`` shape.  The forward pass is a
Python loop over the repeats in place of ``jax.lax.scan``.

Entry points:
  init_params(cfg, gen)                         -> params
  init_cache(cfg, batch, max_len, device)      -> decode cache
  prefill(params, cfg, batch, cache)           -> (last logits (B, V), cache)
  decode_step(params, cfg, tokens, cache, index) -> (logits (B, V), cache)

MoE, SSM, encoder-decoder and frontend configurations raise
``NotImplementedError``: they arrive with later slices.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Tuple

import torch

from . import layers as L

Params = Dict[str, Any]

ATTN, DENSE = "attn", "dense"


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
    ssm_state: int = 0
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
        """The port's model covers the dense (attn, dense) pattern only."""
        if (self.pattern != ((ATTN, DENSE),) or self.n_experts
                or self.ssm_state or self.encoder_layers
                or self.frontend != "none" or not self.tie_embeddings):
            raise NotImplementedError(
                f"{self.name}: only dense attention+SwiGLU models are ported "
                "(MoE, SSM, enc-dec and frontends arrive with later slices)")


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def init_params(cfg: ModelConfig, gen: torch.Generator) -> Params:
    """Random parameters from ``gen`` (on the generator's device).

    Not the reference's numbers: ``jax.random`` and ``torch.Generator``
    differ.  Parity tests convert a reference tree with
    ``repro_torch.weights.params_from_jax`` instead.
    """
    cfg.check_supported()
    R, d, f, hd, dt = cfg.n_repeats, cfg.d_model, cfg.d_ff, cfg.hd, cfg.dtype
    ones = lambda *shape: torch.ones(shape, dtype=dt, device=gen.device)
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
    layer = {
        "norm1": ones(R, d),
        "norm2": ones(R, d),
        "attn": attn,
        "mlp": {"w_gate": L.dense_init(gen, (R, d, f), dt, fan_in=d),
                "w_up": L.dense_init(gen, (R, d, f), dt, fan_in=d),
                "w_down": L.dense_init(gen, (R, f, d), dt, fan_in=f)},
    }
    return {"embed": L.embed_init(gen, cfg.padded_vocab, d, dt),
            "final_norm": ones(d),
            "layers": {"pos0": layer}}


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               device: torch.device) -> Params:
    """Decode cache, stacked over repeats like the params."""
    cfg.check_supported()
    shape = (cfg.n_repeats, batch, max_len, cfg.n_kv, cfg.hd)
    return {"pos0": {"attn": {
        "k": torch.zeros(shape, dtype=cfg.dtype, device=device),
        "v": torch.zeros(shape, dtype=cfg.dtype, device=device)}}}


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------

def _slice(tree: Any, r: int) -> Any:
    if isinstance(tree, dict):
        return {k: _slice(v, r) for k, v in tree.items()}
    return tree[r]


def _layers(params: Params) -> List[Params]:
    stack = params["layers"]["pos0"]
    n = stack["norm1"].shape[0]
    return [_slice(stack, r) for r in range(n)]


def _run_stack(cfg: ModelConfig, params: Params, x: torch.Tensor, *,
               positions: torch.Tensor, cache: Params, cache_index
               ) -> torch.Tensor:
    """Pre-norm residual (attn, SwiGLU) blocks over the repeats; the cache
    slices of each repeat are written in place."""
    cache_k = cache["pos0"]["attn"]["k"]
    cache_v = cache["pos0"]["attn"]["v"]
    for r, p in enumerate(_layers(params)):
        h = L.rms_norm(x, p["norm1"], cfg.norm_eps)
        out, _ = L.attention(
            p["attn"], h, n_heads=cfg.n_heads, n_kv=cfg.n_kv, head_dim=cfg.hd,
            positions=positions, causal=True, rope_theta=cfg.rope_theta,
            qk_norm=cfg.qk_norm, norm_eps=cfg.norm_eps,
            cache={"k": cache_k[r], "v": cache_v[r]},
            cache_index=cache_index, attn_chunk=cfg.attn_chunk,
            decode_kv_splits=cfg.decode_kv_splits)
        x = x + out
        h = L.rms_norm(x, p["norm2"], cfg.norm_eps)
        x = x + L.mlp(p["mlp"], h)
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
