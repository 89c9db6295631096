"""Model building blocks on tensors (port of ``repro.models.layers``).

Every projection goes through ``repro_torch.kernels.dispatch.matmul2``, so
on the card each one runs the hand-written GEMM under its tuned config.
Parameters are plain dicts of tensors; activations keep the model dtype,
normalisation and attention run in fp32.  The reference's sharding
constraints (``constrain``) are not called here: the port has no GSPMD,
so under ``use_rules(mesh, placed=True)`` the model runs the placed
versions of these blocks (``models/placed.py``), each constraint written
out as its collective, on the rank's shards; otherwise these layers run
whole on every rank.

Where autograd records (:func:`recording`), the attention's chunk bodies
run under ``torch.utils.checkpoint``, as the reference's run under
``jax.checkpoint``: the backward pass then keeps no chunk's score matrix
alive.  Without autograd (serving, a CUDA graph capture) the same ops run
with no checkpoint wrapper.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple, Union

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.kernels import dispatch

Params = Dict[str, torch.Tensor]
IndexLike = Union[int, torch.Tensor]

NEG_INF = -1e30


def recording(*trees) -> bool:
    """Does autograd record a graph through these tensors (or the tensors
    of these nested dicts)?  Grad mode on and one of them requiring grad:
    the condition under which the training path's checkpoints apply."""
    if not torch.is_grad_enabled():
        return False

    def any_grad(t) -> bool:
        if isinstance(t, dict):
            return any(any_grad(v) for v in t.values())
        return isinstance(t, torch.Tensor) and t.requires_grad
    return any(any_grad(t) for t in trees)


def maybe_checkpoint(fn, *args, record: bool):
    """``fn(*args)``, under a non-reentrant checkpoint where ``record``:
    its activations are recomputed in the backward pass instead of kept.
    ``fn`` draws no random numbers, so no RNG state is stashed."""
    if record:
        return checkpoint(fn, *args, use_reentrant=False,
                          preserve_rng_state=False)
    return fn(*args)


# ---------------------------------------------------------------------------
# initializers
# ---------------------------------------------------------------------------

def dense_init(gen: torch.Generator, shape: Tuple[int, ...], dtype,
               fan_in: Optional[int] = None) -> torch.Tensor:
    fan_in = fan_in if fan_in is not None else shape[-2]
    scale = 1.0 / math.sqrt(max(fan_in, 1))
    return (torch.randn(shape, generator=gen, dtype=torch.float32,
                        device=gen.device) * scale).to(dtype)


def stacked_init(gen: torch.Generator, stack: Tuple[int, ...],
                 shape: Tuple[int, ...], dtype,
                 fan_in: Optional[int] = None) -> torch.Tensor:
    """``dense_init`` of ``shape`` for each index of the leading dims
    ``stack``, one slice at a time: no fp32 copy of the whole stacked
    tensor is made."""
    out = torch.empty((*stack, *shape), dtype=dtype, device=gen.device)
    flat = out.view(-1, *shape)
    for i in range(flat.shape[0]):
        flat[i] = dense_init(gen, shape, dtype, fan_in=fan_in)
    return out


def embed_init(gen: torch.Generator, vocab: int, d: int, dtype) -> torch.Tensor:
    return (torch.randn((vocab, d), generator=gen, dtype=torch.float32,
                        device=gen.device) * 0.02).to(dtype)


# ---------------------------------------------------------------------------
# norm / rope
# ---------------------------------------------------------------------------

def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-5
             ) -> torch.Tensor:
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * scale.float()).to(x.dtype)


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float
               ) -> torch.Tensor:
    """x (B, S, H, D); positions (B, S) or (S,)."""
    d = x.shape[-1]
    freqs = rope_freqs(d, theta, x.device)
    if positions.dim() == 1:
        positions = positions[None, :]
    ang = positions[..., None].float() * freqs          # (B, S, d/2)
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# GQA attention
# ---------------------------------------------------------------------------

def device_index(x: IndexLike, dev: torch.device) -> torch.Tensor:
    """A position or length, a Python int or a per-slot tensor, as an
    int64 tensor on ``dev``.  An int is filled on the device rather than
    copied from the host, so the op can be captured in a CUDA graph."""
    if isinstance(x, torch.Tensor):
        return x.to(dev)
    return torch.full((), int(x), dtype=torch.long, device=dev)


def _chunked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                       causal: bool, q_start: IndexLike,
                       kv_len: Optional[IndexLike] = None,
                       chunk: int = 1024) -> torch.Tensor:
    """Flash-style attention over KV chunks with a running (max, sum).

    q (B, Sq, H, D); k/v (B, Skv, G, D), H % G == 0.  ``q_start`` is the
    absolute position of q[0] and ``kv_len`` the number of valid KV
    positions, each a scalar or per-slot (B,).  Where autograd records,
    each chunk's body runs under a checkpoint (the reference's
    ``jax.checkpoint(body)``).
    """
    B, Sq, H, D = q.shape
    Skv, G = k.shape[1], k.shape[2]
    rep = H // G
    dev = q.device
    scale = 1.0 / math.sqrt(D)
    chunk = min(chunk, Skv)
    n_chunks = -(-Skv // chunk)
    record = recording(q, k, v)
    qf = q.float() * scale
    q_pos = (device_index(q_start, dev).reshape(-1, 1)
             + torch.arange(Sq, device=dev)[None, :])               # (B|1, Sq)
    valid = device_index(Skv if kv_len is None else kv_len,
                         dev).reshape(-1, 1, 1)

    def body(m, l, acc, kc, vc, lo):
        kb = kc.repeat_interleave(rep, dim=2).float()
        vb = vc.repeat_interleave(rep, dim=2).float()
        s = torch.einsum("bqhd,bkhd->bhqk", qf, kb)
        kv_pos = lo + torch.arange(kb.shape[1], device=dev)
        mask = kv_pos[None, None, :] < valid                       # (B|1,1,ck)
        if causal:
            mask = mask & (kv_pos[None, None, :] <= q_pos[:, :, None])
        s = torch.where(mask[:, None], s, torch.full_like(s, NEG_INF))
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum("bhqk,bkhd->bhqd", p, vb)
        return m_new, l, acc

    m = torch.full((B, H, Sq), float("-inf"), device=dev)
    l = torch.zeros((B, H, Sq), device=dev)
    acc = torch.zeros((B, H, Sq, D), device=dev)
    for c in range(n_chunks):
        lo = c * chunk
        m, l, acc = maybe_checkpoint(body, m, l, acc, k[:, lo:lo + chunk],
                                     v[:, lo:lo + chunk], lo, record=record)
    out = acc / torch.clamp(l[..., None], min=1e-30)
    return out.transpose(1, 2).to(q.dtype)                          # (B,Sq,H,D)


def _block_causal_attention(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, *, chunk: int = 1024
                            ) -> torch.Tensor:
    """Causal self-attention that skips the blocks above the diagonal (the
    reference's ``_block_causal_attention``): both axes are cut into
    chunks and only the nq·(nq+1)/2 (q chunk, kv chunk) pairs with kv <= q
    are computed, each updating its q chunk's running (max, sum, acc),
    q-major as the reference's pair list runs.  Only the diagonal block is
    masked.  Requires Sq == Skv, a start at position 0 and every position
    valid (training and a whole-prompt self-attention); Sq must be a
    multiple of min(chunk, Sq).  Each pair's body runs under a checkpoint
    where autograd records."""
    B, Sq, H, D = q.shape
    G = k.shape[2]
    rep = H // G
    dev = q.device
    ck = min(chunk, Sq)
    if Sq % ck or k.shape[1] != Sq:
        raise ValueError(f"block-causal attention wants Sq == Skv and Sq a "
                         f"multiple of the chunk; got Sq {Sq}, Skv "
                         f"{k.shape[1]}, chunk {ck}")
    nq = Sq // ck
    record = recording(q, k, v)
    qf = q.float() * (1.0 / math.sqrt(D))
    tri = torch.ones((ck, ck), dtype=torch.bool, device=dev).tril()

    def body(m, l, acc, qb, kc, vc, diag: bool):
        kb = kc.repeat_interleave(rep, dim=2).float()
        vb = vc.repeat_interleave(rep, dim=2).float()
        s = torch.einsum("bqhd,bkhd->bhqk", qb, kb)
        if diag:
            s = torch.where(tri[None, None], s, torch.full_like(s, NEG_INF))
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum("bhqk,bkhd->bhqd", p, vb)
        return m_new, l, acc

    outs = []
    for qi in range(nq):
        qb = qf[:, qi * ck:(qi + 1) * ck]
        m = torch.full((B, H, ck), float("-inf"), device=dev)
        l = torch.zeros((B, H, ck), device=dev)
        acc = torch.zeros((B, H, ck, D), device=dev)
        for ki in range(qi + 1):
            sl = slice(ki * ck, (ki + 1) * ck)
            m, l, acc = maybe_checkpoint(body, m, l, acc, qb, k[:, sl],
                                         v[:, sl], qi == ki, record=record)
        outs.append(acc / torch.clamp(l[..., None], min=1e-30))
    out = torch.cat(outs, dim=2)                                    # (B,H,Sq,D)
    return out.transpose(1, 2).to(q.dtype)


def _write_cache(cache: torch.Tensor, new: torch.Tensor, idx: torch.Tensor
                 ) -> None:
    """Write ``new`` (B, S, G, D) into ``cache`` (B, L, G, D) in place at
    per-slot positions ``idx`` (B,); positions past L are dropped, as the
    reference's ``.at[].set(mode="drop")`` drops them."""
    B, S = new.shape[:2]
    L = cache.shape[1]
    rows = torch.arange(B, device=cache.device)[:, None]
    cols = idx.to(cache.device).reshape(-1, 1) + torch.arange(
        S, device=cache.device)[None, :]
    new = new.to(cache.dtype)
    if S == 1:
        # one position per row: clamp, and write back the old value where
        # the position is dropped (no host sync, no duplicate indices)
        keep = (cols < L)[..., None, None]
        colc = cols.clamp(max=L - 1)
        cache[rows, colc] = torch.where(keep, new, cache[rows, colc])
    else:
        keep = cols < L
        rows_b = rows.expand(B, S)
        cache[rows_b[keep], cols[keep]] = new[keep]


def attention(p: Params, x: torch.Tensor, *, n_heads: int, n_kv: int,
              head_dim: int, positions: torch.Tensor, causal: bool,
              rope_theta: float, qk_norm: bool, norm_eps: float,
              cache: Optional[Params] = None,
              cache_index: Optional[IndexLike] = None,
              memory: Optional[torch.Tensor] = None,
              attn_chunk: int = 1024,
              decode_kv_splits: int = 1,
              causal_block_skip: bool = False,
              ) -> Tuple[torch.Tensor, Optional[Params]]:
    """GQA attention block body (no residual / pre-norm).

    ``cache`` {'k','v'}: (B, L_max, G, D) tensors, updated IN PLACE (the
    reference returns a new cache; writing into the caller's buffers saves
    a copy of the cache per layer and step).  ``cache_index`` is the number
    of tokens already in it, a scalar or per-slot (B,).  ``memory`` (B,
    L_enc, D), the encoder output, makes it cross-attention: K and V are
    projected from it instead of ``x``, with no RoPE on q or k, no causal
    mask and no cache.  ``causal_block_skip`` takes
    :func:`_block_causal_attention` where the reference takes it: causal
    self-attention with no cache, Sq == Skv and Sq a multiple of the
    chunk.
    """
    B, S, _ = x.shape
    kv_src = x if memory is None else memory
    Skv = kv_src.shape[1]
    q = dispatch.matmul2(x, p["wq"]).reshape(B, S, n_heads, head_dim)
    k = dispatch.matmul2(kv_src, p["wk"]).reshape(B, Skv, n_kv, head_dim)
    v = dispatch.matmul2(kv_src, p["wv"]).reshape(B, Skv, n_kv, head_dim)
    if qk_norm:
        q = rms_norm(q, p["q_norm"], norm_eps)
        k = rms_norm(k, p["k_norm"], norm_eps)
    if memory is None:
        q = apply_rope(q, positions, rope_theta)
        k = apply_rope(k, positions, rope_theta)

    kv_len = None
    q_start: IndexLike = 0
    if cache is not None:
        idx = cache_index
        if isinstance(idx, torch.Tensor) and idx.dim() == 1:
            _write_cache(cache["k"], k, idx)
            _write_cache(cache["v"], v, idx)
        else:
            i0 = int(idx)
            cache["k"][:, i0:i0 + S] = k.to(cache["k"].dtype)
            cache["v"][:, i0:i0 + S] = v.to(cache["v"].dtype)
        k, v = cache["k"], cache["v"]
        kv_len = idx + S
        q_start = idx

    n_splits = 0
    if cache is not None and S == 1 and decode_kv_splits > 1:
        from repro_torch.serve.flash_decode import (flash_decode_attention,
                                                    resolve_decode_splits)
        n_splits = resolve_decode_splits(
            B=B, Hq=n_heads, Hkv=n_kv, Lkv=k.shape[1], D=head_dim,
            dtype_bits=dispatch._dtype_bits(q.dtype), causal=int(causal),
            default=decode_kv_splits)
        if n_splits <= 1 or k.shape[1] % n_splits != 0:
            n_splits = 0
    if n_splits > 1:
        out = flash_decode_attention(q, k, v, kv_len, n_splits=n_splits)
    elif (causal_block_skip and causal and memory is None and cache is None
          and S == Skv and S % min(attn_chunk, S) == 0):
        out = _block_causal_attention(q, k, v, chunk=attn_chunk)
    else:
        out = _chunked_attention(q, k, v, causal=causal and memory is None,
                                 q_start=q_start, kv_len=kv_len,
                                 chunk=attn_chunk)
    out = out.reshape(B, S, n_heads * head_dim)
    return dispatch.matmul2(out, p["wo"]), cache


# ---------------------------------------------------------------------------
# dense SwiGLU MLP
# ---------------------------------------------------------------------------

def mlp(p: Params, x: torch.Tensor) -> torch.Tensor:
    g = dispatch.matmul2(x, p["w_gate"])
    u = dispatch.matmul2(x, p["w_up"])
    return dispatch.matmul2(torch.nn.functional.silu(g) * u, p["w_down"])
