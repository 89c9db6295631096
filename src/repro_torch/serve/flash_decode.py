"""Split-KV decode attention (flash-decoding), port of
``repro.serve.flash_decode``.

The KV length splits into ``n_splits`` blocks; each computes a partial
softmax (max, exp-sum, weighted accumulator) and the partials merge with the
log-sum-exp combine.  Plain tensor code: the reference runs it as jnp ops,
not as a Pallas kernel.
"""

from __future__ import annotations

import math

import torch

from repro_torch.models.layers import device_index


def resolve_decode_splits(*, B: int, Hq: int, Hkv: int, Lkv: int, D: int,
                          dtype_bits: int, causal: int = 1,
                          default: int = 1) -> int:
    """Split count from the tuned attention config's ``b_kv`` for the decode
    shape (``Lkv // b_kv``), the shape recorded in the telemetry first (so
    decode-split traffic is mined into plans like every kernel call);
    ``default`` when nothing tuned resolves (the
    attention space has no vendor menu: its degraded tier returns no
    config) or the block does not tile ``Lkv``.  A record tuned at this
    exact shape resolves on the exact tier; one whose config the attention
    kernel cannot launch (a TPU-tuned ``b_kv=2048``) is passed over like
    any other unlaunchable record.  The decode attention itself stays plain
    PyTorch (:func:`flash_decode_attention`), as in the reference."""
    from repro_torch.kernels import dispatch
    inputs = {"B": int(B), "Hq": int(Hq), "Hkv": int(Hkv), "Lq": 1,
              "Lkv": int(Lkv), "D": int(D), "dtype_bits": int(dtype_bits),
              "causal": int(causal)}
    dispatch._record("attention", inputs)
    cfg = dispatch._tuned_cfg("attention", inputs)
    if cfg is None:
        return default
    b_kv = int(cfg.get("b_kv", 0))
    if b_kv <= 0 or Lkv % b_kv != 0:
        return default
    return max(1, Lkv // b_kv)


def flash_decode_partials(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          kv_len, *, n_splits: int, pos0: int = 0):
    """The partial softmax of the KV block ``k`` / ``v`` (B, L, G, D),
    positions ``pos0`` .. ``pos0 + L - 1`` of the cache, in ``n_splits``
    splits combined: (max (B, 1, G, rep, Sq), sum of exponentials (B, G,
    rep, Sq), weighted accumulator (B, G, rep, Sq, D)), fp32.  q (B, Sq,
    H, D); kv_len = valid cache entries, a scalar or per-slot (B,).  A
    ``model`` rank's block of a cache cut over its length combines with
    the others' in ``models/placed.py``."""
    B, Sq, H, D = q.shape
    L, G = k.shape[1], k.shape[2]
    rep = H // G
    if L % n_splits:
        raise ValueError(f"cache length {L} does not split into {n_splits}")
    Ls = L // n_splits
    dev = q.device
    scale = 1.0 / math.sqrt(D)
    ks = k.reshape(B, n_splits, Ls, G, D).float()
    vs = v.reshape(B, n_splits, Ls, G, D).float()
    qf = (q.float() * scale).reshape(B, Sq, G, rep, D)

    s = torch.einsum("bqgrd,bnkgd->bngrqk", qf, ks)
    pos = (torch.arange(n_splits, device=dev)[:, None] * Ls
           + torch.arange(Ls, device=dev)[None, :])               # (n, Ls)
    if pos0:
        pos = pos + pos0
    valid = pos[None] < device_index(kv_len, dev).reshape(-1, 1, 1)
    s = torch.where(valid[:, :, None, None, None, :], s,
                    torch.full_like(s, -1e30))

    m_loc = s.amax(dim=-1)                                       # (B,n,G,r,Sq)
    p = torch.exp(s - m_loc[..., None])
    l_loc = p.sum(dim=-1)
    acc_loc = torch.einsum("bngrqk,bnkgd->bngrqd", p, vs)

    m_glob = m_loc.amax(dim=1, keepdim=True)
    corr = torch.exp(m_loc - m_glob)
    l_glob = (l_loc * corr).sum(dim=1)
    acc = (acc_loc * corr[..., None]).sum(dim=1)                 # (B,G,r,Sq,D)
    return m_glob, l_glob, acc


def flash_decode_out(q: torch.Tensor, l: torch.Tensor, acc: torch.Tensor
                     ) -> torch.Tensor:
    """The attention output (B, Sq, H, D) in q's dtype from the combined
    sum of exponentials and accumulator."""
    B, Sq, H, D = q.shape
    out = acc / torch.clamp(l[..., None], min=1e-30)
    return out.permute(0, 3, 1, 2, 4).reshape(B, Sq, H, D).to(q.dtype)


def flash_decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           kv_len, *, n_splits: int) -> torch.Tensor:
    """q (B, Sq, H, D); k/v (B, L, G, D); kv_len = valid cache entries, a
    scalar or per-slot (B,).  Returns (B, Sq, H, D)."""
    _, l, acc = flash_decode_partials(q, k, v, kv_len, n_splits=n_splits)
    return flash_decode_out(q, l, acc)
