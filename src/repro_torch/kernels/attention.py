"""Flash attention: the CUDA kernel's wrapper and its plain version.

Replaces ``repro.kernels.attention`` (``_attn_kernel`` /
``flash_attention_pallas``).  ``attention(q, k, v, cfg, causal=,
q_offset=)`` returns softmax(q k^T / sqrt(D)) v for q (B, Hq, Lq, D) and
k/v (B, Hkv, Lkv, D) in the IO dtype, GQA by head index (Hq a multiple of
Hkv).  On a CUDA tensor it launches ``csrc/attention.cu`` (or raises); on a
CPU tensor it runs :func:`attention_plain`, which repeats the kernel's walk
over KV blocks of ``b_kv`` rows in PyTorch: the same online softmax in
fp32, the same NEG_INF masking (causal, and KV columns past Lkv by length)
and the same cast of p to the IO dtype before p.v.
"""

from __future__ import annotations

import math
from typing import Mapping

import torch

from repro_torch.core.space import attention_fits
from repro_torch.device import on_cuda

from . import _build

# kernel launches since the last reset (the tuning path's proof of use)
launches = 0

NEG_INF = -1e30
_DTYPES = {torch.bfloat16: 0, torch.float32: 1}


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           cfg: Mapping[str, int], causal: bool, q_offset: int) -> None:
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape \
            or q.shape[0] != k.shape[0] or q.shape[3] != k.shape[3] \
            or k.shape[1] == 0 or q.shape[1] % k.shape[1]:
        raise ValueError(f"attention wants q (B, Hq, Lq, D) and k/v (B, Hkv, "
                         f"Lkv, D) with Hkv | Hq; got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in _DTYPES:
        raise TypeError(f"attention wants three bf16 or three fp32 operands; "
                        f"got {q.dtype}, {k.dtype}, {v.dtype}")
    if not (q.device == k.device == v.device):
        raise ValueError(f"operands on {q.device}, {k.device}, {v.device}")
    if min(q.shape) == 0 or min(k.shape) == 0:
        raise ValueError("attention wants non-empty operands")
    if q.shape[3] % 8:
        raise ValueError(f"attention wants a head dim D that is a multiple "
                         f"of 8 (the kernel reads rows in 16-byte pieces); "
                         f"got D={q.shape[3]}")
    if causal and q_offset < 0:
        raise ValueError(f"causal q_offset {q_offset} < 0 leaves query rows "
                         "with no key to attend to")
    if not attention_fits(cfg, torch.finfo(q.dtype).bits, q.shape[3]):
        raise ValueError(f"config {dict(cfg)} is not launchable on sm_90a at "
                         f"D={q.shape[3]} (see repro_torch.core.space."
                         "attention_fits)")


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              cfg: Mapping[str, int], *, causal: bool = True,
              q_offset: int = 0) -> torch.Tensor:
    """(B, Hq, Lq, D), (B, Hkv, Lkv, D) x2 -> (B, Hq, Lq, D) under ``cfg``."""
    global launches
    _check(q, k, v, cfg, causal, q_offset)
    if q.device.type == "cpu":
        return attention_plain(q, k, v, cfg, causal=causal, q_offset=q_offset)
    if not on_cuda(q):
        raise ValueError(f"attention runs on cuda or cpu, not {q.device}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("attention kernel wants contiguous operands")
    B, Hq, Lq, D = q.shape
    Hkv, Lkv = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    lib = _build.load("attention")
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.attention_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, Hq,
            Hkv, Lq, Lkv, D, _DTYPES[q.dtype], cfg["b_q"], cfg["b_kv"],
            int(bool(causal)), int(q_offset), cfg["prefetch"],
            1.0 / math.sqrt(D), stream)
    if rc != 0:
        raise RuntimeError(f"attention kernel launch failed: CUDA error {rc} "
                           f"for B={B} Hq={Hq} Hkv={Hkv} Lq={Lq} Lkv={Lkv} "
                           f"D={D} causal={causal} cfg={dict(cfg)}")
    launches += 1
    return out


def attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    cfg: Mapping[str, int], *, causal: bool = True,
                    q_offset: int = 0) -> torch.Tensor:
    """The kernel's arithmetic in PyTorch, on any device.

    KV blocks of ``b_kv`` rows in order (a causal walk stops at the block
    holding the last row's diagonal, as the kernel's does: later blocks add
    exactly 0); per block: s = q.k^T / sqrt(D) in fp32, NEG_INF where
    causal masks, m/l/acc updated by the online softmax, p rounded to the
    IO dtype before p.v; out = acc / max(l, 1e-30).  ``b_q`` only tiles the
    rows, which are independent, so it changes nothing here.
    """
    B, Hq, Lq, D = q.shape
    Hkv, Lkv = k.shape[1], k.shape[2]
    group = Hq // Hkv
    b_kv = cfg["b_kv"]
    scale = 1.0 / math.sqrt(D)
    qf = q.float()
    m = torch.full((B, Hq, Lq, 1), NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros_like(m)
    acc = torch.zeros((B, Hq, Lq, D), dtype=torch.float32, device=q.device)
    rows = q_offset + torch.arange(Lq, device=q.device)[:, None]
    n_blocks = -(-Lkv // b_kv)
    if causal:
        n_blocks = min(n_blocks, (q_offset + Lq - 1) // b_kv + 1)
    for t in range(n_blocks):
        k0 = t * b_kv
        kb = k[:, :, k0:k0 + b_kv].repeat_interleave(group, dim=1).float()
        vb = v[:, :, k0:k0 + b_kv].repeat_interleave(group, dim=1).float()
        s = torch.einsum("bhqd,bhkd->bhqk", qf, kb) * scale
        if causal:
            cols = k0 + torch.arange(kb.shape[2], device=q.device)[None, :]
            s = torch.where(cols <= rows, s, torch.full_like(s, NEG_INF))
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        p = torch.exp(s - m_new)
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(dim=-1, keepdim=True)
        acc = acc * alpha + torch.einsum("bhqk,bhkd->bhqd",
                                         p.to(q.dtype).float(), vb)
        m = m_new
    return (acc / torch.clamp(l, min=1e-30)).to(q.dtype)
