"""Plain PyTorch oracles, computed in float32 (mirror ``repro.kernels.ref``).

``conv2d_ref`` and ``ssd_ref`` arrive with the slices that port those ops.
"""

from __future__ import annotations

import torch


def matmul_ref(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.matmul(a.float(), b.float()).to(a.dtype)


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True, q_offset: int = 0) -> torch.Tensor:
    """GQA attention.  q (B,Hq,Lq,D), k/v (B,Hkv,Lkv,D)."""
    B, Hq, Lq, D = q.shape
    Hkv, Lkv = k.shape[1], k.shape[2]
    group = Hq // Hkv
    kf = k.repeat_interleave(group, dim=1).float()
    vf = v.repeat_interleave(group, dim=1).float()
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), kf) / (D ** 0.5)
    if causal:
        rows = q_offset + torch.arange(Lq, device=q.device)[:, None]
        cols = torch.arange(Lkv, device=q.device)[None, :]
        s = torch.where(cols <= rows, s, torch.full_like(s, -1e30))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p, vf).to(q.dtype)
