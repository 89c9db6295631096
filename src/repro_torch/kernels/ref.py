"""Plain PyTorch oracles, computed in float32 (mirror ``repro.kernels.ref``)."""

from __future__ import annotations

import torch


def matmul_ref(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.matmul(a.float(), b.float()).to(a.dtype)


def same_padding(R: int, S: int) -> tuple:
    """(top, bottom, left, right) SAME padding for stride 1, XLA's rule:
    an even filter pads one more row/column after than before."""
    pt, pl = (R - 1) // 2, (S - 1) // 2
    return pt, R - 1 - pt, pl, S - 1 - pl


def conv2d_ref(i: torch.Tensor, f: torch.Tensor) -> torch.Tensor:
    """SAME-padded stride-1 conv.  i (N,H,W,C), f (R,S,C,K) -> (N,H,W,K).

    Full fp32 on any device.  cuDNN is switched off for the call: on the
    card PyTorch's own im2col of one image at a time and fp32 GEMM compute
    it (no TF32 unless ``torch.backends.cuda.matmul.allow_tf32`` is set),
    in memory that follows the shape; cuDNN takes whatever workspace its
    first heuristic choice asks for (14 GB for a 50 MB fp32 input on an
    H100, tools/tune_draw_cost.py).
    """
    pt, pb, pl, pr = same_padding(f.shape[0], f.shape[1])
    x = torch.nn.functional.pad(i.float().permute(0, 3, 1, 2),
                                (pl, pr, pt, pb))
    w = f.float().permute(3, 2, 0, 1)                       # (K, C, R, S)
    with torch.backends.cudnn.flags(enabled=False):
        out = torch.nn.functional.conv2d(x, w)
    return out.permute(0, 2, 3, 1).to(i.dtype)


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


def ssd_ref(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
            bm: torch.Tensor, cm: torch.Tensor) -> torch.Tensor:
    """Sequential SSD recurrence, the exact (slow) oracle.

    state_t = exp(a*dt_t) * state_{t-1} + dt_t * x_t (outer) B_t
    y_t     = C_t . state_t
    x (B,L,H,P), dt (B,L,H), a (H,), bm/cm (B,L,S) -> y (B,L,H,P)
    """
    B, L, H, P = x.shape
    S = bm.shape[-1]
    xf, dtf, af = x.float(), dt.float(), a.float()
    bf, cf = bm.float(), cm.float()
    state = torch.zeros((B, H, P, S), dtype=torch.float32, device=x.device)
    ys = []
    for t in range(L):
        decay = torch.exp(af[None, :] * dtf[:, t])                  # (B,H)
        contrib = torch.einsum("bh,bhp,bs->bhps", dtf[:, t], xf[:, t],
                               bf[:, t])
        state = state * decay[:, :, None, None] + contrib
        ys.append(torch.einsum("bhps,bs->bhp", state, cf[:, t]))
    return torch.stack(ys, dim=1).to(x.dtype)
