"""GEMM and conv entry points: config defaulting, block shrinking, the
reduction of split-K / split-C partials.

Mirrors ``repro.kernels.ops.matmul`` and ``ops.conv2d``.  The kernels mask
ragged edges and the conv's SAME halo themselves, so nothing is padded
here; the shrink rules are the port's own (the TPU's lane floors of 128 do
not apply to a CTA tile).
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional

import torch

from repro_torch.core.space import CONV_PARAMS, GEMM_PARAMS

from . import conv as _conv
from . import matmul as _matmul

DEFAULT_GEMM = {"bm": 128, "bn": 128, "bk": 128, "k_unroll": 1, "k_split": 1,
                "order": 0, "acc32": 1, "prefetch": 2}

DEFAULT_CONV = {"b_npq": 64, "b_k": 64, "b_c": 32, "rs_unroll": 1,
                "c_split": 1, "order": 0, "acc32": 1, "prefetch": 2}

_MIN_BM = min(GEMM_PARAMS["bm"])
_MIN_BN = min(GEMM_PARAMS["bn"])
_MIN_BK = min(GEMM_PARAMS["bk"])


def shrink_gemm_cfg(cfg: Mapping[str, int], M: int, N: int, K: int
                    ) -> Dict[str, int]:
    """Shrink tiles larger than the problem, keeping any config runnable.

    A tile halves while it exceeds its dimension (down to the space's
    smallest tile), ``bk`` before ``k_split`` so the split parallelism
    survives on short K, and ``k_unroll`` halves until its sub-dots are
    whole 16-element slices of ``bk``.
    """
    cfg = {**DEFAULT_GEMM, **cfg}
    bm, bn, bk, ks = cfg["bm"], cfg["bn"], cfg["bk"], cfg["k_split"]
    while bm > M and bm > _MIN_BM:
        bm //= 2
    while bn > N and bn > _MIN_BN:
        bn //= 2
    while bk * ks > K and bk > _MIN_BK:
        bk //= 2
    while ks > 1 and bk * ks > max(K, bk):
        ks //= 2
    ku = cfg["k_unroll"]
    while ku > 1 and bk % (ku * 16):
        ku //= 2
    return {**cfg, "bm": bm, "bn": bn, "bk": bk, "k_split": ks, "k_unroll": ku}


def matmul(a: torch.Tensor, b: torch.Tensor,
           cfg: Optional[Mapping[str, int]] = None) -> torch.Tensor:
    """C = A @ B through the parameterised GEMM."""
    M, K = a.shape
    N = b.shape[1]
    cfg = shrink_gemm_cfg(cfg or {}, M, N, K)
    parts = _matmul.gemm(a, b, cfg)
    if cfg["k_split"] == 1:
        return parts[0]
    return parts.float().sum(dim=0).to(a.dtype)


_MIN_BNPQ = min(CONV_PARAMS["b_npq"])
_MIN_BKC = min(CONV_PARAMS["b_k"])
_MIN_BC = min(CONV_PARAMS["b_c"])


def shrink_conv_cfg(cfg: Mapping[str, int], N: int, H: int, W: int, C: int,
                    K: int, R: int, S: int) -> Dict[str, int]:
    """Shrink tiles larger than the problem, keeping any config runnable.

    ``b_npq`` and ``b_k`` halve while they exceed N*H*W and K (down to the
    space's smallest tile); ``b_c`` before ``c_split`` so the split
    parallelism survives on few channels (the reference's order);
    ``rs_unroll`` halves while it exceeds the R*S windows.
    """
    cfg = {**DEFAULT_CONV, **cfg}
    b_npq, b_k, b_c, cs = cfg["b_npq"], cfg["b_k"], cfg["b_c"], cfg["c_split"]
    while b_npq > N * H * W and b_npq > _MIN_BNPQ:
        b_npq //= 2
    while b_k > K and b_k > _MIN_BKC:
        b_k //= 2
    while b_c * cs > C and b_c > _MIN_BC:
        b_c //= 2
    while cs > 1 and b_c * cs > max(C, b_c):
        cs //= 2
    ru = cfg["rs_unroll"]
    while ru > 1 and ru > R * S:
        ru //= 2
    return {**cfg, "b_npq": b_npq, "b_k": b_k, "b_c": b_c, "c_split": cs,
            "rs_unroll": ru}


def conv2d(i: torch.Tensor, f: torch.Tensor,
           cfg: Optional[Mapping[str, int]] = None) -> torch.Tensor:
    """SAME/stride-1 conv i (N,H,W,C) * f (R,S,C,K) -> (N,H,W,K) through
    the parameterised conv."""
    N, H, W, C = i.shape
    R, S, _, K = f.shape
    cfg = shrink_conv_cfg(cfg or {}, N, H, W, C, K, R, S)
    parts = _conv.conv(i, f, cfg)
    if cfg["c_split"] == 1:
        return parts[0]
    return parts.float().sum(dim=0).to(i.dtype)
