"""GEMM entry point: config defaulting, block shrinking, split-K reduction.

Mirrors ``repro.kernels.ops.matmul``.  The kernel masks ragged edges itself,
so nothing is padded here; the shrink rules are the port's own (the TPU's
lane floors of 128 do not apply to a CTA tile).
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional

import torch

from repro_torch.core.space import GEMM_PARAMS

from . import matmul as _matmul

DEFAULT_GEMM = {"bm": 128, "bn": 128, "bk": 128, "k_unroll": 1, "k_split": 1,
                "order": 0, "acc32": 1, "prefetch": 2}

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
