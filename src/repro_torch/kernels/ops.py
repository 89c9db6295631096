"""Kernel entry points: config defaulting, block shrinking, the reduction of
split-K / split-C partials.

Mirrors ``repro.kernels.ops`` (``matmul``, ``conv2d``, ``flash_attention``,
``ssd_scan``).  The kernels mask ragged edges, the conv's SAME halo, KV
columns past Lkv and SSD steps past L themselves, so nothing is padded
here; the shrink rules are the port's own (the TPU's lane floors of 128 do
not apply to a CTA tile).  Unlike the reference's ``flash_attention``, a
non-causal call with a ragged KV length is never turned into a causal one
with an offset (exact only for Lq == 1): the kernel masks by length.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional

import torch

from repro_torch.core.space import (ATTENTION_PARAMS, CONV_PARAMS,
                                    GEMM_PARAMS, SSD_PARAMS, attention_fits,
                                    ssd_fits)

from . import attention as _attention
from . import conv as _conv
from . import matmul as _matmul
from . import ssd as _ssd

DEFAULT_GEMM = {"bm": 128, "bn": 128, "bk": 128, "k_unroll": 1, "k_split": 1,
                "order": 0, "acc32": 1, "prefetch": 2}

DEFAULT_CONV = {"b_npq": 64, "b_k": 64, "b_c": 32, "rs_unroll": 1,
                "c_split": 1, "order": 0, "acc32": 1, "prefetch": 2}

DEFAULT_ATTN = {"b_q": 64, "b_kv": 64, "acc32": 1, "prefetch": 2}

DEFAULT_SSD = {"chunk": 64, "b_heads": 1, "acc32": 1, "prefetch": 2}

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


_MIN_BQ = min(ATTENTION_PARAMS["b_q"])
_MIN_BKV = min(ATTENTION_PARAMS["b_kv"])


def _dtype_bits(dtype: torch.dtype) -> int:
    return torch.finfo(dtype).bits


def _round16(n: int) -> int:
    return -(-n // 16) * 16


def shrink_attention_cfg(cfg: Mapping[str, int], Lq: int, Lkv: int, D: int,
                         dtype_bits: int) -> Dict[str, int]:
    """Shrink tiles larger than the problem, keeping any config runnable.

    ``b_q`` and ``b_kv`` halve while they exceed Lq and Lkv rounded up to
    16 (a decode step runs ``b_q=16``); then, while the config does not fit
    the CTA at this head dim, ``prefetch`` drops, then ``b_kv`` halves,
    then ``b_q``.  A legal config (``attention_is_legal``) is left as it
    is.
    """
    cfg = {**DEFAULT_ATTN, **cfg}
    while cfg["b_q"] > _round16(Lq) and cfg["b_q"] > _MIN_BQ:
        cfg["b_q"] //= 2
    while cfg["b_kv"] > _round16(Lkv) and cfg["b_kv"] > _MIN_BKV:
        cfg["b_kv"] //= 2
    while not attention_fits(cfg, dtype_bits, D):
        if cfg["prefetch"] > 1:
            cfg["prefetch"] -= 1
        elif cfg["b_kv"] > _MIN_BKV:
            cfg["b_kv"] //= 2
        elif cfg["b_q"] > _MIN_BQ:
            cfg["b_q"] //= 2
        else:
            break                       # the wrapper says why it cannot run
    return cfg


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    cfg: Optional[Mapping[str, int]] = None, *,
                    causal: bool = True, q_offset: int = 0) -> torch.Tensor:
    """Flash attention q (B, Hq, Lq, D), k/v (B, Hkv, Lkv, D) -> (B, Hq,
    Lq, D); causal row i attends key columns <= q_offset + i (the
    reference's semantics; a decode step over a cache of Lkv passes
    ``q_offset = Lkv - Lq``)."""
    Lq, D = q.shape[2], q.shape[3]
    cfg = shrink_attention_cfg(cfg or {}, Lq, k.shape[2], D,
                               _dtype_bits(q.dtype))
    return _attention.attention(q, k, v, cfg, causal=causal,
                                q_offset=q_offset)


_MIN_CHUNK = min(SSD_PARAMS["chunk"])


def shrink_ssd_cfg(cfg: Mapping[str, int], L: int, H: int, P: int, S: int,
                   dtype_bits: int) -> Dict[str, int]:
    """Shrink the chunk to the sequence and the head block to H, keeping any
    config runnable.

    ``chunk`` halves while it exceeds L rounded up to 16; ``b_heads``
    halves until it divides H (the reference's rule); then, while the
    config does not fit the CTA at these P and S, ``prefetch`` drops, then
    ``b_heads`` halves, then ``chunk``.  A legal config (``ssd_is_legal``)
    is left as it is.
    """
    cfg = {**DEFAULT_SSD, **cfg}
    while cfg["chunk"] > _round16(L) and cfg["chunk"] > _MIN_CHUNK:
        cfg["chunk"] //= 2
    while H % cfg["b_heads"]:
        cfg["b_heads"] //= 2
    while not ssd_fits(cfg, dtype_bits, P, S):
        if cfg["prefetch"] > 1:
            cfg["prefetch"] -= 1
        elif cfg["b_heads"] > 1:
            cfg["b_heads"] //= 2
        elif cfg["chunk"] > _MIN_CHUNK:
            cfg["chunk"] //= 2
        else:
            break                       # the wrapper says why it cannot run
    return cfg


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
             bm: torch.Tensor, cm: torch.Tensor,
             cfg: Optional[Mapping[str, int]] = None) -> torch.Tensor:
    """Mamba-2 SSD chunk scan: x (B, L, H, P), dt (B, L, H), a (H,), B/C
    (B, L, S) -> y (B, L, H, P); any L (a ragged last chunk is masked by
    length, which equals the reference's dt = 0 padding)."""
    B, L, H, P = x.shape
    cfg = shrink_ssd_cfg(cfg or {}, L, H, P, bm.shape[-1],
                         _dtype_bits(x.dtype))
    return _ssd.ssd(x, dt, a, bm, cm, cfg)
