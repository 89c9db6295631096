"""Parameterised GEMM and its split-K reduction: the CUDA kernels' wrappers
and their plain versions.

Replaces ``repro.kernels.matmul`` (``_gemm_kernel`` / ``matmul_pallas``).
``gemm(a, b, cfg)`` returns the ``(k_split, M, N)`` partials of ``a @ b`` in
the IO dtype.  On a CUDA tensor it launches ``csrc/gemm.cu`` (or raises); on
a CPU tensor it runs :func:`matmul_plain`, which repeats the kernel's
blocking in PyTorch: the same split-K boundaries, the same partials in the
IO dtype and, with ``acc32=0``, the same per-sub-dot rounding.
``splitk_reduce(parts)`` sums the partials in fp32 and rounds once (the
reference's ``parts.sum(axis=0)`` in ``repro.kernels.ops.matmul``): on a
CUDA tensor one launch of ``gemm.cu``'s reduction pass, on a CPU tensor
:func:`splitk_reduce_plain`.  On ``meta`` tensors (the dry-run,
``launch/dryrun.py``) both give a meta tensor of their output's shape and
dtype and launch nothing.  Inside an :func:`observed` block each call of
either goes through the block's observer (the dry-run's op counter).
"""

from __future__ import annotations

import contextlib
from typing import Callable, Iterator, Mapping, Optional

import torch

from repro_torch.core.space import gemm_fits
from repro_torch.device import on_cuda

from . import _build

# kernel launches since the last reset (the serving path's proof of use):
# the GEMM kernel's and the split-K reduction pass's
launches = 0
reduce_launches = 0

_DTYPES = {torch.bfloat16: 0, torch.float32: 1}

# fp32 bytes of rounded acc32=0 sub-dots the plain version forms at once
# (all of them would take K/bk*k_unroll * M*N words: 8 GB at M=N=K=3186)
PLAIN_BLOCK_BYTES = 1 << 30

# the observer of an :func:`observed` block, or None
_OBSERVER: Optional[Callable] = None


def _check(a: torch.Tensor, b: torch.Tensor, cfg: Mapping[str, int]) -> None:
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"gemm wants (M, K) @ (K, N); got {tuple(a.shape)} "
                         f"@ {tuple(b.shape)}")
    if a.dtype != b.dtype or a.dtype not in _DTYPES:
        raise TypeError(f"gemm wants two bf16 or two fp32 operands; got "
                        f"{a.dtype} and {b.dtype}")
    if a.device != b.device:
        raise ValueError(f"operands on {a.device} and {b.device}")
    if min(a.shape[0], a.shape[1], b.shape[1]) == 0:
        raise ValueError("gemm wants non-empty operands")
    if not gemm_fits(cfg, torch.finfo(a.dtype).bits):
        raise ValueError(f"config {dict(cfg)} is not launchable on sm_90a "
                         "(see repro_torch.core.space.gemm_fits)")


@contextlib.contextmanager
def observed(observer: Callable) -> Iterator[None]:
    """Send each :func:`gemm` and :func:`splitk_reduce` call of the block
    through ``observer(name, body, *args)`` (``name``: ``"gemm"`` or
    ``"splitk_reduce"``), which returns ``body(*args)``, the wrapper's own
    work.  The block covers the whole process (a backward's GEMMs run on
    the autograd engine's device threads); blocks do not nest."""
    global _OBSERVER
    if _OBSERVER is not None:
        raise RuntimeError("matmul.observed blocks do not nest")
    _OBSERVER = observer
    try:
        yield
    finally:
        _OBSERVER = None


def gemm(a: torch.Tensor, b: torch.Tensor, cfg: Mapping[str, int]
         ) -> torch.Tensor:
    """(M, K) @ (K, N) -> (k_split, M, N) partials under ``cfg``."""
    if _OBSERVER is not None:
        return _OBSERVER("gemm", _gemm, a, b, cfg)
    return _gemm(a, b, cfg)


def _gemm(a: torch.Tensor, b: torch.Tensor, cfg: Mapping[str, int]
          ) -> torch.Tensor:
    global launches
    _check(a, b, cfg)
    if a.device.type == "cpu":
        return matmul_plain(a, b, cfg)
    if a.device.type == "meta":
        return a.new_empty((cfg["k_split"], a.shape[0], b.shape[1]))
    if not on_cuda(a):
        raise ValueError(f"gemm runs on cuda or cpu, not {a.device}")
    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError("gemm kernel wants contiguous row-major operands")
    M, K = a.shape
    N = b.shape[1]
    out = torch.empty((cfg["k_split"], M, N), dtype=a.dtype, device=a.device)
    lib = _build.load("gemm")
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        rc = lib.gemm_launch(
            a.data_ptr(), b.data_ptr(), out.data_ptr(), M, N, K,
            _DTYPES[a.dtype], cfg["bm"], cfg["bn"], cfg["bk"],
            cfg["k_split"], cfg["k_unroll"], cfg["acc32"], cfg["order"],
            cfg["prefetch"], stream)
    if rc != 0:
        raise RuntimeError(f"gemm kernel launch failed: CUDA error {rc} "
                           f"for M={M} N={N} K={K} cfg={dict(cfg)}")
    launches += 1
    return out


def matmul_plain(a: torch.Tensor, b: torch.Tensor, cfg: Mapping[str, int]
                 ) -> torch.Tensor:
    """The kernel's arithmetic in PyTorch, on any device.

    K is zero-padded to a multiple of ``bk * k_split``; split ``s`` sums
    K-range ``[s*kps*bk, (s+1)*kps*bk)``.  ``acc32=1``: fp32 sum, one cast.
    ``acc32=0``: each sub-dot of ``bk / k_unroll`` elements is summed in
    fp32 and rounded to the IO dtype, then added to the running sum, which
    is rounded again; the sub-dots are formed at most
    :data:`PLAIN_BLOCK_BYTES` of fp32 at a time (at least one per split).
    """
    M, K = a.shape
    N = b.shape[1]
    bk, ks, ku = cfg["bk"], cfg["k_split"], cfg["k_unroll"]
    chunk = bk * ks
    Kp = -(-K // chunk) * chunk
    af = torch.nn.functional.pad(a.float(), (0, Kp - K))
    bf = torch.nn.functional.pad(b.float(), (0, 0, 0, Kp - K))
    if cfg["acc32"]:
        a3 = af.reshape(M, ks, Kp // ks).permute(1, 0, 2)     # (ks, M, Kc)
        b3 = bf.reshape(ks, Kp // ks, N)                      # (ks, Kc, N)
        return torch.bmm(a3, b3).to(a.dtype)
    sub = bk // ku
    n_sub = Kp // (ks * sub)                                  # per split
    a4 = af.reshape(M, ks, n_sub, sub).permute(1, 2, 0, 3)    # (ks,S,M,sub)
    b4 = bf.reshape(ks, n_sub, sub, N)                        # (ks,S,sub,N)
    acc = torch.zeros((ks, M, N), dtype=a.dtype, device=a.device)
    step = max(1, PLAIN_BLOCK_BYTES // (4 * ks * M * N))
    for j0 in range(0, n_sub, step):
        subs = torch.matmul(a4[:, j0:j0 + step],
                            b4[:, j0:j0 + step]).to(a.dtype)  # rounded
        for j in range(subs.shape[1]):
            acc = (acc.float() + subs[:, j].float()).to(a.dtype)
    return acc


def splitk_reduce(parts: torch.Tensor) -> torch.Tensor:
    """(k_split, M, N) partials -> (M, N) in their dtype: summed in fp32 in
    split order, rounded once."""
    if _OBSERVER is not None:
        return _OBSERVER("splitk_reduce", _splitk_reduce, parts)
    return _splitk_reduce(parts)


def _splitk_reduce(parts: torch.Tensor) -> torch.Tensor:
    global reduce_launches
    if parts.dim() != 3 or parts.dtype not in _DTYPES or 0 in parts.shape:
        raise ValueError(f"splitk_reduce wants non-empty bf16 or fp32 "
                         f"(k_split, M, N) partials; got {parts.dtype} "
                         f"{tuple(parts.shape)}")
    if parts.device.type == "cpu":
        return splitk_reduce_plain(parts)
    if parts.device.type == "meta":
        return parts.new_empty(parts.shape[1:])
    if not on_cuda(parts):
        raise ValueError(f"splitk_reduce runs on cuda or cpu, not "
                         f"{parts.device}")
    if not parts.is_contiguous():
        raise ValueError("splitk_reduce wants contiguous partials")
    ks, M, N = parts.shape
    out = torch.empty((M, N), dtype=parts.dtype, device=parts.device)
    lib = _build.load("gemm")
    with torch.cuda.device(parts.device):
        stream = torch.cuda.current_stream(parts.device).cuda_stream
        rc = lib.splitk_reduce_launch(parts.data_ptr(), out.data_ptr(), ks, M,
                                      N, _DTYPES[parts.dtype], stream)
    if rc != 0:
        raise RuntimeError(f"split-K reduction launch failed: CUDA error "
                           f"{rc} for {tuple(parts.shape)}")
    reduce_launches += 1
    return out


def splitk_reduce_plain(parts: torch.Tensor) -> torch.Tensor:
    """The reduction pass's arithmetic in PyTorch, on any device."""
    return parts.float().sum(dim=0).to(parts.dtype)
