"""SAME/stride-1 implicit-GEMM convolution: the CUDA kernel's wrapper and its
plain version.

Replaces ``repro.kernels.conv`` (``_conv_kernel`` / ``conv2d_pallas``).
``conv(i, f, cfg)`` returns the ``(c_split, N, H, W, K)`` partials of the
SAME convolution of ``i`` (N, H, W, C) with ``f`` (R, S, C, K) in the IO
dtype.  On a CUDA tensor it launches ``csrc/conv.cu`` (or raises); on a CPU
tensor it runs :func:`conv2d_plain`, which repeats the kernel's blocking in
PyTorch: the same split-C boundaries, the same partials in the IO dtype
and, with ``acc32=0``, the same rounding after every (r, s) window's
sub-dot over a ``b_c`` slab.
"""

from __future__ import annotations

from typing import Mapping

import torch

from repro_torch.core.space import conv_fits
from repro_torch.device import on_cuda

from . import _build
from .ref import same_padding

# kernel launches since the last reset (the tuning path's proof of use)
launches = 0

_DTYPES = {torch.bfloat16: 0, torch.float32: 1}


def _check(i: torch.Tensor, f: torch.Tensor, cfg: Mapping[str, int]) -> None:
    if i.dim() != 4 or f.dim() != 4 or i.shape[3] != f.shape[2]:
        raise ValueError(f"conv wants (N, H, W, C) * (R, S, C, K); got "
                         f"{tuple(i.shape)} * {tuple(f.shape)}")
    if i.dtype != f.dtype or i.dtype not in _DTYPES:
        raise TypeError(f"conv wants two bf16 or two fp32 operands; got "
                        f"{i.dtype} and {f.dtype}")
    if i.device != f.device:
        raise ValueError(f"operands on {i.device} and {f.device}")
    if min(i.shape) == 0 or min(f.shape) == 0:
        raise ValueError("conv wants non-empty operands")
    if not conv_fits(cfg, torch.finfo(i.dtype).bits):
        raise ValueError(f"config {dict(cfg)} is not launchable on sm_90a "
                         "(see repro_torch.core.space.conv_fits)")


def conv(i: torch.Tensor, f: torch.Tensor, cfg: Mapping[str, int]
         ) -> torch.Tensor:
    """(N, H, W, C) * (R, S, C, K) -> (c_split, N, H, W, K) partials."""
    global launches
    _check(i, f, cfg)
    if i.device.type == "cpu":
        return conv2d_plain(i, f, cfg)
    if not on_cuda(i):
        raise ValueError(f"conv runs on cuda or cpu, not {i.device}")
    if not (i.is_contiguous() and f.is_contiguous()):
        raise ValueError("conv kernel wants contiguous NHWC / RSCK operands")
    N, H, W, C = i.shape
    R, S, _, K = f.shape
    out = torch.empty((cfg["c_split"], N, H, W, K), dtype=i.dtype,
                      device=i.device)
    lib = _build.load("conv")
    with torch.cuda.device(i.device):
        stream = torch.cuda.current_stream(i.device).cuda_stream
        rc = lib.conv_launch(
            i.data_ptr(), f.data_ptr(), out.data_ptr(), N, H, W, C, K, R, S,
            _DTYPES[i.dtype], cfg["b_npq"], cfg["b_k"], cfg["b_c"],
            cfg["rs_unroll"], cfg["c_split"], cfg["acc32"], cfg["order"],
            cfg["prefetch"], stream)
    if rc != 0:
        raise RuntimeError(f"conv kernel launch failed: CUDA error {rc} for "
                           f"N={N} H={H} W={W} C={C} K={K} R={R} S={S} "
                           f"cfg={dict(cfg)}")
    launches += 1
    return out


def conv2d_plain(i: torch.Tensor, f: torch.Tensor, cfg: Mapping[str, int]
                 ) -> torch.Tensor:
    """The kernel's arithmetic in PyTorch, on any device.

    C is zero-padded to a multiple of ``b_c * c_split``; split ``s`` sums
    channels ``[s*cps*b_c, (s+1)*cps*b_c)``.  Every (r, s) window is the
    SAME-padded input shifted by (r, s), so one window's sub-dot is a GEMM
    (N*H*W, b_c) @ (b_c, K).  ``acc32=1``: fp32 sum over every slab and
    window, one cast.  ``acc32=0``: slab by slab, window by window (r
    slower than s), each sub-dot is summed in fp32 and rounded to the IO
    dtype, then added to the running sum, which is rounded again.
    """
    N, H, W, C = i.shape
    R, S, _, K = f.shape
    b_c, cs = cfg["b_c"], cfg["c_split"]
    chunk = b_c * cs
    Cp = -(-C // chunk) * chunk
    cps = Cp // chunk                                  # slabs per split
    pt, pb, pl, pr = same_padding(R, S)
    x = torch.nn.functional.pad(i.float(), (0, Cp - C, pl, pr, pt, pb))
    w = torch.nn.functional.pad(f.float(), (0, 0, 0, Cp - C))
    # every (r, s) window of the padded input: (R*S, N*H*W, Cp)
    wins = torch.stack([x[:, r:r + H, s:s + W, :].reshape(N * H * W, Cp)
                        for r in range(R) for s in range(S)])
    wf = w.reshape(R * S, Cp, K)
    parts = []
    for sp in range(cs):
        if cfg["acc32"]:
            c0, c1 = sp * cps * b_c, (sp + 1) * cps * b_c
            acc = torch.bmm(wins[:, :, c0:c1], wf[:, c0:c1]).sum(dim=0)
            parts.append(acc.to(i.dtype))
            continue
        acc = torch.zeros((N * H * W, K), dtype=i.dtype, device=i.device)
        for slab in range(cps):
            c0 = (sp * cps + slab) * b_c
            subs = torch.bmm(wins[:, :, c0:c0 + b_c],
                             wf[:, c0:c0 + b_c]).to(i.dtype)   # rounded
            for rs in range(R * S):
                acc = (acc.float() + subs[rs].float()).to(i.dtype)
        parts.append(acc)
    return torch.stack(parts).reshape(cs, N, H, W, K)
