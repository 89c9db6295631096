"""Mamba-2 SSD chunk scan: the CUDA kernel's wrapper and its plain version.

Replaces ``repro.kernels.ssd`` (``_ssd_kernel`` / ``ssd_scan_pallas``).
``ssd(x, dt, a, bm, cm, cfg)`` returns y (B, L, H, P) in the IO dtype for x
(B, L, H, P), dt (B, L, H), a (H,) and B/C (B, L, S) (ngroups = 1).  On a
CUDA tensor it launches ``csrc/ssd.cu`` (or raises); on a CPU tensor it
runs :func:`ssd_plain`, which repeats the kernel's chunked algorithm in
PyTorch: the same chunks of ``chunk`` steps, the exponent masked before the
exp, the fp32 state carried across chunks, and a ragged L as zero steps
(dt = 0 is the identity).
"""

from __future__ import annotations

from typing import Mapping

import torch

from repro_torch.core.space import ssd_fits
from repro_torch.device import on_cuda

from . import _build

# kernel launches since the last reset (the tuning path's proof of use)
launches = 0

_DTYPES = {torch.bfloat16: 0, torch.float32: 1}


def _check(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
           bm: torch.Tensor, cm: torch.Tensor, cfg: Mapping[str, int]) -> None:
    if x.dim() != 4 or dt.shape != x.shape[:3] or a.shape != x.shape[2:3] \
            or bm.dim() != 3 or bm.shape[:2] != x.shape[:2] \
            or cm.shape != bm.shape:
        raise ValueError(f"ssd wants x (B, L, H, P), dt (B, L, H), a (H,), "
                         f"B/C (B, L, S); got {tuple(x.shape)}, "
                         f"{tuple(dt.shape)}, {tuple(a.shape)}, "
                         f"{tuple(bm.shape)}, {tuple(cm.shape)}")
    if not (x.dtype == dt.dtype == bm.dtype == cm.dtype) \
            or x.dtype not in _DTYPES or not a.is_floating_point():
        raise TypeError(f"ssd wants x, dt, B, C all bf16 or all fp32 and a "
                        f"float a; got {x.dtype}, {dt.dtype}, {bm.dtype}, "
                        f"{cm.dtype}, {a.dtype}")
    if len({t.device for t in (x, dt, a, bm, cm)}) != 1:
        raise ValueError("ssd operands on different devices")
    if min(x.shape) == 0 or bm.shape[2] == 0:
        raise ValueError("ssd wants non-empty operands")
    if x.shape[3] % 8 or bm.shape[2] % 8:
        raise ValueError(f"ssd wants a head dim P and a state dim S that are "
                         f"multiples of 8 (the kernel reads rows in 16-byte "
                         f"pieces); got P={x.shape[3]} S={bm.shape[2]}")
    if x.shape[2] % cfg["b_heads"]:
        raise ValueError(f"b_heads {cfg['b_heads']} does not divide "
                         f"H={x.shape[2]}")
    if not ssd_fits(cfg, torch.finfo(x.dtype).bits, x.shape[3], bm.shape[2]):
        raise ValueError(f"config {dict(cfg)} is not launchable on sm_90a at "
                         f"P={x.shape[3]} S={bm.shape[2]} (see repro_torch."
                         "core.space.ssd_fits)")


def ssd(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor, bm: torch.Tensor,
        cm: torch.Tensor, cfg: Mapping[str, int]) -> torch.Tensor:
    """The SSD scan of (x, dt, a, B, C) under ``cfg`` -> y (B, L, H, P)."""
    global launches
    _check(x, dt, a, bm, cm, cfg)
    if x.device.type == "cpu":
        return ssd_plain(x, dt, a, bm, cm, cfg)
    if not on_cuda(x):
        raise ValueError(f"ssd runs on cuda or cpu, not {x.device}")
    if not all(t.is_contiguous() for t in (x, dt, a, bm, cm)):
        raise ValueError("ssd kernel wants contiguous operands")
    B, L, H, P = x.shape
    S = bm.shape[2]
    a = a.float().contiguous()
    y = torch.empty_like(x)
    lib = _build.load("ssd")
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.ssd_launch(
            x.data_ptr(), dt.data_ptr(), a.data_ptr(), bm.data_ptr(),
            cm.data_ptr(), y.data_ptr(), B, L, H, P, S, _DTYPES[x.dtype],
            cfg["chunk"], cfg["b_heads"], cfg["prefetch"], stream)
    if rc != 0:
        raise RuntimeError(f"ssd kernel launch failed: CUDA error {rc} for "
                           f"B={B} L={L} H={H} P={P} S={S} cfg={dict(cfg)}")
    launches += 1
    return y


def ssd_plain(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
              bm: torch.Tensor, cm: torch.Tensor, cfg: Mapping[str, int]
              ) -> torch.Tensor:
    """The kernel's arithmetic in PyTorch, on any device.

    L is zero-padded to a multiple of ``chunk`` (dt = 0: the identity
    step); per chunk, in fp32: cum = cumsum(dt * a); the intra-chunk scores
    (C_i . B_j) * exp(cum_i - cum_j), with the exponent masked to -inf
    where j > i before the exp; the carried state's contribution
    exp(cum_i) * C_i . state; then the state decays by exp(cum_last) and
    gains sum_j exp(cum_last - cum_j) dt_j x_j B_j^T.  ``b_heads`` only
    groups heads, which are independent, so it changes nothing here.
    """
    B, L, H, P = x.shape
    S = bm.shape[-1]
    c = cfg["chunk"]
    n = -(-L // c)
    pad = n * c - L
    xf = torch.nn.functional.pad(x.float(), (0, 0, 0, 0, 0, pad))
    dtf = torch.nn.functional.pad(dt.float(), (0, 0, 0, pad))
    bf = torch.nn.functional.pad(bm.float(), (0, 0, 0, pad))
    cf = torch.nn.functional.pad(cm.float(), (0, 0, 0, pad))
    af = a.float()
    causal = torch.ones((c, c), dtype=torch.bool, device=x.device).tril()
    state = torch.zeros((B, H, P, S), dtype=torch.float32, device=x.device)
    ys = []
    for ci in range(n):
        sl = slice(ci * c, (ci + 1) * c)
        xc, dtc, bc, cc = xf[:, sl], dtf[:, sl], bf[:, sl], cf[:, sl]
        cum = torch.cumsum(dtc * af, dim=1)                     # (B, c, H)
        cb = torch.einsum("bis,bjs->bij", cc, bc)
        diff = cum[:, :, None, :] - cum[:, None, :, :]          # (B, i, j, H)
        diff = torch.where(causal[None, :, :, None], diff,
                           torch.full_like(diff, float("-inf")))
        scores = cb[..., None] * torch.exp(diff)
        y = torch.einsum("bijh,bjhp->bihp", scores, xc * dtc[..., None])
        y = y + torch.einsum("bis,bhps,bih->bihp", cc, state, torch.exp(cum))
        ys.append(y)
        tail = torch.exp(cum[:, -1:, :] - cum)                  # (B, c, H)
        contrib = torch.einsum("bjh,bjhp,bjs->bhps", tail * dtc, xc, bc)
        state = state * torch.exp(cum[:, -1])[:, :, None, None] + contrib
    return torch.cat(ys, dim=1)[:, :L].to(x.dtype)
