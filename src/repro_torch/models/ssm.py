"""Mamba-2 (SSD, state-space duality) mixer on tensors (port of
``repro.models.ssm``).

Prefill runs the *chunked* SSD form (arXiv:2405.21060): the sequence is
split into chunks of Q steps; within a chunk the recurrence is a masked
attention-like product, across chunks a loop carries the (H, P, S) state.
As in the reference's ``mamba_block``, the scan is :func:`ssd_chunked` in
plain PyTorch, not the SSD kernel (``kernels/ssd.py``): the reference's
module docstring says the dispatcher routes to the kernel, but its code
calls the jnp form, and the port follows the code.  Decode is the O(1)
recurrence on a carried state (:func:`ssd_decode_step`).

The two projections go through ``dispatch.matmul2``, so on the card they
run the hand-written GEMM under their tuned configs.  With a cache,
:func:`mamba_block` writes the new conv and SSM state into the cache's
tensors in place (the reference returns a new cache), so a captured CUDA
graph keeps its addresses.  Unlike a KV cache, that write is not
idempotent: running a decode step twice advances the state twice.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import dispatch

from .layers import Params, dense_init, rms_norm

CONV_WIDTH = 4

# the leaves the reference keeps in fp32 whatever the model dtype
FP32_LEAVES = ("a_log", "dt_bias", "d_skip")


def init_mamba(gen: torch.Generator, d_model: int, state: int, head_dim: int,
               dtype: torch.dtype, stack: Tuple[int, ...] = ()) -> Params:
    """Random mixer parameters from ``gen``, each leaf with the leading
    dims ``stack`` (the repeats a model stacks its layers over).  The
    reference's layout and dtypes; ``a_log``, ``dt_bias`` and ``d_skip``
    are fp32 and the same in every repeat."""
    d_inner = 2 * d_model
    n_heads = d_inner // head_dim
    conv_ch = d_inner + 2 * state
    dev = gen.device

    def fp32(v: torch.Tensor) -> torch.Tensor:
        return v.expand(*stack, n_heads).contiguous()

    conv_w = torch.randn((*stack, CONV_WIDTH, conv_ch), generator=gen,
                         dtype=torch.float32, device=dev)
    return {
        "w_in": dense_init(gen, (*stack, d_model,
                                 2 * d_inner + 2 * state + n_heads), dtype,
                           fan_in=d_model),
        "conv_w": (conv_w / math.sqrt(CONV_WIDTH)).to(dtype),
        "conv_b": torch.zeros((*stack, conv_ch), dtype=dtype, device=dev),
        "a_log": fp32(torch.log(torch.linspace(1.0, 16.0, n_heads,
                                               dtype=torch.float32,
                                               device=dev))),
        "dt_bias": fp32(torch.zeros(n_heads, dtype=torch.float32,
                                    device=dev)),
        "d_skip": fp32(torch.ones(n_heads, dtype=torch.float32, device=dev)),
        "norm": torch.ones((*stack, d_inner), dtype=dtype, device=dev),
        "w_out": dense_init(gen, (*stack, d_inner, d_model), dtype,
                            fan_in=d_inner),
    }


def _split_proj(proj: torch.Tensor, d_inner: int, state: int, n_heads: int
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(z, xBC, dt) of the fused input projection."""
    return torch.split(proj, [d_inner, d_inner + 2 * state, n_heads], dim=-1)


def _causal_conv(xbc: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 state: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Depthwise causal conv1d, width CONV_WIDTH.  xbc (B, L, C); state
    (B, CONV_WIDTH-1, C) holds the last inputs before xbc.  Returns
    (out (B, L, C), new state: the last CONV_WIDTH-1 inputs)."""
    B, L, C = xbc.shape
    if state is None:
        state = torch.zeros((B, CONV_WIDTH - 1, C), dtype=xbc.dtype,
                            device=xbc.device)
    full = torch.cat([state, xbc], dim=1)                  # (B, L+W-1, C)
    out = torch.zeros((B, L, C), dtype=torch.float32, device=xbc.device)
    for i in range(CONV_WIDTH):
        out = out + full[:, i:i + L].float() * w[i].float()
    out = F.silu(out + b.float()).to(xbc.dtype)
    return out, full[:, L:L + CONV_WIDTH - 1]


def ssd_chunked(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                bm: torch.Tensor, cm: torch.Tensor, *, chunk: int = 256,
                return_final_state: bool = False):
    """Chunked SSD.  x (B, L, H, P), dt (B, L, H) (after softplus), a (H,)
    (< 0), bm / cm (B, L, S).  Returns y (B, L, H, P) in x's dtype, and
    the final (B, H, P, S) fp32 state when ``return_final_state`` (what
    prefill leaves in the cache).  L is zero-padded to a multiple of
    Q = min(chunk, L)."""
    B, L, H, P = x.shape
    S = bm.shape[-1]
    Q = min(chunk, L)
    pad = (-L) % Q
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        bm = F.pad(bm, (0, 0, 0, pad))
        cm = F.pad(cm, (0, 0, 0, pad))
    nc = (L + pad) // Q

    xf = x.reshape(B, nc, Q, H, P).float()
    dtf = dt.reshape(B, nc, Q, H).float()
    bf = bm.reshape(B, nc, Q, S).float()
    cf = cm.reshape(B, nc, Q, S).float()

    cum = torch.cumsum(a.float() * dtf, dim=2)             # (B,nc,Q,H) <= 0
    # intra-chunk: y[t] += sum_{s<=t} C_t.B_s exp(cum_t - cum_s) dt_s x_s.
    # The EXPONENT is masked, not the exp: s > t gives cum_t - cum_s > 0,
    # which overflows to inf under strong decay.
    diff = cum[:, :, :, None, :] - cum[:, :, None, :, :]   # (B,nc,t,s,H)
    mask = torch.ones((Q, Q), dtype=torch.bool, device=x.device).tril()
    decay = torch.exp(torch.where(mask[None, None, :, :, None], diff,
                                  torch.full_like(diff, float("-inf"))))
    cb = torch.einsum("bnts,bnqs->bntq", cf, bf)           # (B,nc,t,s)
    scores = cb[..., None] * decay * dtf[:, :, None, :, :]
    y_intra = torch.einsum("bntsh,bnshp->bnthp", scores, xf)

    # chunk states: S_c = sum_s exp(cum_last - cum_s) dt_s x_s (x) B_s
    seg = torch.exp(cum[:, :, -1:, :] - cum)               # (B,nc,Q,H)
    contrib = torch.einsum("bnqh,bnqhp,bnqs->bnhps", seg * dtf, xf, bf)
    total = torch.exp(cum[:, :, -1, :])                    # (B,nc,H)

    # the reference's lax.scan across chunks: the state BEFORE each chunk
    state = torch.zeros((B, H, P, S), dtype=torch.float32, device=x.device)
    prev = []
    for c in range(nc):
        prev.append(state)
        state = state * total[:, c, :, None, None] + contrib[:, c]
    prev_states = torch.stack(prev, dim=1)                 # (B,nc,H,P,S)

    # inter-chunk: y[t] += C_t . (exp(cum_t) * state_prev)
    y_inter = torch.einsum("bnqs,bnqh,bnhps->bnqhp", cf, torch.exp(cum),
                           prev_states)
    y = (y_intra + y_inter).reshape(B, L + pad, H, P)[:, :L].to(x.dtype)
    if return_final_state:
        return y, state
    return y


def ssd_decode_step(state: torch.Tensor, x: torch.Tensor, dt: torch.Tensor,
                    a: torch.Tensor, bm: torch.Tensor, cm: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One-token recurrence.  state (B, H, P, S); x (B, H, P); dt (B, H);
    bm / cm (B, S).  Returns (new state, y (B, H, P))."""
    decay = torch.exp(a[None, :] * dt)                     # (B,H)
    contrib = torch.einsum("bh,bhp,bs->bhps", dt, x, bm)
    new_state = state * decay[:, :, None, None] + contrib
    y = torch.einsum("bhps,bs->bhp", new_state, cm)
    return new_state, y


def mamba_inputs(p: Params, x: torch.Tensor, *, state: int, head_dim: int,
                 conv_state: Optional[torch.Tensor] = None,
                 project: Optional[Callable[[torch.Tensor], torch.Tensor]]
                 = None):
    """The mixer up to its scan: the input projection, dt, a and the
    causal conv, on the heads ``p`` holds (its ``a_log``'s: all of them,
    or a rank's under head-parallel TP, with the conv channels that go
    with them).  ``project`` gives the input projection of x in place of
    ``x @ p["w_in"]``.  Returns (z, xh (B, L, H, head_dim), dt (B, L, H)
    fp32, a (H,) fp32, B (B, L, S), C (B, L, S), new conv state)."""
    B, L, _ = x.shape
    H = p["a_log"].shape[-1]
    d_inner = H * head_dim
    proj = (project(x) if project is not None
            else dispatch.matmul2(x, p["w_in"]))
    z, xbc, dt_raw = _split_proj(proj, d_inner, state, H)
    # F.softplus returns its input above its threshold of 20 where
    # jax.nn.softplus computes log1p(exp(x)); the two differ by < 2e-9
    dt = F.softplus(dt_raw.float() + p["dt_bias"][None, None, :])
    a = -torch.exp(p["a_log"])
    xbc, new_conv = _causal_conv(xbc, p["conv_w"], p["conv_b"], conv_state)
    xs, bmat, cmat = torch.split(xbc, [d_inner, state, state], dim=-1)
    return z, xs.reshape(B, L, H, head_dim), dt, a, bmat, cmat, new_conv


def mamba_block(p: Params, x: torch.Tensor, *, d_model: int, state: int,
                head_dim: int, chunk: int = 256,
                cache: Optional[Dict[str, torch.Tensor]] = None,
                project_in: Optional[Callable[[torch.Tensor], torch.Tensor]]
                = None,
                project_out: Optional[Callable[[torch.Tensor], torch.Tensor]]
                = None,
                sum_sq: Optional[Callable[[torch.Tensor], torch.Tensor]] = None
                ) -> Tuple[torch.Tensor, Optional[Dict[str, torch.Tensor]]]:
    """The Mamba-2 mixer.  x (B, L, D).  ``cache`` {'conv': (B, W-1, C),
    'ssm': (B, H, P, S)} is read as the state before x and overwritten IN
    PLACE with the state after it: one step (L == 1, the decode branch,
    taken by a 1-token prefill too) or a prefill from the cache's state
    (zero in a fresh cache).  Without a cache: the training/prefill scan
    from zero state.

    Head-parallel TP (``models/placed.py``) runs it on a rank's heads:
    ``p`` holds their ``a_log``, ``dt_bias``, ``d_skip`` and ``norm``
    channels and the conv's channels (``sharding.mamba_conv_channels``),
    the cache their state; ``project_in`` / ``project_out`` stand for the
    products with ``w_in`` / ``w_out`` (the rank's head-aligned columns,
    its rows); ``sum_sq`` totals the gated norm's per-token sum of
    squares over the ranks, which then divides by the whole
    d_inner = 2·d_model."""
    B, L, _ = x.shape
    z, xh, dt, a, bmat, cmat, new_conv = mamba_inputs(
        p, x, state=state, head_dim=head_dim,
        conv_state=cache["conv"] if cache is not None else None,
        project=project_in)

    if cache is not None and L == 1:        # decode step
        new_ssm, y = ssd_decode_step(
            cache["ssm"], xh[:, 0].float(), dt[:, 0], a, bmat[:, 0].float(),
            cmat[:, 0].float())
        y = y[:, None]                                      # (B,1,H,P)
    elif cache is not None:                 # prefill: the final state kept
        y, new_ssm = ssd_chunked(xh, dt, a, bmat, cmat, chunk=chunk,
                                 return_final_state=True)
    else:
        y = ssd_chunked(xh, dt, a, bmat, cmat, chunk=chunk)
    if cache is not None:
        cache["conv"].copy_(new_conv)
        cache["ssm"].copy_(new_ssm)

    # fp32 in both branches: y is fp32 (decode) or x's dtype (prefill)
    # times the fp32 d_skip, as the reference's promotion gives
    y = y + xh.to(y.dtype) * p["d_skip"][None, None, :, None]
    y = y.reshape(B, L, -1)
    # gated RMSNorm (mamba2 style) under rms_norm's default eps, as the
    # reference calls it
    g = y.to(x.dtype) * F.silu(z.float()).to(x.dtype)
    if sum_sq is None:
        y = rms_norm(g, p["norm"])
    else:
        gf = g.float()
        ss = sum_sq((gf * gf).sum(dim=-1, keepdim=True))
        y = (gf * torch.rsqrt(ss / (2 * d_model) + 1e-5)
             * p["norm"].float()).to(x.dtype)
    out = (project_out(y) if project_out is not None
           else dispatch.matmul2(y, p["w_out"]))
    return out, cache


def init_mamba_cache(batch: int, d_model: int, state: int, head_dim: int,
                     dtype: torch.dtype, device: torch.device,
                     stack: Tuple[int, ...] = ()) -> Dict[str, torch.Tensor]:
    """Zero conv state in the model dtype and zero SSM state in fp32, with
    the leading dims ``stack``."""
    d_inner = 2 * d_model
    H = d_inner // head_dim
    return {
        "conv": torch.zeros((*stack, batch, CONV_WIDTH - 1,
                             d_inner + 2 * state), dtype=dtype,
                            device=device),
        "ssm": torch.zeros((*stack, batch, H, head_dim, state),
                           dtype=torch.float32, device=device),
    }
