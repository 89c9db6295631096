"""AdamW with dtype-configurable optimizer states (port of
``repro.optim.adamw``).

The update math runs in fp32 whatever the storage dtype of the parameters
and of the states (``state_dtype``: bf16 halves the optimizer's memory).
Plain PyTorch ops, as the reference's AdamW is plain ``jnp``: no fused
optimizer kernel, no library optimizer.

Trees are nested dicts of tensors.  The step count is a host int, so the
schedule, the bias corrections and the learning rate are host numbers (the
reference computes them in fp32 on the device; the two differ by fp32
rounding); the global norm and the clip factor stay on the device, so a
step reads nothing back.  ``adamw_update`` writes the new parameters and
states into the given tensors in place (the reference's ``donate_argnums``
reuses the buffers alike) and returns them.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch.models import tree_leaves


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    state_dtype: torch.dtype = torch.float32   # bf16 at 100B+ scale
    warmup_steps: int = 100
    total_steps: int = 10000
    min_lr_frac: float = 0.1


class AdamWState(NamedTuple):
    step: int
    m: Any
    v: Any


def _map(fn, *trees: Any) -> Any:
    """``fn`` over the leaves of trees of one structure (the first's)."""
    if isinstance(trees[0], dict):
        return {k: _map(fn, *(t[k] for t in trees)) for k in trees[0]}
    return fn(*trees)


def adamw_init(params: Any, cfg: AdamWConfig) -> AdamWState:
    """Zero m and v in ``cfg.state_dtype`` beside each parameter."""
    zeros = lambda p: torch.zeros(p.shape, dtype=cfg.state_dtype,
                                  device=p.device)
    return AdamWState(step=0, m=_map(zeros, params), v=_map(zeros, params))


def _schedule(cfg: AdamWConfig, step: int) -> float:
    """Linear warmup, then cosine decay to ``min_lr_frac`` of ``lr``."""
    warm = min(step / max(cfg.warmup_steps, 1), 1.0)
    prog = min(max((step - cfg.warmup_steps)
                   / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0), 1.0)
    cos = 0.5 * (1 + math.cos(math.pi * prog))
    return cfg.lr * warm * (cfg.min_lr_frac + (1 - cfg.min_lr_frac) * cos)


def global_norm(tree: Any, shardings: Any = None) -> torch.Tensor:
    """sqrt of the sum of every leaf's squares, in fp32, on the device.
    ``shardings`` (``parallel.sharding.param_shardings`` of the whole
    tree): ``tree`` holds this rank's shards (``shard_params``), so each
    leaf's sum of squares is all-reduced over the axes the leaf is split
    on, and counted once over the axes on which its ranks hold the same
    block."""
    if shardings is None:
        return torch.sqrt(sum(torch.sum(torch.square(t.float()))
                              for t in tree_leaves(tree)))
    from repro_torch.parallel import collectives as col
    from repro_torch.parallel.sharding import spec_axes
    mesh = tree_leaves(shardings)[0].mesh
    by_axes: Dict[Tuple[str, ...], Any] = {}
    for t, s in zip(tree_leaves(tree), tree_leaves(shardings)):
        axes = tuple(a for a in mesh.mesh_dim_names
                     if any(a in spec_axes(e) for e in s.spec))
        by_axes[axes] = by_axes.get(axes, 0.0) + torch.sum(
            torch.square(t.float()))
    total = 0.0
    for axes, ss in by_axes.items():
        for a in axes:
            ss = col.all_reduce(ss, mesh.get_group(a))
        total = total + ss
    return torch.sqrt(total)


def _stochastic_round(gen: torch.Generator, x: torch.Tensor,
                      dtype: torch.dtype) -> torch.Tensor:
    """Unbiased fp32 -> bf16 rounding: add uniform noise below bit 16 of
    the fp32 bits, then cut them (the reference's draw, on a
    ``torch.Generator``: the values differ, the distribution is the
    same)."""
    if dtype == torch.float32 or x.dtype != torch.float32:
        return x.to(dtype)
    bits = x.contiguous().view(torch.int32)
    noise = torch.randint(0, 1 << 16, x.shape, generator=gen,
                          dtype=torch.int32, device=x.device)
    # 0xFFFF0000 as an int32; the add wraps as the reference's uint32 does
    cut = (bits + noise) & -65536
    return cut.view(torch.float32).to(dtype)


@torch.no_grad()
def adamw_update(params: Any, grads: Any, state: AdamWState,
                 cfg: AdamWConfig, *, sr_gen: Optional[torch.Generator] = None,
                 shardings: Any = None
                 ) -> Tuple[Any, AdamWState, Dict[str, Any]]:
    """One AdamW step: grads clipped by their global norm, decay on leaves
    of two or more dims only, the parameter rounded stochastically to its
    dtype where ``sr_gen`` is given and it is not fp32.  On a rank's
    shards, ``shardings`` gives the whole tree's placements, for the
    global norm (:func:`global_norm`).  Returns (params, state,
    {"grad_norm": the unclipped norm (a device scalar), "lr"})."""
    step = state.step + 1
    gnorm = global_norm(grads, shardings)
    scale = torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-9),
                        max=1.0)
    lr = _schedule(cfg, step)
    bc1 = 1 - cfg.b1 ** step
    bc2 = 1 - cfg.b2 ** step

    def one(p: torch.Tensor, g: torch.Tensor, m: torch.Tensor,
            v: torch.Tensor) -> None:
        gf = g.float() * scale
        mf = m.float() * cfg.b1 + (1 - cfg.b1) * gf
        vf = v.float() * cfg.b2 + (1 - cfg.b2) * gf * gf
        upd = (mf / bc1) / (torch.sqrt(vf / bc2) + cfg.eps)
        pf = p.float()
        if p.dim() >= 2:                     # decay matrices only
            upd = upd + cfg.weight_decay * pf
        pf = pf - lr * upd
        if sr_gen is not None and p.dtype != torch.float32:
            p.copy_(_stochastic_round(sr_gen, pf, p.dtype))
        else:
            p.copy_(pf)
        m.copy_(mf)
        v.copy_(vf)

    _map(one, params, grads, state.m, state.v)
    return (params, AdamWState(step=step, m=state.m, v=state.v),
            {"grad_norm": gnorm, "lr": lr})
