"""Pipeline parallelism: a gpipe microbatch schedule over a 'stage' mesh
axis (port of ``repro.parallel.pipeline``).

Schedule: classic fill-drain gpipe.  For n_micro microbatches and n_stages
stages the loop runs n_micro + n_stages - 1 ticks; at tick t, stage s
processes microbatch (t - s) when 0 <= t - s < n_micro.  Activations
advance one stage a tick around the ring (each rank sends to the next and
receives from the previous without blocking; the last stage's send to
the first is made and ignored, as the reference's ``ppermute`` makes
it).  Outputs collect on the last stage and reach every rank by an
all-reduce in which the other stages add zeros, as the reference's masked
``psum`` does.  A stage idle at a tick skips ``stage_fn`` where the
reference computes it and masks the result away.

The forward pass only: the ring carries no autograd.
"""

from __future__ import annotations

from typing import Any, Callable

import torch

from repro_torch.models import tree_map
from repro_torch.parallel import collectives as col
from repro_torch.parallel.sharding import mesh_axes


def pipeline_apply(stage_fn: Callable[[Any, torch.Tensor], torch.Tensor],
                   stage_params: Any, x: torch.Tensor, *, mesh,
                   axis: str = "stage") -> torch.Tensor:
    """Run x through n_stages sequential stages with gpipe microbatching.

    stage_params: a tensor or nested dict whose leaves have leading dim
      n_stages; this rank's stage uses its slice.
    x: (n_micro, micro_batch, ...) microbatched input, the same on every
      rank.
    Returns (n_micro, micro_batch, ...) outputs, the same on every rank.
    """
    n_stages = mesh_axes(mesh)[axis]
    group = mesh.get_group(axis)
    stage = mesh.get_local_rank(axis)
    params = tree_map(lambda p: p[stage], stage_params)
    n_micro = x.shape[0]
    last = n_stages - 1
    state = torch.zeros_like(x[0])                    # inflight activation
    outputs = torch.zeros_like(x)
    for t in range(n_micro + n_stages - 1):
        mb = t - stage                                # microbatch index
        if 0 <= mb < n_micro:
            y = stage_fn(params, x[t] if stage == 0 else state)
        else:
            y = state
        if stage == last and 0 <= t - last < n_micro:
            outputs[t - last] = y
        # one stage has no ring: its state is never read
        state = col.ring_shift(y, group) if n_stages > 1 else y
    if stage != last:
        outputs.zero_()
    return col.all_reduce(outputs, group)


def stage_split(params: Any, n_stages: int) -> Any:
    """Reshape a stacked-layer tree (L, ...) into (n_stages, L//n_stages, ...)
    so each pipeline stage owns a contiguous block of layers."""
    def one(p):
        L = p.shape[0]
        if L % n_stages:
            raise ValueError(f"{L} layers do not split into {n_stages} "
                             f"stages")
        return p.reshape(n_stages, L // n_stages, *p.shape[1:])
    return tree_map(one, params)
