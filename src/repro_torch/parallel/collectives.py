"""The port's collectives over one process group, each reported to
``repro_torch.analysis.comm`` as it is issued.

``torch.distributed``'s collectives carry no autograd, and the
``torch.distributed.nn`` ones send back the collective's own adjoint,
which counts a gradient once per rank when every rank computes the same
replicated loss.  The expert-parallel paths use conjugate pairs instead,
as Megatron-LM does; each assumes the loss downstream is the same on
every rank of the group:

  copy_to      identity forward,            all-reduce backward
  reduce_from  all-reduce forward,          identity backward
  mean_from    all-reduce / n forward,      grad / n backward
  split_to     own chunk of a dim forward,  all-gather backward
  gather_from  all-gather forward,          own chunk backward
  all_to_all   all-to-all forward,          all-to-all backward
  psum         all-reduce forward,          all-reduce backward

The FSDP/TP placements (``models/placed.py``) keep another convention:
every rank computes the gradient of its own share of the work, and a
tensor gathered for work that the ranks split sums their gradients
back.  Their pairs (Megatron-LM's sequence parallelism and ZeRO-3):

  fsdp_gather  all-gather forward over ``data``,   reduce-scatter backward
  seq_gather   all-gather forward over ``model``,  reduce-scatter backward
  seq_scatter  reduce-scatter forward onto a dim,  all-gather backward

(``fsdp_gather`` and ``seq_gather`` are one pair, named for their sites:
a leaf's gradient arrives as the rank's shard, summed over the group.)
``psum`` sums partial values that every rank then uses for its own
share (the head-parallel Mamba norm's sum of squares over ``d_inner``):
the total's gradient is the sum of the ranks' gradients.

``ring_shift`` (a pipeline's send to the next rank, receive from the
previous) and ``all_reduce`` carry no autograd.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.analysis import comm


def all_reduce(t: torch.Tensor, group, op=dist.ReduceOp.SUM
               ) -> torch.Tensor:
    """The sum (or ``op``) of ``t`` over ``group``, in a new tensor."""
    out = t.contiguous().clone()
    with comm.issuing():
        dist.all_reduce(out, op=op, group=group)
    comm.note("all-reduce", out)
    return out


def _all_gather(t: torch.Tensor, group, dim: int) -> torch.Tensor:
    t = t.contiguous()
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    with comm.issuing():
        dist.all_gather(parts, t, group=group)
    out = torch.cat(parts, dim=dim)
    comm.note("all-gather", out)
    return out


def _own_chunk(t: torch.Tensor, group, dim: int) -> torch.Tensor:
    n = dist.get_world_size(group)
    if t.shape[dim] % n:
        raise ValueError(f"dim {dim} of {tuple(t.shape)} does not split "
                         f"over {n} ranks")
    size = t.shape[dim] // n
    return t.narrow(dim, dist.get_rank(group) * size, size).contiguous()


def _reduce_scatter(t: torch.Tensor, group, dim: int) -> torch.Tensor:
    """The sum of ``t`` over ``group``, of which this rank keeps its
    chunk of ``dim``."""
    n = dist.get_world_size(group)
    if t.shape[dim] % n:
        raise ValueError(f"dim {dim} of {tuple(t.shape)} does not split "
                         f"over {n} ranks")
    src = t.movedim(dim, 0).contiguous()
    out = src.new_empty((src.shape[0] // n, *src.shape[1:]))
    with comm.issuing():
        dist.reduce_scatter_tensor(out, src, group=group)
    out = out.movedim(0, dim)
    comm.note("reduce-scatter", out)
    return out


def _all_to_all(t: torch.Tensor, group) -> torch.Tensor:
    t = t.contiguous()
    out = torch.empty_like(t)
    with comm.issuing():
        dist.all_to_all_single(out, t, group=group)
    comm.note("all-to-all", out)
    return out


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, ctx.group), None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _MeanFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.n = dist.get_world_size(group)
        return all_reduce(x, group) / ctx.n

    @staticmethod
    def backward(ctx, g):
        return g / ctx.n, None


class _SplitTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return _own_chunk(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return _all_gather(g, ctx.group, ctx.dim), None, None


class _GatherFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return _all_gather(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return _own_chunk(g, ctx.group, ctx.dim), None, None


class _GatherRS(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return _all_gather(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return _reduce_scatter(g, ctx.group, ctx.dim), None, None


class _ScatterAG(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return _reduce_scatter(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return _all_gather(g, ctx.group, ctx.dim), None, None


class _Psum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, ctx.group), None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_to_all(x, group)

    @staticmethod
    def backward(ctx, g):
        return _all_to_all(g, ctx.group), None


def copy_to(x: torch.Tensor, group) -> torch.Tensor:
    return _CopyTo.apply(x, group)


def reduce_from(x: torch.Tensor, group) -> torch.Tensor:
    return _ReduceFrom.apply(x, group)


def mean_from(x: torch.Tensor, group) -> torch.Tensor:
    return _MeanFrom.apply(x, group)


def split_to(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    return _SplitTo.apply(x, group, dim)


def gather_from(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    return _GatherFrom.apply(x, group, dim)


def fsdp_gather(w: torch.Tensor, group, dim: int) -> torch.Tensor:
    """A parameter block gathered whole along ``dim`` over ``group`` (the
    ``data`` axis, or ``model`` where a layer wants the weight whole);
    its gradient summed over the group and cut back to the block."""
    return _GatherRS.apply(w, group, dim)


def seq_gather(x: torch.Tensor, group, dim: int = 1) -> torch.Tensor:
    """Activations gathered along ``dim`` (the sequence, or K/V heads)
    over ``group``; their gradient summed over the group and cut back."""
    return _GatherRS.apply(x, group, dim)


def seq_scatter(x: torch.Tensor, group, dim: int = 1) -> torch.Tensor:
    """Partial sums reduced over ``group``, each rank keeping its chunk of
    ``dim``; the gradient all-gathered back."""
    return _ScatterAG.apply(x, group, dim)


def psum(x: torch.Tensor, group) -> torch.Tensor:
    """Partial sums all-reduced over ``group``, every rank using the
    total for its own share; the gradient all-reduced back."""
    return _Psum.apply(x, group)


def all_to_all(x: torch.Tensor, group) -> torch.Tensor:
    """Dim 0 of ``x`` (the group's size) scattered over the group: block
    i goes to rank i, and block j of the result came from rank j."""
    return _AllToAll.apply(x, group)


def ring_shift(t: torch.Tensor, group) -> torch.Tensor:
    """Send ``t`` to the next rank of ``group`` (the last to the first)
    and return what the previous rank sent: one non-blocking send and
    receive a rank, so no rank waits on a send before it receives."""
    n, r = dist.get_world_size(group), dist.get_rank(group)
    t = t.contiguous()
    out = torch.empty_like(t)
    nxt = dist.get_global_rank(group, (r + 1) % n)
    prv = dist.get_global_rank(group, (r - 1) % n)
    with comm.issuing():
        reqs = dist.batch_isend_irecv([
            dist.P2POp(dist.isend, t, nxt, group),
            dist.P2POp(dist.irecv, out, prv, group)])
        for req in reqs:
            req.wait()
    comm.note("collective-permute", out)
    return out
