"""The collectives of the port's multi-device layer, each with the
backward pass that makes the step's gradient the reference's.

One convention holds throughout: every rank computes the same scalar loss
and back-propagates it with cotangent 1, and a value that every rank
holds (a replicated value) carries the same, complete cotangent on every
rank.  Where a replicated value feeds a computation split over ranks,
each rank sees only its part of the cotangent, and the backward pass sums
the parts:

  gather_param   a parameter's blocks put back together before use, the
                 FSDP gather (`rules.py`: "GSPMD all-gathers weights per
                 layer"), except along the axes in `keep`, whose split
                 stays (the tensor-parallel blocks keep "model"); backward
                 sums the gradient over `dp` (the ranks the batch splits
                 over, and "model" for a leaf held whole over "model" that
                 feeds split work), then keeps this rank's block
  copy_to        identity; backward sums over `axes` (a replicated value
                 entering work split over `axes`, Megatron's "f")
  reduce_from    sum over `axes`; backward identity (work split over
                 `axes` leaving as one replicated value, Megatron's "g",
                 `jax.lax.psum`)
  sum_over       sum over `axes`; backward sums too (a statistic each
                 rank computes over its part of a row, summed and then
                 used by every rank's split work: the sum of squares of
                 an RMSNorm over channels split over "model")
  max_over       max over `axes`, no gradient (the shift of a logsumexp
                 over a vocabulary split over `axes`, whose value does not
                 depend on it)
  gather_from    the blocks of `x` along `dim` from every rank of `axes`;
                 backward keeps this rank's slice of the (replicated)
                 cotangent (the whole logits from a vocabulary split over
                 "model")
  mean_over      mean over `axes` of per-rank values (`jax.lax.pmean`);
                 backward divides the (replicated) cotangent by the count
  shift          x of the rank before along `axis`, in a ring
                 (`jax.lax.ppermute` by +1); backward shifts the gradient
                 the other way, as ppermute's transpose does

All of them are the identity, and skip every collective, along a mesh
axis of one rank.  The collectives are `all_gather` and `all_reduce`,
which both the NCCL and the gloo backend take.  While a profiler records,
each all-reduce issued is a `tp.all_reduce` span on the device channel
(`obs.realtime.device_tracer`) and counts once in `tp.allreduces` and by
its tensor's bytes in `tp.allreduce_bytes`.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.obs.realtime import device_tracer
from repro_torch.sharding.rules import Mesh, NamedSharding, all_gather


def all_reduce(x: torch.Tensor, mesh: Mesh, axes, op=dist.ReduceOp.SUM):
    """A reduced copy of `x` over `axes` (no gradient)."""
    n = mesh.size(axes)
    if n > 1 and mesh.recorder is not None:
        return mesh.recorder.collective("all-reduce", x, x.shape, n)
    group = mesh.group(axes)
    if group is None:
        return x
    out = x.clone().contiguous()
    tr = device_tracer()
    with tr.span("tp.all_reduce"):
        dist.all_reduce(out, op=op, group=group)
    tr.count("tp.allreduces", 1)
    tr.count("tp.allreduce_bytes", out.numel() * out.element_size())
    return out


def _local_block(x, mesh, dims):
    for d, axes in dims:
        n = x.shape[d] // mesh.size(axes)
        x = x.narrow(d, mesh.index(axes) * n, n)
    return x


class _GatherParam(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, dims, dp):
        ctx.mesh, ctx.dims, ctx.dp = mesh, dims, dp
        for d, axes in dims:
            x = all_gather(x, mesh, axes, d)
        return x

    @staticmethod
    def backward(ctx, g):
        g = all_reduce(g, ctx.mesh, ctx.dp)
        return _local_block(g, ctx.mesh, ctx.dims).contiguous(), None, \
            None, None


def gather_param(x: torch.Tensor, sharding: NamedSharding, dp=(),
                 keep=()) -> torch.Tensor:
    """The whole parameter from this rank's block `x` (laid out by
    `sharding`), except along mesh axes in `keep`, whose split stays (a
    tensor-parallel block keeps its "model" split: its heads or d_ff
    slice).  `dp`: the axes whose ranks' gradients sum: those the batch is
    split over, and "model" for a leaf that is whole over "model" but
    feeds work split over it (each model rank's gradient is a part)."""
    mesh = sharding.mesh
    dims = [(d, tuple(a for a in axes if a not in keep))
            for d, axes in sharding.dims()]
    dims = [(d, axes) for d, axes in dims if mesh.size(axes) > 1]
    if not dims and mesh.size(dp) == 1:
        return x
    return _GatherParam.apply(x, mesh, dims, mesh._norm(dp))


def gather_params(tree, shardings, dp=(), keep=()):
    """`gather_param` on every leaf of a tree of blocks."""
    from repro_torch.models.module import tree_leaves, tree_unflatten
    return tree_unflatten(tree, [
        gather_param(x, sh, dp, keep)
        for x, sh in zip(tree_leaves(tree), tree_leaves(shardings))])


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes):
        ctx.mesh, ctx.axes = mesh, axes
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, ctx.mesh, ctx.axes), None, None


def copy_to(x, mesh: Mesh, axes):
    if mesh.size(axes) == 1:
        return x
    return _CopyTo.apply(x, mesh, axes)


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes):
        return all_reduce(x, mesh, axes)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


def reduce_from(x, mesh: Mesh, axes):
    if mesh.size(axes) == 1:
        return x
    return _ReduceFrom.apply(x, mesh, axes)


class _SumOver(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes):
        ctx.mesh, ctx.axes = mesh, axes
        return all_reduce(x, mesh, axes)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, ctx.mesh, ctx.axes), None, None


def sum_over(x, mesh: Mesh, axes):
    """`reduce_from` whose result feeds split work again: its cotangent is
    a part on each rank, summed over `axes` (`copy_to(reduce_from(x))`
    in one collective each way)."""
    if mesh.size(axes) == 1:
        return x
    return _SumOver.apply(x, mesh, axes)


def max_over(x, mesh: Mesh, axes):
    """The elementwise max of `x` over the ranks of `axes`, no gradient."""
    return all_reduce(x.detach(), mesh, axes, dist.ReduceOp.MAX)


class _GatherFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes, dim):
        ctx.mesh, ctx.axes, ctx.dim = mesh, axes, dim
        return all_gather(x, mesh, axes, dim)

    @staticmethod
    def backward(ctx, g):
        n = g.shape[ctx.dim] // ctx.mesh.size(ctx.axes)
        return g.narrow(ctx.dim, ctx.mesh.index(ctx.axes) * n, n), None, \
            None, None


def gather_from(x, mesh: Mesh, axes, dim: int = -1):
    """Every rank's block of `x` along `dim` over `axes`, concatenated in
    the axes' row-major order; backward keeps this rank's slice."""
    if mesh.size(axes) == 1:
        return x
    return _GatherFrom.apply(x, mesh, axes, dim % x.dim())


class _MeanOver(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes):
        ctx.n = mesh.size(axes)
        return all_reduce(x, mesh, axes) / ctx.n

    @staticmethod
    def backward(ctx, g):
        return g / ctx.n, None, None


def mean_over(x, mesh: Mesh, axes):
    if mesh.size(axes) == 1:
        return x
    return _MeanOver.apply(x, mesh, axes)


def _ring(x, mesh, axis, step):
    n = mesh.size(axis)
    parts = all_gather(x[None], mesh, axis, 0)
    return parts[(mesh.index(axis) - step) % n]


class _Shift(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return _ring(x, mesh, axis, 1)

    @staticmethod
    def backward(ctx, g):
        return _ring(g, ctx.mesh, ctx.axis, -1), None, None


def shift(x, mesh: Mesh, axis: str):
    """Rank i along `axis` gets rank i-1's `x` (rank 0 the last one's)."""
    if mesh.size(axis) == 1:
        return x
    return _Shift.apply(x, mesh, axis)


def rows(x, mesh: Mesh, axes, dim: int = 0):
    """This rank's block of `x` (held whole on every rank) along `dim`,
    split over `axes` (no gradient)."""
    n = mesh.size(axes)
    if n == 1:
        return x
    m = x.shape[dim] // n
    return x.narrow(dim, mesh.index(axes) * m, m)
