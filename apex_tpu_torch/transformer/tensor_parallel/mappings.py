"""Tensor- and sequence-parallel collectives with their backward duals
(counterpart of ``apex_tpu/transformer/tensor_parallel/mappings.py``).

The JAX package writes these as plain differentiable code: under
``shard_map(check_vma=True)`` autodiff inserts each backward collective
itself. ``torch.autograd`` knows nothing of ``torch.distributed``, so a
bare collective in a forward would leave its gradient wrong without a
word. Each function here is therefore a ``torch.autograd.Function``
that pairs its forward collective with the reference's explicit dual
(``apex/transformer/tensor_parallel/mappings.py``):

=====================================  ==================================
forward                                backward
=====================================  ==================================
copy (identity)                        all-reduce
reduce (all-reduce)                    identity
scatter (split the last dim)           all-gather the last dim
gather (all-gather the last dim)       split the last dim
scatter to sequence (split dim 0)      all-gather dim 0
gather from sequence (all-gather 0)    reduce-scatter dim 0, or with
                                       ``to_model_parallel=False`` this
                                       rank's slice
reduce-scatter to sequence             all-gather dim 0
=====================================  ==================================

An ``axis_name`` names a ``parallel_state`` axis (default ``tensor``)
and resolves to that axis's process group
(``parallel.distributed.axis_group``); a ``ProcessGroup`` may stand in
for it. Without a process group the world is 1 and every function is the
identity, as the JAX ones are on one device. With a group, the
collectives run even when the group has one rank, so a run at world 1
goes through the same path and pays its cost. The collectives are the
tensor forms of ``torch.distributed`` (``all_reduce``,
``all_gather_into_tensor``, ``reduce_scatter_tensor``) on the tensors as
they lie: nothing is staged through the host.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.distributed as dist

from .. import parallel_state


def _axis(axis_name):
    return axis_name if axis_name is not None else parallel_state.TENSOR_AXIS


def axis_world(axis_name) -> Tuple[Optional[object], int, int, bool]:
    """``(group, world, rank, active)`` of a tensor-parallel axis:
    ``active`` is False without a process group (world 1, rank 0, no
    collective runs); ``group`` None with ``active`` means the default
    group."""
    from ...parallel.distributed import axis_group as _resolve

    group, world = _resolve(_axis(axis_name))
    active = dist.is_available() and dist.is_initialized()
    if not active:
        return None, 1, 0, False
    rank = dist.get_rank(group) if group is not None else dist.get_rank()
    return group, world, rank, True


def all_reduce(x: torch.Tensor, group, op=None) -> torch.Tensor:
    """A reduced copy of ``x`` over ``group`` (SUM unless ``op``)."""
    out = x.contiguous().clone()
    dist.all_reduce(out, op=dist.ReduceOp.SUM if op is None else op,
                    group=group)
    return out


def _split(x: torch.Tensor, world: int, rank: int, dim: int) -> torch.Tensor:
    """This rank's ``1/world`` slice of ``x`` along ``dim``."""
    dim = dim % x.dim()
    if x.shape[dim] % world != 0:
        raise ValueError(
            f"dimension {dim} of shape {tuple(x.shape)} is not divisible by "
            f"the tensor-parallel world size {world}")
    size = x.shape[dim] // world
    return x.narrow(dim, rank * size, size).contiguous()


def _all_gather(x: torch.Tensor, group, world: int, dim: int) -> torch.Tensor:
    """The ranks' ``x`` concatenated along ``dim`` in rank order."""
    x = x.contiguous()
    out = x.new_empty((world * x.shape[0],) + tuple(x.shape[1:]))
    dist.all_gather_into_tensor(out, x, group=group)
    if dim % x.dim() == 0:
        return out
    return torch.cat(out.chunk(world, dim=0), dim=dim)


def _reduce_scatter(x: torch.Tensor, group, world: int) -> torch.Tensor:
    """The sum over the ranks of ``x``, this rank's slice of dim 0."""
    x = x.contiguous()
    if x.shape[0] % world != 0:
        raise ValueError(
            f"dimension 0 of shape {tuple(x.shape)} is not divisible by "
            f"the tensor-parallel world size {world}")
    out = x.new_empty((x.shape[0] // world,) + tuple(x.shape[1:]))
    dist.reduce_scatter_tensor(out, x, group=group)
    return out


class _Copy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, ctx.group), None


class _Reduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Scatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, world, rank, dim):
        ctx.args = (group, world, dim)
        return _split(x, world, rank, dim)

    @staticmethod
    def backward(ctx, g):
        group, world, dim = ctx.args
        return _all_gather(g, group, world, dim), None, None, None, None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, world, rank, dim):
        ctx.args = (world, rank, dim)
        return _all_gather(x, group, world, dim)

    @staticmethod
    def backward(ctx, g):
        world, rank, dim = ctx.args
        return _split(g, world, rank, dim), None, None, None, None


class _GatherSeqReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, world):
        ctx.args = (group, world)
        return _all_gather(x, group, world, 0)

    @staticmethod
    def backward(ctx, g):
        group, world = ctx.args
        return _reduce_scatter(g, group, world), None, None


class _ReduceScatterSeq(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, world):
        ctx.args = (group, world)
        return _reduce_scatter(x, group, world)

    @staticmethod
    def backward(ctx, g):
        group, world = ctx.args
        return _all_gather(g, group, world, 0), None, None


def copy_to_tensor_model_parallel_region(x, axis_name=None):
    """Identity forward, all-reduce backward."""
    group, _, _, active = axis_world(axis_name)
    return _Copy.apply(x, group) if active else x


def reduce_from_tensor_model_parallel_region(x, axis_name=None):
    """All-reduce forward, identity backward."""
    group, _, _, active = axis_world(axis_name)
    return _Reduce.apply(x, group) if active else x


def scatter_to_tensor_model_parallel_region(x, axis_name=None):
    """This rank's slice of the last dim forward, all-gather backward."""
    group, world, rank, active = axis_world(axis_name)
    if not active:
        return x
    return _Scatter.apply(x, group, world, rank, -1)


def gather_from_tensor_model_parallel_region(x, axis_name=None):
    """All-gather along the last dim forward, this rank's slice backward."""
    group, world, rank, active = axis_world(axis_name)
    if not active:
        return x
    return _Gather.apply(x, group, world, rank, -1)


def scatter_to_sequence_parallel_region(x, axis_name=None):
    """This rank's slice of the sequence dim (0) forward, all-gather
    backward."""
    group, world, rank, active = axis_world(axis_name)
    if not active:
        return x
    return _Scatter.apply(x, group, world, rank, 0)


def gather_from_sequence_parallel_region(x, axis_name=None,
                                         to_model_parallel: bool = True):
    """All-gather along the sequence dim (0).

    ``to_model_parallel=True`` (the sequence-parallel linear layers): the
    backward reduce-scatters the ranks' partial cotangents.
    ``to_model_parallel=False``: the backward takes this rank's slice of
    the cotangent, which is right only when every rank's cotangent is the
    same (a replicated computation after the gather); the JAX package's
    custom-vjp split."""
    group, world, rank, active = axis_world(axis_name)
    if not active:
        return x
    if to_model_parallel:
        return _GatherSeqReduceScatter.apply(x, group, world)
    return _Gather.apply(x, group, world, rank, 0)


def reduce_scatter_to_sequence_parallel_region(x, axis_name=None):
    """Reduce-scatter along the sequence dim (0) forward, all-gather
    backward."""
    group, world, _, active = axis_world(axis_name)
    if not active:
        return x
    return _ReduceScatterSeq.apply(x, group, world)
