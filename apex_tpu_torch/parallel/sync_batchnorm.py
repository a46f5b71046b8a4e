"""Synchronised BatchNorm over a group of ranks (counterpart of
``apex_tpu/parallel/sync_batchnorm.py``).

The reference ships a CUDA SyncBatchNorm (Welford kernels and an
all-gather of per-rank statistics, ``apex/parallel/
optimized_sync_batchnorm.py:9-108``); the JAX package combines the
statistics across a mesh axis with Chan's parallel merge over ``psum``
of ``(n, n * mean, m2 + n * mean^2)``. The port does the same over ONE
``torch.distributed.all_reduce`` of those three (a ``[2C + 1]`` buffer):
``mean = sum(n * mean) / N``, ``m2 = sum(m2 + n * mean^2) - N * mean^2``,
the biased variance ``m2 / N``. Each rank's local moments are two-pass
(``sum((x - mean)^2)``), in fp32 (fp64 for an fp64 input).

The gradient is reduced across ranks too. The JAX package gets that by
differentiating through ``psum``; an ``all_reduce`` inside a forward is
invisible to autograd, so the synced path is an ``autograd.Function``
(:class:`SyncBatchNormFunction`) whose backward is the closed form of
BatchNorm's derivative with the two sums it needs, ``sum(dy * w)`` and
``sum(dy * w * x_hat)``, all-reduced over the same group (the
reference's ``welford_backward``): the input gradient of each rank is
that of the sum of every rank's loss. The weight and bias gradients stay
local, for the data-parallel reduction to average.

``axis_name`` names a ``parallel_state`` axis (``parallel.distributed.
axis_group``: its group when model parallelism is initialised, else the
default group; a ``ProcessGroup`` stands in for it); without a process
group the synced path runs at world 1 with no collective, as the JAX
function does on one device; ``axis_name=None`` is the local path (plain
autograd). The running variance takes the unbiased variance
(``count / (count - 1)``); evaluation normalises with the running
statistics.

:class:`SyncBatchNorm` is an ``nn.Module`` (a ``_BatchNorm``, so a
torch BatchNorm's ``state_dict`` loads into it) and
:func:`convert_syncbn_model` swaps every torch BatchNorm of a module tree
for one (reference ``apex/parallel/__init__.py:22-44``). Unlike the JAX
package's flax module they default to ``channel_last=False``: a torch
BatchNorm's input is NCHW.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch.nn.modules.batchnorm import _BatchNorm

from .distributed import axis_group


def _layout(ndim: int, channel_last: bool):
    """``(reduce_dims, broadcast shape)`` of the per-channel vectors."""
    if channel_last:
        return list(range(ndim - 1)), (1,) * (ndim - 1) + (-1,)
    return [0] + list(range(2, ndim)), (1, -1) + (1,) * (ndim - 2)


def _stat_dtype(dtype: torch.dtype) -> torch.dtype:
    """fp32 statistics, fp64 for an fp64 input."""
    return torch.promote_types(dtype, torch.float32)


def _moments(x: torch.Tensor, reduce_dims: Sequence[int]
             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(mean, biased variance, count) over ``reduce_dims``, local."""
    x32 = x.to(_stat_dtype(x.dtype))
    dims = tuple(reduce_dims)
    mean = x32.mean(dim=dims, keepdim=True)
    m2 = (x32 - mean).square().sum(dim=dims)
    count = torch.tensor(float(x.numel() // m2.numel()), dtype=x32.dtype,
                         device=x.device)
    return mean.reshape(-1), m2 / count, count


def _moments_over_axis(x: torch.Tensor, reduce_dims: Sequence[int],
                       axis_name
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(mean, biased variance, total count) over the local dims and the
    ranks of ``axis_name``: the Chan merge of the JAX package over one
    all-reduce of ``(n, n * mean, m2 + n * mean^2)``. No gradient flows
    through the collective (the synced path differentiates in
    :class:`SyncBatchNormFunction`)."""
    group, _ = axis_group(axis_name)
    x32 = x.to(_stat_dtype(x.dtype))
    dims = tuple(reduce_dims)
    mean_local = x32.mean(dim=dims)
    c = mean_local.numel()
    n_local = float(x.numel() // c)
    m2_local = (x32 - mean_local.reshape(_bshape(x, dims))).square().sum(
        dim=dims)
    stats = torch.cat([
        torch.full((1,), n_local, dtype=x32.dtype, device=x.device),
        n_local * mean_local, m2_local + n_local * mean_local.square()])
    if dist.is_available() and dist.is_initialized():
        dist.all_reduce(stats, group=group)
    n = stats[0]
    mean = stats[1:c + 1] / n
    m2 = stats[c + 1:] - n * mean.square()
    return mean, m2 / n, n


def _bshape(x: torch.Tensor, dims) -> Tuple[int, ...]:
    return tuple(1 if d in dims else s for d, s in enumerate(x.shape))


class SyncBatchNormFunction(torch.autograd.Function):
    """BatchNorm with statistics synced over ``axis_name`` (forward) and
    the input gradient's two sums synced over it too (backward).

    ``apply(x, weight, bias, eps, axis_name, channel_last)`` returns
    ``(y, mean, var, count)``: ``y = (x - mean) * rsqrt(var + eps) * w +
    b`` in the statistics dtype (fp32; fp64 for fp64), the batch mean
    and biased variance, and the total count, the last three without
    gradient. Saved for the backward: ``x`` in its own dtype and
    per-channel vectors."""

    @staticmethod
    def forward(ctx, x, weight, bias, eps, axis_name, channel_last):
        dims, bshape = _layout(x.dim(), channel_last)
        mean, var, count = _moments_over_axis(x, dims, axis_name)
        inv_std = torch.rsqrt(var + eps)
        y = (x.to(mean.dtype) - mean.reshape(bshape)) * inv_std.reshape(
            bshape)
        if weight is not None:
            y = y * weight.to(mean.dtype).reshape(bshape)
        if bias is not None:
            y = y + bias.to(mean.dtype).reshape(bshape)
        ctx.save_for_backward(x, weight, mean, inv_std, count)
        ctx.axis_name, ctx.dims, ctx.bshape = axis_name, dims, bshape
        ctx.has_bias = bias is not None
        ctx.mark_non_differentiable(mean, var, count)
        return y, mean, var, count

    @staticmethod
    def backward(ctx, gy, _gmean, _gvar, _gcount):
        x, weight, mean, inv_std, count = ctx.saved_tensors
        dims, bshape = tuple(ctx.dims), ctx.bshape
        gy = gy.to(mean.dtype)
        xhat = (x.to(mean.dtype) - mean.reshape(bshape)) * inv_std.reshape(
            bshape)
        gxhat = gy if weight is None else gy * weight.to(
            mean.dtype).reshape(bshape)
        sums = torch.cat([gxhat.sum(dims), (gxhat * xhat).sum(dims)])
        if dist.is_available() and dist.is_initialized():
            group, _ = axis_group(ctx.axis_name)
            dist.all_reduce(sums, group=group)
        c = mean.numel()
        dx = inv_std.reshape(bshape) * (
            gxhat - (sums[:c] / count).reshape(bshape)
            - xhat * (sums[c:] / count).reshape(bshape))
        dw = db = None
        if weight is not None and ctx.needs_input_grad[1]:
            dw = (gy * xhat).sum(dims).to(weight.dtype)
        if ctx.has_bias and ctx.needs_input_grad[2]:
            db = gy.sum(dims)
        return dx.to(x.dtype), dw, db, None, None, None


def sync_batch_norm(x: torch.Tensor, weight: Optional[torch.Tensor],
                    bias: Optional[torch.Tensor], running_mean: torch.Tensor,
                    running_var: torch.Tensor, *, training: bool,
                    momentum: float = 0.1, eps: float = 1e-5,
                    axis_name="data", channel_last: bool = True,
                    fuse_relu: bool = False):
    """Functional BatchNorm: ``(y, new_running_mean, new_running_var)``
    (``SyncBatchNorm.forward``, ``apex/parallel/
    optimized_sync_batchnorm.py:85-108``). In training the statistics
    are the batch's over ``axis_name``'s ranks (None: this rank's), the
    running variance takes the unbiased variance; in evaluation the
    running statistics normalise. ``fuse_relu`` applies the ReLU the
    CUDA kernel fused. ``y`` has ``x``'s dtype."""
    dims, bshape = _layout(x.dim(), channel_last)
    if training:
        if axis_name is None:
            mean, var, count = _moments(x, dims)
            y = (x.to(mean.dtype) - mean.reshape(bshape)) * torch.rsqrt(
                var + eps).reshape(bshape)
            if weight is not None:
                y = y * weight.to(mean.dtype).reshape(bshape)
            if bias is not None:
                y = y + bias.to(mean.dtype).reshape(bshape)
        else:
            y, mean, var, count = SyncBatchNormFunction.apply(
                x, weight, bias, eps, axis_name, channel_last)
        unbiased = var * count / torch.clamp_min(count - 1.0, 1.0)
        new_rm = (1 - momentum) * running_mean + momentum * mean.to(
            running_mean.dtype)
        new_rv = (1 - momentum) * running_var + momentum * unbiased.to(
            running_var.dtype)
    else:
        st = _stat_dtype(x.dtype)
        mean, var = running_mean.to(st), running_var.to(st)
        new_rm, new_rv = running_mean, running_var
        y = (x.to(st) - mean.reshape(bshape)) * torch.rsqrt(
            var + eps).reshape(bshape)
        if weight is not None:
            y = y * weight.to(st).reshape(bshape)
        if bias is not None:
            y = y + bias.to(st).reshape(bshape)
    if fuse_relu:
        y = torch.relu(y)
    return y.to(x.dtype), new_rm, new_rv


class SyncBatchNorm(_BatchNorm):
    """``apex.parallel.SyncBatchNorm`` (``optimized_sync_batchnorm.py:9``)
    over :func:`sync_batch_norm`: a torch BatchNorm (``weight``,
    ``bias``, ``running_mean``, ``running_var``, ``num_batches_tracked``)
    whose training statistics and input gradient are synced over the
    ranks of ``process_group`` if given, else of ``axis_name``.

    ``channel_last``: the input is ``[N, ..., C]`` (default ``[N, C,
    ...]``); ``fuse_relu``: a ReLU after the affine; ``use_bias=False``
    keeps no bias (the JAX module's field). In evaluation with
    ``track_running_stats`` the running statistics normalise; without
    them, the batch's. ``momentum=None`` takes the cumulative average,
    as torch's BatchNorm does."""

    def __init__(self, num_features: int, eps: float = 1e-5,
                 momentum: Optional[float] = 0.1, affine: bool = True,
                 track_running_stats: bool = True, process_group=None,
                 channel_last: bool = False, fuse_relu: bool = False, *,
                 use_bias: bool = True, axis_name="data"):
        super().__init__(num_features, eps, momentum, affine,
                         track_running_stats)
        if affine and not use_bias:
            self.register_parameter("bias", None)
        self.process_group = process_group
        self.axis_name = axis_name
        self.channel_last = channel_last
        self.fuse_relu = fuse_relu

    def _check_input_dim(self, input):
        if input.dim() < 2:
            raise ValueError(
                f"expected at least 2D input (got {input.dim()}D input)")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        self._check_input_dim(x)
        use_batch = self.training or not self.track_running_stats
        momentum = 0.0 if self.momentum is None else self.momentum
        if self.training and self.track_running_stats:
            self.num_batches_tracked.add_(1)
            if self.momentum is None:
                momentum = 1.0 / float(self.num_batches_tracked)
        rm, rv = self.running_mean, self.running_var
        if rm is None:  # no running statistics: placeholders, not kept
            c = x.shape[-1 if self.channel_last else 1]
            rm = torch.zeros(c, device=x.device)
            rv = torch.ones(c, device=x.device)
        group = (self.process_group if self.process_group is not None
                 else self.axis_name)
        y, new_rm, new_rv = sync_batch_norm(
            x, self.weight, self.bias, rm, rv, training=use_batch,
            momentum=momentum, eps=self.eps, axis_name=group,
            channel_last=self.channel_last, fuse_relu=self.fuse_relu)
        if self.training and self.track_running_stats:
            with torch.no_grad():
                self.running_mean.copy_(new_rm)
                self.running_var.copy_(new_rv)
        return y


def convert_syncbn_model(module: torch.nn.Module, axis_name="data",
                         channel_last: bool = False,
                         process_group=None) -> torch.nn.Module:
    """Replace every torch BatchNorm (``_BatchNorm``) under ``module``
    with a :class:`SyncBatchNorm` carrying its weights, running
    statistics and batch count (reference ``apex/parallel/__init__.py:
    22-44``). A BatchNorm ``module`` itself comes back converted; any
    other is changed in place and returned."""
    if isinstance(module, _BatchNorm) and not isinstance(module,
                                                         SyncBatchNorm):
        mod = SyncBatchNorm(module.num_features, module.eps,
                            module.momentum, module.affine,
                            module.track_running_stats, process_group,
                            channel_last=channel_last, axis_name=axis_name)
        mod.training = module.training
        with torch.no_grad():
            if module.affine:
                mod.weight.copy_(module.weight)
                mod.bias.copy_(module.bias)
            if module.track_running_stats:
                mod.running_mean.copy_(module.running_mean)
                mod.running_var.copy_(module.running_var)
                mod.num_batches_tracked.copy_(module.num_batches_tracked)
        held = list(module.parameters()) + list(module.buffers())
        return mod.to(held[0].device) if held else mod
    for name, child in module.named_children():
        module.add_module(name, convert_syncbn_model(
            child, axis_name, channel_last, process_group))
    return module
