"""BatchNorm with statistics over the batch (counterpart of
``apex_tpu/parallel/sync_batchnorm.py``), single-device form.

The JAX package combines the statistics across a mesh axis (``axis_name``)
with a Chan-Welford merge over ``psum``; the port has no process group
yet, so a training call with an axis raises and names the queue item that
brings it (A6.3), as does any caller that needs the sync. Without an axis
the statistics are the local ones: the mean, and the second central moment
in two passes (``sum((x - mean)^2)``), in fp32. The running variance takes
the unbiased variance (``count / (count - 1)``); evaluation normalises with
the running statistics.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

#: the refusal of every path that needs statistics synced across ranks
NEEDS_A63 = ("statistics synced across devices (axis_name={!r}) need "
             "torch.distributed, which comes with the distributed slice "
             "(ROADMAP.md, queue A6.3)")


def _moments(x: torch.Tensor, reduce_dims: Sequence[int]
             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(mean, biased variance, count) over ``reduce_dims``, in fp32."""
    x32 = x.to(torch.float32)
    dims = tuple(reduce_dims)
    mean = x32.mean(dim=dims, keepdim=True)
    m2 = (x32 - mean).square().sum(dim=dims)
    count = torch.tensor(float(x.numel() // m2.numel()), dtype=torch.float32,
                         device=x.device)
    return mean.reshape(-1), m2 / count, count


def sync_batch_norm(x: torch.Tensor, weight: Optional[torch.Tensor],
                    bias: Optional[torch.Tensor], running_mean: torch.Tensor,
                    running_var: torch.Tensor, *, training: bool,
                    momentum: float = 0.1, eps: float = 1e-5,
                    axis_name: Optional[str] = "data",
                    channel_last: bool = True, fuse_relu: bool = False):
    """Functional BatchNorm: ``(y, new_running_mean, new_running_var)``.

    ``axis_name`` must be None in training (the single-device path);
    evaluation reads no statistics of the batch, so it takes any."""
    if channel_last:
        reduce_dims = list(range(x.dim() - 1))
        bshape = (1,) * (x.dim() - 1) + (-1,)
    else:
        reduce_dims = [0] + list(range(2, x.dim()))
        bshape = (1, -1) + (1,) * (x.dim() - 2)

    if training:
        if axis_name is not None:
            raise NotImplementedError(NEEDS_A63.format(axis_name))
        mean, var, count = _moments(x, reduce_dims)
        unbiased = var * count / torch.clamp_min(count - 1.0, 1.0)
        new_rm = (1 - momentum) * running_mean + momentum * mean.to(
            running_mean.dtype)
        new_rv = (1 - momentum) * running_var + momentum * unbiased.to(
            running_var.dtype)
    else:
        mean = running_mean.to(torch.float32)
        var = running_var.to(torch.float32)
        new_rm, new_rv = running_mean, running_var

    inv_std = torch.rsqrt(var + eps)
    y = (x.to(torch.float32) - mean.reshape(bshape)) * inv_std.reshape(bshape)
    if weight is not None:
        y = y * weight.to(torch.float32).reshape(bshape)
    if bias is not None:
        y = y + bias.to(torch.float32).reshape(bshape)
    if fuse_relu:
        y = torch.relu(y)
    return y.to(x.dtype), new_rm, new_rv
