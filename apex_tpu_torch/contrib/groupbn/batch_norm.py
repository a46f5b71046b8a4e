"""NHWC BatchNorm with fused ReLU and add + ReLU epilogues (counterpart of
``apex_tpu/contrib/groupbn/batch_norm.py``).

Functional, as in the JAX package: ``init()`` returns ``(params,
state)``, ``apply(params, state, x, z=None, training=True)`` returns
``(y, new_state)``. The statistics are ``parallel.sync_batch_norm``'s.
The reference syncs them over a group of GPUs (``bn_group``); the port's
sync comes with the distributed slice, so ``bn_group > 1`` (and
``GroupBatchNorm2d``'s ``group_size > 1``) raise and name queue A6.3.
``max_cta_per_sm``, ``cta_launch_margin`` and ``multi_stream`` tune the
reference's CUDA kernels: accepted and ignored.
"""
from __future__ import annotations

from typing import Any, Optional, Tuple

import torch

from ..._device import resolve_device
from ...parallel.sync_batchnorm import NEEDS_A63, sync_batch_norm

Tree = Any


class BatchNorm2d_NHWC:
    """The reference's ``BatchNorm2d_NHWC`` (``groupbn/batch_norm.py:101``)."""

    def __init__(self, num_features: int, fuse_relu: bool = False,
                 bn_group: int = 1, max_cta_per_sm: int = 2,
                 cta_launch_margin: int = 12, multi_stream: bool = False,
                 *, axis_name: str = "bn_group", momentum: float = 0.1,
                 eps: float = 1e-5):
        del max_cta_per_sm, cta_launch_margin, multi_stream
        if bn_group > 1:
            raise NotImplementedError(NEEDS_A63.format(axis_name)
                                      + f" (bn_group={bn_group})")
        self.num_features = num_features
        self.fuse_relu = fuse_relu
        self.momentum = momentum
        self.eps = eps

    def init(self, device=None) -> Tuple[Tree, Tree]:
        """``(params, state)``: weight ones, bias zeros, running mean zeros
        and variance ones, fp32 on ``device`` (None: the card)."""
        dev = resolve_device(device)
        c = self.num_features
        params = {"weight": torch.ones(c, device=dev),
                  "bias": torch.zeros(c, device=dev)}
        state = {"running_mean": torch.zeros(c, device=dev),
                 "running_var": torch.ones(c, device=dev)}
        return params, state

    def apply(self, params: Tree, state: Tree, x: torch.Tensor,
              z: Optional[torch.Tensor] = None, *, training: bool = True):
        """``y = bn(x) [+ z] [relu]`` over NHWC ``x``; ``z`` is the
        residual of the reference's ``bn_addrelu`` path, after which ReLU
        always applies. Returns ``(y, new_state)``."""
        y, new_rm, new_rv = sync_batch_norm(
            x, params["weight"], params["bias"], state["running_mean"],
            state["running_var"], training=training, momentum=self.momentum,
            eps=self.eps, axis_name=None, channel_last=True, fuse_relu=False)
        if z is not None:
            y = y + z.to(y.dtype)
        if self.fuse_relu or z is not None:
            y = torch.relu(y)
        return y, {"running_mean": new_rm, "running_var": new_rv}


class GroupBatchNorm2d(BatchNorm2d_NHWC):
    """The cuDNN-frontend generation of the same layer
    (``apex/contrib/cudnn_gbn/batch_norm.py:44``), the same semantics."""

    def __init__(self, num_features: int, group_size: int, eps: float = 1e-5,
                 momentum: float = 0.1, affine: bool = True,
                 track_running_stats: bool = True, *,
                 axis_name: str = "bn_group"):
        if not affine or not track_running_stats:
            raise NotImplementedError(
                "reference GroupBatchNorm2d requires affine + running stats")
        super().__init__(num_features, fuse_relu=False, bn_group=group_size,
                         axis_name=axis_name, momentum=momentum, eps=eps)
