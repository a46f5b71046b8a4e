"""NHWC BatchNorm with fused ReLU and add + ReLU epilogues (counterpart of
``apex_tpu/contrib/groupbn/batch_norm.py``).

Functional, as in the JAX package: ``init()`` returns ``(params,
state)``, ``apply(params, state, x, z=None, training=True)`` returns
``(y, new_state)``. The statistics are ``parallel.sync_batch_norm``'s.
With ``bn_group > 1`` (``GroupBatchNorm2d``'s ``group_size > 1``) they
are synced, with the input gradient's sums, over a group of
``bn_group`` consecutive ranks of this rank's data-parallel group (the
reference's peer group of GPUs; the JAX package's mesh axis
``axis_name``, whose devices the caller lays out): the ranks of the
default group, or of the ``parallel_state`` data group when model
parallelism is initialised, cut into blocks of ``bn_group``. Every rank
builds every block's process group at construction, so every rank
constructs the layer. ``max_cta_per_sm``, ``cta_launch_margin`` and
``multi_stream`` tune the reference's CUDA kernels: accepted and
ignored.
"""
from __future__ import annotations

from typing import Any, Optional, Tuple

import torch
import torch.distributed as dist

from ..._device import resolve_device
from ...parallel.sync_batchnorm import sync_batch_norm

Tree = Any

#: (bn_group, the data groups' ranks, the default group) -> this rank's
#: block's process group
_BN_GROUPS = {}


def bn_group_process_group(bn_group: int):
    """This rank's process group of ``bn_group`` consecutive ranks of its
    data-parallel group, built (every block, on every rank, in one
    order) on first use. Raises without a process group, or where the
    data group's size is not a multiple of ``bn_group``."""
    if not (dist.is_available() and dist.is_initialized()):
        raise ValueError(
            f"bn_group={bn_group} syncs BatchNorm statistics over "
            f"{bn_group} ranks: initialise torch.distributed (torchrun, "
            "init_process_group) first")
    from ...transformer import parallel_state as ps

    if ps.model_parallel_is_initialized():
        devs = ps.get_mesh().devices  # (pipeline, data, tensor)
        data_groups = [tuple(int(r) for r in devs[p, :, t])
                       for p in range(devs.shape[0])
                       for t in range(devs.shape[2])]
    else:
        data_groups = [tuple(range(dist.get_world_size()))]
    size = len(data_groups[0])
    if size % bn_group:
        raise ValueError(f"bn_group={bn_group} does not divide the "
                         f"data-parallel group's {size} ranks")
    key = (bn_group, tuple(data_groups), id(dist.group.WORLD))
    if key not in _BN_GROUPS:
        rank, mine = dist.get_rank(), None
        for ranks in data_groups:
            for i in range(0, size, bn_group):
                block = list(ranks[i:i + bn_group])
                group = dist.new_group(block)
                if rank in block:
                    mine = group
        _BN_GROUPS[key] = mine
    return _BN_GROUPS[key]


class BatchNorm2d_NHWC:
    """The reference's ``BatchNorm2d_NHWC`` (``groupbn/batch_norm.py:101``)."""

    def __init__(self, num_features: int, fuse_relu: bool = False,
                 bn_group: int = 1, max_cta_per_sm: int = 2,
                 cta_launch_margin: int = 12, multi_stream: bool = False,
                 *, axis_name: str = "bn_group", momentum: float = 0.1,
                 eps: float = 1e-5):
        del max_cta_per_sm, cta_launch_margin, multi_stream
        self.bn_group = bn_group
        self.axis_name = axis_name if bn_group > 1 else None
        self.group = bn_group_process_group(bn_group) if bn_group > 1 \
            else None
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
            eps=self.eps, axis_name=self.group if self.bn_group > 1 else None,
            channel_last=True, fuse_relu=False)
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
