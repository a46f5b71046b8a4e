"""The ResNet bottleneck block, 1x1 -> 3x3 -> 1x1 with a residual, and
its spatial-parallel form (counterpart of
``apex_tpu/contrib/bottleneck/bottleneck.py``'s flax modules
``Bottleneck`` and ``SpatialBottleneck`` and its ``spatial_conv3x3``).

The flax block's arithmetic, written out as the ResNet port writes it
(``examples/imagenet/resnet.py``), whose conv and BatchNorm helpers this
module reuses:

- every ``nn.Conv`` is bias-free with flax's ``"SAME"`` padding: a
  stride-2 3x3 conv over an even size pads 0 before and 1 after
  (``resnet._same_pads``), not torch's symmetric 1;
- ``nn.Conv(dtype=None)`` promotes its input against its kernel, so a
  bf16 input to the fp32 kernels computes, and returns, fp32;
- every BatchNorm is flax's (``momentum=0.9``, ``epsilon=1e-5``,
  ``dtype=float32``): fp32 statistics with the biased variance E[x^2] -
  E[x]^2, fp32 output; in training (``use_running_stats=False``) the batch
  statistics normalise and the running ones update as ``0.9 * running +
  0.1 * batch``, into this module's buffers (flax returns them as the
  mutated ``batch_stats``).

Input and output are NHWC, as the flax block's. Internally the block
runs on the channels-last NCHW view of the same memory (a permute, no
copy). Parameters keep flax's names: ``conv1.kernel`` (``[out, in, kh,
kw]``, channels-last in memory), ``bn1.scale``, ``bn1.bias`` and the
buffers ``bn1.mean``, ``bn1.var``; ``convert.bottleneck_state_from_jax``
turns a flax ``params`` / ``batch_stats`` pair into a state dict for
``load_state_dict``.

:class:`SpatialBottleneck` shards the image height over the ranks of a
group: :func:`spatial_conv3x3` pads each slab with one row from each
neighbour (``halo_exchangers``) before a conv VALID in H, and every
BatchNorm reduces its statistics over the group (``_SpatialSyncBN``),
so the ranks' outputs are the unsharded block's.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..._device import resolve_device
from ...examples.imagenet import resnet as _resnet
from .halo_exchangers import (
    HaloExchanger,
    HaloExchangerSendRecv,
    halo_pad_1d,
    spatial_group,
)


def _lecun_normal(shape, generator: Optional[torch.Generator], device):
    """flax's ``lecun_normal`` on an ``[out, in, kh, kw]`` kernel: a normal
    truncated at two standard deviations, std sqrt(1 / fan_in) /
    0.8796..., drawn on ``generator``'s device, channels-last."""
    gen_dev = generator.device if generator is not None else "cpu"
    t = torch.empty(shape, device=gen_dev)
    std = math.sqrt(1.0 / math.prod(shape[1:])) / .87962566103423978
    torch.nn.init.trunc_normal_(t, 0.0, std, -2 * std, 2 * std,
                                generator=generator)
    return t.to(device).contiguous(memory_format=torch.channels_last)


class _Conv(nn.Module):
    def __init__(self, cin: int, cout: int, k: int, stride: int,
                 generator, device):
        super().__init__()
        self.stride = stride
        self.kernel = nn.Parameter(_lecun_normal((cout, cin, k, k),
                                                 generator, device))

    def forward(self, x):
        dtype = torch.promote_types(x.dtype, self.kernel.dtype)
        return _resnet._conv(x, self.kernel, self.stride, dtype)


class _BatchNorm(nn.Module):
    def __init__(self, c: int, device):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(c, device=device))
        self.bias = nn.Parameter(torch.zeros(c, device=device))
        self.register_buffer("mean", torch.zeros(c, device=device))
        self.register_buffer("var", torch.ones(c, device=device))

    def forward(self, x, train: bool):
        new = {}
        y = _resnet._batch_norm(
            x, {"scale": self.scale, "bias": self.bias},
            {"mean": self.mean, "var": self.var}, train, new, "bn")
        if train:
            with torch.no_grad():
                self.mean.copy_(new["bn"]["mean"])
                self.var.copy_(new["bn"]["var"])
        return y


class Bottleneck(nn.Module):
    """1x1 -> 3x3 (``stride``) -> 1x1 with BatchNorms and ReLUs, plus a
    1x1 + BatchNorm downsample on the residual when the stride is not 1 or
    the widths differ. Weights from ``generator`` (flax's initialisers) on
    ``device`` (None: the card)."""

    def __init__(self, in_channels: int, bottleneck_channels: int,
                 out_channels: int, stride: int = 1,
                 use_running_stats: bool = False, *,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        dev = resolve_device(device)
        self.in_channels = in_channels
        self.bottleneck_channels = bottleneck_channels
        self.out_channels = out_channels
        self.stride = stride
        self.use_running_stats = use_running_stats
        mid = bottleneck_channels
        # created in flax's sorted-name order, so a generator draws the
        # kernels as conv1, conv2, conv3, downsample_conv
        self.conv1 = _Conv(in_channels, mid, 1, 1, generator, dev)
        self.conv2 = _Conv(mid, mid, 3, stride, generator, dev)
        self.conv3 = _Conv(mid, out_channels, 1, 1, generator, dev)
        self.bn1 = _BatchNorm(mid, dev)
        self.bn2 = _BatchNorm(mid, dev)
        self.bn3 = _BatchNorm(out_channels, dev)
        self.has_downsample = stride != 1 or in_channels != out_channels
        if self.has_downsample:
            self.downsample_conv = _Conv(in_channels, out_channels, 1, stride,
                                         generator, dev)
            self.downsample_bn = _BatchNorm(out_channels, dev)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        train = not self.use_running_stats
        xc = x.permute(0, 3, 1, 2)  # NHWC memory, NCHW view
        y = torch.relu(self.bn1(self.conv1(xc), train))
        y = torch.relu(self.bn2(self.conv2(y), train))
        y = self.bn3(self.conv3(y), train)
        residual = xc
        if self.has_downsample:
            residual = self.downsample_bn(self.downsample_conv(xc), train)
        return torch.relu(y + residual).permute(0, 2, 3, 1)


# ---------------------------------------------------------------------------
# the spatial-parallel block
# ---------------------------------------------------------------------------

def _spatial_conv_nchw(xc: torch.Tensor, kernel: torch.Tensor,
                       exchanger) -> torch.Tensor:
    """The 3x3 conv of a height slab on the NCHW view: one halo row from
    each neighbour along H, then a conv VALID in H and SAME in W, in the
    promotion of the input and kernel dtypes (flax ``nn.Conv``)."""
    padded = halo_pad_1d(xc, 1, exchanger, axis=2)  # [N, C, H + 2, W]
    dtype = torch.promote_types(xc.dtype, kernel.dtype)
    return F.conv2d(padded.to(dtype), kernel.to(dtype), None, 1, (0, 1))


def spatial_conv3x3(
    x: torch.Tensor,  # [N, H_local, W, C] — H sharded over the spatial axis
    w: torch.Tensor,  # [C_out, C, 3, 3] — the port's kernel layout
    exchanger: Optional[HaloExchanger] = None,
    *,
    stride: int = 1,
) -> torch.Tensor:
    """SAME 3x3 conv over a height-sharded NHWC slab, halos exchanged
    with the neighbouring ranks: each slab is padded with one row from
    each neighbour (zeros at the chain's ends, SAME padding's zeros at
    the image border) and convolved VALID in H, SAME in W, so the ranks'
    outputs concatenated along H are the unsharded conv's. ``w`` is in
    the port's ``[out, in, kh, kw]`` layout (``convert.
    conv_kernel_from_jax`` turns an HWIO kernel into it); the conv runs
    on cuDNN over the channels-last NCHW view. Only ``stride == 1`` is
    supported under spatial sharding."""
    if stride != 1:
        raise NotImplementedError(
            "spatial_conv3x3 supports stride=1 under spatial sharding")
    y = _spatial_conv_nchw(x.permute(0, 3, 1, 2), w, exchanger)
    return y.permute(0, 2, 3, 1)


class _SpatialSyncBN(nn.Module):
    """BatchNorm whose batch statistics (and input gradient's sums) are
    reduced over the spatial group (``parallel.sync_batch_norm``,
    momentum 0.1, eps 1e-5: the JAX module's): the slabs' local moments
    combine into exactly the unsharded ``(N, H, W)`` statistics.
    Parameters ``scale`` / ``bias``, buffers ``mean`` / ``var``."""

    def __init__(self, c: int, axis_name, device):
        super().__init__()
        self.axis_name = axis_name
        self.scale = nn.Parameter(torch.ones(c, device=device))
        self.bias = nn.Parameter(torch.zeros(c, device=device))
        self.register_buffer("mean", torch.zeros(c, device=device))
        self.register_buffer("var", torch.ones(c, device=device))

    def forward(self, x, train: bool):
        from ...parallel.sync_batchnorm import sync_batch_norm

        y, new_rm, new_rv = sync_batch_norm(
            x, self.scale, self.bias, self.mean, self.var, training=train,
            momentum=0.1, eps=1e-5,
            axis_name=spatial_group(self.axis_name) if train else None,
            channel_last=False)
        if train:
            with torch.no_grad():
                self.mean.copy_(new_rm)
                self.var.copy_(new_rv)
        return y


class SpatialBottleneck(nn.Module):
    """The height-sharded bottleneck: :class:`Bottleneck`'s math at
    stride 1 with the 3x3 conv's halos exchanged across the ranks of
    ``axis_name`` (``HaloExchangerSendRecv``) and every BatchNorm's
    statistics reduced over them. Each rank calls it on its ``[N,
    H / ranks, W, C]`` NHWC slab. ``axis_name`` is a ``ProcessGroup``,
    a ``parallel_state`` axis name, or any other name for the default
    group (``halo_exchangers.spatial_group``). Parameters keep the flax
    names: ``conv1.kernel``, ``conv2_kernel`` (``[out, in, 3, 3]``,
    channels-last), ``conv3.kernel``, ``bn1.scale``..., and with
    ``in_channels != out_channels`` ``downsample_conv`` /
    ``downsample_bn``; ``convert.spatial_bottleneck_state_from_jax``
    carries a flax tree across. Weights from ``generator`` on ``device``
    (None: the card)."""

    def __init__(self, in_channels: int, bottleneck_channels: int,
                 out_channels: int, axis_name="spatial",
                 use_running_stats: bool = False, *,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        dev = resolve_device(device)
        self.in_channels = in_channels
        self.bottleneck_channels = bottleneck_channels
        self.out_channels = out_channels
        self.axis_name = axis_name
        self.use_running_stats = use_running_stats
        mid = bottleneck_channels
        self.conv1 = _Conv(in_channels, mid, 1, 1, generator, dev)
        self.conv2_kernel = nn.Parameter(_lecun_normal((mid, mid, 3, 3),
                                                       generator, dev))
        self.conv3 = _Conv(mid, out_channels, 1, 1, generator, dev)
        self.bn1 = _SpatialSyncBN(mid, axis_name, dev)
        self.bn2 = _SpatialSyncBN(mid, axis_name, dev)
        self.bn3 = _SpatialSyncBN(out_channels, axis_name, dev)
        self.has_downsample = in_channels != out_channels
        if self.has_downsample:
            self.downsample_conv = _Conv(in_channels, out_channels, 1, 1,
                                         generator, dev)
            self.downsample_bn = _SpatialSyncBN(out_channels, axis_name, dev)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        train = not self.use_running_stats
        xc = x.permute(0, 3, 1, 2)  # NHWC memory, NCHW view
        y = torch.relu(self.bn1(self.conv1(xc), train))
        y = _spatial_conv_nchw(y, self.conv2_kernel,
                               HaloExchangerSendRecv(self.axis_name))
        y = torch.relu(self.bn2(y, train))
        y = self.bn3(self.conv3(y), train)
        residual = xc
        if self.has_downsample:
            residual = self.downsample_bn(self.downsample_conv(xc), train)
        return torch.relu(y + residual).permute(0, 2, 3, 1)
