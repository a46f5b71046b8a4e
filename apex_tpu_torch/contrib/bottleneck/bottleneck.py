"""The ResNet bottleneck block, 1x1 -> 3x3 -> 1x1 with a residual
(counterpart of ``apex_tpu/contrib/bottleneck/bottleneck.py``'s
``Bottleneck``, a flax module).

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
"""
from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from ..._device import resolve_device
from ...examples.imagenet import resnet as _resnet


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
