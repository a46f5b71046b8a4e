"""NHWC GroupNorm with an optional swish/SiLU (counterpart of
``apex_tpu/contrib/group_norm/group_norm.py``).

Statistics in fp32 per (sample, group), the variance in two passes,
``mean((x - mean)^2)`` (not E[x^2] - E[x]^2); then the optional affine
and swish in fp32, and one cast back to the input's dtype. The three
``cuda_group_norm_*`` names of the reference's kernel variants are
aliases of one implementation, as in the JAX package.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..._device import resolve_device


def group_norm_nhwc(x: torch.Tensor, num_groups: int,
                    weight: Optional[torch.Tensor] = None,
                    bias: Optional[torch.Tensor] = None, eps: float = 1e-5,
                    act: Optional[str] = None) -> torch.Tensor:
    """GroupNorm over an NHWC tensor; ``act`` None or ``"swish"`` /
    ``"silu"``."""
    if act not in (None, "", "swish", "silu"):
        raise ValueError(f"unsupported act {act!r} (None or 'swish'/'silu')")
    n, h, w, c = x.shape
    if c % num_groups:
        raise ValueError(
            f"channels {c} not divisible by num_groups {num_groups}")
    xg = x.to(torch.float32).reshape(n, h * w, num_groups, c // num_groups)
    mean = xg.mean(dim=(1, 3), keepdim=True)
    var = (xg - mean).square().mean(dim=(1, 3), keepdim=True)
    y = (xg - mean) * torch.rsqrt(var + eps)
    y = y.reshape(n, h, w, c)
    if weight is not None:
        y = y * weight.to(torch.float32)
    if bias is not None:
        y = y + bias.to(torch.float32)
    if act in ("swish", "silu"):
        y = y * torch.sigmoid(y)
    return y.to(x.dtype)


# the reference's three kernel variants (`group_norm.py:187, :191, :195`)
def cuda_group_norm_nhwc_one_pass(x, G, weight, bias, eps, act=None):
    return group_norm_nhwc(x, G, weight, bias, eps, act)


def cuda_group_norm_nhwc_two_pass(x, G, weight, bias, eps, act=None):
    return group_norm_nhwc(x, G, weight, bias, eps, act)


def cuda_group_norm_v2_nhwc(x, G, weight, bias, eps, act=None):
    return group_norm_nhwc(x, G, weight, bias, eps, act)


class GroupNorm(nn.Module):
    """The reference's ``GroupNorm`` module: NHWC input, optional affine
    (flax's names ``weight`` and ``bias``, ones and zeros in
    ``param_dtype``), optional swish. Parameters live on ``device``
    (None: the card)."""

    def __init__(self, num_groups: int, num_channels: int,
                 eps: float = 1e-5, affine: bool = True,
                 act: Optional[str] = None,
                 param_dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.num_groups = num_groups
        self.num_channels = num_channels
        self.eps = eps
        self.affine = affine
        self.act = act
        if affine:
            dev = resolve_device(device)
            self.weight = nn.Parameter(torch.ones(
                num_channels, dtype=param_dtype, device=dev))
            self.bias = nn.Parameter(torch.zeros(
                num_channels, dtype=param_dtype, device=dev))
        else:
            self.weight = self.bias = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.shape[-1] != self.num_channels:
            raise ValueError(f"expected {self.num_channels} channels (NHWC), "
                             f"got {x.shape[-1]}")
        return group_norm_nhwc(x, self.num_groups, self.weight, self.bias,
                               self.eps, self.act)
