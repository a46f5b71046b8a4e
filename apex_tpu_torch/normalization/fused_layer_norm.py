"""FusedLayerNorm module and functional API (counterpart of
``apex_tpu/normalization/fused_layer_norm.py``).

Both go through :func:`apex_tpu_torch.ops.layer_norm.layer_norm`, the
autograd Function over the forward and backward kernels. RMSNorm, the
``Mixed*`` variants and ``memory_efficient`` are not ported yet
(ROADMAP.md, queue A2).
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple, Union

import torch
from torch import nn

from ..ops.layer_norm import layer_norm as _layer_norm_op

Shape = Union[int, Sequence[int]]


def _norm_shape(normalized_shape: Shape) -> Tuple[int, ...]:
    if isinstance(normalized_shape, int):
        return (int(normalized_shape),)
    return tuple(int(d) for d in normalized_shape)


def _check_shape(x: torch.Tensor, ns: Tuple[int, ...]) -> None:
    if tuple(x.shape[x.ndim - len(ns):]) != ns:
        raise ValueError(
            f"normalized_shape {ns} does not match trailing input dims "
            f"{tuple(x.shape)}")


def fused_layer_norm_affine(x, weight, bias, normalized_shape, eps=1e-5,
                            memory_efficient=False):
    ns = _norm_shape(normalized_shape)
    _check_shape(x, ns)
    return _layer_norm_op(x, weight, bias, eps, normalized_ndim=len(ns),
                          memory_efficient=memory_efficient)


def fused_layer_norm(x, normalized_shape, eps=1e-5, memory_efficient=False):
    ns = _norm_shape(normalized_shape)
    _check_shape(x, ns)
    return _layer_norm_op(x, None, None, eps, normalized_ndim=len(ns),
                          memory_efficient=memory_efficient)


class FusedLayerNorm(nn.Module):
    """Drop-in LayerNorm module: weight ones, bias zeros, in
    ``param_dtype`` (fp32 by default), statistics fp32."""

    def __init__(self, normalized_shape: Shape, eps: float = 1e-5,
                 elementwise_affine: bool = True,
                 memory_efficient: bool = False,
                 param_dtype: torch.dtype = torch.float32,
                 device: Optional[torch.device] = None):
        super().__init__()
        self.normalized_shape = _norm_shape(normalized_shape)
        self.eps = eps
        self.elementwise_affine = elementwise_affine
        self.memory_efficient = memory_efficient
        if elementwise_affine:
            self.weight = nn.Parameter(torch.ones(
                self.normalized_shape, dtype=param_dtype, device=device))
            self.bias = nn.Parameter(torch.zeros(
                self.normalized_shape, dtype=param_dtype, device=device))
        else:
            self.register_parameter("weight", None)
            self.register_parameter("bias", None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.elementwise_affine:
            return fused_layer_norm_affine(
                x, self.weight, self.bias, self.normalized_shape, self.eps,
                self.memory_efficient)
        return fused_layer_norm(x, self.normalized_shape, self.eps,
                                self.memory_efficient)
