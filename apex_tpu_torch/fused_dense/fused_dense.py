"""Fused GEMM + bias and GEMM + bias + GeLU + GEMM (counterpart of
``apex_tpu/fused_dense/fused_dense.py``).

Numerics follow the JAX package: each product accumulates in fp32 and is
rounded once to ``x.dtype`` (``_matmul_t``: the einsum with
``preferred_element_type=float32``, then ``astype(x.dtype)``; operands of
two dtypes meet in the wider one, as JAX promotes them), and each bias
add is a second rounding in that dtype. The GEMMs are ``F.linear`` on
cuBLAS, as the JAX package left them to XLA.
:func:`fused_dense_gelu_dense` runs its bias + tanh GeLU through the
port's bias-GeLU kernels (``ops.fused_block.bias_gelu``, kernels #8/#9
of the TPU kernel table), which compute the same function as the JAX
module's ``jax.nn.gelu(h + bias, approximate=True)`` with the add and
the GeLU in fp32 and one rounding.

The modules keep the flax parameter names and shapes (``weight [out,
in]``, ``bias [out]``; ``weight1``, ``bias1``, ``weight2``, ``bias2``),
so flax-initialised params load through ``convert.params_from_jax`` and
``load_state_dict``. Their own init draws fp32 ``uniform(-1/sqrt(fan_in),
1/sqrt(fan_in))`` from ``generator`` (torch's default generator when
None) on ``device`` (None: the card), as flax's default param dtype.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from .._device import resolve_device
from ..ops.fused_block import bias_gelu


def _matmul_t(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w^T`` (``w [out, in]``, torch Linear layout) accumulated in
    fp32 and rounded once to ``x.dtype``."""
    ct = torch.promote_types(x.dtype, w.dtype)
    return F.linear(x.to(ct), w.to(ct)).to(x.dtype)


def fused_dense(x: torch.Tensor, weight: torch.Tensor,
                bias: torch.Tensor) -> torch.Tensor:
    """GEMM + bias (reference ``FusedDenseFunc``)."""
    y = _matmul_t(x, weight)
    return y + bias.to(y.dtype)


def dense_no_bias(x: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """GEMM (reference ``DenseNoBiasFunc``)."""
    return _matmul_t(x, weight)


def fused_dense_gelu_dense(x: torch.Tensor, weight1: torch.Tensor,
                           bias1: torch.Tensor, weight2: torch.Tensor,
                           bias2: torch.Tensor) -> torch.Tensor:
    """GEMM + bias + tanh GeLU + GEMM + bias (reference
    ``FusedDenseGeluDenseFunc``); the bias + GeLU is the bias-GeLU
    kernel on the card."""
    h = _matmul_t(x, weight1)
    h = bias_gelu(h, bias1.to(h.dtype))
    y = _matmul_t(h, weight2)
    return y + bias2.to(y.dtype)


def _uniform(shape, bound: float, generator: Optional[torch.Generator],
             device: torch.device) -> nn.Parameter:
    """An fp32 parameter drawn from ``uniform(-bound, bound)``."""
    t = torch.empty(shape, device=device)
    return nn.Parameter(t.uniform_(-bound, bound, generator=generator))


class FusedDense(nn.Module):
    """Reference ``FusedDense``: ``weight [out, in]`` and, with ``bias``,
    ``bias [out]``."""

    def __init__(self, in_features: int, out_features: int,
                 bias: bool = True, *,
                 generator: Optional[torch.Generator] = None,
                 device=None):
        super().__init__()
        self.in_features = in_features
        self.out_features = out_features
        device = resolve_device(device)
        bound = 1.0 / in_features ** 0.5
        self.weight = _uniform((out_features, in_features), bound,
                               generator, device)
        if bias:
            self.bias = _uniform((out_features,), bound, generator, device)
        else:
            self.register_parameter("bias", None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.bias is not None:
            return fused_dense(x, self.weight, self.bias)
        return dense_no_bias(x, self.weight)


class FusedDenseGeluDense(nn.Module):
    """Reference ``FusedDenseGeluDense``: ``weight1 [inter, in]``,
    ``bias1 [inter]``, ``weight2 [out, inter]``, ``bias2 [out]``;
    ``bias=False`` raises, as in the reference."""

    def __init__(self, in_features: int, intermediate_features: int,
                 out_features: int, bias: bool = True, *,
                 generator: Optional[torch.Generator] = None,
                 device=None):
        super().__init__()
        if not bias:
            raise RuntimeError(
                "FusedDenseGeluDense module requires bias=True (reference "
                "fused_dense.py:85)")
        self.in_features = in_features
        self.intermediate_features = intermediate_features
        self.out_features = out_features
        device = resolve_device(device)
        b1 = 1.0 / in_features ** 0.5
        b2 = 1.0 / intermediate_features ** 0.5
        self.weight1 = _uniform((intermediate_features, in_features), b1,
                                generator, device)
        self.bias1 = _uniform((intermediate_features,), b1, generator,
                              device)
        self.weight2 = _uniform((out_features, intermediate_features), b2,
                                generator, device)
        self.bias2 = _uniform((out_features,), b2, generator, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return fused_dense_gelu_dense(x, self.weight1, self.bias1,
                                      self.weight2, self.bias2)
