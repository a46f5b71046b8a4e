"""Fused multi-layer perceptron (counterpart of ``apex_tpu/mlp/mlp.py``).

A chain of GEMM + bias + activation (none, relu or sigmoid). Each GEMM
accumulates in fp32 and is rounded once to the input's dtype, as the JAX
package's einsum with ``preferred_element_type=float32`` is; the bias
add is a second rounding. The activation is applied after EVERY layer,
the last included (``mlp_cuda``'s forward loop, kept by the JAX
package). The GEMMs are ``F.linear`` on cuBLAS.

:class:`MLP` keeps the flax parameter names ``weight_{i}`` (``[out,
in]``) and ``bias_{i}``, so flax-initialised params load through
``convert.params_from_jax`` and ``load_state_dict``; its own init draws
``uniform(-1/sqrt(fan_in), 1/sqrt(fan_in))`` from ``generator`` (torch's
default generator when None) on ``device`` (None: the card).
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from .._device import resolve_device
from ..fused_dense.fused_dense import _matmul_t, _uniform

_ACTIVATIONS = {
    "none": lambda x: x,
    "relu": torch.relu,
    "sigmoid": torch.sigmoid,
}


def mlp(x: torch.Tensor, weights: Sequence[torch.Tensor],
        biases: Optional[Sequence[Optional[torch.Tensor]]] = None,
        activation: str = "relu") -> torch.Tensor:
    """Functional fused MLP (reference ``MlpFunction``): ``weights[i]``
    is ``[out_i, in_i]``; an unknown activation raises ``TypeError``."""
    if activation not in _ACTIVATIONS:
        raise TypeError("activation must be relu or none or sigmoid")
    act = _ACTIVATIONS[activation]
    h = x
    for i, w in enumerate(weights):
        h = _matmul_t(h, w)
        if biases is not None and biases[i] is not None:
            h = h + biases[i].to(h.dtype)
        h = act(h)
    return h


class MLP(nn.Module):
    """Module form (reference ``MLP``): ``mlp_sizes=[1024, 1024, 1024]``
    makes two 1024 x 1024 layers."""

    def __init__(self, mlp_sizes: Sequence[int], bias: bool = True,
                 activation: str = "relu", *,
                 generator: Optional[torch.Generator] = None,
                 device=None):
        super().__init__()
        self.mlp_sizes = list(mlp_sizes)
        self.bias = bias
        self.activation = activation
        device = resolve_device(device)
        for i in range(len(self.mlp_sizes) - 1):
            fan_in, fan_out = self.mlp_sizes[i], self.mlp_sizes[i + 1]
            bound = 1.0 / fan_in ** 0.5
            setattr(self, f"weight_{i}", _uniform(
                (fan_out, fan_in), bound, generator, device))
            if bias:
                setattr(self, f"bias_{i}", _uniform(
                    (fan_out,), bound, generator, device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n = len(self.mlp_sizes) - 1
        weights = [getattr(self, f"weight_{i}") for i in range(n)]
        biases = ([getattr(self, f"bias_{i}") for i in range(n)]
                  if self.bias else None)
        return mlp(x, weights, biases, self.activation)
