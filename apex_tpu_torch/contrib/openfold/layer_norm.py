"""OpenFold small-shape LayerNorm entry point (counterpart of
``apex_tpu/contrib/openfold/layer_norm.py``): the reference's
``LayerNormSmallShapeOptImpl.apply(inputs, normalized_shape, weight,
bias, eps)`` over the port's LayerNorm kernels (fp32 statistics per row;
``normalized_shape`` selects the trailing dims normalised over).
"""
from __future__ import annotations

from typing import Sequence

import torch

from ...ops.layer_norm import layer_norm


def layer_norm_small_shape(inputs: torch.Tensor,
                           normalized_shape: Sequence[int],
                           weight: torch.Tensor, bias: torch.Tensor,
                           eps: float = 1e-5) -> torch.Tensor:
    """``LayerNormSmallShapeOptImpl.apply``: the LayerNorm of ``inputs``
    over its trailing ``normalized_shape``; the kernels take fp32
    parameters, so 16-bit ones are widened (exactly)."""
    normalized_shape = tuple(normalized_shape)
    nd = len(normalized_shape)
    if tuple(inputs.shape[-nd:]) != normalized_shape:
        raise ValueError(
            f"normalized_shape {normalized_shape} does not match trailing "
            f"input dims {tuple(inputs.shape[-nd:])}")
    return layer_norm(inputs, weight.float(), bias.float(), eps,
                      normalized_ndim=nd)


class LayerNormSmallShapeOptImpl:
    """The reference's class name, with ``apply`` a plain function."""
    apply = staticmethod(layer_norm_small_shape)
