"""A convolution with its bias (+ReLU / +mask / frozen scale) epilogue
(counterpart of ``apex_tpu/contrib/conv_bias_relu/conv_bias_relu.py``).

The four functions of the reference: ``ConvBiasReLU``,
``ConvBiasMaskReLU``, ``ConvBias`` and ``ConvFrozenScaleBiasReLU``, with
its call shape ``f(x, weight, bias, padding, stride)``; ``padding`` and
``stride`` are integers applied to H and W alike (the padding on both
sides). ``x`` is NHWC, as in the JAX package and the reference. The
weight is in torch's layout, ``[out, in, kh, kw]``, ideally
``torch.channels_last`` in memory: ``convert.conv_kernel_from_jax``
turns the JAX package's HWIO kernel into it once, so no call converts a
weight. The NHWC input is handed to cuDNN as the channels-last NCHW view
of the same memory and the output comes back as NHWC, so no call
transposes an activation either. The epilogue is plain PyTorch after the
convolution, in the input's dtype; autograd gives the backward, and the
frozen scale and bias are ``detach``-ed, as JAX's ``stop_gradient``.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def _conv(x: torch.Tensor, weight: torch.Tensor, padding: int,
          stride: int) -> torch.Tensor:
    y = F.conv2d(x.permute(0, 3, 1, 2), weight, None, stride, padding)
    return y.permute(0, 2, 3, 1)


def ConvBiasReLU(x, weight, bias, padding: int, stride: int):
    """``relu(conv(x, w) + b)`` (reference ``ConvBiasReLU_``)."""
    return torch.relu(_conv(x, weight, padding, stride) + bias.to(x.dtype))


def ConvBiasMaskReLU(x, weight, bias, mask, padding: int, stride: int):
    """``relu((conv(x, w) + b) * mask)``; ``mask`` broadcasts against the
    NHWC output (reference ``ConvBiasMaskReLU_``)."""
    return torch.relu((_conv(x, weight, padding, stride) + bias.to(x.dtype))
                      * mask.to(x.dtype))


def ConvBias(x, weight, bias, padding: int, stride: int):
    """``conv(x, w) + b`` (reference ``ConvBias_``)."""
    return _conv(x, weight, padding, stride) + bias.to(x.dtype)


def ConvFrozenScaleBiasReLU(x, weight, scale, bias, padding: int,
                            stride: int):
    """``relu(conv(x, w) * scale + b)`` with the scale and bias frozen (no
    gradient): the folded-BatchNorm epilogue of inference."""
    scale = scale.detach()
    bias = bias.detach()
    return torch.relu(_conv(x, weight, padding, stride) * scale.to(x.dtype)
                      + bias.to(x.dtype))
