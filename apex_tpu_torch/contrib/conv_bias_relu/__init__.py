"""contrib.conv_bias_relu (counterpart of
``apex_tpu/contrib/conv_bias_relu``): a convolution with its bias, mask,
frozen scale and ReLU epilogues over cuDNN."""
from .conv_bias_relu import (  # noqa: F401
    ConvBias,
    ConvBiasMaskReLU,
    ConvBiasReLU,
    ConvFrozenScaleBiasReLU,
)

__all__ = [
    "ConvBiasReLU",
    "ConvBiasMaskReLU",
    "ConvBias",
    "ConvFrozenScaleBiasReLU",
]
