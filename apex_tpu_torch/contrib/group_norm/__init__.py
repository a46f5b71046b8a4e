"""contrib.group_norm (counterpart of ``apex_tpu/contrib/group_norm``):
NHWC GroupNorm with an optional swish/SiLU, plain PyTorch."""
from .group_norm import (
    GroupNorm,
    cuda_group_norm_nhwc_one_pass,
    cuda_group_norm_nhwc_two_pass,
    cuda_group_norm_v2_nhwc,
    group_norm_nhwc,
)

__all__ = [
    "GroupNorm",
    "group_norm_nhwc",
    "cuda_group_norm_nhwc_one_pass",
    "cuda_group_norm_nhwc_two_pass",
    "cuda_group_norm_v2_nhwc",
]
