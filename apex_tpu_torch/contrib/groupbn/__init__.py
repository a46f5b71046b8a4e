"""contrib.groupbn (counterpart of ``apex_tpu/contrib/groupbn``): the NHWC
BatchNorm with the fused ReLU and add + ReLU epilogues, single-device
(``bn_group > 1`` waits for queue A6.3)."""
from .batch_norm import BatchNorm2d_NHWC  # noqa: F401

__all__ = ["BatchNorm2d_NHWC"]
