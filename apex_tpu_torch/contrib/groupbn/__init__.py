"""contrib.groupbn (counterpart of ``apex_tpu/contrib/groupbn``): the NHWC
BatchNorm with the fused ReLU and add + ReLU epilogues; ``bn_group > 1``
syncs its statistics over groups of consecutive data-parallel ranks."""
from .batch_norm import BatchNorm2d_NHWC  # noqa: F401

__all__ = ["BatchNorm2d_NHWC"]
