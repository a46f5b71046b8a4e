"""contrib.cudnn_gbn (counterpart of ``apex_tpu/contrib/cudnn_gbn``): the
cuDNN-frontend group BatchNorm, an alias of ``contrib.groupbn``'s."""
from ..groupbn.batch_norm import GroupBatchNorm2d  # noqa: F401

__all__ = ["GroupBatchNorm2d"]
