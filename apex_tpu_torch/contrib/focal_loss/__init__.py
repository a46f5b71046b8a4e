"""contrib.focal_loss (counterpart of ``apex_tpu/contrib/focal_loss``):
the sigmoid focal loss of detection models, plain PyTorch."""
from .focal_loss import FocalLoss, focal_loss

__all__ = ["FocalLoss", "focal_loss"]
