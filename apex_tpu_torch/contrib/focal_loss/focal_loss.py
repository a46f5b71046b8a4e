"""Sigmoid focal loss, EfficientDet style (counterpart of
``apex_tpu/contrib/focal_loss/focal_loss.py``).

- ``cls_output``: logits ``(..., num_classes)``, possibly right-padded
  past ``num_real_classes`` (the padding contributes nothing and gets
  exactly zero gradient);
- ``cls_targets_at_level``: integer targets per anchor; ``-2`` ignores
  the example, ``-1`` makes it all-negative, ``>= 0`` names its class;
- per (example, class) a binary focal cross entropy against the smoothed
  targets ``1 - s + s/2`` and ``s/2``, in fp32: ``coeff * BCE`` with the
  stable ``BCE = (1 - t) p + softplus(-p)``, ``coeff = alpha (1 - sigma)^
  gamma`` at the positive class and ``(1 - alpha) sigma^gamma``
  elsewhere;
- the sum over valid elements divided by ``num_positives_sum``.

The expression is the JAX package's, operation for operation; autograd
gives the gradient.
"""
from __future__ import annotations

import torch


def focal_loss(cls_output: torch.Tensor, cls_targets_at_level: torch.Tensor,
               num_positives_sum, num_real_classes: int, alpha: float,
               gamma: float, label_smoothing: float = 0.0) -> torch.Tensor:
    """Scalar focal loss (see the module docstring)."""
    p = cls_output.to(torch.float32)
    num_classes = p.shape[-1]
    y = cls_targets_at_level.to(torch.int32)[..., None]
    class_ids = torch.arange(num_classes, dtype=torch.int32, device=p.device)
    is_pos = (y == class_ids) & (y >= 0)

    s = label_smoothing
    t_pos = 1.0 - s + s / 2.0
    t_neg = s / 2.0
    target = torch.where(is_pos, t_pos, t_neg)

    sigma = torch.sigmoid(p)
    # softplus as jax.nn.softplus spells it: logaddexp(x, 0)
    bce = (1.0 - target) * p + torch.logaddexp(-p, torch.zeros_like(p))
    coeff = torch.where(is_pos, alpha * (1.0 - sigma) ** gamma,
                        (1.0 - alpha) * sigma ** gamma)
    elem = coeff * bce

    valid = (y != -2) & (class_ids < num_real_classes)
    total = torch.where(valid, elem, torch.zeros((), device=p.device)).sum()
    num_pos = torch.as_tensor(num_positives_sum, device=p.device).to(
        torch.float32).reshape(())
    return total / num_pos


class FocalLoss:
    """``FocalLoss.apply``: the reference's autograd-Function spelling."""

    @staticmethod
    def apply(cls_output, cls_targets_at_level, num_positives_sum,
              num_real_classes, alpha, gamma, label_smoothing=0.0):
        return focal_loss(cls_output, cls_targets_at_level, num_positives_sum,
                          num_real_classes, alpha, gamma, label_smoothing)
