"""``out = in1[idx1] * in2``, the gather-multiply of OpenFold's gating
(counterpart of ``apex_tpu/contrib/index_mul_2d/index_mul_2d.py``).

One gather and one multiply: autograd gives the backward (``index_select``'s
backward scatter-adds into ``grad_in1``) and the double backward. On the
card that scatter-add uses atomics, so where ``idx1`` repeats an index the
fp32 sums of ``grad_in1`` land in an order that changes from run to run:
card against CPU they agree to summation order, not bit for bit. The
forward is one rounding (the product) on every device. The contract
checks raise the JAX package's messages.
"""
from __future__ import annotations

import torch


def index_mul_2d(in1: torch.Tensor, in2: torch.Tensor,
                 idx1: torch.Tensor) -> torch.Tensor:
    """``out[i, :] = in1[idx1[i], :] * in2[i, :]``."""
    if in1.dim() != 2 or in2.dim() != 2:
        raise RuntimeError("in1 and in2 must be 2-dimension tensors.")
    if idx1.dim() != 1:
        raise RuntimeError("idx1 must be a 1-dimension tensor.")
    if in2.shape[0] != idx1.shape[0]:
        raise RuntimeError("in2 and idx1 must agree on dim 0.")
    if in1.dtype != in2.dtype:
        raise RuntimeError(
            "input1's dtype and input2's dtype must be the same.")
    return torch.index_select(in1, 0, idx1) * in2
