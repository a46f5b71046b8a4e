"""contrib.multihead_attn (counterpart of
``apex_tpu/contrib/multihead_attn``): ``SelfMultiheadAttn`` and
``EncdecMultiheadAttn`` over the flash kernels, and
``mask_softmax_dropout``."""
from .multihead_attn import (
    EncdecMultiheadAttn,
    SelfMultiheadAttn,
    mask_softmax_dropout,
)

__all__ = ["SelfMultiheadAttn", "EncdecMultiheadAttn",
           "mask_softmax_dropout"]
