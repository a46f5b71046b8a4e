"""Transformer functional ops (counterpart of
``apex_tpu/transformer/functional``): the fused scale-mask-softmax and
the rotary positional embeddings."""
from .fused_rope import (  # noqa: F401
    fused_apply_rotary_pos_emb,
    fused_apply_rotary_pos_emb_2d,
    fused_apply_rotary_pos_emb_cached,
    fused_apply_rotary_pos_emb_thd,
)
from .fused_softmax import (  # noqa: F401
    FusedScaleMaskSoftmax,
    generic_scaled_masked_softmax,
    scaled_masked_softmax,
    scaled_softmax,
    scaled_upper_triang_masked_softmax,
)
