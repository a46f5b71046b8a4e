"""Transformer functional ops (counterpart of
``apex_tpu/transformer/functional``): the fused scale-mask-softmax.
``fused_rope`` is not ported yet (ROADMAP.md, queue A5.3)."""
from .fused_softmax import (  # noqa: F401
    FusedScaleMaskSoftmax,
    generic_scaled_masked_softmax,
    scaled_masked_softmax,
    scaled_softmax,
    scaled_upper_triang_masked_softmax,
)
