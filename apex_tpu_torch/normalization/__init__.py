"""Fused LayerNorm module and functional API (counterpart of
``apex_tpu/normalization``; RMSNorm is not ported yet)."""
from .fused_layer_norm import (  # noqa: F401
    FusedLayerNorm,
    fused_layer_norm,
    fused_layer_norm_affine,
)
