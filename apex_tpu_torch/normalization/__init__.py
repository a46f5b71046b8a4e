"""Fused LayerNorm and RMSNorm modules and functional API (counterpart of
``apex_tpu/normalization``)."""
from .fused_layer_norm import (  # noqa: F401
    FusedLayerNorm,
    FusedRMSNorm,
    MixedFusedLayerNorm,
    MixedFusedRMSNorm,
    fused_layer_norm,
    fused_layer_norm_affine,
    fused_rms_norm,
    fused_rms_norm_affine,
    manual_rms_norm,
    mixed_dtype_fused_layer_norm_affine,
    mixed_dtype_fused_rms_norm_affine,
)
