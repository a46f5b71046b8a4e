"""Transformer layer-norm wrappers (counterpart of
``apex_tpu/transformer/layers``)."""
from .layer_norm import (  # noqa: F401
    FastLayerNorm,
    FusedLayerNorm,
    MixedFusedLayerNorm,
)
