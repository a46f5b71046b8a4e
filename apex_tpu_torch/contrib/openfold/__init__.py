"""contrib.openfold (counterpart of ``apex_tpu/contrib/openfold``): the
pair-biased attention core (``mha``: ``attention_core`` / ``AttnTri``)
over the flash kernels' additive bias, and the small-shape LayerNorm
entry point (``layer_norm``) over the port's LayerNorm kernels.
``FusedAdamSWA`` is not ported yet (ROADMAP.md, queue A5.4)."""
from . import mha
from .layer_norm import LayerNormSmallShapeOptImpl, layer_norm_small_shape
from .mha import (
    AttnTri,
    attention_core,
    attention_reference,
    can_use_fused_attention,
)

__all__ = [
    "AttnTri",
    "attention_core",
    "attention_reference",
    "can_use_fused_attention",
    "LayerNormSmallShapeOptImpl",
    "layer_norm_small_shape",
    "mha",
]
