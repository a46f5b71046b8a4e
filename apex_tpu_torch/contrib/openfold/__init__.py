"""contrib.openfold (counterpart of ``apex_tpu/contrib/openfold``): the
pair-biased attention core (``mha``: ``attention_core`` / ``AttnTri``)
over the flash kernels' additive bias, the small-shape LayerNorm entry
point (``layer_norm``) over the port's LayerNorm kernels, and
``FusedAdamSWA`` (``fused_adam_swa``: Adam with stochastic weight
averaging over three parameter banks, plain PyTorch)."""
from . import mha
from .fused_adam_swa import AdamMathType, FusedAdamSWA, FusedAdamSWAState
from .layer_norm import LayerNormSmallShapeOptImpl, layer_norm_small_shape
from .mha import (
    AttnTri,
    attention_core,
    attention_reference,
    can_use_fused_attention,
)

__all__ = [
    "AdamMathType",
    "FusedAdamSWA",
    "FusedAdamSWAState",
    "AttnTri",
    "attention_core",
    "attention_reference",
    "can_use_fused_attention",
    "LayerNormSmallShapeOptImpl",
    "layer_norm_small_shape",
    "mha",
]
