"""Kernels of the port, each beside its plain PyTorch version."""
from .flash_decode import (  # noqa: F401
    flash_decode,
    flash_decode_available,
    paged_decode_reference,
)
from .fused_block import (  # noqa: F401
    bias_dropout_residual,
    bias_gelu,
    fused_block_available,
    residual_add_layer_norm,
)
from .layer_norm import (  # noqa: F401
    layer_norm,
    layer_norm_fwd,
    layer_norm_reference,
    rms_norm,
    rms_norm_fwd,
    rms_norm_reference,
)
