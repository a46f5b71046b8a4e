"""Kernels of the port, each beside its plain PyTorch version
(counterpart of ``apex_tpu/ops``): the names the JAX package exports
here are the functions, not their modules (``from apex_tpu_torch.ops
import flash_attention`` gives the function; the module is
``importlib.import_module("apex_tpu_torch.ops.flash_attention")``)."""
from .multi_tensor import (  # noqa: F401
    has_inf_or_nan,
    l2norm,
    multi_tensor_axpby,
    multi_tensor_l2norm,
    multi_tensor_scale,
    multi_tensor_unscale_l2norm,
    update_scale_hysteresis,
)
from .packed_optimizer import (  # noqa: F401
    multi_tensor_axpby_flat,
    multi_tensor_l2norm_flat,
    multi_tensor_scale_flat,
    packed_adam_apply,
    packed_lamb_stage1,
    packed_novograd_apply,
    packed_row_reduce,
    packed_row_stats,
    packed_scale_update,
    packed_sgd_apply,
)
from .flash_attention import (  # noqa: F401
    flash_attention,
    flash_attention_available,
    flash_attention_sbhd,
)
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
