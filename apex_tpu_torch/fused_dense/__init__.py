"""Fused dense layers (counterpart of ``apex_tpu/fused_dense``)."""
from .fp8 import (  # noqa: F401
    FP8_E4M3_MAX,
    FP8_E5M2_MAX,
    Fp8DenseState,
    Fp8TensorMeta,
    fp8_fused_dense,
    fp8_fused_dense_qgrad,
    init_fp8_dense_state,
    quantize_e4m3,
    quantize_e5m2,
    record_grad_amax,
)
from .fused_dense import (  # noqa: F401
    FusedDense,
    FusedDenseGeluDense,
    dense_no_bias,
    fused_dense,
    fused_dense_gelu_dense,
)
