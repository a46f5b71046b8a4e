"""Fused optimizers (counterpart of ``apex_tpu/optimizers``): FusedAdam,
FusedLAMB, FusedSGD and FusedNovoGrad, each with its pytree path and its
packed flat-buffer path, and FusedAdagrad (pytree only, as in the JAX
package): every optimizer of ``apex_tpu/optimizers``. The legacy
contrib optimizers are ``contrib.optimizers``; the distributed ones wait
for queue A6.6 (ROADMAP.md)."""
from ._packed import PackedState  # noqa: F401
from .fused_adagrad import FusedAdagrad, FusedAdagradState  # noqa: F401
from .fused_adam import FusedAdam, FusedAdamState, FusedAdamW  # noqa: F401
from .fused_lamb import (  # noqa: F401
    FusedLAMB,
    FusedLAMBState,
    FusedMixedPrecisionLamb,
)
from .fused_novograd import FusedNovoGrad, FusedNovoGradState  # noqa: F401
from .fused_sgd import FusedSGD, FusedSGDState  # noqa: F401
