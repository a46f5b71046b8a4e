"""Fused optimizers (counterpart of ``apex_tpu/optimizers``): FusedAdam,
FusedLAMB and FusedSGD, each with its pytree path and its packed
flat-buffer path. The other optimizers are not ported yet (ROADMAP.md,
queues A3 and B)."""
from ._packed import PackedState  # noqa: F401
from .fused_adam import FusedAdam, FusedAdamState, FusedAdamW  # noqa: F401
from .fused_lamb import (  # noqa: F401
    FusedLAMB,
    FusedLAMBState,
    FusedMixedPrecisionLamb,
)
from .fused_sgd import FusedSGD, FusedSGDState  # noqa: F401
