"""Fused optimizers (counterpart of ``apex_tpu/optimizers``): FusedAdam
with the packed flat-buffer path, and FusedLAMB's pytree path. The other
optimizers and packed LAMB are not ported yet (ROADMAP.md, queues A3
and B)."""
from ._packed import PackedState  # noqa: F401
from .fused_adam import FusedAdam, FusedAdamState, FusedAdamW  # noqa: F401
from .fused_lamb import (  # noqa: F401
    FusedLAMB,
    FusedLAMBState,
    FusedMixedPrecisionLamb,
)
