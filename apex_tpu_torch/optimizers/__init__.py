"""Fused optimizers (counterpart of ``apex_tpu/optimizers``): FusedAdam
with the packed flat-buffer path. The other optimizers are not ported
yet (ROADMAP.md, queue A3)."""
from ._packed import PackedState  # noqa: F401
from .fused_adam import FusedAdam, FusedAdamState, FusedAdamW  # noqa: F401
