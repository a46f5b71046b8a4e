"""contrib.optimizers (counterpart of ``apex_tpu/contrib/optimizers``).

The legacy ``FusedAdam`` and ``FusedSGD`` with the explicit-scale step
(``legacy.py``), and the maintained ``FusedLAMB`` and ``FP16_Optimizer``
re-exported, as in the JAX package. The ZeRO optimizers
``DistributedFusedAdam`` and ``DistributedFusedLAMB`` shard their state
over ranks: they come with the distributed slice (ROADMAP.md, queue A6.6)
and raise on construction until then.
"""
from ...fp16_utils.fp16_optimizer import FP16_Optimizer  # noqa: F401
from ...optimizers.fused_lamb import FusedLAMB  # noqa: F401
from .legacy import LegacyFusedAdam as FusedAdam  # noqa: F401
from .legacy import LegacyFusedSGD as FusedSGD  # noqa: F401

_NEEDS_A66 = ("{} shards its state over ranks with torch.distributed, "
              "which comes with the distributed slice (ROADMAP.md, queue "
              "A6.6)")


class DistributedFusedAdam:
    def __init__(self, *args, **kwargs):
        raise NotImplementedError(_NEEDS_A66.format("DistributedFusedAdam"))


class DistributedFusedLAMB:
    def __init__(self, *args, **kwargs):
        raise NotImplementedError(_NEEDS_A66.format("DistributedFusedLAMB"))


__all__ = [
    "DistributedFusedAdam",
    "DistributedFusedLAMB",
    "FusedAdam",
    "FusedSGD",
    "FusedLAMB",
    "FP16_Optimizer",
]
