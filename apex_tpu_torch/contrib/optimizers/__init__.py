"""contrib.optimizers (counterpart of ``apex_tpu/contrib/optimizers``).

The legacy ``FusedAdam`` and ``FusedSGD`` with the explicit-scale step
(``legacy.py``), the maintained ``FusedLAMB`` and ``FP16_Optimizer``
re-exported, as in the JAX package, and the ZeRO-2 optimizers
``DistributedFusedAdam`` and ``DistributedFusedLAMB``, whose state is
sharded over the ranks of a ``torch.distributed`` group
(``distributed_fused_adam.py``, ``distributed_fused_lamb.py``).
"""
from ...fp16_utils.fp16_optimizer import FP16_Optimizer  # noqa: F401
from ...optimizers.fused_lamb import FusedLAMB  # noqa: F401
from .distributed_fused_adam import (  # noqa: F401
    DistributedFusedAdam,
    DistributedFusedAdamState,
)
from .distributed_fused_lamb import (  # noqa: F401
    DistributedFusedLAMB,
    DistributedFusedLAMBState,
)
from .legacy import LegacyFusedAdam as FusedAdam  # noqa: F401
from .legacy import LegacyFusedSGD as FusedSGD  # noqa: F401

__all__ = [
    "DistributedFusedAdam",
    "DistributedFusedAdamState",
    "DistributedFusedLAMB",
    "DistributedFusedLAMBState",
    "FusedAdam",
    "FusedSGD",
    "FusedLAMB",
    "FP16_Optimizer",
]
