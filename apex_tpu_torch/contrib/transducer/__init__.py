"""contrib.transducer (counterpart of ``apex_tpu/contrib/transducer``): the
RNN-T joint and loss, plain PyTorch."""
from .transducer import (  # noqa: F401
    TransducerJoint,
    TransducerLoss,
    transducer_joint,
    transducer_loss,
)

__all__ = [
    "TransducerJoint",
    "TransducerLoss",
    "transducer_joint",
    "transducer_loss",
]
