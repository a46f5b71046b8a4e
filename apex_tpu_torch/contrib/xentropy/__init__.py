from .softmax_xentropy import (  # noqa: F401
    SoftmaxCrossEntropyLoss,
    lm_head_cross_entropy,
    lm_logits,
    logits_f32,
    softmax_cross_entropy_loss,
)

__all__ = ["SoftmaxCrossEntropyLoss", "lm_head_cross_entropy", "lm_logits",
           "logits_f32", "softmax_cross_entropy_loss"]
