from .softmax_xentropy import lm_head_cross_entropy, logits_f32  # noqa: F401

__all__ = ["lm_head_cross_entropy", "logits_f32"]
