from .clip_grad import clip_grad_norm_, clip_grad_norm_flat  # noqa: F401

__all__ = ["clip_grad_norm_", "clip_grad_norm_flat"]
