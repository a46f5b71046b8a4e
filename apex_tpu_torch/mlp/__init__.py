"""Fused MLP (counterpart of ``apex_tpu/mlp``)."""
from .mlp import MLP, mlp  # noqa: F401
