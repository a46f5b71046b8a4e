"""Model-parallel-aware amp (counterpart of ``apex_tpu/transformer/amp``)."""
from .grad_scaler import GradScaler  # noqa: F401
