"""contrib.sparsity (counterpart of ``apex_tpu/contrib/sparsity``): 2:4
structured-sparsity masks (``create_mask``), the functional ``ASP``
workflow, and the channel-permutation searches."""
from .asp import ASP
from .permutation_search import (
    apply_2_to_4,
    apply_permutation_C,
    apply_permutation_K,
    channel_swap_search,
    exhaustive_search,
    sum_after_2_to_4,
)
from .sparse_masklib import create_mask

__all__ = [
    "ASP",
    "create_mask",
    "channel_swap_search",
    "exhaustive_search",
    "apply_2_to_4",
    "sum_after_2_to_4",
    "apply_permutation_C",
    "apply_permutation_K",
]
