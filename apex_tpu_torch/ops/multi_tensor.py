"""Multi-tensor L2 norms (counterpart of ``apex_tpu/ops/multi_tensor.py``'s
``multi_tensor_l2norm`` and ``l2norm``).

The JAX package computes them as a tree reduce that XLA fuses on its
own (no Pallas kernel); here each leaf's sum of squares is one PyTorch
reduction in fp32. The rest of that module (scale, axpby, unscale with
overflow flags) comes with the amp slice (ROADMAP.md, queue A3).
"""
from __future__ import annotations

from typing import Any, Optional, Tuple

import torch

from .._tree import tree_leaves

Tree = Any


def _sq_sum(leaf: torch.Tensor) -> torch.Tensor:
    leaf = leaf.float()
    return (leaf * leaf).sum()


def multi_tensor_l2norm(tree: Tree, per_tensor: bool = False
                        ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """``(global_norm, per_tensor_norms or None)`` over the leaves of a
    tree; the per-leaf norms are a 1-D fp32 tensor in flatten order."""
    leaves = tree_leaves(tree)
    if not leaves:
        zero = torch.zeros((), dtype=torch.float32)
        return zero, (torch.zeros((0,), dtype=torch.float32) if per_tensor
                      else None)
    sq = torch.stack([_sq_sum(leaf) for leaf in leaves])
    return torch.sqrt(sq.sum()), (torch.sqrt(sq) if per_tensor else None)


def l2norm(tree: Tree) -> torch.Tensor:
    """The global L2 norm of a tree."""
    return multi_tensor_l2norm(tree)[0]
