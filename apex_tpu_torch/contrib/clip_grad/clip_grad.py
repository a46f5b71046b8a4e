"""Global gradient-norm clipping (counterpart of
``apex_tpu/contrib/clip_grad/clip_grad.py``).

The reference (``apex/contrib/clip_grad/clip_grad.py:16-100``) is a
drop-in ``torch.nn.utils.clip_grad_norm_`` over the fused
``multi_tensor_l2norm`` and ``multi_tensor_scale``. As in the JAX
package, gradients are values: each function returns ``(clipped,
total_norm)``, the pre-clip norm, and the clip coefficient
``min(max_norm / (norm + 1e-6), 1)`` stays a device scalar (no host
read). :func:`clip_grad_norm_` walks a tree in plain PyTorch;
:func:`clip_grad_norm_flat` is two kernel sweeps over a packed flat
buffer: the norm's row partials (``multi_tensor_l2norm_flat``), then the
scale (``multi_tensor_scale_flat``).
"""
from __future__ import annotations

import math
from typing import Any, Tuple

import torch

from ..._tree import tree_leaves, tree_map
from ...multi_tensor_apply.packing import DEFAULT_CHUNK
from ...ops.multi_tensor import multi_tensor_l2norm
from ...ops.packed_optimizer import (
    multi_tensor_l2norm_flat,
    multi_tensor_scale_flat,
)

Tree = Any


def _clip_coef(max_norm: float, total_norm: torch.Tensor) -> torch.Tensor:
    # torch's rule: max_norm / (norm + 1e-6), applied only below 1
    return torch.clamp_max(float(max_norm) / (total_norm + 1e-6), 1.0)


def clip_grad_norm_(grads: Tree, max_norm: float, norm_type: float = 2.0,
                    error_if_nonfinite: bool = False
                    ) -> Tuple[Tree, torch.Tensor]:
    """Clip the global ``norm_type``-norm of ``grads`` (``inf`` allowed)
    to ``max_norm``. A non-finite norm propagates into the gradients, as
    ``torch.nn.utils.clip_grad_norm_(error_if_nonfinite=False)`` does;
    ``error_if_nonfinite=True`` would read the norm on the host and, as
    in the JAX package, is refused: check the returned norm instead."""
    if error_if_nonfinite:
        raise NotImplementedError(
            "error_if_nonfinite=True needs the norm on the host; check the "
            "returned total_norm instead")
    leaves = tree_leaves(grads)
    if not leaves:
        return grads, torch.zeros((), dtype=torch.float32)
    norm_type = float(norm_type)
    if norm_type == 2.0:
        total_norm, _ = multi_tensor_l2norm(grads)
    elif math.isinf(norm_type):
        total_norm = torch.stack([g.float().abs().amax()
                                  for g in leaves]).amax()
    else:
        total_norm = sum(g.float().abs().pow(norm_type).sum()
                         for g in leaves) ** (1.0 / norm_type)
    coef = _clip_coef(max_norm, total_norm)
    return tree_map(lambda g: (g.float() * coef).to(g.dtype),
                    grads), total_norm


def clip_grad_norm_flat(flat_grads: torch.Tensor, max_norm: float, *,
                        chunk_size: int = DEFAULT_CHUNK
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """2-norm clipping over a packed flat gradient buffer in two sweeps
    (the norm's row partials, then the scale by the coefficient, read on
    the device). Returns ``(clipped_flat, total_norm)``; the buffer's
    padding must be zero, as ``PackSpec.pack`` leaves it. ``chunk_size``
    goes to both sweeps, which validate it; the result does not depend
    on it."""
    total_norm, _ = multi_tensor_l2norm_flat(flat_grads,
                                             chunk_size=chunk_size)
    clipped, _ = multi_tensor_scale_flat(
        flat_grads, _clip_coef(max_norm, total_norm), chunk_size=chunk_size)
    return clipped, total_norm


clip_grad_norm_flat.accepts_chunk_size = True
