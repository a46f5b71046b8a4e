"""Multi-tensor utility ops over trees of tensors (counterpart of
``apex_tpu/ops/multi_tensor.py``, the reference's ``amp_C``).

The JAX package computes them as elementwise passes and tree reduces
that XLA fuses on its own (no Pallas kernel); here each is plain PyTorch
per leaf, in fp32:

- :func:`has_inf_or_nan` — any non-finite value in any leaf;
- :func:`multi_tensor_scale` — ``out = x * scale``, flagging non-finite
  results (per leaf with ``per_tensor``);
- :func:`multi_tensor_axpby` — ``out = a * x + b * y``, flagged;
- :func:`multi_tensor_l2norm` / :func:`l2norm` — global and per-leaf L2
  norms;
- :func:`multi_tensor_unscale_l2norm` — unscale, then the norms, flagged;
- :func:`update_scale_hysteresis` — the dynamic loss-scale update with
  hysteresis (``csrc/update_scale_hysteresis.cu``).

Every flag is a 0-dim bool tensor on the leaves' device, never read on
the host: a caller skips a step with it on the device. The flat-buffer
forms with kernels are ``ops.packed_optimizer.multi_tensor_*_flat``.
"""
from __future__ import annotations

from typing import Any, Optional, Tuple

import torch

from .._tree import tree_flatten, tree_leaves, tree_unflatten

Tree = Any


def _false(device=None) -> torch.Tensor:
    return torch.zeros((), dtype=torch.bool, device=device)


def _bad(x: torch.Tensor) -> torch.Tensor:
    return ~torch.isfinite(x).all()


def has_inf_or_nan(tree: Tree) -> torch.Tensor:
    """True where any leaf of ``tree`` holds a non-finite value."""
    leaves = tree_leaves(tree)
    if not leaves:
        return _false()
    return torch.stack([_bad(leaf.float()) for leaf in leaves]).any()


def multi_tensor_scale(tree: Tree, scale, out_dtype=None,
                       per_tensor: bool = False):
    """Scale every leaf by ``scale`` in fp32, flagging non-finite results.

    Returns ``(scaled_tree, found_inf)``; each output leaf in
    ``out_dtype`` or its own dtype. ``per_tensor=True`` also returns the
    per-leaf flags (bool ``(n_leaves,)`` in flatten order)."""
    leaves, treedef = tree_flatten(tree)
    dev = leaves[0].device if leaves else None
    scale = torch.as_tensor(scale, dtype=torch.float32, device=dev)
    outs, bads = [], []
    for leaf in leaves:
        out = leaf.float() * scale
        bads.append(_bad(out))
        outs.append(out.to(out_dtype or leaf.dtype))
    flags = (torch.stack(bads) if bads
             else torch.zeros((0,), dtype=torch.bool))
    found = flags.any() if bads else _false()
    out_tree = tree_unflatten(treedef, outs)
    if per_tensor:
        return out_tree, found, flags
    return out_tree, found


def multi_tensor_axpby(a, b, xs: Tree, ys: Tree, out_dtype=None
                       ) -> Tuple[Tree, torch.Tensor]:
    """``out = a * x + b * y`` per leaf in fp32, flagging non-finite
    results. Returns ``(out_tree, found_inf)``."""
    xl, treedef = tree_flatten(xs)
    yl = tree_leaves(ys)
    if len(xl) != len(yl):
        raise ValueError("axpby requires matching trees")
    dev = xl[0].device if xl else None
    a = torch.as_tensor(a, dtype=torch.float32, device=dev)
    b = torch.as_tensor(b, dtype=torch.float32, device=dev)
    outs, bads = [], []
    for x, y in zip(xl, yl):
        out = a * x.float() + b * y.float()
        bads.append(_bad(out))
        outs.append(out.to(out_dtype or x.dtype))
    found = torch.stack(bads).any() if bads else _false()
    return tree_unflatten(treedef, outs), found


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


def multi_tensor_unscale_l2norm(tree: Tree, inv_scale,
                                per_tensor: bool = False):
    """Unscale by ``inv_scale``, then the L2 norms, flagging non-finite
    input. Returns ``(global_norm, per_tensor_norms or None,
    found_inf)``."""
    leaves = tree_leaves(tree)
    if not leaves:
        zero = torch.zeros((), dtype=torch.float32)
        return zero, (torch.zeros((0,), dtype=torch.float32) if per_tensor
                      else None), _false()
    inv_scale = torch.as_tensor(inv_scale, dtype=torch.float32,
                                device=leaves[0].device)
    unscaled = [leaf.float() * inv_scale for leaf in leaves]
    found = torch.stack([_bad(u) for u in unscaled]).any()
    sq = torch.stack([(u * u).sum() for u in unscaled])
    return torch.sqrt(sq.sum()), (torch.sqrt(sq) if per_tensor
                                  else None), found


def update_scale_hysteresis(scale, growth_tracker, hysteresis_tracker,
                            found_inf, growth_factor: float = 2.0,
                            backoff_factor: float = 0.5,
                            growth_interval: int = 2000,
                            hysteresis: int = 1):
    """The dynamic loss-scale update with hysteresis, as a function of
    device scalars (``csrc/update_scale_hysteresis.cu``):

    - overflow: the hysteresis tracker counts down, the scale backs off
      by ``backoff_factor`` once it is spent, the growth tracker resets;
    - clean step: the growth tracker counts up and at ``growth_interval``
      the scale grows by ``growth_factor`` (kept where that would not be
      finite) and the tracker resets; the hysteresis tracker refills.

    Returns ``(scale, growth_tracker, hysteresis_tracker)``: fp32, int32,
    int32 0-dim tensors."""
    scale = torch.as_tensor(scale, dtype=torch.float32)
    dev = scale.device
    growth = torch.as_tensor(growth_tracker, dtype=torch.int32, device=dev)
    hyst = torch.as_tensor(hysteresis_tracker, dtype=torch.int32,
                           device=dev)
    found = torch.as_tensor(found_inf, dtype=torch.bool, device=dev)
    hyst_after = torch.clamp_min(hyst - 1, 0)
    backoff = found & (hyst_after <= 0)
    grown = ~found & (growth + 1 >= growth_interval)
    grown_scale = scale * growth_factor
    grown_scale = torch.where(torch.isfinite(grown_scale), grown_scale,
                              scale)
    new_scale = torch.where(backoff, scale * backoff_factor,
                            torch.where(grown, grown_scale, scale))
    new_growth = torch.where(found | grown, torch.zeros_like(growth),
                             growth + 1)
    new_hyst = torch.where(found, hyst_after,
                           torch.full_like(hyst, hysteresis))
    return new_scale, new_growth, new_hyst
