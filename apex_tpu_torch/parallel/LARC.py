"""LARC: layer-wise adaptive rate clipping and scaling (counterpart of
``apex_tpu/parallel/LARC.py``).

The reference (``apex/parallel/LARC.py:5-100``) wraps an optimizer and,
for each parameter tensor, computes

    adaptive_lr = trust_coefficient * ||p|| / (||g|| + weight_decay * ||p|| + eps)

then clips the effective learning rate (``clip=True``: the gradient
scaled by ``min(adaptive_lr / lr, 1)``) or replaces it (``clip=False``:
scaled by ``adaptive_lr``), with the weight decay folded into the
gradient first, so that the wrapped optimizer runs at weight decay 0.
As in the JAX package, it is a transform of the gradient tree ahead of
any optimizer of ``apex_tpu_torch.optimizers`` (:func:`larc_adjust_
gradients`, one pass over the tree, the trust ratios a vector on the
device) and a wrapper (:class:`LARC`). The JAX package's optax form,
:func:`larc_transform`, has no PyTorch counterpart and raises.
"""
from __future__ import annotations

from typing import Any

import torch

from .._tree import tree_flatten, tree_leaves, tree_unflatten

Tree = Any


def larc_adjust_gradients(grads: Tree, params: Tree, lr: float, *,
                          trust_coefficient: float = 0.02,
                          clip: bool = True, eps: float = 1e-8,
                          weight_decay: float = 0.0) -> Tree:
    """The LARC adjustment of ``grads`` (reference ``LARC.py:71-100``),
    each leaf in its own dtype; a leaf whose parameter or gradient norm
    is zero is left as it is (no weight decay folded in either). One pass
    over the tree: every leaf's two norms from one ``_foreach_norm``
    each, the trust ratios as one vector on the device, then a scale and
    a select a leaf."""
    gl, treedef = tree_flatten(grads)
    pl = tree_leaves(params)
    if len(pl) != len(gl):
        raise ValueError(f"tree mismatch: {len(gl)} gradient leaves, "
                         f"{len(pl)} parameter leaves")
    if not gl:
        return grads
    g32 = [g.to(torch.float32) for g in gl]
    p32 = [p.to(torch.float32) for p in pl]
    p_norm = torch.stack(torch._foreach_norm(p32))
    g_norm = torch.stack(torch._foreach_norm(g32))
    adaptive = (trust_coefficient * p_norm
                / (g_norm + p_norm * weight_decay + eps))
    scale = torch.clamp_max(adaptive / lr, 1.0) if clip else adaptive
    keep = (p_norm > 0) & (g_norm > 0)
    folded = (torch._foreach_add(g32, p32, alpha=weight_decay)
              if weight_decay else g32)
    out = [torch.where(k, f * s, g).to(orig.dtype) for k, f, s, g, orig in
           zip(keep.unbind(), folded, scale.unbind(), g32, gl)]
    return tree_unflatten(treedef, out)


class LARC:
    """A wrapper over an ``apex_tpu_torch.optimizers`` optimizer, used as
    the optimizer it wraps::

        opt = LARC(FusedSGD(lr=0.1, momentum=0.9), trust_coefficient=1e-3)
        state = opt.init(params)
        params, state = opt.step(grads, state, params)

    ``step`` adjusts the gradients with the wrapped optimizer's ``lr``
    and ``weight_decay``, runs its step at weight decay 0 and restores
    the decay afterwards."""

    def __init__(self, optimizer, trust_coefficient: float = 0.02,
                 clip: bool = True, eps: float = 1e-8):
        self.optim = optimizer
        self.trust_coefficient = trust_coefficient
        self.clip = clip
        self.eps = eps

    def __getattr__(self, name):
        if name == "optim":  # not set yet: no recursion through it
            raise AttributeError(name)
        return getattr(self.optim, name)

    def init(self, params: Tree):
        return self.optim.init(params)

    def step(self, grads: Tree, state, params: Tree, **kwargs):
        lr = getattr(self.optim, "lr", None)
        wd = getattr(self.optim, "weight_decay", 0.0) or 0.0
        grads = larc_adjust_gradients(
            grads, params, lr, trust_coefficient=self.trust_coefficient,
            clip=self.clip, eps=self.eps, weight_decay=wd)
        saved_wd = getattr(self.optim, "weight_decay", None)
        if saved_wd is not None:
            self.optim.weight_decay = 0.0
        try:
            return self.optim.step(grads, state, params, **kwargs)
        finally:
            if saved_wd is not None:
                self.optim.weight_decay = saved_wd


def larc_transform(lr: float, trust_coefficient: float = 0.02,
                   clip: bool = True, eps: float = 1e-8,
                   weight_decay: float = 0.0):
    """The JAX package's optax ``GradientTransformation`` form of LARC:
    optax has no PyTorch counterpart, so the port refuses. Use
    :func:`larc_adjust_gradients` or :class:`LARC`."""
    raise NotImplementedError(
        "larc_transform builds an optax GradientTransformation; optax has "
        "no PyTorch counterpart: apply larc_adjust_gradients(grads, "
        "params, lr, ...) or wrap the optimizer in LARC")
