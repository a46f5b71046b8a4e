"""FusedAdagrad: Adagrad over a tree of parameters (counterpart of
``apex_tpu/optimizers/fused_adagrad.py``).

Per leaf, in fp32: ``h += g * g`` and ``p -= lr * g / (sqrt(h) + eps)``,
with weight decay folded into the gradient (L2, the kernel's MODE_0) or,
under ``adagrad_w_mode``, added to the update (decoupled, MODE_1).
``grad_scale`` / ``found_inf`` are the kernel's scale and noop flag. The
JAX package has no kernel for it (plain XLA), so this is plain PyTorch.
"""
from __future__ import annotations

from typing import Any, NamedTuple, Optional

import torch

from .._tree import tree_leaves, tree_map
from ._common import (
    FusedOptimizer,
    lr_tensor,
    multi_tree_update,
    resolve_scale,
    skip_on_overflow,
    tree_zeros_like,
)

Tree = Any


class FusedAdagradState(NamedTuple):
    step: torch.Tensor  # int32 device scalar
    sum: Tree  # fp32 accumulated squared gradients


class FusedAdagrad(FusedOptimizer):
    def __init__(self, lr: float = 1e-2, eps: float = 1e-10,
                 weight_decay: float = 0.0, set_grad_none: bool = True,
                 adagrad_w_mode: bool = False):
        del set_grad_none  # parity: the functional step keeps no .grad
        self.lr = lr
        self.eps = eps
        self.weight_decay = weight_decay
        self.adagrad_w_mode = adagrad_w_mode

    def init(self, params: Tree) -> FusedAdagradState:
        dev = tree_leaves(params)[0].device
        return FusedAdagradState(
            step=torch.zeros((), dtype=torch.int32, device=dev),
            sum=tree_zeros_like(params, torch.float32))

    def _stepped(self, grads, state: FusedAdagradState, params, lr,
                 inv_scale):
        lr = lr_tensor(lr, state.step.device)
        wd = self.weight_decay

        def leaf(g, p, h):
            g = g.to(torch.float32) * inv_scale
            p32 = p.to(torch.float32)
            if wd != 0.0 and not self.adagrad_w_mode:
                g = g + wd * p32
            new_h = h + g * g
            update = g / (torch.sqrt(new_h) + self.eps)
            if wd != 0.0 and self.adagrad_w_mode:
                update = update + wd * p32
            return p32 - lr * update, new_h

        p32s, hs = multi_tree_update(leaf, 2, grads, params, state.sum)
        new_params = tree_map(lambda p32, p: p32.to(p.dtype), p32s, params)
        return new_params, FusedAdagradState(step=state.step + 1, sum=hs)

    def step(self, grads: Tree, state: FusedAdagradState, params: Tree,
             lr=None, found_inf: Optional[torch.Tensor] = None,
             grad_scale=None):
        lr = self.lr if lr is None else lr
        inv_scale = resolve_scale(grad_scale, state.step.device)
        return skip_on_overflow(
            found_inf,
            lambda: self._stepped(grads, state, params, lr, inv_scale),
            (params, state))
