"""FusedLAMB: LAMB with global gradient clipping and per-tensor trust
ratios (counterpart of ``apex_tpu/optimizers/fused_lamb.py``).

Phase 1: the global L2 norm of the unscaled gradients
(``ops.multi_tensor.multi_tensor_l2norm``) gives ``clip = max(1,
norm / max_grad_norm)``. Phase 2, per leaf: Adam moments of ``g / clip``
(``grad_averaging`` makes beta3 = 1 - beta1), the update
``m_hat / (sqrt(v_hat) + eps)`` plus ``wd * p`` (decoupled under
``adam_w_mode``, else folded into the gradient), rescaled by the trust
ratio ``||p|| / ||update||`` for tensors with weight decay, or for every
tensor under ``use_nvlamb``. ``master_weights`` keeps fp32 masters and
re-casts the params from them; ``grad_scale`` / ``found_inf`` are the
mixed-precision kernel's ``inv_scale`` / ``noop``.

This is the pytree path (``packed=False``), plain PyTorch per leaf as
the JAX package's is plain XLA; it reaches no TPU kernel. ``packed=True``
runs the packed LAMB kernels (TPU kernels #19, #20 and #22), which are
not ported yet and raise.
"""
from __future__ import annotations

from typing import Any, NamedTuple, Optional, Tuple

import torch

from .._tree import tree_leaves, tree_map
from ..ops.multi_tensor import multi_tensor_l2norm
from ._common import (
    lr_tensor,
    multi_tree_update,
    resolve_scale,
    skip_on_overflow,
    tree_f32,
    tree_zeros_like,
)

Tree = Any


class FusedLAMBState(NamedTuple):
    step: torch.Tensor  # int32 device scalar
    exp_avg: Tree  # fp32
    exp_avg_sq: Tree  # fp32
    master_params: Optional[Tree]  # fp32 when master_weights else None


class FusedLAMB:
    def __init__(self, lr: float = 1e-3, bias_correction: bool = True,
                 betas: Tuple[float, float] = (0.9, 0.999),
                 eps: float = 1e-6, weight_decay: float = 0.01,
                 amsgrad: bool = False, adam_w_mode: bool = True,
                 grad_averaging: bool = True, set_grad_none: bool = True,
                 max_grad_norm: float = 1.0, use_nvlamb: bool = False,
                 master_weights: bool = False, packed: bool = False):
        if amsgrad:
            raise RuntimeError(
                "FusedLAMB does not support the AMSGrad variant.")
        if packed:
            raise NotImplementedError(
                "FusedLAMB(packed=True) runs the packed LAMB kernels (TPU "
                "kernels #19 packed_lamb_stage1, #20 packed_scale_update "
                "and #22 packed_row_reduce), which are not ported yet "
                "(ROADMAP.md, queue B)")
        del set_grad_none  # parity: the functional step keeps no .grad
        self.lr = lr
        self.bias_correction = bias_correction
        self.betas = betas
        self.eps = eps
        self.weight_decay = weight_decay
        self.adam_w_mode = adam_w_mode
        self.grad_averaging = grad_averaging
        self.max_grad_norm = max_grad_norm
        self.use_nvlamb = use_nvlamb
        self.master_weights = master_weights

    def init(self, params: Tree) -> FusedLAMBState:
        dev = tree_leaves(params)[0].device
        return FusedLAMBState(
            step=torch.zeros((), dtype=torch.int32, device=dev),
            exp_avg=tree_zeros_like(params, torch.float32),
            exp_avg_sq=tree_zeros_like(params, torch.float32),
            master_params=tree_f32(params) if self.master_weights else None)

    def _stepped(self, grads, state: FusedLAMBState, params, lr, inv_scale):
        beta1, beta2 = self.betas
        beta3 = 1.0 - beta1 if self.grad_averaging else 1.0
        new_step = state.step + 1
        t = new_step.to(torch.float32)
        one = torch.ones((), dtype=torch.float32, device=t.device)
        bc1 = 1.0 - torch.pow(beta1, t) if self.bias_correction else one
        bc2 = 1.0 - torch.pow(beta2, t) if self.bias_correction else one
        wd = self.weight_decay
        lr = lr_tensor(lr, t.device)

        grads32 = tree_map(lambda g: g.to(torch.float32) * inv_scale, grads)
        # phase 1: the global gradient norm
        global_norm, _ = multi_tensor_l2norm(grads32)
        clip = (torch.clamp_min(global_norm / self.max_grad_norm, 1.0)
                if self.max_grad_norm > 0 else one)
        src = state.master_params if self.master_weights else params

        def leaf(g, p, m, v):
            g = g / clip
            p32 = p.to(torch.float32)
            if not self.adam_w_mode and wd != 0.0:
                g = g + wd * p32
            new_m = beta1 * m + beta3 * g
            new_v = beta2 * v + (1.0 - beta2) * g * g
            update = (new_m / bc1) / (torch.sqrt(new_v / bc2) + self.eps)
            if self.adam_w_mode and wd != 0.0:
                update = update + wd * p32
            if wd != 0.0 or self.use_nvlamb:
                w_norm = torch.sqrt((p32 * p32).sum())
                u_norm = torch.sqrt((update * update).sum())
                ratio = torch.where((w_norm > 0) & (u_norm > 0),
                                    w_norm / u_norm, 1.0)
            else:
                ratio = 1.0
            return p32 - lr * ratio * update, new_m, new_v

        p32s, ms, vs = multi_tree_update(leaf, 3, grads32, src,
                                         state.exp_avg, state.exp_avg_sq)
        new_params = tree_map(lambda p32, p: p32.to(p.dtype), p32s, params)
        return new_params, FusedLAMBState(
            step=new_step, exp_avg=ms, exp_avg_sq=vs,
            master_params=p32s if self.master_weights else None)

    def step(self, grads: Tree, state: FusedLAMBState, params: Tree,
             lr=None, found_inf: Optional[torch.Tensor] = None,
             grad_scale=None) -> Tuple[Tree, FusedLAMBState]:
        lr = self.lr if lr is None else lr
        inv_scale = resolve_scale(grad_scale, state.step.device)
        return skip_on_overflow(
            found_inf,
            lambda: self._stepped(grads, state, params, lr, inv_scale),
            (params, state))


class FusedMixedPrecisionLamb(FusedLAMB):
    """Grad-scaler-aware LAMB (the reference's
    ``fused_mixed_precision_lamb.py``): the base class with
    ``master_weights`` on by default; ``found_inf`` and ``grad_scale``
    are the mixed-precision kernel's ``noop`` and ``inv_scale``."""

    def __init__(self, *args, **kwargs):
        kwargs.setdefault("master_weights", True)
        super().__init__(*args, **kwargs)
