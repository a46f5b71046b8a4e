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

The pytree path (``packed=False``) is plain PyTorch per leaf, as the JAX
package's is plain XLA. ``packed=True`` keeps the state in flat buffers
(:class:`~apex_tpu_torch.optimizers._packed.PackedState`) and runs a step
as three kernel sweeps, the CUDA structure (``multi_tensor_l2norm`` ->
``lamb`` stage 1 -> stage 2): the gradient's global norm from its per-row
squared sums (``multi_tensor_l2norm_flat`` over ``packed_row_reduce``),
the moments with the unratioed update and its
per-row norm partials (``packed_lamb_stage1``), then the per-row
trust-ratio apply with the recast (``packed_scale_update``). The trust
ratios are per leaf: a segmented sum of the row partials over each
leaf's contiguous rows (``PackSpec.row_segments``, on the device), in a
fixed order, so a step gives the same bits every time. The moments and
masters are updated in place, so ``found_inf`` rides into the sweeps as
their noop flag, and no value of a step is read on the host.
"""
from __future__ import annotations

from typing import Any, NamedTuple, Optional, Tuple

import torch

from .._tree import tree_leaves, tree_map
from ..ops.multi_tensor import multi_tensor_l2norm
from ..ops.packed_optimizer import (
    multi_tensor_l2norm_flat,
    packed_lamb_stage1,
    packed_scale_update,
)
from ._common import (
    FusedOptimizer,
    lr_tensor,
    multi_tree_update,
    resolve_scale,
    skip_on_overflow,
    tree_f32,
    tree_zeros_like,
)
from ._packed import PackedState, as_flat_grads, packed_init, packed_src

Tree = Any


class FusedLAMBState(NamedTuple):
    step: torch.Tensor  # int32 device scalar
    exp_avg: Tree  # fp32
    exp_avg_sq: Tree  # fp32
    master_params: Optional[Tree]  # fp32 when master_weights else None


class FusedLAMB(FusedOptimizer):
    def __init__(self, lr: float = 1e-3, bias_correction: bool = True,
                 betas: Tuple[float, float] = (0.9, 0.999),
                 eps: float = 1e-6, weight_decay: float = 0.01,
                 amsgrad: bool = False, adam_w_mode: bool = True,
                 grad_averaging: bool = True, set_grad_none: bool = True,
                 max_grad_norm: float = 1.0, use_nvlamb: bool = False,
                 master_weights: bool = False, packed: bool = False,
                 packed_chunk_size: Optional[int] = None):
        if amsgrad:
            raise RuntimeError(
                "FusedLAMB does not support the AMSGrad variant.")
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
        self.packed = packed
        self.packed_chunk_size = packed_chunk_size

    def init(self, params: Tree):
        dev = tree_leaves(params)[0].device
        if self.packed:
            state = packed_init(params, chunk_size=self.packed_chunk_size,
                                master_weights=self.master_weights)
            state.spec.row_segments(dev)  # copied to the device once
            return state
        return FusedLAMBState(
            step=torch.zeros((), dtype=torch.int32, device=dev),
            exp_avg=tree_zeros_like(params, torch.float32),
            exp_avg_sq=tree_zeros_like(params, torch.float32),
            master_params=tree_f32(params) if self.master_weights else None)

    def _hyper(self, step: torch.Tensor):
        """``(new_step, beta3, bc1, bc2, one)`` of the step after
        ``step``, on its device."""
        beta1, beta2 = self.betas
        beta3 = 1.0 - beta1 if self.grad_averaging else 1.0
        new_step = step + 1
        t = new_step.to(torch.float32)
        one = torch.ones((), dtype=torch.float32, device=t.device)
        bc1 = 1.0 - torch.pow(beta1, t) if self.bias_correction else one
        bc2 = 1.0 - torch.pow(beta2, t) if self.bias_correction else one
        return new_step, beta3, bc1, bc2, one

    def _clip(self, global_norm, one):
        return (torch.clamp_min(global_norm / self.max_grad_norm, 1.0)
                if self.max_grad_norm > 0 else one)

    def _stepped(self, grads, state: FusedLAMBState, params, lr, inv_scale):
        beta1, beta2 = self.betas
        new_step, beta3, bc1, bc2, one = self._hyper(state.step)
        wd = self.weight_decay
        lr = lr_tensor(lr, one.device)

        grads32 = tree_map(lambda g: g.to(torch.float32) * inv_scale, grads)
        # phase 1: the global gradient norm
        global_norm, _ = multi_tensor_l2norm(grads32)
        clip = self._clip(global_norm, one)
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

    def _packed_stepped(self, grads, state: PackedState, params, lr,
                        inv_scale, found_inf):
        """Three sweeps over the flat buffers; ``found_inf`` is their
        noop flag (m, v and the masters are updated in place, so a
        select after the fact could not restore them) and holds the
        step count."""
        spec = state.spec
        beta1, beta2 = self.betas
        new_step, beta3, bc1, bc2, one = self._hyper(state.step)
        wd = self.weight_decay
        flat_g = as_flat_grads(grads, spec)
        # phase 1: the global gradient norm from per-row partials
        global_norm, _ = multi_tensor_l2norm_flat(flat_g, inv_scale=inv_scale)
        clip = self._clip(global_norm, one)
        src = packed_src(state, params, self.master_weights)
        update, _, _, row_u_sq, row_p_sq = packed_lamb_stage1(
            flat_g, state.exp_avg, state.exp_avg_sq, src, clip=clip,
            bc1=bc1, bc2=bc2, inv_scale=inv_scale, noop=found_inf,
            beta1=beta1, beta2=beta2, beta3=beta3, eps=self.eps, wd=wd,
            adam_w_mode=self.adam_w_mode)
        if wd != 0.0 or self.use_nvlamb:
            lengths, row_ids = spec.row_segments(flat_g.device)
            # per-leaf sums over contiguous rows: a fixed order, unlike
            # a scatter-add (the last segment is the padding rows)
            u_norm, w_norm = (torch.sqrt(torch.segment_reduce(
                rows, "sum", lengths=lengths, unsafe=True))
                for rows in (row_u_sq, row_p_sq))
            ratio = torch.where(
                (w_norm > 0) & (u_norm > 0),
                w_norm / torch.clamp_min(u_norm, 1e-38), 1.0)
            ratio[-1:].fill_(1.0)  # the padding segment
            row_coef = ratio.index_select(0, row_ids)
        else:
            row_coef = torch.ones(spec.n_rows, dtype=torch.float32,
                                  device=flat_g.device)
        p_out, _ = packed_scale_update(
            update, src, row_coef, param_dtype=spec.common_dtype(),
            lr=lr_tensor(lr, flat_g.device), noop=found_inf,
            write_master=self.master_weights)
        if found_inf is not None:
            new_step = torch.where(torch.as_tensor(found_inf).to(
                new_step.device, torch.bool), state.step, new_step)
        return spec.unpack(p_out), PackedState(
            step=new_step, exp_avg=state.exp_avg,
            exp_avg_sq=state.exp_avg_sq,
            master_params=state.master_params if self.master_weights
            else None,
            spec=spec)

    def step(self, grads: Tree, state, params: Tree, lr=None,
             found_inf: Optional[torch.Tensor] = None, grad_scale=None):
        lr = self.lr if lr is None else lr
        inv_scale = resolve_scale(grad_scale, state.step.device)
        if self.packed:
            return self._packed_stepped(grads, state, params, lr, inv_scale,
                                        found_inf)
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
