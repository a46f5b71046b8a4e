"""FusedSGD: momentum SGD as one fused update (counterpart of
``apex_tpu/optimizers/fused_sgd.py``).

Momentum, dampening, nesterov, weight decay before or after the momentum
(``wd_after_momentum``), the first-run materialisation of the momentum
buffer (the buffer is the gradient on the first step, as the reference
allocates it lazily there), ``master_weights`` (fp32 masters, the
kernel's 4-list variant) and ``grad_scale`` / ``found_inf`` (the
kernel's scale and noop flag).

The pytree path (``packed=False``) is plain PyTorch per leaf, as the JAX
package's is plain XLA. ``packed=True`` keeps the momentum buffer (the
state's ``exp_avg``; no second moment) and the masters in flat buffers
and runs the whole step as ONE launch of the packed SGD kernel
(``ops.packed_optimizer.packed_sgd_apply``), which updates them in place;
``found_inf`` is its noop flag, and the first-run flag (the step count is
0) is read on the device. ``packed_spec`` adopts a layout built elsewhere
(``parallel.GradBuckets(params).spec``): ``step`` then takes the reduced
flat buffer of the bucketed all-reduce, or its ``BucketBuffers``.
"""
from __future__ import annotations

from typing import Any, NamedTuple, Optional

import torch

from .._tree import tree_leaves, tree_map
from ..ops.packed_optimizer import packed_sgd_apply
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


class FusedSGDState(NamedTuple):
    step: torch.Tensor  # int32 device scalar; 0: buffers not materialised
    momentum_buffer: Tree  # fp32
    master_params: Optional[Tree]  # fp32 when master_weights else None


class FusedSGD(FusedOptimizer):
    def __init__(self, lr: float, momentum: float = 0.0,
                 dampening: float = 0.0, weight_decay: float = 0.0,
                 nesterov: bool = False, wd_after_momentum: bool = False,
                 materialize_master_grads: bool = True,
                 set_grad_none: bool = False, master_weights: bool = False,
                 packed: bool = False,
                 packed_chunk_size: Optional[int] = None,
                 packed_spec=None):
        if nesterov and (momentum <= 0 or dampening != 0):
            raise ValueError(
                "Nesterov momentum requires a momentum and zero dampening")
        if packed_spec is not None and not packed:
            raise ValueError("packed_spec requires packed=True")
        # parity: the functional step keeps no .grad
        del materialize_master_grads, set_grad_none
        self.lr = lr
        self.momentum = momentum
        self.dampening = dampening
        self.weight_decay = weight_decay
        self.nesterov = nesterov
        self.wd_after_momentum = wd_after_momentum
        self.master_weights = master_weights
        self.packed = packed
        self.packed_chunk_size = packed_chunk_size
        # an adopted layout (GradBuckets.spec): step then takes the
        # reduced flat buffer or the BucketBuffers as they come
        self.packed_spec = packed_spec

    def init(self, params: Tree):
        if self.packed:
            return packed_init(params, chunk_size=self.packed_chunk_size,
                               with_exp_avg_sq=False,
                               master_weights=self.master_weights,
                               spec=self.packed_spec)
        dev = tree_leaves(params)[0].device
        return FusedSGDState(
            step=torch.zeros((), dtype=torch.int32, device=dev),
            momentum_buffer=tree_zeros_like(params, torch.float32),
            master_params=tree_f32(params) if self.master_weights else None)

    def _stepped(self, grads, state: FusedSGDState, params, lr, inv_scale):
        lr = lr_tensor(lr, state.step.device)
        first_run = state.step == 0
        src = state.master_params if self.master_weights else params
        wd = self.weight_decay

        def leaf(g, p, buf):
            g = g.to(torch.float32) * inv_scale
            p32 = p.to(torch.float32)
            d_p = g
            if wd != 0.0 and not self.wd_after_momentum:
                d_p = d_p + wd * p32
            if self.momentum != 0.0:
                new_buf = torch.where(
                    first_run, d_p,
                    self.momentum * buf + (1.0 - self.dampening) * d_p)
                d_p = (d_p + self.momentum * new_buf if self.nesterov
                       else new_buf)
            else:
                new_buf = buf
            if wd != 0.0 and self.wd_after_momentum:
                d_p = d_p + wd * p32
            return p32 - lr * d_p, new_buf

        p32s, bufs = multi_tree_update(leaf, 2, grads, src,
                                       state.momentum_buffer)
        new_params = tree_map(lambda p32, p: p32.to(p.dtype), p32s, params)
        return new_params, FusedSGDState(
            step=state.step + 1, momentum_buffer=bufs,
            master_params=p32s if self.master_weights else None)

    def _packed_stepped(self, grads, state: PackedState, params, lr,
                        inv_scale, found_inf):
        """One fused sweep; ``found_inf`` is its noop flag (the buffer
        and the masters are updated in place) and holds the count."""
        spec = state.spec
        flat_g = as_flat_grads(grads, spec)
        p_out, _, _ = packed_sgd_apply(
            flat_g, state.exp_avg,
            packed_src(state, params, self.master_weights),
            param_dtype=spec.common_dtype(),
            lr=lr_tensor(lr, flat_g.device), first_run=state.step == 0,
            inv_scale=inv_scale, noop=found_inf, momentum=self.momentum,
            dampening=self.dampening, nesterov=self.nesterov,
            wd=self.weight_decay, wd_after_momentum=self.wd_after_momentum,
            write_master=self.master_weights)
        new_step = state.step + 1
        if found_inf is not None:
            new_step = torch.where(torch.as_tensor(found_inf).to(
                new_step.device, torch.bool), state.step, new_step)
        return spec.unpack(p_out), PackedState(
            step=new_step, exp_avg=state.exp_avg, exp_avg_sq=None,
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
