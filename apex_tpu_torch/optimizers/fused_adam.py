"""FusedAdam / AdamW with overflow noop (counterpart of
``apex_tpu/optimizers/fused_adam.py``).

- ``adam_w_mode`` (decoupled weight decay) or classic Adam L2 (decay
  folded into the gradient);
- ``bias_correction`` on or off; the step count and both bias
  corrections stay device scalars (no host read per step);
- ``master_weights``: fp32 master params in the state, the returned
  params re-cast from them (O2);
- the fork's ``no_update_mv_step``: m, v and the step count feed this
  step's update and are not kept;
- ``grad_scale`` / ``found_inf``, the capturable kernel's ``inv_scale``
  and ``noop_flag``;
- ``packed=True``: the state is flat fp32 buffers
  (:class:`~apex_tpu_torch.optimizers._packed.PackedState`) and the
  whole step — unscale + Adam + master -> param recast — is ONE launch
  of the packed kernel (``ops.packed_optimizer.packed_adam_apply``),
  which updates m, v and the masters in place. The returned params are
  views into that launch's parameter buffer (``PackSpec.unpack``), so
  unpacking them copies nothing; each step writes a fresh buffer, so the
  views of an earlier step stay as they were.

The pytree path (``packed=False``) is plain PyTorch per leaf, as the JAX
package's is plain XLA.
"""
from __future__ import annotations

from typing import Any, NamedTuple, Optional, Tuple

import torch

from .._tree import tree_leaves, tree_map
from ..ops.packed_optimizer import packed_adam_apply
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
from ..telemetry.numerics import tap_flat

Tree = Any


class FusedAdamState(NamedTuple):
    step: torch.Tensor  # int32 device scalar shared by every leaf
    exp_avg: Tree  # fp32
    exp_avg_sq: Tree  # fp32
    master_params: Optional[Tree]  # fp32 when master_weights else None


class FusedAdam(FusedOptimizer):
    def __init__(self, lr: float = 1e-3, bias_correction: bool = True,
                 betas: Tuple[float, float] = (0.9, 0.999),
                 eps: float = 1e-8, adam_w_mode: bool = True,
                 weight_decay: float = 0.0, amsgrad: bool = False,
                 master_weights: bool = False, packed: bool = False):
        if amsgrad:
            raise RuntimeError(
                "FusedAdam does not support the AMSGrad variant.")
        self.lr = lr
        self.bias_correction = bias_correction
        self.betas = betas
        self.eps = eps
        self.adam_w_mode = adam_w_mode
        self.weight_decay = weight_decay
        self.master_weights = master_weights
        self.packed = packed

    def init(self, params: Tree):
        if self.packed:
            return packed_init(params, master_weights=self.master_weights)
        dev = tree_leaves(params)[0].device
        return FusedAdamState(
            step=torch.zeros((), dtype=torch.int32, device=dev),
            exp_avg=tree_zeros_like(params, torch.float32),
            exp_avg_sq=tree_zeros_like(params, torch.float32),
            master_params=tree_f32(params) if self.master_weights else None)

    def _bias_corrections(self, step: torch.Tensor):
        beta1, beta2 = self.betas
        if not self.bias_correction:
            one = torch.ones((), dtype=torch.float32, device=step.device)
            return one, one
        t = step.to(torch.float32)
        return 1.0 - torch.pow(beta1, t), 1.0 - torch.pow(beta2, t)

    # -- pytree path (plain PyTorch per leaf) --------------------------
    def _update_leaf(self, g, p, m, v, bc1, bc2, lr, wd):
        beta1, beta2 = self.betas
        g = g.to(torch.float32)
        p32 = p.to(torch.float32)
        if not self.adam_w_mode and wd != 0.0:
            g = g + wd * p32  # ADAM_MODE_0: L2 into the gradient
        new_m = beta1 * m + (1.0 - beta1) * g
        new_v = beta2 * v + ((1.0 - beta2) * g) * g
        update = (new_m / bc1) / (torch.sqrt(new_v / bc2) + self.eps)
        if self.adam_w_mode and wd != 0.0:
            update = update + wd * p32  # ADAM_MODE_1: decoupled decay
        return p32 - lr * update, new_m, new_v

    def _stepped(self, grads, state: FusedAdamState, params, lr, wd,
                 inv_scale):
        new_step = state.step + 1
        bc1, bc2 = self._bias_corrections(new_step)
        lr = lr_tensor(lr, new_step.device)
        src = state.master_params if self.master_weights else params

        def leaf(g, p, m, v):
            return self._update_leaf(g.to(torch.float32) * inv_scale, p, m,
                                     v, bc1, bc2, lr, wd)

        p32s, ms, vs = multi_tree_update(leaf, 3, grads, src, state.exp_avg,
                                         state.exp_avg_sq)
        new_params = tree_map(lambda p32, p: p32.to(p.dtype), p32s, params)
        return new_params, FusedAdamState(
            step=new_step, exp_avg=ms, exp_avg_sq=vs,
            master_params=p32s if self.master_weights else None)

    # -- packed path (one kernel launch) --------------------------------
    def _packed_stepped(self, grads, state: PackedState, params, lr, wd,
                        inv_scale, found_inf=None, write_mv=True):
        """One fused sweep over the flat buffers. ``found_inf`` rides
        into the sweep as its noop flag (m, v and the masters are
        updated in place, so a select after the fact could not restore
        them). ``write_mv=False`` writes only the params."""
        spec = state.spec
        beta1, beta2 = self.betas
        new_step = state.step + 1
        bc1, bc2 = self._bias_corrections(new_step)
        flat_g = as_flat_grads(grads, spec)
        # the activation-watch tap on the flat gradients: identity unless
        # a numerics.activation_watch is active, then one row-stats sweep
        # names non-finite leaves through the spec's row-aligned offsets
        flat_g = tap_flat("apex_tpu.packed_adam/grads", flat_g, spec=spec,
                          inv_scale=inv_scale)
        p_out, _, _, _ = packed_adam_apply(
            flat_g, state.exp_avg, state.exp_avg_sq,
            packed_src(state, params, self.master_weights),
            param_dtype=spec.common_dtype(),
            lr=lr_tensor(lr, flat_g.device), bc1=bc1, bc2=bc2,
            inv_scale=inv_scale, noop=found_inf, beta1=beta1, beta2=beta2,
            eps=self.eps, wd=wd, adam_w_mode=self.adam_w_mode,
            write_mv=write_mv,
            # no_update_mv must not advance the masters either
            write_master=write_mv and self.master_weights)
        new_params = spec.unpack(p_out)
        if not write_mv:
            return new_params, state
        if found_inf is not None:
            # the noop contract covers the step counter too
            new_step = torch.where(torch.as_tensor(found_inf).to(
                new_step.device, torch.bool), state.step, new_step)
        return new_params, PackedState(
            step=new_step, exp_avg=state.exp_avg,
            exp_avg_sq=state.exp_avg_sq,
            master_params=state.master_params if self.master_weights
            else None,
            spec=spec)

    # -- public API -----------------------------------------------------
    def step(self, grads: Tree, state, params: Tree, lr=None,
             weight_decay: Optional[float] = None,
             found_inf: Optional[torch.Tensor] = None, grad_scale=None):
        lr = self.lr if lr is None else lr
        wd = self.weight_decay if weight_decay is None else weight_decay
        inv_scale = resolve_scale(grad_scale, state.step.device)
        if self.packed:
            return self._packed_stepped(grads, state, params, lr, wd,
                                        inv_scale, found_inf=found_inf)
        return skip_on_overflow(
            found_inf,
            lambda: self._stepped(grads, state, params, lr, wd, inv_scale),
            (params, state))

    def step_flat(self, grads, state: PackedState, lr=None,
                  weight_decay: Optional[float] = None,
                  found_inf: Optional[torch.Tensor] = None,
                  grad_scale=None) -> PackedState:
        """Flat-carry step: a flat gradient buffer in, the new state out;
        the fp32 master buffer IS the parameter store. The overflow skip
        is the sweep's in-kernel noop flag. Requires ``packed=True``
        with ``master_weights=True``."""
        if not (self.packed and self.master_weights):
            raise ValueError(
                "step_flat requires packed=True and master_weights=True "
                "(the fp32 update source must live in the optimizer state)")
        lr = self.lr if lr is None else lr
        wd = self.weight_decay if weight_decay is None else weight_decay
        inv_scale = resolve_scale(grad_scale, state.step.device)
        return self._packed_stepped(grads, state, None, lr, wd, inv_scale,
                                    found_inf=found_inf)[1]

    def no_update_mv_step(self, grads: Tree, state, params: Tree, lr=None,
                          weight_decay: Optional[float] = None,
                          found_inf: Optional[torch.Tensor] = None,
                          grad_scale=None):
        """Fork-added step: params move, m/v (and the step count) stay
        (``AdamFunctorNoUpdateMV``)."""
        lr = self.lr if lr is None else lr
        wd = self.weight_decay if weight_decay is None else weight_decay
        inv_scale = resolve_scale(grad_scale, state.step.device)
        if self.packed:
            return self._packed_stepped(grads, state, params, lr, wd,
                                        inv_scale, found_inf=found_inf,
                                        write_mv=False)

        def do():
            new_params, _ = self._stepped(grads, state, params, lr, wd,
                                          inv_scale)
            return new_params, state

        return skip_on_overflow(found_inf, do, (params, state))


def FusedAdamW(*args, **kwargs) -> FusedAdam:
    kwargs.setdefault("adam_w_mode", True)
    return FusedAdam(*args, **kwargs)
