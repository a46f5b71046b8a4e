"""FP16_Optimizer: a master-weight mixed-precision optimizer wrapper
(counterpart of ``apex_tpu/fp16_utils/fp16_optimizer.py``).

Reference: ``apex/fp16_utils/fp16_optimizer.py:13-556``: wraps any
optimizer with fp32 master copies of the half params, loss scaling
(static or dynamic), the overflow skip, ``clip_master_grads``, and a
state_dict holding the masters.

Functional, following the fused optimizers' protocol: the state carries
the masters, the wrapped optimizer's state over them and the amp
scaler's state. The step unscales, checks for an overflow, updates the
masters unless one was found (the flag is the wrapped optimizer's
``found_inf``: a device select, or a packed kernel's noop flag, where the
JAX package branches with ``lax.cond``) and casts them back; nothing
reads the device from the host.
"""
from __future__ import annotations

from typing import Any, NamedTuple, Optional, Tuple

import torch

from .._tree import tree_leaves, tree_map
from ..amp.scaler import LossScaler, LossScaleState
from ..ops.multi_tensor import multi_tensor_l2norm
from .fp16util import master_params_to_model_params, prep_param_lists

Tree = Any


class FP16OptimizerState(NamedTuple):
    masters: Tree  # fp32 master params
    inner: Any  # the wrapped optimizer's state (over the masters)
    scaler: LossScaleState


def _to_host(tree: Tree) -> Tree:
    return tree_map(lambda t: t.detach().cpu().numpy()
                    if isinstance(t, torch.Tensor) else t, tree)


def _like(old: Tree, new: Tree) -> Tree:
    return tree_map(
        lambda o, n: torch.as_tensor(n, dtype=o.dtype, device=o.device)
        if isinstance(o, torch.Tensor) else n, old, new)


class FP16_Optimizer:
    """Reference ``FP16_Optimizer`` (``fp16_optimizer.py:13``).

    Usage (the functional spelling of init_optimizer / backward / step)::

        opt = FP16_Optimizer(FusedSGD(lr=0.1), dynamic_loss_scale=True)
        state = opt.init(half_params)
        _, scaled_grads = value_and_grad(
            lambda p: opt.scale_loss(state, loss_fn(p)), half_params)
        half_params, state = opt.step(scaled_grads, state, half_params)
    """

    def __init__(self, init_optimizer, static_loss_scale: float = 1.0,
                 dynamic_loss_scale: bool = False,
                 dynamic_loss_args: Optional[dict] = None,
                 verbose: bool = False):
        self.optimizer = init_optimizer
        if dynamic_loss_scale:
            self.loss_scaler = LossScaler("dynamic",
                                          **(dynamic_loss_args or {}))
        else:
            self.loss_scaler = LossScaler(static_loss_scale)
        self.verbose = verbose

    def init(self, params: Tree) -> FP16OptimizerState:
        _, masters = prep_param_lists(params)
        device = tree_leaves(masters)[0].device
        return FP16OptimizerState(
            masters=masters, inner=self.optimizer.init(masters),
            scaler=self.loss_scaler.init_state(device))

    # -- loss scaling ------------------------------------------------------
    def scale_loss(self, state: FP16OptimizerState,
                   loss: torch.Tensor) -> torch.Tensor:
        """The scaling half of ``optimizer.backward(loss)``
        (``fp16_optimizer.py:322-356``)."""
        return self.loss_scaler.scale_loss(state.scaler, loss)

    @property
    def loss_scale(self):
        """The reference exposes the numeric scale here
        (``fp16_optimizer.py:547-556``); on the functional interface the
        scale lives in the carried state, so this raises loudly instead of
        returning a wrong type."""
        raise RuntimeError(
            "FP16_Optimizer is functional: read state.scaler.loss_scale "
            "(a 0-dim tensor) instead of optimizer.loss_scale")

    def get_loss_scale(self, state: FP16OptimizerState):
        return state.scaler.loss_scale

    # -- step --------------------------------------------------------------
    def step(self, scaled_grads: Tree, state: FP16OptimizerState,
             params: Tree, max_grad_norm: Optional[float] = None
             ) -> Tuple[Tree, FP16OptimizerState]:
        """Unscale -> (clip) -> the master update unless an overflow ->
        cast back: ``FP16_Optimizer.step`` (``fp16_optimizer.py:363-418``)
        with ``clip_master_grads`` (``:420-455``) folded in by
        ``max_grad_norm``."""
        master_grads, scaler_state = self.loss_scaler.unscale(
            state.scaler, scaled_grads, out_dtype=torch.float32)
        if max_grad_norm is not None:
            master_grads = self.clip_master_grads(master_grads,
                                                  max_grad_norm)
        new_masters, new_inner = self.optimizer.step(
            master_grads, state.inner, state.masters,
            found_inf=scaler_state.found_inf)
        new_scaler = self.loss_scaler.update_scale(scaler_state)
        new_params = master_params_to_model_params(params, new_masters)
        return new_params, FP16OptimizerState(
            masters=new_masters, inner=new_inner, scaler=new_scaler)

    def clip_master_grads(self, master_grads: Tree, max_norm: float) -> Tree:
        """Standalone grad clip over the masters
        (``fp16_optimizer.py:420-455``)."""
        norm, _ = multi_tensor_l2norm(master_grads)
        clip = torch.clamp_max(max_norm / (norm + 1e-6), 1.0)
        return tree_map(lambda g: g * clip, master_grads)

    # -- checkpointing (``fp16_optimizer.py:212-273``) ---------------------
    def state_dict(self, state: FP16OptimizerState) -> dict:
        return {"loss_scaler": self.loss_scaler.state_dict(state.scaler),
                "fp32_from_fp16": _to_host(state.masters),
                "optimizer_state": _to_host(state.inner)}

    def load_state_dict(self, sd: dict, state: FP16OptimizerState
                        ) -> FP16OptimizerState:
        return FP16OptimizerState(
            masters=_like(state.masters, sd["fp32_from_fp16"]),
            inner=_like(state.inner, sd["optimizer_state"]),
            scaler=self.loss_scaler.load_state_dict(
                sd["loss_scaler"], device=state.scaler.loss_scale.device))

