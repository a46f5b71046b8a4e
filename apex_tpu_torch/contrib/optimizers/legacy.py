"""The legacy contrib optimizers' explicit-scale step (counterpart of
``apex_tpu/contrib/optimizers/legacy.py``).

The reference keeps deprecated copies of FusedAdam and FusedSGD whose
``step`` differs from the maintained ones: the gradients come in
explicitly and are divided by a caller's ``scale``, optionally clipped by
a combined scale from precomputed ``grad_norms`` (norms of the SCALED
gradients: ``clip = ((norm / scale) + 1e-6) / max_grad_norm``, ``combined
= clip * scale`` when ``clip > 1``), and a reduced-precision copy of the
updated params can come back beside them (``output_params_dtype``).

The legacy Adam kernel's update (``fused_adam_cuda_kernel.cu:60-70``)
differs from both maintained modes: the denominator is the RAW second
moment's, ``sqrt(v + eps)`` with ``eps_inside_sqrt`` else ``sqrt(v) +
eps``; the bias corrections fold into the step size, ``lr * sqrt(bc2) /
bc1``; the weight decay applies after the denominator, ``update = m /
denom + decay * p``. :class:`LegacyFusedAdam` subclasses the port's
pytree ``FusedAdam`` and overrides its leaf update, which receives the
bias corrections ``bc1 = 1 - beta1**t``, ``bc2 = 1 - beta2**t`` as fp32
tensors computed once a step on the params' device. Both run the
pytree path (``packed=False``), as in the JAX package; ``use_mt`` and
``amp_scale_adjustment`` are kept for the signature (the latter is never
applied: the reference applies it on the amp-stash path only).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..._tree import tree_map
from ...optimizers.fused_adam import FusedAdam, FusedAdamState
from ...optimizers.fused_sgd import FusedSGD


def _combined_scale(scale, grad_norms, max_grad_norm):
    """The legacy clip; ``grad_norms`` are norms of the SCALED grads."""
    if max_grad_norm <= 0 or grad_norms is None:
        return scale
    scale = torch.as_tensor(scale, dtype=torch.float32)
    norm = torch.as_tensor(grad_norms, dtype=torch.float32).to(scale.device)
    clip = ((norm / scale) + 1e-6) / max_grad_norm
    return torch.where(clip > 1.0, clip * scale, scale)


def _legacy_returns(new_params, new_state, output_params_dtype):
    """``(params, state)``, or ``(params, state, output_params)`` with the
    reduced-precision copy when ``output_params_dtype`` is given."""
    if output_params_dtype is None:
        return new_params, new_state
    out = tree_map(lambda p: p.to(output_params_dtype), new_params)
    return new_params, new_state, out


class LegacyFusedAdam(FusedAdam):
    """``apex.contrib.optimizers.FusedAdam``: the legacy step over the
    maintained pytree update."""

    def __init__(self, lr: float = 1e-3, bias_correction: bool = True,
                 betas: Tuple[float, float] = (0.9, 0.999),
                 eps: float = 1e-8, eps_inside_sqrt: bool = False,
                 weight_decay: float = 0.0, max_grad_norm: float = 0.0,
                 amsgrad: bool = False, use_mt: bool = False,
                 amp_scale_adjustment: float = 1.0):
        super().__init__(lr=lr, bias_correction=bias_correction, betas=betas,
                         eps=eps, adam_w_mode=False,
                         weight_decay=weight_decay, amsgrad=amsgrad)
        del use_mt
        self.eps_inside_sqrt = bool(eps_inside_sqrt)
        self.max_grad_norm = float(max_grad_norm)
        self.amp_scale_adjustment = float(amp_scale_adjustment)

    def _update_leaf(self, g, p, m, v, bc1, bc2, lr, wd):
        beta1, beta2 = self.betas
        g = g.to(torch.float32)
        p32 = p.to(torch.float32)
        new_m = beta1 * m + (1.0 - beta1) * g
        new_v = beta2 * v + (1.0 - beta2) * g * g
        if self.eps_inside_sqrt:
            denom = torch.sqrt(new_v + self.eps)
        else:
            denom = torch.sqrt(new_v) + self.eps
        if self.bias_correction:
            step_size = lr * torch.sqrt(bc2) / bc1
        else:
            step_size = lr
        update = new_m / denom
        if wd != 0.0:
            update = update + wd * p32
        return p32 - step_size * update, new_m, new_v

    def step(self, grads, state: FusedAdamState, params, scale=1.0,
             grad_norms=None, output_params_dtype=None, lr=None):
        """``update = adam(grads / combined_scale)``; returns ``(params,
        state)`` or, with ``output_params_dtype``, ``(params, state,
        output_params)``."""
        dev = state.step.device
        scale = torch.as_tensor(scale, dtype=torch.float32).to(dev)
        combined = _combined_scale(scale, grad_norms, self.max_grad_norm)
        new_params, new_state = super().step(grads, state, params, lr=lr,
                                             grad_scale=combined)
        return _legacy_returns(new_params, new_state, output_params_dtype)


class LegacyFusedSGD(FusedSGD):
    """``apex.contrib.optimizers.FusedSGD``: the legacy step (explicit
    grads, a scale, an optional reduced-precision copy)."""

    def __init__(self, lr: float, momentum: float = 0.0,
                 dampening: float = 0.0, weight_decay: float = 0.0,
                 nesterov: bool = False, wd_after_momentum: bool = False,
                 materialize_master_grads: bool = True):
        super().__init__(lr=lr, momentum=momentum, dampening=dampening,
                         weight_decay=weight_decay, nesterov=nesterov,
                         wd_after_momentum=wd_after_momentum)
        del materialize_master_grads

    def step(self, grads, state, params, scale=1.0, grad_norms=None,
             output_params_dtype=None, lr=None):
        del grad_norms  # the legacy SGD takes them and never clips
        scale = torch.as_tensor(scale, dtype=torch.float32).to(
            state.step.device)
        new_params, new_state = super().step(grads, state, params, lr=lr,
                                             grad_scale=scale)
        return _legacy_returns(new_params, new_state, output_params_dtype)
