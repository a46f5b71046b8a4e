"""Loss scaling entry points, the ``amp.scale_loss`` analogue
(counterpart of ``apex_tpu/amp/handle.py``).

Reference: ``apex/amp/handle.py:16-152``: a context manager around
``loss.backward()`` that patches ``optimizer.step`` to skip on overflow.
As in the JAX package the workhorse is functional:
:func:`scaled_value_and_grad` differentiates the *scaled* loss, unscales
the gradients and records an overflow in the scaler state; the optimizer
step is then skipped on the device (the fused optimizers' ``found_inf``
argument, or :func:`apply_updates_skip_on_overflow`). Nothing here reads
the device from the host.
"""
from __future__ import annotations

from typing import Any, Callable

import torch

from .._tree import tree_map, value_and_grad
from .scaler import LossScaler, LossScaleState

Tree = Any


def scale_loss(loss: torch.Tensor, scaler_state: LossScaleState
               ) -> torch.Tensor:
    """loss * current scale (use inside your loss function)."""
    return loss * scaler_state.loss_scale.to(loss.dtype)


def _detached(tree: Tree) -> Tree:
    return tree_map(lambda x: x.detach() if isinstance(x, torch.Tensor)
                    else x, tree)


def scaled_value_and_grad(loss_fn: Callable, scaler: LossScaler,
                          argnums=0, has_aux: bool = False):
    """Build a value-and-grad function with loss scaling folded in.

    Returns ``fn(scaler_state, *args) -> ((loss, aux) or loss, grads,
    new_state)``: ``grads`` (of the argument ``argnums`` names, a tuple
    of trees for a tuple of positions) are already unscaled, and
    ``new_state.found_inf`` is set on the device if any gradient
    overflowed. The same control flow as the reference's

        with amp.scale_loss(loss, optimizer) as scaled_loss:
            scaled_loss.backward()

    (``apex/amp/handle.py:17-124``), but functional: the caller's tensors
    get no ``.grad``, and the loss and ``aux`` come back detached."""
    positions = (argnums,) if isinstance(argnums, int) else tuple(argnums)

    def fn(scaler_state: LossScaleState, *args):
        out = {}

        def scaled(diff):
            full = list(args)
            for i, p in zip(positions, diff):
                full[i] = p
            res = loss_fn(*full)
            loss, aux = res if has_aux else (res, None)
            out["loss"], out["aux"] = loss, aux
            return scale_loss(loss.to(torch.float32), scaler_state)

        _, scaled_grads = value_and_grad(
            scaled, tuple(args[i] for i in positions))
        if isinstance(argnums, int):
            scaled_grads = scaled_grads[0]
        grads, scaler_state = scaler.unscale(scaler_state, scaled_grads)
        loss = out["loss"].detach()
        if has_aux:
            return (loss, _detached(out["aux"])), grads, scaler_state
        return loss, grads, scaler_state

    return fn


def apply_updates_skip_on_overflow(params: Tree, new_params: Tree,
                                   found_inf: torch.Tensor) -> Tree:
    """Select the old params when the step overflowed: the functional
    analogue of the reference's patched ``optimizer.step`` skipping on
    ``noop_flag`` (``apex/amp/handle.py:126-146``), a device select."""
    return tree_map(lambda old, new: torch.where(found_inf, old, new),
                    params, new_params)
