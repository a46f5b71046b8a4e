"""No-pipelining schedule: sequential microbatches with gradient
accumulation (counterpart of ``apex_tpu/transformer/pipeline_parallel/
schedules/fwd_bwd_no_pipelining.py``; reference
``fwd_bwd_no_pipelining.py:23-94``).

A Python loop over the microbatches, each one's forward and backward in
turn, its gradients summed in fp32 (the JAX ``lax.scan``'s carry); data-
parallel sync is the caller's, applied once to the sum.
"""
from __future__ import annotations

from typing import Any, Callable, Optional

import torch

from ...._tree import tree_leaves, tree_map, value_and_grad
from .common import emit_tick, warn_ignored_parity_kwargs

Pytree = Any


def forward_backward_no_pipelining(
    stage_fn: Callable,
    loss_fn: Callable,
    params: Pytree,
    microbatches: Pytree,
    extras: Optional[Pytree] = None,
    *,
    forward_only: bool = False,
    grad_scaler: Optional[Callable] = None,
    microbatch_hook=None,
    **parity_kwargs,
):
    """Every microbatch through the whole model, accumulating.

    ``stage_fn(params, x) -> hidden`` (the whole model here), ``loss_fn(
    hidden, extra) -> scalar`` per microbatch, ``microbatches`` a tree
    with a leading microbatch axis, ``grad_scaler`` applied to each
    microbatch's loss before its backward. Returns ``(mean_loss,
    grads)``: the gradients summed over the microbatches in fp32 and
    divided by their count (fp32, as the JAX carry), or ``(mean_loss,
    None)`` with ``forward_only``. ``microbatch_hook`` receives ``(i, 0,
    True, not forward_only)`` a microbatch."""
    warn_ignored_parity_kwargs("forward_backward_no_pipelining",
                               parity_kwargs)
    n = tree_leaves(microbatches)[0].shape[0]
    if extras is None:
        extras = torch.zeros((n,))

    def one_loss(p, mb, ex):
        loss = loss_fn(stage_fn(p, mb), ex)
        return grad_scaler(loss) if grad_scaler is not None else loss

    total, acc = 0.0, None
    for i in range(n):
        mb = tree_map(lambda t: t[i], microbatches)
        ex = tree_map(lambda e: e[i], extras)
        emit_tick(microbatch_hook, i, 0, True, not forward_only)
        if forward_only:
            with torch.no_grad():
                total = total + one_loss(params, mb, ex).float()
            continue
        loss, grads = value_and_grad(lambda p: one_loss(p, mb, ex), params)
        total = total + loss.float()
        acc = tree_map(lambda g: g.float(), grads) if acc is None else \
            tree_map(lambda a, g: a.add_(g.float()), acc, grads)
    if forward_only:
        return total / n, None
    return total / n, tree_map(lambda g: g / n, acc)
