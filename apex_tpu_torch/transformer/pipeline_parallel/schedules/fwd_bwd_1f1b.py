"""True 1F1B pipeline schedule (counterpart of
``apex_tpu/transformer/pipeline_parallel/schedules/fwd_bwd_1f1b.py``;
reference ``fwd_bwd_pipelining_without_interleaving.py:241-597`` and,
with virtual chunks, ``fwd_bwd_pipelining_with_interleaving.py:27-744``).

Each stage runs the reference's order on the executor of ``common``
(:func:`common.one_f_one_b_order`): ``pp - rank - 1`` warm-up forwards,
then one forward and one backward at a time, then the cool-down
backwards, so stage ``rank`` holds at most ``pp - rank`` microbatches'
graphs and its activation memory does not grow with the microbatch
count; with ``num_chunks = vpp > 1`` the interleaved order, ``2 (pp -
rank - 1) + (vpp - 1) pp`` warm-up forwards over the stream. The JAX
schedule gets the same bound from a uniform double tick over a ring
buffer of residuals, ``2 vpp pp - 1`` slots on every stage.
"""
from __future__ import annotations

from typing import Any, Callable, Optional

import torch

from .common import ScheduleRun, one_f_one_b_order

Pytree = Any


def pipeline_forward_backward_1f1b(
    stage_fn: Callable,
    loss_fn: Callable,
    stage_params: Pytree,
    inputs: torch.Tensor,
    extras: Optional[Pytree] = None,
    *,
    axis_name: Optional[str] = None,
    grad_scaler: Optional[Callable] = None,
    with_dinputs: bool = True,
    num_chunks: int = 1,
    tick_hook=None,
):
    """1F1B forward and backward; the contract of
    ``pipeline_forward_backward``: ``(mean_loss, grads, dinputs)``, the
    loss on every stage, the gradients of the local ``stage_params``
    summed over the microbatches of the ``1/n``-scaled loss (fp32 sums in
    the parameters' dtype), ``dinputs`` stage 0's input gradients on
    every stage (None with ``with_dinputs=False``). ``grad_scaler`` must
    be linear (loss scaling). ``num_chunks = vpp > 1`` is the interleaved
    schedule: ``stage_params`` leaves carry a leading ``[vpp]`` chunk
    axis (chunk ``c`` of stage ``s`` holds global layer block ``c pp +
    s``), and ``n_micro % pp == 0`` is required. ``tick_hook`` receives
    ``(t, rank, active_f, active_b)`` a tick: the warm-up, steady and
    cool-down timeline."""
    n = inputs.shape[0]
    if extras is None:
        extras = torch.zeros((n,), device=inputs.device)
    run = ScheduleRun(stage_fn, loss_fn, stage_params, inputs, extras,
                      axis_name, num_chunks, False, grad_scaler,
                      mode="loss", want_dinputs=with_dinputs,
                      tick_hook=tick_hook)
    run.run(one_f_one_b_order)
    return run.reduced_loss(), run.grads(), run.reduced_dinputs()
