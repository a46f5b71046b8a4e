"""The pipelined forward and backward (counterpart of
``apex_tpu/transformer/pipeline_parallel/schedules/
fwd_bwd_pipelining_without_interleaving.py``).

The JAX schedule streams the microbatches through ``vpp`` traversals of
the stage ring in one ``lax.scan`` of ``n vpp + pp - 1`` ticks and lets
autodiff transpose it. Here the same stream runs on the executor of
``common``: every forward of the stream in order, then every backward in
reverse (:func:`common.gpipe_order`), a stage's graphs kept between the
two (only its inputs with ``checkpoint_stages``, the stage replayed in
its backward). :func:`pipeline_rounds` is the stream alone, as a
differentiable function of the parameters and inputs whose outputs lie
on the last stage, for callers that compose the loss outside the
schedule.

``tick_checkpoint`` (the JAX scan's nested remat over tick blocks) is
accepted and changes nothing: the eager schedule keeps one graph an item
(a stage input with ``checkpoint_stages``) whatever its value.
"""
from __future__ import annotations

from typing import Any, Callable, Optional

import torch
import torch.distributed as dist

from ...._tree import tree_leaves, tree_map
from ... import parallel_state
from .common import (
    ScheduleRun,
    gpipe_order,
    warn_ignored_parity_kwargs,
)

Pytree = Any


def _check_tick_checkpoint(tick_checkpoint) -> None:
    if tick_checkpoint is not None and int(tick_checkpoint) <= 0:
        raise ValueError(
            f"tick_checkpoint must be positive, got {tick_checkpoint}")


def _extras(extras, n, like):
    return torch.zeros((n,), device=like.device) if extras is None \
        else extras


class _Rounds(torch.autograd.Function):
    @staticmethod
    def forward(ctx, run, inputs, *leaves):
        run.run(lambda r, pp, vpp, n: gpipe_order(r, pp, vpp, n,
                                                  backward=False))
        ctx.run = run
        return run.outs

    @staticmethod
    def backward(ctx, d_outs):
        run = ctx.run
        run.d_outs = d_outs.contiguous()
        run.run(lambda r, pp, vpp, n: gpipe_order(r, pp, vpp, n,
                                                  forward=False),
                forwards_done=True)
        grads = tree_leaves(run.grads())
        return (None, run.reduced_dinputs(), *grads)


def pipeline_rounds(
    stage_fn: Callable,
    stage_params_chunks,
    inputs: torch.Tensor,
    axis_name: str,
    checkpoint_stages: bool,
    num_chunks: Optional[int] = None,
    tick_checkpoint: Optional[int] = None,
    tick_hook=None,
) -> torch.Tensor:
    """Stream every microbatch of ``inputs [n, ...]`` through ``vpp``
    traversals of the stage ring: the final chunk's outputs ``[n, ...]``
    in microbatch order on the last stage, zeros on the others.
    Differentiable in the chunk parameters and ``inputs``: the backward
    runs the reverse stream, returns each stage's parameter gradients and
    the input gradients summed over the stages (stage 0's). Every stage
    must take part in the backward (a loss that reads the outputs on
    every stage, zero cotangents off the last).

    ``stage_params_chunks``: a tuple or list of per-chunk trees, or one
    tree whose leaves carry a leading ``[num_chunks]`` axis (none with
    ``num_chunks`` 1). ``n % pp == 0`` is required with ``vpp > 1``."""
    _check_tick_checkpoint(tick_checkpoint)
    if isinstance(stage_params_chunks, (tuple, list)):
        vpp = len(stage_params_chunks)
        stacked = stage_params_chunks[0] if vpp == 1 else tree_map(
            lambda *xs: torch.stack(xs), *stage_params_chunks)
    else:
        if num_chunks is None:
            raise ValueError("num_chunks required with a stacked params tree")
        vpp, stacked = num_chunks, stage_params_chunks
    run = ScheduleRun(stage_fn, None, stacked, inputs, None, axis_name,
                      vpp, checkpoint_stages, mode="outputs",
                      tick_hook=tick_hook)
    return _Rounds.apply(run, inputs, *tree_leaves(stacked))


def pipeline_forward_backward(
    stage_fn: Callable,
    loss_fn: Callable,
    stage_params: Pytree,
    inputs: torch.Tensor,
    extras: Optional[Pytree] = None,
    *,
    forward_only: bool = False,
    axis_name: Optional[str] = None,
    checkpoint_stages: bool = True,
    grad_scaler: Optional[Callable] = None,
    num_chunks: int = 1,
    tick_checkpoint: Optional[int] = None,
    tick_hook=None,
    **parity_kwargs,
):
    """This stage's pipelined forward and backward over the microbatches.

    ``stage_fn(stage_params, hidden) -> hidden``: one microbatch through
    this stage's chunk (``stage_params`` this stage's, a leading
    ``[num_chunks]`` axis with virtual chunks); ``loss_fn(hidden, extra)
    -> scalar`` on the last stage; ``inputs [n_micro, ...]`` enter stage
    0 (every stage passes a tensor of that shape and dtype: the
    messages' template); ``extras`` the loss's per-microbatch inputs.

    Returns ``(mean_loss, grads, dinputs)``: the loss (times
    ``grad_scaler``, applied to each microbatch's ``loss / n``) summed
    over the stages, so every stage holds it; the gradients of the
    local ``stage_params`` summed over the microbatches (fp32 sums in the
    parameters' dtype); ``dinputs`` the gradient of ``inputs`` (stage
    0's, on every stage). ``(mean_loss, None, None)`` with
    ``forward_only``. ``tick_hook`` receives ``(t, rank, active_f,
    active_b)`` a tick."""
    warn_ignored_parity_kwargs("pipeline_forward_backward", parity_kwargs)
    _check_tick_checkpoint(tick_checkpoint)
    run = ScheduleRun(stage_fn, loss_fn, stage_params, inputs,
                      _extras(extras, inputs.shape[0], inputs), axis_name,
                      num_chunks, checkpoint_stages, grad_scaler,
                      mode="loss", train=not forward_only,
                      tick_hook=tick_hook)
    run.run(lambda r, pp, vpp, n: gpipe_order(r, pp, vpp, n,
                                              backward=not forward_only))
    loss = run.reduced_loss()
    if forward_only:
        return loss, None, None
    return loss, run.grads(), run.reduced_dinputs()


def _own_stage(stage_params, axis_name):
    from ..p2p_communication import AxisGroup

    ax = AxisGroup(axis_name)
    return ax, tree_map(lambda p: p[ax.index], stage_params)


def _gather_stages(ax, grads):
    """Every stage's gradients stacked ``[pp, ...]`` on every stage."""
    if not ax.active or ax.size == 1:
        return tree_map(lambda g: g[None], grads)

    def gather(g):
        out = g.new_empty((ax.size,) + tuple(g.shape))
        dist.all_gather_into_tensor(out, g[None].contiguous(),
                                    group=ax.group)
        return out

    return tree_map(gather, grads)


def run_pipeline(
    mesh,
    stage_fn: Callable,
    loss_fn: Callable,
    stage_params: Pytree,
    inputs: torch.Tensor,
    extras: Optional[Pytree] = None,
    *,
    forward_only: bool = False,
    checkpoint_stages: bool = True,
    num_chunks: int = 1,
    tick_checkpoint: Optional[int] = None,
    tick_hook=None,
):
    """The single-axis form: ``stage_params`` leaves carry a leading
    ``[pp]`` (or ``[pp, num_chunks]``) axis of every stage's parameters,
    of which this stage takes its own. Returns the loss with
    ``forward_only``, else ``(loss, grads, dinputs)`` with the gradients
    of every stage stacked ``[pp, ...]`` like ``stage_params`` (one
    all-gather a leaf). ``mesh`` (a ``ModelParallelMesh`` or None) is the
    JAX signature's; the stages are the ``pipeline`` group's."""
    del mesh
    ax, own = _own_stage(stage_params, parallel_state.PIPELINE_AXIS)
    loss, grads, dinputs = pipeline_forward_backward(
        stage_fn, loss_fn, own, inputs, extras, forward_only=forward_only,
        axis_name=parallel_state.PIPELINE_AXIS,
        checkpoint_stages=checkpoint_stages, num_chunks=num_chunks,
        tick_checkpoint=tick_checkpoint, tick_hook=tick_hook)
    if forward_only:
        return loss
    return loss, _gather_stages(ax, grads), dinputs
