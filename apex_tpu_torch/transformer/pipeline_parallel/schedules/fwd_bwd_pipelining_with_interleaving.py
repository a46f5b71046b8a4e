"""Interleaved (virtual-pipeline) schedule (counterpart of
``apex_tpu/transformer/pipeline_parallel/schedules/
fwd_bwd_pipelining_with_interleaving.py``; reference
``fwd_bwd_pipelining_with_interleaving.py:27-744``).

Each stage owns ``vpp`` chunks (chunk ``v`` of stage ``s`` holds global
layer block ``v pp + s``) and every microbatch crosses the stage ring
``vpp`` times in groups of ``pp``: ``pipeline_forward_backward`` with
``num_chunks = vpp``. Requires ``n_micro % pp == 0``, as the reference.
"""
from __future__ import annotations

from typing import Any, Callable, Optional

from ...._tree import tree_leaves
from ... import parallel_state
from .common import warn_ignored_parity_kwargs
from .fwd_bwd_pipelining_without_interleaving import (
    pipeline_forward_backward,
    run_pipeline,
)

Pytree = Any


def pipeline_forward_backward_interleaved(
    stage_fn: Callable,
    loss_fn: Callable,
    stage_params_chunks: Pytree,
    inputs,
    extras=None,
    *,
    forward_only: bool = False,
    axis_name: Optional[str] = None,
    checkpoint_stages: bool = True,
    grad_scaler: Optional[Callable] = None,
    **parity_kwargs,
):
    """The interleaved schedule: ``stage_params_chunks`` leaves carry a
    leading ``[vpp]`` chunk axis (``vpp`` from ``parallel_state`` when
    set, else that axis). Other arguments and the result as
    ``pipeline_forward_backward``."""
    tick_checkpoint = parity_kwargs.pop("tick_checkpoint", None)
    tick_hook = parity_kwargs.pop("tick_hook", None)
    warn_ignored_parity_kwargs("pipeline_forward_backward_interleaved",
                               parity_kwargs)
    vpp = parallel_state.get_virtual_pipeline_model_parallel_world_size()
    if vpp is None:
        vpp = tree_leaves(stage_params_chunks)[0].shape[0]
    return pipeline_forward_backward(
        stage_fn, loss_fn, stage_params_chunks, inputs, extras,
        forward_only=forward_only, axis_name=axis_name,
        checkpoint_stages=checkpoint_stages, grad_scaler=grad_scaler,
        num_chunks=vpp, tick_checkpoint=tick_checkpoint,
        tick_hook=tick_hook)


def run_pipeline_interleaved(
    mesh,
    stage_fn: Callable,
    loss_fn: Callable,
    stage_params_chunks: Pytree,
    inputs,
    extras=None,
    *,
    forward_only: bool = False,
    checkpoint_stages: bool = True,
    tick_checkpoint=None,
    tick_hook=None,
):
    """The single-axis form; ``stage_params_chunks`` leaves are ``[pp,
    vpp, ...]``."""
    vpp = tree_leaves(stage_params_chunks)[0].shape[1]
    return run_pipeline(
        mesh, stage_fn, loss_fn, stage_params_chunks, inputs, extras,
        forward_only=forward_only, checkpoint_stages=checkpoint_stages,
        num_chunks=vpp, tick_checkpoint=tick_checkpoint,
        tick_hook=tick_hook)


# reference private name
_forward_backward_pipelining_with_interleaving = (
    pipeline_forward_backward_interleaved
)
