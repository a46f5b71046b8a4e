"""The test GPT's provider (counterpart of
``apex_tpu/transformer/testing/standalone_gpt.py``), with the fork's
``cpu_offload`` option.

The reference wraps the GPT's forward in
``torch.autograd.graph.save_on_cpu(pin_memory=True)``
(``apex/transformer/testing/standalone_gpt.py:59-61, :96``): every
tensor that autograd saves for the backward, the port's autograd
Functions' ``ctx.save_for_backward`` included, goes to host memory in
the forward and comes back to the card in the backward. The port does
exactly that. The JAX package maps the option to ``jax.checkpoint``
with an offload policy (the dots' results to pinned host memory, the
rest recomputed), or to plain recomputation where no pinned host memory
exists. Either way the option moves memory and time, never values: a
step's loss and gradients are the same bit for bit with and without it.
"""
from __future__ import annotations

import functools
from typing import Optional

import torch

from ..._tree import tree_leaves
from .standalone_transformer_lm import (  # noqa: F401
    GPTConfig,
    gpt_forward,
    gpt_loss,
    init_gpt_params,
)


def _offloaded(fn, device: torch.device):
    """``fn`` under ``save_on_cpu``: saved tensors go to host memory,
    pinned where the model is on the card (pinning needs a CUDA
    device)."""
    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        with torch.autograd.graph.save_on_cpu(
                pin_memory=device.type == "cuda"):
            return fn(*args, **kwargs)
    return wrapped


def gpt_model_provider(cfg: GPTConfig, generator: torch.Generator,
                       cpu_offload: bool = False, pre_process: bool = True,
                       post_process: bool = True,
                       device: Optional[torch.device] = None):
    """``(params, forward_fn, loss_fn)`` for the test GPT (the reference's
    ``gpt_model_provider``): weights drawn from ``generator`` and placed
    on ``device`` (default: the generator's), ``forward_fn(params,
    tokens, ...)`` and ``loss_fn(params, tokens, labels, ...)`` as
    :func:`gpt_forward` and :func:`gpt_loss` with ``cfg`` bound, both
    under ``save_on_cpu`` with ``cpu_offload``. ``pre_process`` /
    ``post_process`` are the reference's pipeline-stage flags, accepted
    for its signature (one stage holds the whole model here)."""
    del pre_process, post_process
    params = init_gpt_params(cfg, generator, device)
    fwd = functools.partial(gpt_forward, cfg)
    loss = functools.partial(gpt_loss, cfg)
    if cpu_offload:
        dev = tree_leaves(params)[0].device
        fwd, loss = _offloaded(fwd, dev), _offloaded(loss, dev)
    return params, fwd, loss
