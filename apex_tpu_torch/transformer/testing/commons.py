"""Shared test fixtures (counterpart of
``apex_tpu/transformer/testing/commons.py``): seeding, the process group,
the separator print and the toy stage helpers of the schedule tests."""
from __future__ import annotations

import random
from typing import Any

import numpy as np
import torch
import torch.distributed as dist

from ...parallel.multiproc import initialize_distributed as _init_dist
from ..tensor_parallel import model_parallel_manual_seed

Tree = Any

TEST_SUCCESS_MESSAGE = ">> passed the test :-)"


def set_random_seed(seed: int) -> torch.Generator:
    """Seed Python, numpy, torch and the model-parallel streams
    (``model_parallel_manual_seed``); returns a host ``torch.Generator``
    seeded with ``seed``, where the JAX one returns a key."""
    random.seed(seed)
    np.random.seed(seed)
    model_parallel_manual_seed(seed)
    return torch.Generator().manual_seed(seed)


def initialize_distributed(backend: str = "nccl") -> None:
    """Join the ``torch.distributed`` world from ``COORDINATOR_ADDRESS``,
    ``NUM_PROCESSES`` and ``PROCESS_ID`` when set
    (``parallel.multiproc.initialize_distributed``), else from torchrun's
    ``MASTER_ADDR`` / ``RANK`` / ``WORLD_SIZE`` (``env://``) when set, with
    ``backend`` (gloo without a CUDA device); otherwise one process, no
    group. A process already in a group keeps it."""
    import os

    if dist.is_initialized():
        return
    if os.environ.get("COORDINATOR_ADDRESS"):
        _init_dist()
        return
    if os.environ.get("MASTER_ADDR") and os.environ.get("WORLD_SIZE"):
        if backend == "nccl" and not torch.cuda.is_available():
            backend = "gloo"
        dist.init_process_group(backend, init_method="env://")


def print_separator(message: str) -> None:
    """A ``---- message ----`` line on rank 0."""
    filler = "-" * ((78 - len(message)) // 2)
    rank = dist.get_rank() if dist.is_initialized() else 0
    if rank == 0:
        print("\n" + filler + " {} ".format(message) + filler, flush=True)


def identity_layer(shape, generator: torch.Generator) -> torch.Tensor:
    """A trainable tensor of ``shape`` (the reference's
    ``IdentityLayer``), normal from ``generator``."""
    return torch.randn(shape, generator=generator,
                       device=generator.device)


def toy_mlp_stage(hidden: int, generator: torch.Generator,
                  n_stages: int = 1) -> Tree:
    """Per-stage toy MLP params ``{"w": [n, h, h], "b": [n, h]}`` for
    pipeline schedule tests."""
    w = torch.randn((n_stages, hidden, hidden), generator=generator,
                    device=generator.device) * 0.5
    return {"w": w, "b": torch.zeros((n_stages, hidden), device=w.device)}


def toy_stage_fn(params: Tree, x: torch.Tensor) -> torch.Tensor:
    return torch.tanh(x @ params["w"] + params["b"])


def toy_loss_fn(y: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return torch.mean((y - target) ** 2)


def fwd_step_func(batch, model_fn, params):
    """The reference's ``fwd_step_func``: ``(output, loss_func)``."""
    output = model_fn(params, batch)

    def loss_func(output):
        loss = torch.sum(output)
        return loss, {"avg": loss}

    return output, loss_func
