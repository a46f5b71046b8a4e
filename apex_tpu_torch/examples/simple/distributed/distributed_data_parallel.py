"""Minimal amp + DistributedDataParallel example: the PyTorch port of
``examples/simple/distributed/distributed_data_parallel.py``, itself a
port of Apex's ``examples/simple/distributed/``.

One linear layer ``[1024 -> 16]`` trained on fake data with
``amp.initialize(opt_level="O1")``, ``FusedSGD(lr=1e-3)`` and
``parallel.DistributedDataParallel``: each rank's shard of the batch (64
rows of ``[64 * world, 1024]``) gives its gradients, which DDP averages
across the ranks before the step. Ranks are processes::

    python -m apex_tpu_torch.examples.simple.distributed.distributed_data_parallel
    torchrun --nproc-per-node=N -m \\
        apex_tpu_torch.examples.simple.distributed.distributed_data_parallel
    python -m apex_tpu_torch.examples.simple.distributed.distributed_data_parallel --cpu 8

The first runs one process on the card (``--device cpu`` for the plain
path); ``torchrun`` one process a card over NCCL; ``--cpu N`` a gloo
world of N CPU processes spawned here (the JAX script's N-device CPU
mesh). Rank 0 prints ``step t: loss L`` every 100 steps and at the last,
as the JAX script does, the loss averaged across the ranks. The data and
the initial weight are normal draws from a ``torch.Generator`` seeded 0
(on the CPU, so every device gets the same values), or, with ``--data``,
the arrays ``x``, ``y`` and ``w`` of an ``.npz`` file (the JAX script's
draws, for a comparison).
"""
from __future__ import annotations

import argparse
import os
import tempfile

import numpy as np
import torch
import torch.distributed as dist

N, D_IN, D_OUT = 64, 1024, 16


def parse(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--cpu", type=int, default=0,
                   help="run N ranks as a gloo world of CPU processes")
    p.add_argument("--steps", type=int, default=500)
    p.add_argument("--device", default=None,
                   help="torch device (default: the card)")
    p.add_argument("--data", default=None,
                   help=".npz with x [64 * world, 1024], y [64 * world, 16] "
                        "and w [1024, 16] in place of the seeded draws")
    return p.parse_args(argv)


def make_data(world: int, path=None):
    """``(x, y, w)`` on the CPU: the seeded draws, or ``path``'s arrays."""
    if path is not None:
        with np.load(path) as f:
            return tuple(torch.from_numpy(np.asarray(f[k], np.float32))
                         for k in ("x", "y", "w"))
    g = torch.Generator().manual_seed(0)
    x = torch.randn(N * world, D_IN, generator=g)
    y = torch.randn(N * world, D_OUT, generator=g)
    w = torch.randn(D_IN, D_OUT, generator=g) * 0.01
    return x, y, w


def train(args):
    """The training loop on this rank; returns the per-print losses
    ``[(step, loss), ...]``."""
    from ....amp import (
        apply_updates_skip_on_overflow,
        initialize,
        scaled_value_and_grad,
    )
    from ...._device import resolve_device
    from ....optimizers import FusedSGD
    from ....parallel import DistributedDataParallel

    distributed = dist.is_available() and dist.is_initialized()
    rank, world = ((dist.get_rank(), dist.get_world_size()) if distributed
                   else (0, 1))
    dev = resolve_device(args.device)
    kind = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    say = print if rank == 0 else (lambda *a, **k: None)
    say(f"world size {world} ({kind})")

    x, y, w = make_data(world, args.data)
    # each rank's shard is its "fake batch", as in the reference
    x = x[rank * N:(rank + 1) * N].to(dev)
    y = y[rank * N:(rank + 1) * N].to(dev)
    params = {"w": w.to(dev), "b": torch.zeros(D_OUT, device=dev)}

    opt = FusedSGD(lr=1e-3)
    params, opt, amp_state = initialize(params, opt, opt_level="O1")
    opt_state = opt.init(params)
    scaler = amp_state.scaler(0)
    scaler_state = amp_state.scaler_state(0)
    ddp = DistributedDataParallel(axis_name="data")

    def loss_fn(params, x, y):
        with amp_state.autocast():
            # the operator, as the JAX script writes it: O1 casts the
            # listed functions, and ``@`` is none of them
            pred = x @ params["w"] + params["b"]
        return torch.mean((pred.to(torch.float32) - y) ** 2)

    grad_fn = scaled_value_and_grad(loss_fn, scaler)
    losses = []
    for t in range(args.steps):
        loss, grads, scaler_state = grad_fn(scaler_state, params, x, y)
        grads = ddp.sync(grads)
        new_params, new_opt_state = opt.step(grads, opt_state, params)
        params = apply_updates_skip_on_overflow(params, new_params,
                                                scaler_state.found_inf)
        opt_state = apply_updates_skip_on_overflow(
            opt_state, new_opt_state, scaler_state.found_inf)
        scaler_state = scaler.update_scale(scaler_state)
        if t % 100 == 0 or t == args.steps - 1:
            loss = ddp.sync({"loss": loss.detach()})["loss"]  # pmean
            losses.append((t, float(loss)))
            say(f"step {t}: loss {losses[-1][1]:.6f}")
    if not np.isfinite(losses[-1][1]):
        raise AssertionError(f"loss {losses[-1][1]} is not finite")
    say("done.")
    return losses


def _cpu_rank(rank, world, store, args):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method="file://" + store,
                            world_size=world, rank=rank)
    try:
        args.cpu, args.device = 0, "cpu"
        train(args)
    finally:
        dist.destroy_process_group()


def main(argv=None):
    args = parse(argv)
    if args.cpu:
        import torch.multiprocessing as mp

        ctx = mp.get_context("spawn")
        with tempfile.TemporaryDirectory() as tmp:
            procs = [ctx.Process(target=_cpu_rank,
                                 args=(r, args.cpu, os.path.join(tmp, "store"),
                                       args)) for r in range(args.cpu)]
            for proc in procs:
                proc.start()
            for proc in procs:
                proc.join()
            failed = {r: p.exitcode for r, p in enumerate(procs)
                      if p.exitcode}
        if failed:
            raise SystemExit(f"--cpu {args.cpu}: ranks exited with {failed}")
        return None
    joined = False
    if int(os.environ.get("WORLD_SIZE", "1")) > 1 and not dist.is_initialized():
        if args.device is None and torch.cuda.is_available():
            args.device = f"cuda:{int(os.environ.get('LOCAL_RANK', '0'))}"
            torch.cuda.set_device(torch.device(args.device))
        dist.init_process_group(
            "nccl" if torch.device(args.device or "cuda").type == "cuda"
            else "gloo")
        joined = True
    try:
        return train(args)
    finally:
        if joined:
            dist.destroy_process_group()


if __name__ == "__main__":
    main()
