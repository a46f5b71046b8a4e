"""Long-context GPT training with context parallelism (ring attention):
the PyTorch port of ``examples/long_context/train_long_context.py``.

The sequence is sharded over a context-parallel group end to end
(embeddings, ``transformer.context_parallel.ring_attention``, MLP and
loss all run on ``s / cp`` tokens a rank), so the longest trainable
context grows with the group::

    python -m apex_tpu_torch.examples.long_context.train_long_context --seq 8192 --steps 5
    python -m apex_tpu_torch.examples.long_context.train_long_context --world 4 --seq 8192
    python -m apex_tpu_torch.examples.long_context.train_long_context --world 4 --device cpu --seq 2048 --steps 3

``--world N`` spawns a gloo world of N processes here (the JAX script's
``--cpu N`` devices), all on ``--device`` (the card by default; gloo
shares one card between them, its hops through host memory); without it
one process runs the whole sequence (a ring of one: flash attention).
``--zigzag`` (default) uses the load-balanced layout
(``zigzag_indices``: rank r holds global chunks ``(r, 2cp-1-r)``),
``--no-zigzag`` the contiguous one. The weights are ``init_gpt_params``
from a ``torch.Generator`` seeded 0 and the tokens from one seeded 1,
or, with ``--init``, an ``.npz`` file's (``params/<path>`` and
``tokens [batch, seq]``: the JAX script's draws, for a comparison).
bf16 compute on the card, fp32 on the CPU, fp32 params and pytree
``FusedAdam``, as the JAX script. Prints the JAX script's per-step
``step i: loss ... ms ... tok/s`` lines on rank 0 and returns them as
``(step, loss, ms, tokens/s)``.
"""
from __future__ import annotations

import argparse
import json
import os
import tempfile
import time

import numpy as np
import torch
import torch.distributed as dist


def parse(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--world", type=int, default=0,
                   help="run N context-parallel ranks as a gloo world of "
                        "processes")
    p.add_argument("--seq", type=int, default=2048)
    p.add_argument("--batch", type=int, default=2)
    p.add_argument("--layers", type=int, default=4)
    p.add_argument("--hidden", type=int, default=256)
    p.add_argument("--heads", type=int, default=8)
    p.add_argument("--vocab", type=int, default=8192)
    p.add_argument("--steps", type=int, default=5)
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--zigzag", action=argparse.BooleanOptionalAction,
                   default=True)
    p.add_argument("--device", default=None,
                   help="cuda (default) or cpu")
    p.add_argument("--init", default=None,
                   help=".npz with params/<path> and tokens in place of "
                        "the seeded draws")
    return p.parse_args(argv)


def _load(path, params, dev):
    with np.load(path) as f:
        def walk(tree, prefix):
            if isinstance(tree, dict):
                return {k: walk(v, f"{prefix}/{k}") for k, v in tree.items()}
            return torch.from_numpy(np.asarray(f[prefix], np.float32)).to(dev)
        return walk(params, "params"), torch.from_numpy(
            np.asarray(f["tokens"], np.int64)).to(dev)


def train(args, rank: int = 0, world: int = 1):
    """This rank's steps; returns the ``(step, loss, ms, tokens/s)``
    rows."""
    from ..._device import resolve_device
    from ..._tree import value_and_grad
    from ...optimizers import FusedAdam
    from ...transformer.context_parallel import zigzag_indices
    from ...transformer.testing import GPTConfig, gpt_loss, init_gpt_params

    dev = resolve_device(args.device)
    say = print if rank == 0 else (lambda *a, **k: None)
    kind = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    say(f"devices: {world} x {kind}  seq {args.seq} = "
        f"{args.seq // world}/rank  zigzag={args.zigzag}", flush=True)
    cfg = GPTConfig(
        num_layers=args.layers, hidden_size=args.hidden,
        num_attention_heads=args.heads, vocab_size=args.vocab,
        max_position_embeddings=args.seq, hidden_dropout=0.0,
        attention_dropout=0.0, apply_query_key_layer_scaling=False,
        compute_dtype=torch.bfloat16 if dev.type == "cuda"
        else torch.float32,
        context_parallel_axis="cp", context_parallel_zigzag=args.zigzag)
    params = init_gpt_params(cfg, torch.Generator().manual_seed(0),
                             device=dev)
    tokens = torch.randint(0, args.vocab, (args.batch, args.seq),
                           generator=torch.Generator().manual_seed(1)).to(dev)
    if args.init is not None:
        params, tokens = _load(args.init, params, dev)
    labels = torch.roll(tokens, -1, dims=1)
    if args.zigzag:
        perm = torch.from_numpy(zigzag_indices(args.seq, world)[0]).to(dev)
        tokens, labels = tokens[:, perm], labels[:, perm]
    s_loc = args.seq // world
    tokens = tokens[:, rank * s_loc:(rank + 1) * s_loc].contiguous()
    labels = labels[:, rank * s_loc:(rank + 1) * s_loc].contiguous()
    opt = FusedAdam(lr=args.lr)
    state = opt.init(params)
    rows = []
    for it in range(args.steps):
        t0 = time.perf_counter()
        loss, grads = value_and_grad(
            lambda p: gpt_loss(cfg, p, tokens, labels), params)
        params, state = opt.step(grads, state, params)
        loss = float(loss)
        dt = time.perf_counter() - t0
        tps = args.batch * args.seq / dt
        say(f"step {it}: loss {loss:.4f}  {dt * 1e3:.1f} ms  {tps:,.0f} "
            f"tok/s{'  (warm-up)' if it == 0 else ''}", flush=True)
        rows.append((it, loss, dt * 1e3, tps))
    if not np.isfinite(rows[-1][1]):
        raise AssertionError(f"loss {rows[-1][1]} is not finite")
    say("done.", flush=True)
    return rows


def _rank(rank, world, tmp, args):
    torch.set_num_threads(1)
    if args.device in (None, "cuda") and torch.cuda.is_available():
        torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method="file://"
                            + os.path.join(tmp, "store"),
                            world_size=world, rank=rank)
    try:
        rows = train(args, rank, world)
    finally:
        dist.destroy_process_group()
    if rank == 0:
        with open(os.path.join(tmp, "rows.json"), "w") as f:
            json.dump(rows, f)


def main(argv=None):
    args = parse(argv)
    if args.world <= 1:
        return train(args)
    import torch.multiprocessing as mp

    ctx = mp.get_context("spawn")
    with tempfile.TemporaryDirectory() as tmp:
        procs = [ctx.Process(target=_rank, args=(r, args.world, tmp, args))
                 for r in range(args.world)]
        for p in procs:
            p.start()
        for p in procs:
            p.join()
        failed = {r: p.exitcode for r, p in enumerate(procs) if p.exitcode}
        if failed:
            raise SystemExit(f"--world {args.world}: ranks exited with "
                             f"{failed}")
        with open(os.path.join(tmp, "rows.json")) as f:
            return [tuple(r) for r in json.load(f)]


if __name__ == "__main__":
    main()
