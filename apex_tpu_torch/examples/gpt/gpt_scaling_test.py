"""GPT scaling study: iteration time against model size, with and
without activation offload (counterpart of
``examples/gpt/gpt_scaling_test.py``, the fork's study of
``tests/L0/run_transformer/gpt_scaling_test.py``).

For each layer count of the ladder, and each ``cpu_offload`` setting,
one eager train-step loop over ``gpt_model_provider`` with
``FusedAdam``: a first step, then ``--steps`` timed ones. Each run
prints the two lines the reference's harness parses::

    Number of Parameters: <n>
    Average Iteration Time: <seconds> s

and the results go to ``--out`` (JSON; no plot).

    python -m apex_tpu_torch.examples.gpt.gpt_scaling_test       # the card
    python -m apex_tpu_torch.examples.gpt.gpt_scaling_test \\
        --device cpu --layers 1 2 --steps 1 --hidden 64 --seq 32  # CPU
"""
from __future__ import annotations

import argparse
import json
import time

import torch


def parse(argv=None):
    p = argparse.ArgumentParser(description="GPT scaling study")
    p.add_argument("--layers", type=int, nargs="+", default=[2, 4, 8, 12],
                   help="model-size ladder (transformer layer counts)")
    p.add_argument("--hidden", type=int, default=512)
    p.add_argument("--heads", type=int, default=8)
    p.add_argument("--vocab", type=int, default=8192)
    p.add_argument("--batch", type=int, default=4)
    p.add_argument("--seq", type=int, default=512)
    p.add_argument("--steps", type=int, default=5)
    p.add_argument("--offload", choices=["off", "on", "both"], default="both")
    p.add_argument("--out", default="gpt_scaling.json")
    p.add_argument("--device", default=None,
                   help="torch device (default: the card; 'cpu' runs the "
                        "plain PyTorch path)")
    return p.parse_args(argv)


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_config(args, layers: int, cpu_offload: bool, device) -> dict:
    from apex_tpu_torch._tree import tree_leaves, value_and_grad
    from apex_tpu_torch.optimizers import FusedAdam
    from apex_tpu_torch.transformer.testing import (
        GPTConfig,
        gpt_model_provider,
    )

    cfg = GPTConfig(
        num_layers=layers, hidden_size=args.hidden,
        num_attention_heads=args.heads, vocab_size=args.vocab,
        max_position_embeddings=args.seq, hidden_dropout=0.0,
        attention_dropout=0.0, compute_dtype=torch.bfloat16)
    params, _, loss_fn = gpt_model_provider(
        cfg, torch.Generator(device=device).manual_seed(0),
        cpu_offload=cpu_offload, device=device)
    n_params = sum(p.numel() for p in tree_leaves(params))
    tokens = torch.randint(
        0, cfg.vocab_size, (args.batch, args.seq), device=device,
        generator=torch.Generator(device=device).manual_seed(1))
    labels = torch.roll(tokens, -1, dims=1)
    opt = FusedAdam(lr=1e-4)
    state = opt.init(params)

    def step(params, state):
        loss, grads = value_and_grad(
            lambda p: loss_fn(p, tokens, labels), params)
        params, state = opt.step(grads, state, params)
        return params, state, loss

    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    params, state, loss = step(params, state)  # the first step
    _sync(device)
    t0 = time.perf_counter()
    for _ in range(args.steps):
        params, state, loss = step(params, state)
    final = float(loss)  # waits for the last step
    avg_s = (time.perf_counter() - t0) / args.steps
    peak = (torch.cuda.max_memory_allocated(device) / 2 ** 30
            if device.type == "cuda" else None)
    # the reference's harness greps these two prefixes
    print(f"Number of Parameters: {n_params}")
    print(f"Average Iteration Time: {avg_s:.6f} s", flush=True)
    return {"layers": layers, "cpu_offload": cpu_offload,
            "n_params": n_params, "avg_iteration_time_s": avg_s,
            "final_loss": final, "peak_gib": peak}


def main(argv=None):
    from apex_tpu_torch._device import resolve_device

    args = parse(argv)
    device = resolve_device(args.device)
    offloads = {"off": [False], "on": [True], "both": [False, True]}[
        args.offload]
    results = []
    for layers in args.layers:
        for off in offloads:
            print(f"=== layers={layers} cpu_offload={off} ===", flush=True)
            results.append(run_config(args, layers, off, device))
            if device.type == "cuda":
                torch.cuda.empty_cache()
    with open(args.out, "w") as f:
        json.dump({"config": vars(args), "results": results}, f, indent=2)
    print(f"wrote {args.out}")
    return results


if __name__ == "__main__":
    main()
