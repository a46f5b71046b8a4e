"""fp8 GPT training, the e4m3 / e5m2 delayed-scaling recipe end to end:
the PyTorch port of ``examples/gpt/fp8_training.py``.

A small GPT whose four projection GEMMs a layer run
``fused_dense.fp8_fused_dense_qgrad`` (e4m3 forward, e5m2 gradients,
delayed scaling; ``torch._scaled_mm`` on the card), bf16 params over
fp32 masters in ``FusedAdam(master_weights=True)``, the per-layer states
threaded through the layers and the gradient amaxes recovered from the
carriers' gradients (``record_gpt_grad_amaxes``)::

    python -m apex_tpu_torch.examples.gpt.fp8_training         # the card
    python -m apex_tpu_torch.examples.gpt.fp8_training --cpu 1  # the CPU

``--device`` picks any device (the card by default); ``--cpu N`` runs on
the CPU, as the JAX script's N-device CPU backend does (the step uses
one device either way). The weights are the model's init from a
``torch.Generator`` seeded 0 and the tokens draws from one seeded 1, or,
with ``--init``, the arrays of an ``.npz`` file (the JAX script's
params, flattened by key path as ``params/<path>``, and ``tokens``), for
a comparison. It prints the JAX script's lines: ``step t  loss L
x_scale s  g_scale s`` every 5 steps and at the last, then ``final loss``.
"""
from __future__ import annotations

import argparse

import numpy as np
import torch


def parse(argv=None):
    p = argparse.ArgumentParser(description="fp8 GPT training example")
    p.add_argument("--layers", type=int, default=4)
    p.add_argument("--hidden", type=int, default=256)
    p.add_argument("--heads", type=int, default=8)
    p.add_argument("--vocab", type=int, default=2048)
    p.add_argument("--batch", type=int, default=4)
    p.add_argument("--seq", type=int, default=256)
    p.add_argument("--steps", type=int, default=20)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--cpu", type=int, default=0, metavar="N",
                   help="run on the CPU (the JAX script's N-device CPU "
                        "backend)")
    p.add_argument("--device", default=None,
                   help="torch device (default: the card)")
    p.add_argument("--init", default=None,
                   help=".npz with params/<path> and tokens in place of the "
                        "seeded draws")
    return p.parse_args(argv)


def _load_params(path: str, params, device):
    """``params`` with every leaf replaced by the ``.npz``'s
    ``params/<a>/<b>`` array, as bf16 on ``device``."""
    with np.load(path) as f:
        def walk(tree, prefix):
            if isinstance(tree, dict):
                return {k: walk(v, f"{prefix}/{k}") for k, v in tree.items()}
            arr = np.asarray(f["params" + prefix], np.float32)
            return torch.from_numpy(arr).to(device=device,
                                             dtype=torch.bfloat16)
        tokens = torch.from_numpy(np.asarray(f["tokens"], np.int64))
        return walk(params, ""), tokens.to(device)


def main(argv=None):
    """Train; returns the list of ``(step, loss)`` printed."""
    from ..._device import resolve_device
    from ..._tree import tree_map, value_and_grad
    from ...optimizers import FusedAdam
    from ...transformer.testing import (
        GPTConfig,
        gpt_loss,
        init_gpt_fp8_carriers,
        init_gpt_fp8_states,
        init_gpt_params,
        record_gpt_grad_amaxes,
    )

    args = parse(argv)
    if args.cpu and args.device not in (None, "cpu"):
        raise SystemExit(f"--cpu {args.cpu} runs on the CPU, not on "
                         f"--device {args.device}")
    dev = resolve_device("cpu" if args.cpu else args.device)
    cfg = GPTConfig(
        num_layers=args.layers, hidden_size=args.hidden,
        num_attention_heads=args.heads, vocab_size=args.vocab,
        max_position_embeddings=args.seq, hidden_dropout=0.0,
        attention_dropout=0.0, compute_dtype=torch.bfloat16, fp8=True)
    params = tree_map(lambda p: p.to(torch.bfloat16), init_gpt_params(
        cfg, torch.Generator().manual_seed(0), device=dev))
    if args.init is not None:
        params, tokens = _load_params(args.init, params, dev)
    else:
        tokens = torch.randint(0, cfg.vocab_size, (args.batch, args.seq),
                               generator=torch.Generator().manual_seed(1)
                               ).to(dev)
    labels = torch.roll(tokens, -1, dims=1)
    opt = FusedAdam(lr=args.lr, master_weights=True)
    opt_state = opt.init(params)
    fp8_states = init_gpt_fp8_states(cfg, dev)

    def train_step(params, opt_state, fp8_states):
        box = {}

        def loss_fn(tree):
            loss, box["states"] = gpt_loss(cfg, tree[0], tokens, labels,
                                           fp8_states=fp8_states,
                                           fp8_carriers=tree[1])
            return loss

        loss, (grads, amaxes) = value_and_grad(
            loss_fn, (params, init_gpt_fp8_carriers(cfg, dev)))
        new_states = record_gpt_grad_amaxes(cfg, box["states"], amaxes)
        params, opt_state = opt.step(grads, opt_state, params)
        return params, opt_state, new_states, loss

    printed = []
    for step in range(args.steps):
        params, opt_state, fp8_states, loss = train_step(
            params, opt_state, fp8_states)
        if step % 5 == 0 or step == args.steps - 1:
            s = fp8_states["qkv"]
            printed.append((step, float(loss)))
            print(f"step {step:3d}  loss {float(loss):.4f}  "
                  f"x_scale {float(s.x.scale[0]):.3g}  "
                  f"g_scale {float(s.g.scale[0]):.3g}", flush=True)
    print(f"final loss: {float(loss):.4f}")
    return printed


if __name__ == "__main__":
    main()
