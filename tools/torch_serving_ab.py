"""Time the GPT-2 345M serving trace of several checkouts of the PyTorch
port on one card, in alternating fresh processes.

Each run is a fresh process whose working directory is one checkout. It
serves ``chip_smoke.py``'s phase-3 trace through that checkout's public
``ServingEngine`` (so an older checkout runs it too): GPT-2 345M bf16
(24 x 1024, 16 heads, vocab 50304, max positions 256, random weights from
seed 0), 8 slots, ``prefill_chunk=8``, 16 requests of 128 random prompt
tokens + 64 new, one arriving every 4 steps, after a 4-token warm-up
request. It prints tokens/s, the step p50 / p99 and the number of
steps, then a profiled stretch (8 requests of 128 + 16 arriving at
once, ``chip_smoke.profile_steps``' trace): wall ms, device busy ms and
the idle share (``torch.profiler``, profiler on).

A side is ``PATH`` or ``PATH@KWARGS`` with ``KWARGS`` a JSON object of
extra engine keyword arguments, e.g. ``.@{"trace": false}``. The sides
run in the order given, then in reverse (``--rounds`` such blocks), so a
drift of the card or the host over the call falls on every side.

    python3 tools/torch_serving_ab.py _tree/parent . '.@{"trace": false}'

Prints the card's name and power limit, one ``sab_json`` line per side
and round, and a summary per side; each process's output goes to
``--logs`` (default ``_tree/serving_ab``, which ``.gitignore`` lists).
Needs one CUDA device.
"""
from __future__ import annotations

import argparse
import json
import sys

from _torch_ab import run_sides

CHILD = r'''
import json, sys, time
import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile
from apex_tpu_torch.serving import Request, ServingEngine
from apex_tpu_torch.transformer.testing import GPTConfig, init_gpt_params

kw = json.loads(sys.argv[1])
dev = torch.device("cuda", 0)
torch.backends.cuda.matmul.allow_tf32 = False
cfg = GPTConfig(num_layers=24, hidden_size=1024, num_attention_heads=16,
                vocab_size=50304, max_position_embeddings=256,
                compute_dtype=torch.bfloat16)
params = init_gpt_params(cfg, torch.Generator(device=dev).manual_seed(0),
                         device=dev)
eng = ServingEngine(cfg, params, n_slots=8, prefill_chunk=8, device=dev, **kw)
rng = np.random.default_rng(0)
eng.generate([Request(prompt=[int(t) for t in rng.integers(0, 50304, 16)],
                      max_new_tokens=4)])


def trace(n, new, every):
    return [Request(prompt=[int(t) for t in rng.integers(0, 50304, 128)],
                    max_new_tokens=new, arrival_step=every * i)
            for i in range(n)]


torch.cuda.synchronize()
eng.generate(trace(16, 64, 4))
torch.cuda.synchronize()
st = eng.last_stats
# the profiled stretch is short: a trace of every op of a whole run
# takes minutes to gather
reqs = trace(8, 16, 0)
with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as p:
    t0 = time.perf_counter()
    eng.generate(reqs)
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
busy = sum(e.device_time_total for e in p.key_averages()
           if e.device_time_total > 0
           and e.device_type.name == "CUDA") / 1e3
print("sab_json " + json.dumps({
    "tokens_per_sec": st["tokens_per_sec"], "step_p50_ms":
    st["step_ms"]["p50"], "step_p99_ms": st["step_ms"]["p99"],
    "steps": st["steps"], "profiled_wall_ms": wall, "busy_ms": busy,
    "idle_share": 1 - busy / wall}), flush=True)
'''


def _side(spec: str):
    path, _, kw = spec.partition("@")
    return path, (kw or "{}")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("sides", nargs="+", help="PATH or PATH@KWARGS")
    ap.add_argument("--rounds", type=int, default=1)
    ap.add_argument("--logs", default="_tree/serving_ab",
                    help="directory for each process's output")
    args = ap.parse_args()
    sides = [_side(s) for s in args.sides]
    got = {}
    for i, s, rec in run_sides([p for p, _ in sides], CHILD, "sab_json",
                               rounds=args.rounds, logs=args.logs,
                               argv=lambda s: [sides[s][1]]):
        rec.update(side=args.sides[s], run=i)
        print("sab_json " + json.dumps(rec), flush=True)
        got.setdefault(args.sides[s], []).append(rec)
    for side, recs in got.items():
        print(f"{side}: tokens/s "
              + ", ".join(f"{r['tokens_per_sec']:.1f}" for r in recs)
              + "; step p50 ms "
              + ", ".join(f"{r['step_p50_ms']:.3f}" for r in recs)
              + "; idle " + ", ".join(f"{r['idle_share']:.3f}"
                                      for r in recs))
    return 0


if __name__ == "__main__":
    sys.exit(main())
