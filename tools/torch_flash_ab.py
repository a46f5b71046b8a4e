"""Time the flash-attention kernels of several checkouts of the PyTorch
port on one card, in alternating fresh processes.

Each run is a fresh process whose working directory is one checkout: it
imports that checkout's ``chip_smoke`` (which builds the checkout's
kernels into its own build directory, all checkouts' builds started
together first) and calls ``chip_smoke._flash_timing`` on bf16 causal
inputs made from a seed: the GPT-2 345M shape ``[8, 16, 1024, 64]`` and
``[8, 8, 1024, 128]``. The checkouts run in the order given, then in
reverse (``--rounds`` such blocks), so a drift of the card over the call
falls on every side.

    python3 tools/torch_flash_ab.py _tree/parent .

Prints one ``flash_json`` line per checkout, shape and round (forward and
backward device ms, the SDPA yardsticks, the bounds) and a summary of the
device times per checkout; each process's output goes to ``--logs``
(default ``_tree/flash_ab``, which ``.gitignore`` lists). Needs one CUDA
device.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

SHAPES = ((8, 16, 1024, 64), (8, 8, 1024, 128))

BUILD = r'''
from apex_tpu_torch import _build
_build.build()
'''

CHILD = r'''
import json, sys
import torch
import chip_smoke as c

torch.backends.cuda.matmul.allow_tf32 = False
dev = torch.device("cuda", 0)
c._build.kernels()
for shape in json.loads(sys.argv[1]):
    b, n, s, d = shape
    g = torch.Generator(device=dev).manual_seed(5)
    q, k, v, do = c._attn_case(g, dev, b, n, s, s, d, torch.bfloat16)
    o, lse = c.flash_attention_fwd(q, k, v, causal=True)
    t = c._flash_timing(q, k, v, do, o, lse, True)
    print("flash_json " + json.dumps({"shape": shape, **t}), flush=True)
    del q, k, v, do, o, lse
    torch.cuda.empty_cache()
'''


def _env(path: str):
    return dict(os.environ, PYTHONPATH=os.path.abspath(path))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("trees", nargs="+", help="checkouts to compare")
    ap.add_argument("--rounds", type=int, default=1)
    ap.add_argument("--logs", default="_tree/flash_ab",
                    help="directory for each process's output")
    args = ap.parse_args()
    os.makedirs(args.logs, exist_ok=True)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    print(card, flush=True)
    builds = [subprocess.Popen([sys.executable, "-c", BUILD], cwd=path,
                               env=_env(path), stdout=subprocess.PIPE,
                               stderr=subprocess.STDOUT, text=True)
              for path in args.trees]
    for path, p in zip(args.trees, builds):
        log, _ = p.communicate(timeout=900)
        if p.returncode:
            sys.stderr.write(log[-4000:])
            raise SystemExit(f"{path}: build exit {p.returncode}")
    order = (list(range(len(args.trees)))
             + list(reversed(range(len(args.trees))))) * args.rounds
    dev = {}
    for i, t in enumerate(order):
        path = args.trees[t]
        out = subprocess.run(
            [sys.executable, "-c", CHILD, json.dumps(SHAPES)], cwd=path,
            env=_env(path), capture_output=True, text=True, timeout=900)
        with open(os.path.join(args.logs, f"{i}_{t}.log"), "w") as f:
            f.write(out.stdout + out.stderr)
        if out.returncode:
            sys.stderr.write(out.stdout[-4000:] + out.stderr[-4000:])
            raise SystemExit(f"{path}: exit {out.returncode}")
        for line in out.stdout.splitlines():
            if not line.startswith("flash_json "):
                continue
            rec = json.loads(line.split(" ", 1)[1])
            rec.update(tree=path, run=i)
            print("flash_json " + json.dumps(rec), flush=True)
            key = (path, tuple(rec["shape"]))
            dev.setdefault(key, []).append(
                (rec["fwd"]["device_ms"], rec["bwd"]["device_ms"]))
    for (path, shape), v in dev.items():
        print(f"{path} {list(shape)}: device ms fwd "
              f"{', '.join(str(f) for f, _ in v)}; bwd "
              f"{', '.join(str(b) for _, b in v)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
