"""Time the norm backward and paged flash-decode kernels of several
checkouts of the PyTorch port on one card, in alternating fresh processes.

Each run is a fresh process whose working directory is one checkout. It
calls that checkout's public wrappers ``layer_norm_bwd``, ``rms_norm_bwd``
and ``flash_decode`` (so an older checkout runs it too) on inputs made on
the card from a seed, and reads each call's device time from a
``torch.profiler`` trace (the kernels whose names hold ``norm_bwd`` or
``flash_decode``; host time excluded). Cases:

- ``ln_bwd``: the LayerNorm backward at ``[8192, 1024]`` fp32, the GPT-2
  345M train step's shape (x and dy fp32);
- ``rms_bwd_bf16`` and ``rms_bwd_f32``: the RMSNorm backward at ``[8192,
  1024]``;
- ``decode_serving``: ``[8, 16, 64]`` bf16 at the serving leg's lengths
  (592 tokens, 32 pages of 8 a slot);
- ``decode_8x1024`` and ``decode_64x1024``: 8 and 64 slots, each at
  ``kv_len`` 1024 (128 pages of 8).

Timing loops cycle through input sets larger than the 50 MB L2 together,
so the kernels read device memory as the train step and the serving
layers do. Each checkout's kernels are built first, all builds started
together. The checkouts run in the order given, then in reverse
(``--rounds`` such blocks), so a drift of the card over the call falls on
every side.

    python3 tools/torch_kernel_ab.py _tree/parent . --rounds 2

Prints the card's name and power limit, one ``kab_json`` line per
checkout, case and round (device ms, its split by kernel, the bound), and
a summary of the device times per checkout and case; each process's
output goes to ``--logs`` (default ``_tree/kernel_ab``, which
``.gitignore`` lists). Needs one CUDA device.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

BUILD = r'''
from apex_tpu_torch import _build
_build.build()
'''

CHILD = r'''
import json
import torch
from torch.profiler import ProfilerActivity, profile
from apex_tpu_torch.ops.flash_decode import flash_decode
from apex_tpu_torch.ops.layer_norm import layer_norm_bwd, rms_norm_bwd

HBM = 3.35e12
dev = torch.device("cuda", 0)


def device_ms(fn, match, iters=50):
    """Device ms a call of the kernels whose names hold ``match``, and
    the split by kernel name."""
    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        by = {e.key: e.device_time_total / 1e3 / iters
              for e in prof.key_averages() if match in e.key}
        if by:
            return sum(by.values()), by
    return None, {}


def rotating(sets):
    it = {"i": -1}

    def nxt():
        it["i"] = (it["i"] + 1) % len(sets)
        return sets[it["i"]]
    return nxt


def norm(case, rms, dt, rows=8192, hidden=1024, n_sets=2):
    g = torch.Generator(device=dev).manual_seed(9)
    sets = []
    for _ in range(n_sets):
        x = (torch.randn(rows, hidden, generator=g, device=dev) * 3
             + 1).to(dt)
        dy = torch.randn(rows, hidden, generator=g, device=dev).to(dt)
        xf = x.float()
        if rms:
            stats = (torch.rsqrt((xf * xf).mean(1, keepdim=True) + 1e-5),)
        else:
            mu = xf.mean(1, keepdim=True)
            stats = (mu, torch.rsqrt(((xf - mu) ** 2).mean(
                1, keepdim=True) + 1e-5))
        sets.append((dy, x, *stats))
    w = torch.randn(hidden, generator=g, device=dev)
    nxt = rotating(sets)
    fn = rms_norm_bwd if rms else layer_norm_bwd
    ms, by = device_ms(lambda: fn(*nxt(), w), "norm_bwd")
    es = x.element_size()
    nbytes = 3 * rows * hidden * es + (1 if rms else 2) * rows * 4 \
        + (2 if rms else 3) * hidden * 4
    return {"case": case, "device_ms": ms, "kernels": by,
            "bound_ms": nbytes / HBM * 1e3}


def decode(case, lens, mp, n_pools, n=16, d=64, ps=8):
    g = torch.Generator(device=dev).manual_seed(10)
    b = len(lens)
    pages = b * mp + 1
    pools = [tuple(torch.randn(pages, n, ps, d, generator=g,
                               device=dev).to(torch.bfloat16)
                   for _ in range(2)) for _ in range(n_pools)]
    q = torch.randn(b, n, d, generator=g, device=dev).to(torch.bfloat16)
    pt = (torch.randperm(pages - 1, generator=g, device=dev)[:b * mp] + 1
          ).reshape(b, mp).to(torch.int32)
    kl = torch.tensor(lens, dtype=torch.int32, device=dev)
    nxt = rotating(pools)
    ms, by = device_ms(lambda: flash_decode(q, *nxt(), pt, kl),
                       "flash_decode")
    tokens = sum(lens)
    nbytes = (2 * tokens * n * d * 2 + 2 * q.numel() * 2
              + sum(-(-L // ps) for L in lens) * 4 + b * 4)
    return {"case": case, "device_ms": ms, "kernels": by,
            "bound_ms": nbytes / HBM * 1e3}


cases = [lambda: norm("ln_bwd", False, torch.float32),
         lambda: norm("rms_bwd_bf16", True, torch.bfloat16, n_sets=4),
         lambda: norm("rms_bwd_f32", True, torch.float32),
         lambda: decode("decode_serving", [0, 1, 7, 8, 64, 129, 191, 192],
                        32, 8),
         lambda: decode("decode_8x1024", [1024] * 8, 128, 4),
         lambda: decode("decode_64x1024", [1024] * 64, 128, 2)]
for case in cases:
    print("kab_json " + json.dumps(case()), flush=True)
    torch.cuda.empty_cache()
'''


def _env(path: str):
    return dict(os.environ, PYTHONPATH=os.path.abspath(path))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("trees", nargs="+", help="checkouts to compare")
    ap.add_argument("--rounds", type=int, default=1)
    ap.add_argument("--logs", default="_tree/kernel_ab",
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
        out = subprocess.run([sys.executable, "-c", CHILD], cwd=path,
                             env=_env(path), capture_output=True, text=True,
                             timeout=900)
        with open(os.path.join(args.logs, f"{i}_{t}.log"), "w") as f:
            f.write(out.stdout + out.stderr)
        if out.returncode:
            sys.stderr.write(out.stdout[-4000:] + out.stderr[-4000:])
            raise SystemExit(f"{path}: exit {out.returncode}")
        for line in out.stdout.splitlines():
            if not line.startswith("kab_json "):
                continue
            rec = json.loads(line.split(" ", 1)[1])
            rec.update(tree=path, run=i)
            print("kab_json " + json.dumps(rec), flush=True)
            dev.setdefault((rec["case"], path), []).append(rec["device_ms"])
    for (case, path), v in sorted(dev.items()):
        print(f"{case} {path}: device ms {', '.join(str(x) for x in v)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
