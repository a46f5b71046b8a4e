"""Sweep the launch plans of the PyTorch port's LayerNorm and RMSNorm
forward kernels on one card.

For each norm and dtype at ``[rows, hidden]`` (default the GPT-2 345M
train step's ``[8192, 1024]``, fp32 and bf16), every team shape that
covers the row (1-8 warps a row, 1-8 vectors of 16 bytes a lane, at most
32 columns a lane) runs at grids of 1, 2, 3, 4, 6 and 8 blocks an SM
(capped at one row a team), through the internal launchers with an
explicit ``NormFwdPlan``; the plan ``norm_fwd_plan`` picks runs too. Each
is timed warm (one input set, which with its output fits the 50 MB L2)
and cold (input sets rotated past 50 MB), as device ms of its kernel from
a ``torch.profiler`` trace, beside ``F.layer_norm`` / ``F.rms_norm`` on
the same inputs and the byte bound. Every plan's output is checked
against the plain version first.

    python3 tools/torch_norm_fwd_sweep.py [--rows 8192] [--hidden 1024]

Prints the card's name and power limit, one ``sweep_json`` line per
case (norm, dtype, plan), and the fastest cold plan per norm and dtype.
Needs one CUDA device.
"""
from __future__ import annotations

import argparse
import importlib
import json
import os
import sys

import torch
import torch.nn.functional as F
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from _torch_ab import card  # noqa: E402

from apex_tpu_torch import _build  # noqa: E402

# the module (the package re-exports a function of the same name)
ln = importlib.import_module("apex_tpu_torch.ops.layer_norm")

HBM = 3.35e12


def device_ms(fn, match, iters=30):
    """Device ms a call of the kernels whose names hold ``match``."""
    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        total = sum(e.device_time_total for e in prof.key_averages()
                    if match in e.key)
        if total:
            return total / 1e3 / iters
    return None


def rotating(sets):
    it = {"i": -1}

    def nxt():
        it["i"] = (it["i"] + 1) % len(sets)
        return sets[it["i"]]
    return nxt


def plans(rows, hidden, elem_bytes, n_sms):
    per = 16 // elem_bytes
    for wpr in (1, 2, 4, 8):
        for vecs in (1, 2, 4, 8):
            if vecs * per > 32 or vecs * per * 32 * wpr < hidden:
                continue
            most = -(-rows // (8 // wpr))
            for k in (1, 2, 3, 4, 6, 8):
                blocks = min(k * n_sms, most)
                rpb = -(-rows // blocks)
                yield k, ln.NormFwdPlan(-(-rows // rpb), rpb, wpr, vecs)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rows", type=int, default=8192)
    ap.add_argument("--hidden", type=int, default=1024)
    args = ap.parse_args()
    rows, hidden = args.rows, args.hidden
    card()
    dev = torch.device("cuda", 0)
    n_sms = _build.sm_count(0)
    _build.kernels()
    g = torch.Generator(device=dev).manual_seed(5)
    best = {}
    for dt in (torch.bfloat16, torch.float32):
        es = torch.tensor([], dtype=dt).element_size()
        n_sets = max(2, -(-50 * 2 ** 20 // (2 * rows * hidden * es)) + 1)
        xs = [(torch.randn(rows, hidden, generator=g, device=dev) * 2
               + 0.5).to(dt) for _ in range(n_sets)]
        w = torch.randn(hidden, generator=g, device=dev)
        b = torch.randn(hidden, generator=g, device=dev)
        wl, bl = w.to(dt), b.to(dt)
        nbytes = {"ln": 2 * rows * hidden * es + 2 * hidden * 4 + 2 * rows * 4,
                  "rms": 2 * rows * hidden * es + hidden * 4 + rows * 4}
        refs = {"ln": ln.layer_norm_reference(xs[0], w, b, 1e-5)[0],
                "rms": ln.rms_norm_reference(xs[0], w, 1e-5)[0]}
        run = {"ln": lambda x, p: ln._launch(x, w, b, 1e-5, plan=p),
               "rms": lambda x, p: ln._launch_rms(x, w, 1e-5, plan=p)}
        lib = {"ln": lambda x: F.layer_norm(x, (hidden,), wl, bl, 1e-5),
               "rms": lambda x: F.rms_norm(x, (hidden,), wl, 1e-5)}
        tol = 2e-5 if dt == torch.float32 else 2e-2
        for norm in ("ln", "rms"):
            match = f"::{norm}_fwd_"
            nxt = rotating(xs)
            rec = {"norm": norm, "dtype": str(dt)[6:], "rows": rows,
                   "hidden": hidden,
                   "bound_ms": nbytes[norm] / HBM * 1e3,
                   "library_warm_ms": device_ms(lambda: lib[norm](xs[0]),
                                                ""),
                   "library_cold_ms": device_ms(lambda: lib[norm](nxt()),
                                                "")}
            print("sweep_json " + json.dumps({**rec, "plan": "library"}),
                  flush=True)
            default = ln.norm_fwd_plan(rows, hidden, n_sms, es,
                                       rms=norm == "rms")
            cases = [("default", default)] + [
                (f"{k} an SM", p) for k, p in plans(rows, hidden, es, n_sms)]
            for label, p in cases:
                y = run[norm](xs[0], p)[0]
                err = float((y.float() - refs[norm].float()).abs().max())
                if err > tol * (1 + float(refs[norm].float().abs().max())):
                    raise SystemExit(f"{norm} {dt} {p}: max abs err {err}")
                warm = device_ms(lambda: run[norm](xs[0], p), match)
                cold = device_ms(lambda: run[norm](nxt(), p), match)
                print("sweep_json " + json.dumps({
                    "norm": norm, "dtype": str(dt)[6:], "grid": label,
                    "plan": list(p), "warm_ms": warm, "cold_ms": cold,
                    "max_abs_err": err}), flush=True)
                key = (norm, str(dt)[6:])
                if cold is not None and (key not in best
                                         or cold < best[key][0]):
                    best[key] = (cold, label, list(p))
        del xs
        torch.cuda.empty_cache()
    for (norm, dt), (ms, label, p) in sorted(best.items()):
        print(f"fastest cold {norm} {dt}: {ms:.5f} ms, plan {p} ({label})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
