"""Time the norm and paged flash-decode kernels of several checkouts of
the PyTorch port on one card, in alternating fresh processes.

Each run is a fresh process whose working directory is one checkout. It
calls that checkout's public wrappers ``layer_norm_fwd``,
``rms_norm_fwd``, ``layer_norm_bwd``, ``rms_norm_bwd`` and
``flash_decode`` (so an older checkout runs it too) on inputs made on the
card from a seed, and reads each call's device time from a
``torch.profiler`` trace (the kernels whose names start ``ln_fwd_``,
``rms_fwd_``, or hold ``norm_bwd`` or ``flash_decode``; host time
excluded). Cases:

- ``ln_fwd_bf16``, ``ln_fwd_f32``, ``rms_fwd_bf16`` and ``rms_fwd_f32``:
  the forwards at ``[8192, 1024]``, and ``ln_fwd_serving``, the LayerNorm
  forward at the serving step's ``[8, 1024]`` fp32; each also warm (one
  input set: ``warm_ms``), and ``F.layer_norm`` / ``F.rms_norm`` on the
  same inputs, cold and warm (``library_ms``, ``library_warm_ms``: every
  kernel of the call); each with the CUDA-event time of a back-to-back
  call of the wrapper, of its launcher under the custom op (``_launch``,
  ``_launch_rms``) and of the library on the warm set, the median of 25
  batches (``call_ms``, ``launch_call_ms``, ``library_call_ms``: at ``[8,
  1024]`` the host's cost a call);
- ``ln_fwd_wide_bf16``, ``ln_fwd_wide_f32``, ``rms_fwd_wide_bf16`` and
  ``rms_fwd_wide_f32``: the same at ``[1024, 32768]``, rows wider than the
  team kernels take;
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

    python3 tools/torch_kernel_ab.py _tree/parent . --rounds 2 \
        [--cases fwd]

Prints the card's name and power limit, one ``kab_json`` line per
checkout, case and round (device ms, its split by kernel, the bound), and
a summary of the device times per checkout and case; each process's
output goes to ``--logs`` (default ``_tree/kernel_ab``, which
``.gitignore`` lists). Needs one CUDA device.
"""
from __future__ import annotations

import argparse
import json
import sys

from _torch_ab import run_sides

CHILD = r'''
import json
import sys
import torch
import torch.nn.functional as F
from torch.profiler import ProfilerActivity, profile
from apex_tpu_torch.ops.flash_decode import flash_decode
from apex_tpu_torch.ops.layer_norm import (layer_norm_bwd, layer_norm_fwd,
                                           rms_norm_bwd, rms_norm_fwd)

# the module (the package re-exports a function of the same name)
ln_mod = sys.modules["apex_tpu_torch.ops.layer_norm"]

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


def call_ms(fn, batches=25, iters=40):
    """CUDA-event ms a call of ``fn``, called back to back (host cost
    included): the median of ``batches`` batches of ``iters`` calls."""
    fn()
    torch.cuda.synchronize()
    t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    per = []
    for _ in range(batches):
        t0.record()
        for _ in range(iters):
            fn()
        t1.record()
        t1.synchronize()
        per.append(t0.elapsed_time(t1) / iters)
    return sorted(per)[batches // 2]


def rotating(sets):
    it = {"i": -1}

    def nxt():
        it["i"] = (it["i"] + 1) % len(sets)
        return sets[it["i"]]
    return nxt


def norm_fwd(case, rms, dt, rows=8192, hidden=1024):
    g = torch.Generator(device=dev).manual_seed(8)
    es = torch.tensor([], dtype=dt).element_size()
    # x and y of the sets together past the 50 MB L2, with a set to spare
    n_sets = max(2, -(-50 * 2 ** 20 // (2 * rows * hidden * es)) + 1)
    sets = [(torch.randn(rows, hidden, generator=g, device=dev) * 2
             + 0.5).to(dt) for _ in range(n_sets)]
    w = torch.randn(hidden, generator=g, device=dev)
    b = torch.randn(hidden, generator=g, device=dev)
    wl, bl = w.to(dt), b.to(dt)
    if rms:
        fn, match = (lambda x: rms_norm_fwd(x, w)), "::rms_fwd_"
        launch = lambda x: ln_mod._launch_rms(x, w, 1e-5)
        lib = lambda x: F.rms_norm(x, (hidden,), wl, 1e-5)
    else:
        fn, match = ((lambda x: layer_norm_fwd(x, w, b, eps=1e-5)),
                     "::ln_fwd_")
        launch = lambda x: ln_mod._launch(x, w, b, 1e-5)
        lib = lambda x: F.layer_norm(x, (hidden,), wl, bl, 1e-5)
    nxt = rotating(sets)
    ms, by = device_ms(lambda: fn(nxt()), match)
    warm, _ = device_ms(lambda: fn(sets[0]), match)
    lib_ms, _ = device_ms(lambda: lib(nxt()), "")
    lib_warm, _ = device_ms(lambda: lib(sets[0]), "")
    nbytes = 2 * rows * hidden * es + (1 if rms else 2) * (hidden + rows) * 4
    return {"case": case, "device_ms": ms, "warm_ms": warm, "kernels": by,
            "library_ms": lib_ms, "library_warm_ms": lib_warm,
            "call_ms": call_ms(lambda: fn(sets[0])),
            "launch_call_ms": call_ms(lambda: launch(sets[0])),
            "library_call_ms": call_ms(lambda: lib(sets[0])),
            "sets": n_sets, "bound_ms": nbytes / HBM * 1e3}


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


cases = {
    "ln_fwd_bf16": lambda c: norm_fwd(c, False, torch.bfloat16),
    "ln_fwd_f32": lambda c: norm_fwd(c, False, torch.float32),
    "rms_fwd_bf16": lambda c: norm_fwd(c, True, torch.bfloat16),
    "rms_fwd_f32": lambda c: norm_fwd(c, True, torch.float32),
    "ln_fwd_serving": lambda c: norm_fwd(c, False, torch.float32, rows=8),
    "ln_fwd_wide_bf16": lambda c: norm_fwd(c, False, torch.bfloat16,
                                           rows=1024, hidden=32768),
    "ln_fwd_wide_f32": lambda c: norm_fwd(c, False, torch.float32,
                                          rows=1024, hidden=32768),
    "rms_fwd_wide_bf16": lambda c: norm_fwd(c, True, torch.bfloat16,
                                            rows=1024, hidden=32768),
    "rms_fwd_wide_f32": lambda c: norm_fwd(c, True, torch.float32,
                                           rows=1024, hidden=32768),
    "ln_bwd": lambda c: norm(c, False, torch.float32),
    "rms_bwd_bf16": lambda c: norm(c, True, torch.bfloat16, n_sets=4),
    "rms_bwd_f32": lambda c: norm(c, True, torch.float32),
    "decode_serving": lambda c: decode(c, [0, 1, 7, 8, 64, 129, 191, 192],
                                       32, 8),
    "decode_8x1024": lambda c: decode(c, [1024] * 8, 128, 4),
    "decode_64x1024": lambda c: decode(c, [1024] * 64, 128, 2)}
only = sys.argv[1:]
for name, case in cases.items():
    if not only or any(o in name for o in only):
        print("kab_json " + json.dumps(case(name)), flush=True)
        torch.cuda.empty_cache()
'''


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("trees", nargs="+", help="checkouts to compare")
    ap.add_argument("--rounds", type=int, default=1)
    ap.add_argument("--logs", default="_tree/kernel_ab",
                    help="directory for each process's output")
    ap.add_argument("--cases", nargs="*", default=[],
                    help="run only the cases whose names hold one of these")
    args = ap.parse_args()
    dev = {}
    for i, t, rec in run_sides(args.trees, CHILD, "kab_json",
                               rounds=args.rounds, logs=args.logs,
                               argv=lambda s: args.cases):
        path = args.trees[t]
        rec.update(tree=path, run=i)
        print("kab_json " + json.dumps(rec), flush=True)
        dev.setdefault((rec["case"], path), []).append(
            (rec["device_ms"], rec.get("call_ms")))
    for (case, path), v in sorted(dev.items()):
        print(f"{case} {path}: device ms "
              f"{', '.join(str(d) for d, _ in v)}; call ms "
              f"{', '.join(str(c) for _, c in v)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
