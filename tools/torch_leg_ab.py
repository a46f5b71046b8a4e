"""Compare GPT-2 345M train-step legs of ``chip_smoke.py`` between two
checkouts of the PyTorch port on one card.

Each run is a fresh process whose working directory is one checkout: it
imports that checkout's ``chip_smoke`` (which builds the checkout's
kernels into its own build directory; all builds are started together
first) and drives the named legs through
``chip_smoke.train_leg`` (2 warm-up steps, ``--timed`` timed steps, launch
counts asserted, one profiled step). The runs alternate base, head, head,
base (``--rounds`` such blocks), so a drift of the host or the card over
the call falls on both sides. ``--head-legs`` runs more legs in the head's
processes only, such as a leg with the numerics monitor that the base
lacks.

    python3 tools/torch_leg_ab.py --base _tree/parent --head . \
        --legs headline --head-legs fused,fused_monitor

``fused_nonflash`` is the fused leg with ``use_flash_attention=False``
(the fused softmax kernels in place of flash attention): beside
``fused`` in the same processes it answers which attention path a step
without recompute should take. Each ``ab_json`` line also carries the leg's
peak memory in GiB.

Prints one ``ab_json`` line per leg run (checkout, round, p50 and p99 ms,
the profiled step's wall and device-busy ms and its host-side operator
count) and a summary of the p50s per checkout; each process's whole
output goes to ``chiprun_out/ab/``. Needs one CUDA device.
"""
from __future__ import annotations

import argparse
import json
import sys

from _torch_ab import run_sides

#: ``chip_smoke.train_leg`` keywords of each leg; each launches
#: ``chip_smoke.HEADLINE_LAUNCHES`` a step but where ``LAUNCHES`` says
#: otherwise
LEGS = {
    "headline": dict(fused_block=True,
                     recompute_granularity="selective_elementwise"),
    "headline_monitor": dict(fused_block=True, numerics=True,
                             recompute_granularity="selective_elementwise"),
    "fused": dict(fused_block=True),
    "fused_monitor": dict(fused_block=True, numerics=True),
    "fused_nonflash": dict(fused_block=True, use_flash_attention=False),
}
#: launches a step of the legs that do not launch HEADLINE_LAUNCHES: the
#: fused softmax's forward and backward in place of flash attention's
LAUNCHES = {
    "fused_nonflash": {"layer_norm_fwd": 25, "layer_norm_bwd": 25,
                       "softmax_fwd": 24, "softmax_bwd": 24,
                       "bias_gelu_fwd": 24, "bias_gelu_bwd": 24,
                       "bias_dropout_residual_fwd": 24,
                       "bias_dropout_residual_bwd": 24,
                       "residual_ln_fwd": 24, "residual_ln_bwd": 24,
                       "packed_adam": 1},
}

CHILD = r'''
import json, sys, time
import torch
import chip_smoke as c

legs, timed = json.loads(sys.argv[1]), int(sys.argv[2])
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
dev = torch.device("cuda", 0)
c._build.kernels()
seen = {}


def profiled(run, label, top):
    # chip_smoke.profiled's device view, plus the host's: the operators
    # the step dispatched and where their CPU time went
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    ev = prof.key_averages()
    busy = sum(e.device_time_total for e in ev
               if e.device_type.name == "CUDA") / 1e3
    cpu = [e for e in ev if e.device_type.name == "CPU"]
    n_ops = sum(e.count for e in cpu if e.key.startswith("aten::"))
    seen.update(wall=wall, busy=busy, aten_ops=n_ops)
    print(f"  profiled {label}: wall {wall:.1f} ms, busy {busy:.1f} ms, "
          f"{n_ops} aten ops", flush=True)
    for e in sorted(cpu, key=lambda e: -e.self_cpu_time_total)[:top]:
        print(f"    {e.self_cpu_time_total / 1e3:9.3f} ms self cpu  "
              f"x{e.count:6d}  {e.key[:80]}", flush=True)


c.profiled = profiled
for name, kw, launches in legs:
    seen.clear()
    leg = c.train_leg(dev, name, launches or c.HEADLINE_LAUNCHES, timed,
                      **kw)
    print("leg_json " + json.dumps({"leg": name, "p50": leg["p50"],
                                    "p99": leg["p99"], "peak": leg["peak"],
                                    **seen}), flush=True)
    torch.cuda.empty_cache()
'''


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--base", required=True)
    ap.add_argument("--head", required=True)
    ap.add_argument("--legs", default="headline")
    ap.add_argument("--head-legs", default="")
    ap.add_argument("--rounds", type=int, default=1)
    ap.add_argument("--timed", type=int, default=6)
    args = ap.parse_args()
    legs = [x for x in args.legs.split(",") if x]
    side_legs = (legs, legs + [x for x in args.head_legs.split(",") if x])
    which = ("base", "head")

    def argv(s):
        return [json.dumps([(name, LEGS[name], LAUNCHES.get(name))
                            for name in side_legs[s]]), str(args.timed)]
    p50 = {}
    for i, s, rec in run_sides([args.base, args.head], CHILD, "leg_json",
                               rounds=args.rounds, logs="chiprun_out/ab",
                               argv=argv):
        rec.update(checkout=which[s], run=i)
        print("ab_json " + json.dumps(rec), flush=True)
        p50.setdefault((which[s], rec["leg"]), []).append(rec["p50"])
    for (side, leg), v in sorted(p50.items()):
        print(f"{side} {leg}: p50 ms {', '.join(f'{x:.2f}' for x in v)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
