"""Peak memory and step time of the ResNet-50 O2 bf16 train step with the
port's BatchNorm backward written by hand (``resnet._BatchNormTrain``)
against autograd through the same forward ops, on one card.

Both sides compute flax's training BatchNorm with the same operations in
the same order (fp32 statistics, E[x^2] - E[x]^2, the biased variance);
they differ only in what the backward keeps and runs: the hand-written
one keeps the conv output in its own dtype (bf16 under O2) and the
per-channel vectors, autograd keeps what its elementwise ops save (the
fp32 copy of the input and the centred input). Each round runs the leg
hand-written, autograd, autograd, hand-written through
``chip_smoke.resnet_leg`` (ResNet-50, 224 px, batch 256, one staged
batch, 2 warm-up and ``--timed`` timed steps, flax's dtypes asserted,
peak memory over the timed steps), so a drift of the card over the call
falls on both sides; the first step's loss must agree bit for bit.

    python3 tools/torch_resnet_bn_ab.py [--rounds 1] [--timed 6]

Prints one ``bn_ab_json`` line per run and a summary of the p50s and the
peaks per side. Needs one CUDA device.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))

import chip_smoke  # noqa: E402
from apex_tpu_torch.examples.imagenet import resnet  # noqa: E402


class AutogradBatchNorm:
    """``resnet._BatchNormTrain``'s forward, differentiated by autograd."""

    @staticmethod
    def apply(x, scale, bias, eps):
        xf = x.to(scale.dtype)
        mean = xf.mean(resnet._DIMS)
        var = ((xf * xf).mean(resnet._DIMS) - mean * mean).clamp_min(0.0)
        rstd = torch.rsqrt(var + eps)
        pc = resnet._per_channel
        y = (xf - pc(mean)) * pc(rstd * scale) + pc(bias)
        return y, mean.detach(), var.detach()


SIDES = {"hand": resnet._BatchNormTrain, "autograd": AutogradBatchNorm}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rounds", type=int, default=1)
    ap.add_argument("--timed", type=int, default=6)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_resnet_bn_ab: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    print(chip_smoke.card_line(), flush=True)
    x, y = chip_smoke._resnet_batch(dev)
    runs = []
    try:
        for r in range(args.rounds):
            for side in ("hand", "autograd", "autograd", "hand"):
                resnet._BatchNormTrain = SIDES[side]
                torch.cuda.empty_cache()
                res = chip_smoke.resnet_leg(dev, f"O2 bf16 {side}", "O2",
                                            torch.bfloat16, 2, args.timed,
                                            x, y)[0]
                row = {"side": side, "round": r, "p50_ms": res["p50_ms"],
                       "p99_ms": res["p99_ms"], "peak_gib": res["peak_gib"],
                       "losses": res["losses"]}
                runs.append(row)
                print("bn_ab_json " + json.dumps(row), flush=True)
    finally:
        resnet._BatchNormTrain = SIDES["hand"]
    first = {row["losses"][0] for row in runs}
    for side in SIDES:
        mine = [row for row in runs if row["side"] == side]
        print(f"{side}: p50 {[round(m['p50_ms'], 2) for m in mine]} ms "
              f"(median {np.median([m['p50_ms'] for m in mine]):.2f}), peak "
              f"{[round(m['peak_gib'], 2) for m in mine]} GiB", flush=True)
    if len(first) != 1:
        print(f"first-step losses differ: {sorted(first)}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
