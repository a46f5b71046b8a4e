"""How much an in-flight async checkpoint save slows the 345M train step
on the card, by the way the save stages the card tensors to the host.

One process: the 345M loss-scaled, clipped unfused step (``chip_smoke``'s
phase 17 (a) step, 24 layers, seq 1024, batch 8) runs ``--steps`` steps
after one ``CheckpointManager.save`` of its ~5 GB state, for each
staging variant in turn (each its own manager and directory):

- ``pinned``: the manager's own path — clones on the card, then one
  pinned host buffer, allocated at the first save and reused, filled on a
  stream of its own after a CUDA event (``hostio.to_host``), written by
  ``SAVE_WRITERS`` (2) host threads;
- ``pinned_reused``: the same after a first save has allocated the
  buffer (the second save is timed);
- ``pageable``: the clones copied to pageable host tensors instead;
- ``pinned_8_writers``: ``pinned_reused`` with 8 host writer threads,
  the host IO engine's default, in place of ``SAVE_WRITERS``.

Prints, per variant, the step times before the save, while it is in
flight and after it, and the background thread's copy, write and total
seconds, as one ``stall_json`` line.

    python3 tools/torch_ckpt_stall.py --steps 40
"""
import argparse
import json
import os
import shutil
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as c  # noqa: E402
from apex_tpu_torch import _build  # noqa: E402
from apex_tpu_torch.optimizers import FusedAdam  # noqa: E402
from apex_tpu_torch.amp import LossScaler  # noqa: E402
from apex_tpu_torch.resilience import CheckpointManager, capture  # noqa: E402
from apex_tpu_torch.resilience import manager as mgr_mod  # noqa: E402


def _pageable_copy(self, snapshot, ready, reuse=True):
    card = [k for k, v in snapshot.items()
            if isinstance(v, torch.Tensor) and v.device.type == "cuda"]
    if not card:
        return snapshot
    side = torch.cuda.Stream(snapshot[card[0]].device)
    out = dict(snapshot)
    with torch.cuda.stream(side):
        if ready is not None:
            side.wait_event(ready)
        for k in card:
            out[k] = snapshot[k].to("cpu")
    side.synchronize()
    return out


def run_variant(name, dev, cfg, steps, timings):
    params = c.p17_params(cfg, dev)
    opt = FusedAdam(lr=1e-4, master_weights=True, packed=True)
    sc = LossScaler("dynamic")
    ostate, ss = opt.init(params), sc.init_state(dev)
    step = c.p17_step_fn(cfg, opt, sc)
    root = tempfile.mkdtemp(prefix=f"stall_{name}_")
    mgr = CheckpointManager(root, keep_n=1, async_save=True)
    real_copy, real_writers = mgr_mod.CheckpointManager._host_copy, \
        mgr_mod.SAVE_WRITERS
    if name == "pageable":
        mgr_mod.CheckpointManager._host_copy = _pageable_copy
    if name == "pinned_8_writers":
        mgr_mod.SAVE_WRITERS = 8
    phases = {}

    def timed_copy(self, *a, **k):
        t0 = time.perf_counter()
        out = mgr_mod.CheckpointManager._inner_copy(self, *a, **k)
        phases["copy_s"] = time.perf_counter() - t0
        return out

    mgr_mod.CheckpointManager._inner_copy = \
        mgr_mod.CheckpointManager._host_copy
    mgr_mod.CheckpointManager._host_copy = timed_copy
    try:
        k = 0
        if name in ("pinned_reused", "pinned_8_writers"):
            mgr.save(capture(0, params, ostate, scaler=ss), blocking=True)
        times, flight = [], []
        for k in range(steps):
            if k == 5:
                mgr.save(capture(k, params, ostate, scaler=ss))
                t_save = time.perf_counter()
            t0 = time.perf_counter()
            params, ostate, ss, loss = step(params, ostate, ss,
                                            c.p17_batch(k, dev))
            float(loss)
            times.append((time.perf_counter() - t0) * 1e3)
            flight.append(k >= 5 and mgr._thread is not None
                          and mgr._thread.is_alive())
        mgr.wait_until_finished()
        phases["total_s"] = time.perf_counter() - t_save
    finally:
        mgr_mod.CheckpointManager._host_copy = real_copy
        mgr_mod.SAVE_WRITERS = real_writers
        shutil.rmtree(root, ignore_errors=True)
    before = times[1:5]
    during = [t for t, f in zip(times, flight) if f]
    after = [t for i, (t, f) in enumerate(zip(times, flight))
             if i > 5 and not f]
    rec = {"variant": name,
           "before_ms": float(np.median(before)),
           "during_ms_median": float(np.median(during)) if during else None,
           "during_ms_max": max(during) if during else None,
           "steps_in_flight": len(during),
           "after_ms": float(np.median(after)) if after else None,
           "save_step_ms": times[5], **phases}
    timings.append(rec)
    print(json.dumps(rec), flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=40)
    ap.add_argument("--variants", default="pinned,pinned_reused,pageable,"
                                          "pinned_8_writers")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    _build.kernels()
    cfg = c.p17_cfg(c.P12_LAYERS)
    timings = []
    for name in args.variants.split(","):
        run_variant(name, dev, cfg, args.steps, timings)
        torch.cuda.empty_cache()
    print(c.card_line())
    print("stall_json " + json.dumps(timings))
    return 0


if __name__ == "__main__":
    sys.exit(main())
