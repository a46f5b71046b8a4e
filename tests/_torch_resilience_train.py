"""Subprocess target for the port's crash/resume tests (the counterpart of
``tests/_resilience_train.py``).

A miniature but fully-armed training run: bf16 MLP params, packed
FusedAdam (flat fp32 buffers + masters), dynamic loss scaler, a
``torch.Generator`` carried through the train state (dropout),
IndexedBatches data stream, and the telemetry metrics and numerics
states — everything ``resilience.TrainState`` claims to make resumable.
Each completed step appends ``S <step> <loss.hex()>`` to the losses file
(bit-exact loss records); the end of a full run appends a ``F
<total_steps> <loss_scale>`` summary line from the telemetry counters.

Modes (driven by tests/test_torch_crash_resume.py):

- plain: run ``--steps`` steps with checkpoints every 3, exit 0;
- ``--die-at K``: ``os._exit(13)`` immediately after step K's loss line
  — a hard crash (no cleanup, async save threads killed mid-write);
- ``--preemptable``: install the SIGTERM emergency-flush handler and
  exit 17 when preempted (optionally ``--step-sleep`` to give the
  parent time to deliver the signal).

Every invocation resumes from the newest good checkpoint automatically
(``resume_or_init``); a fresh root starts from scratch. Batches come
from NumPy seeded by the step index and dropout from the generator, so
the records are not the JAX harness's (``jax.random`` is not
reproduced); ``make_train_step(..., keep=)`` takes a dropout mask, and
the tests hold one step against the JAX harness's on the same mask.
"""
import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from apex_tpu_torch import telemetry  # noqa: E402
from apex_tpu_torch._tree import value_and_grad  # noqa: E402
from apex_tpu_torch.amp.scaler import LossScaler  # noqa: E402
from apex_tpu_torch.optimizers import FusedAdam  # noqa: E402
from apex_tpu_torch.resilience import (  # noqa: E402
    CheckpointManager, IndexedBatches, capture, resume_or_init,
)
from apex_tpu_torch.resilience.state import tree_map  # noqa: E402
from apex_tpu_torch.telemetry import numerics as tnum  # noqa: E402

N_IN, HID, BATCH = 8, 16, 4
KEEP = 0.9


def batch_fn(i):
    rng = np.random.default_rng([1234, int(i)])
    x = rng.standard_normal((BATCH, N_IN)).astype(np.float32)
    y = (x.sum(axis=1, keepdims=True)
         + 0.1 * rng.standard_normal((BATCH, 1))).astype(np.float32)
    return torch.from_numpy(x), torch.from_numpy(y)


def init_params_np():
    rng = np.random.default_rng(0)
    return {"w1": 0.3 * rng.standard_normal((N_IN, HID)),
            "b1": np.zeros((HID,)),
            "w2": 0.3 * rng.standard_normal((HID, 1))}


def init_params():
    return {k: torch.from_numpy(np.asarray(v, np.float32)).to(torch.bfloat16)
            for k, v in init_params_np().items()}


def build():
    opt = FusedAdam(lr=1e-2, packed=True, packed_chunk_size=256,
                    master_weights=True)
    sc = LossScaler("dynamic", init_scale=2.0 ** 8, scale_window=5)
    mon = tnum.NumericsMonitor(init_params(), max_consecutive_skips=4)
    return opt, sc, mon


def loss_of(p, x, y, keep):
    h = torch.tanh(x.to(torch.bfloat16) @ p["w1"] + p["b1"])
    h = torch.where(keep, h, torch.zeros_like(h))
    pred = h @ p["w2"]
    return torch.mean((pred.float() - y) ** 2)


def make_train_step(opt, sc, mon):
    """One step: ``train_step(params, opt_state, sstate, nstate, metrics,
    gen, x, y, keep=None)``; the dropout mask is drawn from ``gen`` unless
    ``keep`` is given."""

    def train_step(params, opt_state, sstate, nstate, metrics, gen, x, y,
                   keep=None):
        if keep is None:
            keep = torch.rand((x.shape[0], HID), generator=gen) < KEEP
        loss, grads = value_and_grad(
            lambda p: sc.scale_loss(sstate, loss_of(p, x, y, keep)), params)
        loss = loss / sstate.loss_scale
        grads, new_ss, nstate = sc.unscale(sstate, grads,
                                           numerics=(mon, nstate))
        params, opt_state = opt.step(grads, opt_state, params,
                                     found_inf=new_ss.found_inf)
        new_ss, metrics, nstate = sc.update_scale(
            new_ss, metrics=metrics, numerics=nstate)
        metrics = telemetry.accumulate(metrics, loss=loss, tokens=BATCH)
        return params, opt_state, new_ss, nstate, metrics, loss

    return train_step


def _settled(state):
    """A copy no later step touches (the packed step updates its buffers
    in place): what the SIGTERM handler flushes."""
    return tree_map(lambda t: t.clone() if isinstance(t, torch.Tensor)
                    else t, state)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, required=True)
    ap.add_argument("--root", required=True)
    ap.add_argument("--losses", required=True)
    ap.add_argument("--die-at", type=int, default=None)
    ap.add_argument("--preemptable", action="store_true")
    ap.add_argument("--step-sleep", type=float, default=0.0)
    ap.add_argument("--save-every", type=int, default=3)
    args = ap.parse_args()
    torch.set_num_threads(1)

    opt, sc, mon = build()
    train_step = make_train_step(opt, sc, mon)

    def init_state():
        params = init_params()
        return capture(
            0, params, opt.init(params), scaler=sc.init_state("cpu"),
            rng=torch.Generator().manual_seed(42).get_state(),
            data={"position": 0},
            metrics=telemetry.init_metrics("cpu"), numerics=mon.init("cpu"))

    mgr = CheckpointManager(args.root, keep_n=2, async_save=True,
                            save_every=args.save_every)
    state, resumed = resume_or_init(mgr, init_state)
    it = IndexedBatches(batch_fn, position=int(state.data["position"]))
    params, opt_state, sstate = state.params, state.opt_state, state.scaler
    nstate, metrics = state.numerics, state.metrics
    gen = torch.Generator()
    gen.set_state(state.rng)
    done = int(state.step)

    # seeded BEFORE the handler is armed: a SIGTERM during the first
    # step must flush the resumed/initial state
    latest = {"state": _settled(capture(
        done, params, opt_state, scaler=sstate, rng=gen.get_state(),
        data=it.state(), metrics=metrics, numerics=nstate))}
    if args.preemptable:
        mgr.install_preemption_handler(lambda: latest["state"])

    with open(args.losses, "a") as f:
        while done < args.steps:
            x, y = next(it)
            params, opt_state, sstate, nstate, metrics, loss = train_step(
                params, opt_state, sstate, nstate, metrics, gen, x, y)
            done += 1
            f.write(f"S {done - 1} {float(loss).hex()}\n")
            f.flush()
            latest["state"] = _settled(capture(
                done, params, opt_state, scaler=sstate,
                rng=gen.get_state(), data=it.state(), metrics=metrics,
                numerics=nstate))
            mgr.maybe_save(latest["state"])
            if args.die_at is not None and done == args.die_at:
                os._exit(13)  # hard crash: no cleanup, threads killed
            if mgr.preempted:
                return 17
            if args.step_sleep:
                time.sleep(args.step_sleep)
        f.write(f"F {int(metrics.total_steps)} "
                f"{float(sstate.loss_scale)}\n")
    mgr.close()
    return 0


if __name__ == "__main__":
    rc = main()
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(rc)
