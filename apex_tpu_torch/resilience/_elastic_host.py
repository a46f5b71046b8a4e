"""Fake-host training program for the elastic supervisor (counterpart of
``apex_tpu/resilience/_elastic_host.py``).

One *fake host* of a supervised world. Each host runs the full bucketed
flat-gradient lifecycle (``GradBuckets`` packing, ``LossScaler.
unscale_flat`` — kernel #24 on the card — packed ``FusedAdam`` with fp32
masters — kernel #17) over a fixed global batch stream — compute is
replicated, the checkpoint is SHARDED: host ``h`` writes rows
``spec.shard_bounds(world)[h]`` of every flat buffer through the
two-phase :class:`~apex_tpu_torch.resilience.elastic.
ElasticCheckpointManager` commit, heartbeats every step for the
supervisor's hang detector, and auto-resumes from the newest *committed*
step on launch — including onto a different world size than the
checkpoint was saved from (topology-elastic resume re-flattens the
packed state bit-exactly).

Because the global batch is world-invariant, the per-step loss records
(``S <step> <f32.hex()>`` appended by host 0) are byte-identical across
any kill/restart/reshape history — the oracle every chaos test holds
the service to.

The model is the JAX host's MLP (``N_IN, HID, BATCH = 8, 16, 4``, tanh,
dropout at keep 0.9, mean squared error), in fp32. Its batches come from
NumPy seeded by the step index and its dropout from a
``torch.Generator`` (whose state is the train state's ``rng``), so the
records are not the JAX host's: ``jax.random`` is not reproduced.

It runs on the card unless given ``--device cpu``. Chaos faults arrive
as a :meth:`ChaosHost.parse` spec via ``--chaos`` or the
``APEX_TPU_ELASTIC_CHAOS`` environment variable (the supervisor's
per-incarnation arming channel, named as in the JAX package).

Driven by ``tools/torch_elastic_supervisor.py``,
``tests/test_torch_elastic_supervisor.py`` and ``chip_smoke.py`` phase
17.

Exit codes: 0 = reached ``--steps``; killed hosts die by SIGKILL (no
code of their own); 17 = preempted (SIGTERM emergency flush).
"""
import argparse
import json
import os
import sys
import time

import numpy as np
import torch

from apex_tpu_torch import _device
from apex_tpu_torch._tree import value_and_grad
from apex_tpu_torch.amp.scaler import LossScaler
from apex_tpu_torch.optimizers import FusedAdam
from apex_tpu_torch.resilience import (
    ChaosHost,
    ElasticCheckpointManager,
    HangWatchdog,
    Heartbeat,
    IndexedBatches,
    capture,
    grad_buckets_for_world,
    resume_or_init,
)
from apex_tpu_torch.resilience.state import tree_map
from apex_tpu_torch.telemetry import JsonlRecorder, TaggedRecorder

N_IN, HID, BATCH = 8, 16, 4
KEEP = 0.9


def batch_fn(i, device=None):
    """The GLOBAL batch for step-index ``i`` — identical on every host
    and at every world size, so the training math is world-invariant
    and loss records are byte-comparable across reshapes. Like every
    helper here it builds on the card unless ``device='cpu'`` is given."""
    device = _device.resolve_device(device)
    rng = np.random.default_rng([1234, int(i)])
    x = rng.standard_normal((BATCH, N_IN)).astype(np.float32)
    y = (x.sum(axis=1, keepdims=True)
         + 0.1 * rng.standard_normal((BATCH, 1))).astype(np.float32)
    return torch.from_numpy(x).to(device), torch.from_numpy(y).to(device)


def init_params(device=None):
    device = _device.resolve_device(device)
    rng = np.random.default_rng(0)
    w1 = (0.3 * rng.standard_normal((N_IN, HID))).astype(np.float32)
    w2 = (0.3 * rng.standard_normal((HID, 1))).astype(np.float32)
    return {"b1": torch.zeros(HID, device=device),
            "w1": torch.from_numpy(w1).to(device),
            "w2": torch.from_numpy(w2).to(device)}


def init_rng(device=None):
    """The dropout generator, seeded; its state is the train state's
    ``rng``."""
    device = _device.resolve_device(device)
    return torch.Generator(device=device).manual_seed(42)


def build_world(world: int, *, chunk: int = 256,
                bucket_cap_mb: float = 0.005, device=None):
    """(params, buckets, opt, scaler) for ``world`` — the
    world-parameterized layout every host of an incarnation shares."""
    params = init_params(device)
    buckets = grad_buckets_for_world(
        params, world, bucket_cap_mb=bucket_cap_mb, chunk_size=chunk)
    opt = FusedAdam(lr=1e-2, packed=True, packed_spec=buckets.spec,
                    master_weights=True)
    sc = LossScaler("dynamic", init_scale=2.0 ** 8, scale_window=5)
    return params, buckets, opt, sc


def loss_of(p, x, y, keep):
    h = torch.tanh(x @ p["w1"] + p["b1"])
    h = torch.where(keep, h, torch.zeros_like(h))
    pred = h @ p["w2"]
    return torch.mean((pred - y) ** 2)


def make_train_step(buckets, opt, sc):
    """The step every fake host runs — also the REFERENCE (in-process,
    uninterrupted) oracle of the tests and ``chip_smoke.py``, so the
    byte-identity proofs compare against the literal same computation.
    ``gen`` is the dropout generator, advanced by one draw a step."""

    def train_step(params, opt_state, sstate, gen, x, y):
        keep = torch.rand((x.shape[0], HID), generator=gen,
                          device=x.device) < KEEP
        loss, grads = value_and_grad(
            lambda p: sc.scale_loss(sstate, loss_of(p, x, y, keep)),
            params)
        flat = buckets.concat(buckets.pack(grads))
        flat, new_ss = sc.unscale_flat(sstate, flat,
                                       out_dtype=torch.float32)
        params, opt_state = opt.step(flat, opt_state, params,
                                     found_inf=new_ss.found_inf)
        return (params, opt_state, sc.update_scale(new_ss),
                loss / sstate.loss_scale)

    return train_step


def fresh_state(world: int, step: int = 0, position: int = 0,
                device=None):
    """The step-``step`` template of a ``world`` incarnation."""
    device = _device.resolve_device(device)
    p, _, o, s = build_world(world, device=device)
    return capture(step, p, o.init(p), scaler=s.init_state(device),
                   rng=init_rng(device).get_state(),
                   data={"position": position})


def reference_records(world: int, steps: int, *, start_state=None,
                      device=None):
    """Loss records ``{step: f32.hex()}`` of an UNINTERRUPTED run at
    ``world``'s layout, from ``start_state`` (or step 0) to ``steps`` —
    the oracle the supervised/chaos runs must match byte-for-byte.
    Returns ``(records, final state)``."""
    device = _device.resolve_device(device)
    _, buckets, opt, sc = build_world(world, device=device)
    train_step = make_train_step(buckets, opt, sc)
    st = start_state if start_state is not None else fresh_state(
        world, device=device)
    params, opt_state, sstate = st.params, st.opt_state, st.scaler
    gen = torch.Generator(device=device)
    gen.set_state(st.rng)
    done = int(st.step)
    it = IndexedBatches(lambda i: batch_fn(i, device),
                        position=int(st.data["position"]))
    records = {}
    while done < steps:
        x, y = next(it)
        params, opt_state, sstate, loss = train_step(
            params, opt_state, sstate, gen, x, y)
        records[done] = float(loss).hex()
        done += 1
    final = capture(done, params, opt_state, scaler=sstate,
                    rng=gen.get_state(), data=it.state())
    return records, final


def _settled(state):
    """A copy of ``state`` that no later step touches (the packed step
    updates its buffers in place): what the preemption handler flushes,
    whenever between two bytecodes SIGTERM lands."""
    return tree_map(lambda t: t.clone() if isinstance(t, torch.Tensor)
                    else t, state)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--host", type=int, required=True)
    ap.add_argument("--world", type=int, required=True)
    ap.add_argument("--steps", type=int, required=True)
    ap.add_argument("--root", required=True)
    ap.add_argument("--losses", default=None,
                    help="host 0 appends 'S <step> <loss.hex()>' lines")
    ap.add_argument("--heartbeat-dir", required=True)
    ap.add_argument("--save-every", type=int, default=3)
    ap.add_argument("--barrier-timeout", type=float, default=60.0)
    ap.add_argument("--chaos", default=None,
                    help="ChaosHost.parse spec, e.g. 'kill@7' "
                         "(or env APEX_TPU_ELASTIC_CHAOS)")
    ap.add_argument("--events", default=None,
                    help="JSONL event sink (host/rank-tagged)")
    ap.add_argument("--step-sleep", type=float, default=0.0)
    ap.add_argument("--device", default="cuda",
                    help="the card (default) or cpu")
    ap.add_argument("--launches", default=None,
                    help="write this host's kernel launch counts (JSON) "
                         "here when it reaches --steps")
    args = ap.parse_args(argv)
    torch.set_num_threads(1)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print("elastic host: no CUDA device (pass --device cpu)",
              file=sys.stderr)
        return 2

    chaos_spec = args.chaos or os.environ.get("APEX_TPU_ELASTIC_CHAOS", "")
    chaos = ChaosHost.parse(chaos_spec) if chaos_spec else None

    sink = None
    if args.events:
        # appended to: the supervisor and every host of every
        # incarnation share the one stream
        sink = TaggedRecorder(JsonlRecorder(args.events, append=True),
                              owns_sink=True,
                              tags={"host": args.host, "rank": args.host})
    # the in-host watchdog: hang events from supervised hosts carry the
    # host id/rank
    watchdog = HangWatchdog(
        timeout_s=max(10.0, 2 * args.barrier_timeout), sink=sink,
        context={"host": args.host, "rank": args.host})

    hb = Heartbeat(os.path.join(args.heartbeat_dir, f"hb-{args.host}"),
                   args.host)
    _, buckets, opt, sc = build_world(args.world, device=device)
    train_step = make_train_step(buckets, opt, sc)

    mgr = ElasticCheckpointManager(
        args.root, host=args.host, world=args.world,
        keep_n=2, async_save=True, save_every=args.save_every,
        sink=sink, watchdog=watchdog,
        barrier_timeout_s=args.barrier_timeout, chaos=chaos)
    state, resumed = resume_or_init(
        mgr, lambda: fresh_state(args.world, device=device))
    it = IndexedBatches(lambda i: batch_fn(i, device),
                        position=int(state.data["position"]))
    params, opt_state, sstate = state.params, state.opt_state, state.scaler
    gen = torch.Generator(device=device)
    gen.set_state(state.rng)
    done = int(state.step)

    latest = {"state": _settled(capture(
        done, params, opt_state, scaler=sstate, rng=gen.get_state(),
        data=it.state()))}
    mgr.install_preemption_handler(lambda: latest["state"])

    hb.beat(done)  # first beat: init/resume finished, loop entered
    # startup rendezvous: wait until every peer of this incarnation has
    # beaten once, so the world steps roughly in lockstep instead of a
    # fast host racing steps ahead while a peer is still starting. Best
    # effort — a peer that never shows up is the SUPERVISOR's incident
    # to detect, not ours to die on.
    deadline = time.monotonic() + args.barrier_timeout
    while time.monotonic() < deadline:
        if all(os.path.exists(os.path.join(args.heartbeat_dir,
                                           f"hb-{h}"))
               for h in range(args.world)):
            break
        time.sleep(0.02)
    losses_f = open(args.losses, "a") if (args.losses
                                          and args.host == 0) else None
    try:
        while done < args.steps:
            x, y = next(it)
            params, opt_state, sstate, loss = train_step(
                params, opt_state, sstate, gen, x, y)
            done += 1
            if losses_f is not None:
                losses_f.write(f"S {done - 1} {float(loss).hex()}\n")
                losses_f.flush()
            if chaos is not None:
                stall = chaos.take_wedge(done)
                if stall is not None:
                    time.sleep(stall)  # wedged: NO heartbeat
                chaos.at_step_boundary(done)
            hb.beat(done)
            latest["state"] = _settled(capture(
                done, params, opt_state, scaler=sstate,
                rng=gen.get_state(), data=it.state()))
            mgr.maybe_save(latest["state"])
            if mgr.preempted:
                return 17
            if args.step_sleep:
                time.sleep(args.step_sleep)
        if losses_f is not None:
            losses_f.write(f"F {done} {float(sstate.loss_scale)}\n")
            losses_f.flush()
    finally:
        if losses_f is not None:
            losses_f.close()
    mgr.close()
    watchdog.close()
    if args.launches:
        with open(args.launches, "w") as f:
            json.dump(_device.launch_counts(), f)
    return 0


if __name__ == "__main__":
    rc = main()
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(rc)
