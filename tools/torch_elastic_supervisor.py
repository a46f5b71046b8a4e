"""Elastic training supervisor CLI for the PyTorch port — run a world of
fake hosts under supervision, survive kills and hangs, resume
elastically (counterpart of ``tools/elastic_supervisor.py``).

The command-line face of :class:`apex_tpu_torch.resilience.elastic.
Supervisor`: launches N copies of the built-in fake-host training
program (``apex_tpu_torch/resilience/_elastic_host.py``; swap in your own
with ``--cmd``), watches exit codes and per-host heartbeat files, and
restarts the world with auto-resume from the newest COMMITTED checkpoint
when a host dies or hangs. ``--reshape`` changes the world size on a
chosen restart — topology-elastic resume re-flattens the packed
optimizer state onto the new world bit-exactly. The hosts run on the
card (all of them share it) unless ``--device cpu`` is given.

Usage::

    # 4 fake hosts on the card, 24 steps, checkpoints + heartbeats
    # under RUNDIR
    python tools/torch_elastic_supervisor.py --world 4 --steps 24 \
        --run-dir RUNDIR

    # on the CPU; chaos: SIGKILL host 2 at step 7 of incarnation 0,
    # then shrink the world to 2 hosts on the restart
    python tools/torch_elastic_supervisor.py --world 4 --steps 24 \
        --run-dir RUNDIR --device cpu --chaos 0:2:kill@7 --reshape 1:2

    # your own training program (placeholders expanded per host)
    python tools/torch_elastic_supervisor.py --world 2 --steps 0 \
        --run-dir RUNDIR --cmd "python train.py --rank {host} \
        --world {world}"

``--chaos INCARNATION:HOST:SPEC`` arms a
:class:`~apex_tpu_torch.resilience.chaos.ChaosHost` fault spec
(``kill@N``, ``kill_write@N``, ``kill_barrier@N``, ``wedge@N[:S]``) on
one host of one incarnation via the child's environment
(``APEX_TPU_ELASTIC_CHAOS``); repeatable. ``--reshape
INCARNATION:WORLD`` sets the world size used FROM that incarnation on;
repeatable.

Exit codes: 0 = the world completed, 1 = the world failed past
``--max-restarts``, 2 = usage/infra error.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HOST_PROGRAM = os.path.join(
    REPO_ROOT, "apex_tpu_torch", "resilience", "_elastic_host.py")


def parse_chaos(specs):
    """``["0:2:kill@7", ...]`` -> {(incarnation, host): spec}."""
    out = {}
    for item in specs or []:
        try:
            inc, host, spec = item.split(":", 2)
            out[(int(inc), int(host))] = spec
        except ValueError:
            raise SystemExit(
                f"--chaos wants INCARNATION:HOST:SPEC, got {item!r}")
    return out


def parse_reshape(specs):
    """``["1:2", ...]`` -> {incarnation: world}."""
    out = {}
    for item in specs or []:
        try:
            inc, world = item.split(":", 1)
            out[int(inc)] = int(world)
        except ValueError:
            raise SystemExit(
                f"--reshape wants INCARNATION:WORLD, got {item!r}")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="Supervise an elastic world of fake training hosts")
    ap.add_argument("--world", type=int, required=True,
                    help="initial world size (number of fake hosts)")
    ap.add_argument("--steps", type=int, default=24,
                    help="training steps for the built-in host program")
    ap.add_argument("--run-dir", required=True,
                    help="holds ckpt/, heartbeats/, losses.txt, "
                         "events.jsonl")
    ap.add_argument("--cmd", default=None,
                    help="custom host argv template; placeholders "
                         "{host} {world} {incarnation} {run_dir}")
    ap.add_argument("--save-every", type=int, default=3)
    ap.add_argument("--heartbeat-timeout", type=float, default=60.0)
    ap.add_argument("--startup-timeout", type=float, default=300.0)
    ap.add_argument("--barrier-timeout", type=float, default=60.0)
    ap.add_argument("--max-restarts", type=int, default=3)
    ap.add_argument("--chaos", action="append", default=[],
                    metavar="INC:HOST:SPEC",
                    help="arm a ChaosHost fault (repeatable)")
    ap.add_argument("--reshape", action="append", default=[],
                    metavar="INC:WORLD",
                    help="world size from incarnation INC on "
                         "(repeatable)")
    ap.add_argument("--device", default="cuda",
                    help="where the built-in hosts train: the card "
                         "(default) or cpu")
    ap.add_argument("--json", action="store_true",
                    help="emit the summary as JSON")
    args = ap.parse_args(argv)

    try:
        from apex_tpu_torch.resilience import Supervisor, WorldFailedError
        from apex_tpu_torch.telemetry import JsonlRecorder
    except Exception as e:  # infra, not a supervision failure
        print(f"cannot import apex_tpu_torch: {type(e).__name__}: {e}",
              file=sys.stderr)
        return 2

    run_dir = os.path.abspath(args.run_dir)
    os.makedirs(run_dir, exist_ok=True)
    ckpt = os.path.join(run_dir, "ckpt")
    hb_dir = os.path.join(run_dir, "heartbeats")
    losses = os.path.join(run_dir, "losses.txt")
    events = os.path.join(run_dir, "events.jsonl")
    chaos = parse_chaos(args.chaos)
    reshape = parse_reshape(args.reshape)

    def build_cmd(host, world, incarnation):
        if args.cmd:
            import shlex

            tpl = args.cmd.format(host=host, world=world,
                                  incarnation=incarnation,
                                  run_dir=run_dir)
            return shlex.split(tpl)
        return [sys.executable, HOST_PROGRAM,
                "--host", host, "--world", world,
                "--steps", args.steps, "--root", ckpt,
                "--losses", losses, "--heartbeat-dir", hb_dir,
                "--save-every", args.save_every,
                "--barrier-timeout", args.barrier_timeout,
                "--events", events, "--device", args.device]

    def host_env(host, world, incarnation):
        env = {"PYTHONPATH": REPO_ROOT + os.pathsep
               + os.environ.get("PYTHONPATH", "")}
        spec = chaos.get((incarnation, host))
        if spec:
            env["APEX_TPU_ELASTIC_CHAOS"] = spec
        return env

    def on_restart(incarnation, world):
        # incarnation is the one that just FAILED; the next one is +1
        return reshape.get(incarnation + 1, world)

    sup = Supervisor(
        build_cmd, args.world, heartbeat_dir=hb_dir,
        heartbeat_timeout_s=args.heartbeat_timeout,
        startup_timeout_s=args.startup_timeout,
        max_restarts=args.max_restarts,
        sink=JsonlRecorder(events),
        host_env=host_env, on_restart=on_restart)
    try:
        summary = sup.run()
    except WorldFailedError as e:
        print(f"world failed: {e}", file=sys.stderr)
        if args.json:
            print(json.dumps(sup.summary(ok=False, wall_s=0.0),
                             indent=2))
        return 1
    except Exception as e:
        print(f"supervisor infra error: {type(e).__name__}: {e}",
              file=sys.stderr)
        return 2
    if args.json:
        print(json.dumps(summary, indent=2))
    else:
        print(f"world done: {summary['incarnations']} incarnation(s), "
              f"{summary['restarts']} restart(s), worlds "
              f"{summary['world_history']}, {summary['wall_s']}s")
        for inc in summary["incidents"]:
            print(f"  incident: {inc['kind']} host {inc['host']} "
                  f"(incarnation {inc['incarnation']}) -> recovered in "
                  f"{inc['recovery_s']}s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
