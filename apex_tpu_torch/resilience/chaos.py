"""Fault injection: break the stack on purpose, prove it survives
(counterpart of ``apex_tpu/resilience/chaos.py``).

- **Poisoned data** — :meth:`ChaosMonkey.poison_batches` marks a window
  of batch indices; the loop asks :meth:`ChaosMonkey.should_poison` per
  batch and :func:`poison_grads` turns it into NaN gradients on the
  device (the flag may be a host bool or a device tensor: no host
  read). Keyed by batch index, not step — after a rewind advances the
  iterator past the window, the poison is gone, exactly like a corrupt
  data shard.
- **Checkpoint write faults** — :meth:`ChaosMonkey.fail_write_at` /
  :meth:`ChaosMonkey.fail_commit_at` make the manager's write raise
  before the array write or between write and commit (the atomicity
  window); :func:`corrupt_checkpoint` truncates a committed step's files
  post-hoc (the bit-rot / partial-delete case the restore fallback must
  survive).
- **Preemption** — :func:`send_preemption` delivers a real SIGTERM to
  the current process, driving the manager's emergency-flush handler.
- **Stalls** — :class:`StallingSink` blocks inside a recorder callback
  (the shape of a wedged host callback / storage write) so the watchdog
  has something real to catch.
- **Host kills** — :class:`ChaosHost` SIGKILLs a supervised fake host of
  the elastic service at a step boundary, mid-``.part`` write or
  mid-barrier, and wedges its heartbeat.
- :class:`ServingChaos` reaches into the serving engine's seams
  (``apex_tpu_torch.serving``): logit poisoning of one request inside
  the step (the fault-isolation quarantine proof), a wedged step sync
  (the armed-watchdog proof), an engine kill mid-flight (the
  restart-with-replay proof), stolen page allocations (spurious
  preemption pressure) and forced prefix-cache evictions;
- :class:`WorkerChaos` holds the transport faults ``ServingChaos``
  arms for one worker process of a process fleet (kill, wedge, dropped
  frames), serialised to the spec string a supervisor passes its
  child;
- :func:`request_storm` builds malformed-request batches (every
  refusal path fires with a typed reason).

"""
from __future__ import annotations

import os
import pathlib
import signal
import threading
import time
from typing import Dict, Iterable, List, Optional, Sequence, Set

import numpy as np
import torch

from .._tree import tree_map

#: a wedge sleeps in slices this long, so an interrupt the hang watchdog
#: raises in the main thread lands within a slice rather than at the end
#: of the stall (``_thread.interrupt_main`` wakes no blocking sleep)
_WEDGE_SLICE_S = 0.01


class ChaosError(RuntimeError):
    """An injected fault (never raised by production code paths)."""


class ChaosMonkey:
    """Injection flags consulted by the resilience seams.

    Pass an instance as ``CheckpointManager(chaos=...)``; checkpoint
    faults arm per step and fire once.
    """

    def __init__(self):
        self._fail_write: Set[int] = set()
        self._fail_commit: Set[int] = set()
        self._poison: Set[int] = set()
        self.faults_fired: list = []

    # -- checkpoint seams (called by CheckpointManager._write) -------------
    def fail_write_at(self, *steps: int) -> "ChaosMonkey":
        """Fail the save BEFORE the array tree is written."""
        self._fail_write.update(int(s) for s in steps)
        return self

    def fail_commit_at(self, *steps: int) -> "ChaosMonkey":
        """Fail AFTER the tmp tree is fully written, BEFORE the rename —
        the exact window atomicity must cover."""
        self._fail_commit.update(int(s) for s in steps)
        return self

    def before_write(self, step: int) -> None:
        if int(step) in self._fail_write:
            self._fail_write.discard(int(step))
            self.faults_fired.append(("write", int(step)))
            raise ChaosError(f"injected write failure at step {step}")

    def before_commit(self, step: int) -> None:
        if int(step) in self._fail_commit:
            self._fail_commit.discard(int(step))
            self.faults_fired.append(("commit", int(step)))
            raise ChaosError(f"injected commit failure at step {step}")

    # -- data poisoning ----------------------------------------------------
    def poison_batches(self, batches: Iterable[int]) -> "ChaosMonkey":
        """Mark batch indices whose gradients go NaN (a corrupt shard)."""
        self._poison.update(int(b) for b in batches)
        return self

    def should_poison(self, batch_index: int) -> bool:
        return int(batch_index) in self._poison


def poison_grads(grads, poison):
    """NaN injection on the device: multiply every gradient leaf by NaN
    when ``poison`` (a host bool — the loop feeds
    ``chaos.should_poison(i)`` — or a bool tensor, read on the device:
    one step function serves both arms with no host read)."""

    def bad(g):
        flag = torch.as_tensor(poison, dtype=torch.bool, device=g.device)
        mult = torch.where(flag, torch.tensor(float("nan"), device=g.device),
                           torch.tensor(1.0, device=g.device))
        return g * mult.to(g.dtype)

    return tree_map(bad, grads)


def corrupt_checkpoint(step_dir: str, *, truncate_to: int = 4,
                       only_largest: bool = False) -> list:
    """Truncate the storage files of a COMMITTED checkpoint — post-hoc
    bit-rot the restore fallback must detect and skip.

    Default damages every file (the unambiguous total-rot case: the
    index and the arrays file alike). ``only_largest=True`` clips just
    the biggest file (the single-bad-sector case). Returns the damaged
    paths."""
    root = pathlib.Path(step_dir)
    files = [f for f in root.rglob("*") if f.is_file()]
    if not files:
        raise FileNotFoundError(f"no files under {step_dir}")
    if only_largest:
        files = [max(files, key=lambda f: f.stat().st_size)]
    for victim in files:
        with open(victim, "r+b") as f:
            f.truncate(truncate_to)
    return [str(f) for f in files]


def send_preemption(sig: int = signal.SIGTERM) -> None:
    """Deliver a real preemption notice to this process (the cloud
    SIGTERM), driving any installed emergency-flush handler."""
    os.kill(os.getpid(), sig)


class StallingSink:
    """A recorder whose ``record`` blocks — the wedged-callback fault.

    ``stall_s`` bounds the stall (so an un-watched test cannot hang
    forever); ``release`` frees it early. ``forward`` optionally passes
    records through to a real sink after the stall.
    """

    def __init__(self, stall_s: float = 30.0, *, forward=None):
        self.stall_s = float(stall_s)
        self.forward = forward
        self.stalled = threading.Event()   # set while a record is stuck
        self._release = threading.Event()
        self.records: list = []

    def record(self, rec: dict) -> None:
        self.stalled.set()
        self._release.wait(self.stall_s)
        self.records.append(dict(rec))
        if self.forward is not None:
            self.forward.record(rec)

    def add_scalar(self, name, value, step) -> None:
        self.record({"event": "scalar", "name": name, "value": value,
                     "step": step})

    def release(self) -> None:
        self._release.set()


def stall(seconds: float) -> None:
    """A plain host stall (for wrapping into callbacks under test)."""
    time.sleep(float(seconds))


class ServingChaos:
    """Fault injection for the serving engine's seams.

    Pass an instance as ``ServingEngine(chaos=...)`` — the engine
    forwards it to the scheduler for the allocation seam. Every fault
    is armed once and fires once (``faults_fired`` records what landed),
    so a recovered engine carrying the same injector does not re-die.

    - :meth:`poison_request` — turn one request's logits non-finite
      inside the step (via its poison mask) at a chosen engine step, or
      at its first active step; the quarantine path must isolate it.
    - :meth:`wedge_step_at` — stall the step's one host sync (the shape
      of a hung device / wedged transfer); the armed
      ``resilience.HangWatchdog`` must catch it with thread stacks.
    - :meth:`kill_engine_at` — raise :class:`ChaosError` at a step
      boundary (the engine process dying mid-flight); recovery must
      replay the in-flight requests token-identically.
    - :meth:`kill_replica_at` — the fleet-scale variant: kill ONE
      replica of a replica fleet (the JAX package's ``ReplicaFleet``) at a
      fleet step boundary; the fleet must migrate its in-flight
      requests to the survivors token-identically (requests-lost = 0).
    - :meth:`fail_allocs` — the next N page allocations report a dry
      pool even when pages are free (a transient allocator fault),
      driving the preemption machinery spuriously; invariants must
      hold and every request still terminate.
    - :meth:`evict_prefix_cache` — eviction-under-pressure: force the
      engine to run N prefix-cache evictions at its next boundary even
      though the pool is not actually dry. ``evict_one`` must still
      refuse to free any page a live reader holds — the property the
      chaos trace proves, combined with :meth:`fail_allocs` driving
      real pressure through the same path.
    """

    def __init__(self):
        self._poison: Dict[int, Optional[int]] = {}  # rid -> step|None
        self._kill: Set[int] = set()
        self._kill_replica: Dict[int, Set[int]] = {}  # replica -> steps
        self._wedge: Dict[int, float] = {}
        self._fail_alloc = 0
        self._cache_evict = 0
        self._worker: Dict[int, "WorkerChaos"] = {}  # replica -> faults
        self.faults_fired: list = []

    # -- poisoned logits ---------------------------------------------------
    def poison_request(self, rid: int,
                       at_step: Optional[int] = None) -> "ServingChaos":
        """Arm a non-finite-logits fault for request ``rid`` — at engine
        step ``at_step``, or (None) its first active step."""
        self._poison[int(rid)] = None if at_step is None else int(at_step)
        return self

    def poison_mask(self, occupants: Sequence[Optional[int]],
                    step: int) -> Optional[np.ndarray]:
        """[n_slots] bool mask for this step (None = nothing fires).
        ``occupants`` is the per-slot rid (None = empty)."""
        if not self._poison:
            return None
        mask = np.zeros((len(occupants),), bool)
        fired = False
        for i, rid in enumerate(occupants):
            if rid is None or rid not in self._poison:
                continue
            when = self._poison[rid]
            if when is not None and when != int(step):
                continue
            mask[i] = True
            fired = True
            del self._poison[rid]
            self.faults_fired.append(("poison", int(rid), int(step)))
        return mask if fired else None

    # -- engine kill -------------------------------------------------------
    def kill_engine_at(self, *steps: int) -> "ServingChaos":
        """Die (raise :class:`ChaosError`) at these step boundaries."""
        self._kill.update(int(s) for s in steps)
        return self

    def maybe_kill(self, step: int) -> None:
        if int(step) in self._kill:
            self._kill.discard(int(step))
            self.faults_fired.append(("kill", int(step)))
            raise ChaosError(f"injected engine kill at step {step}")

    # -- replica kill (fleet) ----------------------------------------------
    def kill_replica_at(self, replica_id: int,
                        *steps: int) -> "ServingChaos":
        """Die (raise :class:`ChaosError`) when replica ``replica_id``
        reaches these FLEET step boundaries — the one-replica-of-N
        outage the fleet's migration path must absorb.

        Steps are the fleet's LIFETIME boundary counter
        (``ReplicaFleet.steps_run``), not per-``generate()`` offsets —
        on a fleet reused across traces, arm against ``steps_run`` at
        scheduling time (request ``arrival_step`` by contrast is
        relative to its own ``generate()`` call)."""
        self._kill_replica.setdefault(int(replica_id), set()).update(
            int(s) for s in steps)
        return self

    def maybe_kill_replica(self, replica_id: int, step: int) -> None:
        """Consulted by ``ReplicaFleet`` per replica per fleet step."""
        armed = self._kill_replica.get(int(replica_id))
        if armed and int(step) in armed:
            armed.discard(int(step))
            self.faults_fired.append(
                ("kill_replica", int(replica_id), int(step)))
            raise ChaosError(
                f"injected replica {replica_id} kill at fleet step "
                f"{step}")

    # -- wedged step sync --------------------------------------------------
    def wedge_step_at(self, step: int,
                      stall_s: float = 30.0) -> "ServingChaos":
        """The step's host sync at ``step`` blocks ``stall_s`` seconds
        (bounded, so an un-watched run cannot hang forever)."""
        self._wedge[int(step)] = float(stall_s)
        return self

    def maybe_wedge(self, step: int) -> None:
        stall_s = self._wedge.pop(int(step), None)
        if stall_s is not None:
            self.faults_fired.append(("wedge", int(step)))
            end = time.monotonic() + stall_s
            while (left := end - time.monotonic()) > 0:
                time.sleep(min(_WEDGE_SLICE_S, left))

    # -- allocator faults --------------------------------------------------
    def fail_allocs(self, n: int) -> "ServingChaos":
        """The next ``n`` page allocations look exhausted."""
        self._fail_alloc += int(n)
        return self

    def steal_alloc(self) -> bool:
        """Consulted by ``Scheduler.ensure_capacity`` per allocation."""
        if self._fail_alloc > 0:
            self._fail_alloc -= 1
            self.faults_fired.append(("alloc", None))
            return True
        return False

    # -- worker-process faults (real-process fleet) ------------------------
    def _worker_chaos(self, replica_id: int) -> "WorkerChaos":
        return self._worker.setdefault(int(replica_id), WorkerChaos())

    def kill_worker_at(self, replica_id: int, step: int, *,
                       mid_frame: bool = False) -> "ServingChaos":
        """SIGKILL replica ``replica_id``'s WORKER SUBPROCESS at its
        ``step``-th transport step — the real-process twin of
        :meth:`kill_replica_at` (a raised exception vs an actual
        corpse: exit code, torn pipes, stale heartbeat left behind).
        ``mid_frame=True`` kills halfway through writing the response
        frame AND a telemetry line, so the router's frame reader and
        ``read_jsonl`` both face a genuinely torn tail."""
        self._worker_chaos(replica_id).kill_at(step, mid_frame=mid_frame)
        return self

    def wedge_worker_at(self, replica_id: int, step: int,
                        stall_s: float = 30.0) -> "ServingChaos":
        """Replica ``replica_id``'s worker stops heartbeating and
        stalls ``stall_s`` seconds at its ``step``-th transport step
        (bounded, so an un-watched run cannot hang forever) — the
        supervisor's staleness detector must declare it hung, SIGKILL
        it and restart."""
        self._worker_chaos(replica_id).wedge_at(step, stall_s)
        return self

    def drop_frames_at(self, replica_id: int, step: int,
                       n: int = 1) -> "ServingChaos":
        """Replica ``replica_id``'s worker silently drops its next
        ``n`` response frames starting at its ``step``-th transport
        step — the lossy-transport fault: the router's RPC deadline
        must fire and the supervisor must treat the worker as gone
        (at-most-once stepping means an unacknowledged step cannot be
        retried blind)."""
        self._worker_chaos(replica_id).drop_at(step, n)
        return self

    def worker_spec(self, replica_id: int) -> str:
        """The :class:`WorkerChaos` spec string to arm replica
        ``replica_id``'s worker subprocess with (empty = unarmed) —
        the supervisor passes it through argv/env, the worker parses
        it back (:meth:`WorkerChaos.parse`). Restarted incarnations
        are launched unarmed (the supervisor passes the spec only at
        incarnation 0), so a revived worker does not re-die."""
        wc = self._worker.get(int(replica_id))
        return wc.to_spec() if wc is not None else ""

    # -- prefix-cache eviction under pressure ------------------------------
    def evict_prefix_cache(self, n: int) -> "ServingChaos":
        """Force ``n`` prefix-cache evictions at the engine's next
        scheduling boundary — synthetic pool pressure aimed straight at
        the eviction path (``PrefixCache.evict_one`` must never free a
        page a live reader holds, pressured or not)."""
        self._cache_evict += int(n)
        return self

    def take_cache_evictions(self) -> int:
        """Consulted by ``ServingEngine.run_step`` per boundary: how
        many forced evictions to run now (the budget drains once)."""
        n, self._cache_evict = self._cache_evict, 0
        if n:
            self.faults_fired.append(("cache_evict", n))
        return n


class ChaosHost:
    """Host-process faults for the elastic service's supervised fake
    hosts — where :class:`ChaosMonkey` raises exceptions a single
    process survives, this one **kills the process** (SIGKILL: no
    cleanup, no flush, exactly a preempted host) at the seams the
    two-phase commit must cover:

    - :meth:`kill_at_step` — SIGKILL at a step boundary (mid-step from
      the world's point of view: peers are between collectives).
    - :meth:`kill_in_shard_write_at` — SIGKILL mid-``.part`` write:
      the shard's arrays are on disk, its meta/rename are not — a torn
      shard that must read as garbage, never as data.
    - :meth:`kill_in_barrier_at` — SIGKILL while waiting in the commit
      barrier: this host's shard landed, the COMMIT marker never will —
      the markerless-step-is-garbage case.
    - :meth:`wedge_heartbeat_at` — stop heartbeating for ``stall_s``
      (the silent-hang fault); the supervisor's staleness detector must
      declare the host hung and restart the world.

    Faults fire once (crossing the armed step also fires, so a world
    that restarts *past* the armed step does not dodge its fault, and a
    restarted host re-running the same steps does not re-die). The
    hooks double as the manager's chaos seams: ``before_write`` (step
    boundary alias), ``mid_part_write``, ``before_commit`` /
    ``in_barrier`` (barrier window). Armed sets serialize through
    :meth:`to_spec` / :meth:`parse` (``"kill@7,kill_write@6,`` ``kill_
    barrier@5,wedge@9:30"``) so a supervisor can arm a child host
    through its environment/argv.
    """

    def __init__(self):
        self._kill_step: Optional[int] = None
        self._kill_write: Optional[int] = None
        self._kill_barrier: Optional[int] = None
        self._wedge: Optional[tuple] = None  # (step, stall_s)
        self.faults_fired: list = []

    # -- arming ------------------------------------------------------------
    def kill_at_step(self, step: int) -> "ChaosHost":
        self._kill_step = int(step)
        return self

    def kill_in_shard_write_at(self, step: int) -> "ChaosHost":
        self._kill_write = int(step)
        return self

    def kill_in_barrier_at(self, step: int) -> "ChaosHost":
        self._kill_barrier = int(step)
        return self

    def wedge_heartbeat_at(self, step: int,
                           stall_s: float = 3600.0) -> "ChaosHost":
        self._wedge = (int(step), float(stall_s))
        return self

    # -- spec round-trip (supervisor -> child host) ------------------------
    def to_spec(self) -> str:
        parts = []
        if self._kill_step is not None:
            parts.append(f"kill@{self._kill_step}")
        if self._kill_write is not None:
            parts.append(f"kill_write@{self._kill_write}")
        if self._kill_barrier is not None:
            parts.append(f"kill_barrier@{self._kill_barrier}")
        if self._wedge is not None:
            parts.append(f"wedge@{self._wedge[0]}:{self._wedge[1]}")
        return ",".join(parts)

    @classmethod
    def parse(cls, spec: str) -> "ChaosHost":
        out = cls()
        for part in (spec or "").split(","):
            part = part.strip()
            if not part:
                continue
            kind, _, arg = part.partition("@")
            if kind == "kill":
                out.kill_at_step(int(arg))
            elif kind == "kill_write":
                out.kill_in_shard_write_at(int(arg))
            elif kind == "kill_barrier":
                out.kill_in_barrier_at(int(arg))
            elif kind == "wedge":
                step, _, stall = arg.partition(":")
                out.wedge_heartbeat_at(int(step),
                                       float(stall) if stall else 3600.0)
            else:
                raise ValueError(f"unknown chaos fault {part!r} "
                                 f"(spec {spec!r})")
        return out

    # -- the kill itself ---------------------------------------------------
    @staticmethod
    def _die() -> None:
        # SIGKILL self: no handlers, no atexit, threads gone mid-write
        os.kill(os.getpid(), signal.SIGKILL)
        time.sleep(60)  # unreachable; belt for exotic platforms

    def _take(self, attr: str, step: int) -> bool:
        armed = getattr(self, attr)
        if armed is not None and int(step) >= armed:
            setattr(self, attr, None)
            return True
        return False

    # -- hooks (host loop + ElasticCheckpointManager seams) ----------------
    def at_step_boundary(self, step: int) -> None:
        if self._take("_kill_step", step):
            self.faults_fired.append(("kill", int(step)))
            self._die()

    def before_write(self, step: int) -> None:
        """Manager seam; step-boundary kills also honored here so a
        save-driven loop without an explicit boundary call still dies."""
        if self._take("_kill_step", step):
            self.faults_fired.append(("kill", int(step)))
            self._die()

    def mid_part_write(self, step: int) -> None:
        if self._take("_kill_write", step):
            self.faults_fired.append(("kill_write", int(step)))
            self._die()

    def before_commit(self, step: int) -> None:
        if self._take("_kill_barrier", step):
            self.faults_fired.append(("kill_barrier", int(step)))
            self._die()

    def in_barrier(self, step: int) -> None:
        if self._take("_kill_barrier", step):
            self.faults_fired.append(("kill_barrier", int(step)))
            self._die()

    def take_wedge(self, step: int) -> Optional[float]:
        """Stall seconds to sleep WITHOUT heartbeating at this step (the
        host loop consults it each boundary), or None."""
        if self._wedge is not None and int(step) >= self._wedge[0]:
            _, stall = self._wedge
            self._wedge = None
            self.faults_fired.append(("wedge", int(step)))
            return stall
        return None


class WorkerChaos:
    """Transport-level faults for ONE serving worker subprocess
    (the JAX package's ``serving.worker`` — the real-process fleet's replica
    host). Where :class:`ServingChaos` raises exceptions an in-process
    fleet catches, this one breaks the PROCESS and its pipes, the
    failures the fleet's supervisor (``FleetSupervisor``)
    must detect from outside:

    - :meth:`kill_at` — SIGKILL self at a transport step boundary
      (exit code + EOF on the pipes + a corpse heartbeat left behind);
      ``mid_frame=True`` dies halfway through the response frame and
      a telemetry line — the torn-tail case the frame reader and
      ``read_jsonl`` must count, not crash on.
    - :meth:`wedge_at` — stop heartbeating and stall (bounded); the
      supervisor's staleness detector must fire.
    - :meth:`drop_at` — swallow the next ``n`` response frames; the
      router's RPC deadline must fire.

    Faults fire once; crossing the armed step also fires (a worker
    that restarts past the armed step does not dodge its fault — and
    a restarted incarnation is launched unarmed anyway). Armed sets
    serialize through :meth:`to_spec` / :meth:`parse`
    (``"kill@6"`` / ``"killmid@6"`` / ``"wedge@9:30"`` /
    ``"drop@5:2"``) so the supervisor arms a child worker through its
    argv — the :class:`ChaosHost` pattern."""

    def __init__(self):
        self._kill: Optional[tuple] = None   # (step, mid_frame)
        self._wedge: Optional[tuple] = None  # (step, stall_s)
        self._drop: Optional[tuple] = None   # (step, n)
        self.faults_fired: list = []

    # -- arming ------------------------------------------------------------
    def kill_at(self, step: int, *, mid_frame: bool = False
                ) -> "WorkerChaos":
        self._kill = (int(step), bool(mid_frame))
        return self

    def wedge_at(self, step: int, stall_s: float = 30.0) -> "WorkerChaos":
        self._wedge = (int(step), float(stall_s))
        return self

    def drop_at(self, step: int, n: int = 1) -> "WorkerChaos":
        self._drop = (int(step), int(n))
        return self

    @property
    def armed(self) -> bool:
        return (self._kill is not None or self._wedge is not None
                or self._drop is not None)

    # -- spec round-trip (supervisor -> child worker) ----------------------
    def to_spec(self) -> str:
        parts = []
        if self._kill is not None:
            step, mid = self._kill
            parts.append(f"killmid@{step}" if mid else f"kill@{step}")
        if self._wedge is not None:
            parts.append(f"wedge@{self._wedge[0]}:{self._wedge[1]}")
        if self._drop is not None:
            parts.append(f"drop@{self._drop[0]}:{self._drop[1]}")
        return ",".join(parts)

    @classmethod
    def parse(cls, spec: str) -> "WorkerChaos":
        out = cls()
        for part in (spec or "").split(","):
            part = part.strip()
            if not part:
                continue
            kind, _, arg = part.partition("@")
            if kind in ("kill", "killmid"):
                out.kill_at(int(arg), mid_frame=kind == "killmid")
            elif kind == "wedge":
                step, _, stall = arg.partition(":")
                out.wedge_at(int(step),
                             float(stall) if stall else 30.0)
            elif kind == "drop":
                step, _, n = arg.partition(":")
                out.drop_at(int(step), int(n) if n else 1)
            else:
                raise ValueError(f"unknown worker chaos fault {part!r} "
                                 f"(spec {spec!r})")
        return out

    # -- hooks (consulted by the worker's transport loop) ------------------
    def take_kill(self, step: int) -> Optional[bool]:
        """``mid_frame`` flag when the kill fires at ``step`` (crossing
        the armed step fires too), else ``None``. The CALLER dies —
        mid-frame kills must first emit their torn bytes, so the kill
        itself cannot live here."""
        if self._kill is not None and int(step) >= self._kill[0]:
            _, mid = self._kill
            self._kill = None
            self.faults_fired.append(
                ("kill_worker", int(step), bool(mid)))
            return bool(mid)
        return None

    def take_wedge(self, step: int) -> Optional[float]:
        """Stall seconds to sleep WITHOUT heartbeating, or ``None``."""
        if self._wedge is not None and int(step) >= self._wedge[0]:
            _, stall = self._wedge
            self._wedge = None
            self.faults_fired.append(("wedge_worker", int(step)))
            return stall
        return None

    def take_drop(self, step: int) -> bool:
        """True when THIS step's response frame should be swallowed
        (the ``n`` budget drains one frame per step)."""
        if self._drop is not None and int(step) >= self._drop[0]:
            at, n = self._drop
            self._drop = (at, n - 1) if n > 1 else None
            self.faults_fired.append(("drop_frame", int(step)))
            return True
        return False

    @staticmethod
    def die() -> None:
        """SIGKILL self: no handlers, no atexit, pipes torn as-is."""
        os.kill(os.getpid(), signal.SIGKILL)
        time.sleep(60)  # unreachable; belt for exotic platforms


def request_storm(engine, seed: int = 0) -> List[tuple]:
    """A batch of malformed/oversized serving requests built against a
    live engine's actual limits, each paired with the
    :class:`~apex_tpu_torch.serving.RejectionCode` its refusal must carry —
    the admission front door's fuzz fixture for
    ``ServingEngine.try_submit``. Returns ``[(Request, RejectionCode),
    ...]``; none of them may leave any scheduler/allocator state
    behind."""
    from ..serving import RejectionCode, Request  # lazy: no import cycle

    rng = np.random.default_rng(seed)
    vocab = engine.cfg.vocab_size
    maxpos = engine.cfg.max_position_embeddings
    spec = engine.spec

    def toks(n):
        return [int(t) for t in rng.integers(0, vocab, size=n)]

    storm = [
        (Request(prompt=[], max_new_tokens=4),
         RejectionCode.EMPTY_PROMPT),
        (Request(prompt=toks(engine.max_prompt_len + 1),
                 max_new_tokens=1),
         RejectionCode.PROMPT_TOO_LONG),
        (Request(prompt=toks(1), max_new_tokens=0),
         RejectionCode.BAD_MAX_NEW),
        (Request(prompt=toks(1), max_new_tokens=maxpos),
         RejectionCode.EXCEEDS_MAX_SEQ),
    ]
    # pool-infeasible (needs more pages than the whole pool) is only
    # constructible when the pool is smaller than the sequence cap —
    # exactly the tiny-pool engines the chaos tests run
    need = (spec.n_usable_pages + 1) * spec.page_size
    if need <= min(maxpos, spec.max_seq_len):
        storm.append((Request(prompt=toks(1), max_new_tokens=need - 1),
                      RejectionCode.POOL_INFEASIBLE))
    return storm
