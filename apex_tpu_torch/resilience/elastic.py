"""Elastic multi-host training service: supervised fake hosts, two-phase
checkpoint commit, topology-elastic resume (counterpart of
``apex_tpu/resilience/elastic.py``).

Three pieces, each proven by killing real processes:

- :class:`Supervisor` — runs the train loop as N *fake hosts* (real
  subprocesses: ``resilience/_elastic_host.py``, on the card unless it is
  given ``--device cpu``; several hosts share the one card). It detects
  host **death** from exit codes and host **hangs** from per-host
  heartbeat files, then restarts the whole world with auto-resume from
  the newest committed checkpoint — optionally at a *different* world
  size (``on_restart``), which is what a preemption that permanently
  shrinks the cluster looks like.

- :class:`ElasticCheckpointManager` — a two-phase multi-host commit
  layered on :class:`~apex_tpu_torch.resilience.manager.CheckpointManager`:
  every host writes its own ``step_X/shard-<host>.part`` (staged
  ``shard-<host>.tmp-<pid>`` + fsync + rename, so a shard is atomic on
  its own), all hosts rendezvous on the shared directory (paced by
  :data:`~apex_tpu_torch.resilience.retry.ELASTIC_BARRIER_POLICY`), and
  host 0 *promotes* the step by writing a fsync'd ``COMMIT`` marker only
  after every shard has landed. Restore walks steps newest-first and
  treats a **markerless step as garbage** — a host SIGKILLed mid-save
  can leave half the shards behind, but it can never produce a torn
  restore.

- **Topology-elastic resume** — a checkpoint saved at world size W
  restores onto W′ hosts. The packed/bucketed optimizer state
  (:class:`~apex_tpu_torch.multi_tensor_apply.packing.PackSpec` flat
  buffers, sharded by rows across hosts at save time) is reassembled
  from the W committed shards and **re-flattened** through the fresh
  spec the W′-world builds (:func:`pack_spec_for_world` — chunking is
  rounded so the new total admits W′ equal ROW-aligned shards, checked
  by :func:`~apex_tpu_torch.multi_tensor_apply.packing.layout_findings`
  at both shard counts, the JAX auditor's ``check_reshard`` rules).
  Re-flattening is a pure per-leaf element copy (:func:`reflatten_flat`,
  on whatever device the buffer lies), so the resumed run is
  **bit-identical** to an uninterrupted W′ run from the same step.

As in the JAX package, the fake hosts shard the *checkpoint* (each
writes 1/W of the flat optimizer state) but replicate the *compute* —
every host steps the full state over the same global batch, so loss
records are world-size-invariant by construction: what this service
proves is supervision, commit atomicity and reshard bit-exactness.

Chaos: :class:`~apex_tpu_torch.resilience.chaos.ChaosHost` SIGKILLs a
host at a step boundary, mid-``.part`` write, or mid-barrier, and wedges
heartbeats; ``tests/test_torch_elastic_*.py`` and ``chip_smoke.py``
phase 17 drive them.
"""
from __future__ import annotations

import json
import os
import re
import shutil
import subprocess
import time
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from .._tree import tree_unflatten as _unflatten_template
from ..checkpoint import (
    CheckpointCorruptError,
    fsync_dir,
    fsync_tree,
    load_checkpoint,
    save_checkpoint,
    stale_writer,
)
from ..multi_tensor_apply.packing import (
    DEFAULT_CHUNK,
    ROW,
    PackSpec,
    _round_up,
    layout_findings,
)
from ..telemetry.recorder import stamp_wall
from ..telemetry.spans import Tracer, next_span_id
from .liveness import read_json_tolerant as _read_json
from .manager import (
    _STEP_DIR,
    SAVE_WRITERS,
    CheckpointManager,
    _multi_process,
    _snapshot_leaf,
)
from .retry import (
    ELASTIC_BARRIER_POLICY,
    BarrierNotReady,
    RetryPolicy,
    as_record,
    retry_call,
)
from .state import (
    TrainState,
    device_part,
    flat_leaves,
    tree_leaves,
    unflatten_like,
)

COMMIT_MARKER = "COMMIT"


# ---------------------------------------------------------------------------
# world-aware packed layouts + bit-exact re-flattening
# ---------------------------------------------------------------------------
def world_chunk_size(chunk_size: int, world: int, align: int = ROW) -> int:
    """The smallest chunk size >= ``chunk_size`` that makes every
    PackSpec total divisible into ``world`` equal ROW-aligned shards
    (totals are chunk multiples, so a chunk that is a multiple of
    ``world * align`` suffices)."""
    world = int(world)
    if world <= 0:
        raise ValueError(f"world must be > 0, got {world}")
    return _round_up(int(chunk_size), world * int(align))


def pack_spec_for_world(template, world: int, *,
                        chunk_size: int = DEFAULT_CHUNK,
                        align: int = ROW,
                        bucket_elems: Optional[int] = None) -> PackSpec:
    """A :class:`PackSpec` over ``template`` whose layout admits
    ``world`` equal ROW-aligned shards — the world-parameterized layout
    of the elastic service (different worlds produce different chunking
    and therefore different totals/offsets; that is exactly what
    :func:`reflatten_flat` bridges on resume). ``layout_findings(spec,
    shard_count=world)`` is empty for every spec this builds."""
    spec = PackSpec(template, align=align,
                    chunk_size=world_chunk_size(chunk_size, world, align),
                    bucket_elems=bucket_elems)
    spec.shard_bounds(world)  # raises if the invariant somehow fails
    return spec


def grad_buckets_for_world(template, world: int, *,
                           bucket_cap_mb: float = 25.0,
                           chunk_size: int = DEFAULT_CHUNK,
                           align: int = ROW, reduce_dtype=None):
    """:class:`~apex_tpu_torch.parallel.GradBuckets` whose shared spec
    admits ``world`` equal ROW-aligned shards (the bucketed flat-gradient
    lifecycle, elastic-checkpointable by row slicing)."""
    from ..parallel.distributed import GradBuckets

    buckets = GradBuckets(template,
                          bucket_cap_mb=bucket_cap_mb, align=align,
                          chunk_size=world_chunk_size(chunk_size, world,
                                                      align),
                          reduce_dtype=reduce_dtype)
    buckets.spec.shard_bounds(world)
    return buckets


def reflatten_flat(old_spec: PackSpec, new_spec: PackSpec, flat):
    """Re-flatten a packed buffer from ``old_spec``'s layout into
    ``new_spec``'s — the bit-exact core of topology-elastic resume.

    A pure element copy: each leaf's ``sizes[i]`` real elements move
    from their old offset to their new offset; padding is written as
    zeros (the packed-path invariant). No arithmetic, no dtype
    conversion — the output is bitwise the buffer the new world would
    have packed from the same leaf values. ``flat`` is a tensor (the
    copy runs on its device; a tensor comes back) or a NumPy array (an
    array comes back). Specs must describe the same leaf sequence
    (:func:`reshard_findings` is the full check; this enforces the
    fatal subset at runtime).
    """
    if (old_spec.shapes != new_spec.shapes
            or old_spec.dtypes != new_spec.dtypes):
        raise ValueError(
            "old and new PackSpecs describe different leaf sequences "
            f"({old_spec!r} vs {new_spec!r}) — re-flattening between "
            "them would copy elements across unrelated tensors")
    as_numpy = not isinstance(flat, torch.Tensor)
    buf = torch.from_numpy(np.ascontiguousarray(flat)) if as_numpy else flat
    if tuple(buf.shape) != (old_spec.total,):
        raise ValueError(
            f"flat buffer has shape {tuple(buf.shape)}, old spec lays out "
            f"({old_spec.total},)")
    out = torch.zeros((new_spec.total,), dtype=buf.dtype, device=buf.device)
    for o_old, o_new, n in zip(old_spec.offsets, new_spec.offsets,
                               old_spec.sizes):
        out[o_new:o_new + n] = buf[o_old:o_old + n]
    return out.numpy() if as_numpy else out


def reshard_findings(old_spec: PackSpec, new_spec: PackSpec, *,
                     old_count: Optional[int] = None,
                     new_count: Optional[int] = None) -> List[tuple]:
    """``(code, message)`` for each reason a buffer laid out under
    ``old_spec`` (``old_count`` shards) cannot be re-flattened bit-exactly
    into ``new_spec`` (``new_count`` shards): either layout failing
    :func:`layout_findings` at its shard count, or the two describing
    different leaf sequences (``reshard_leaf_mismatch``) — the rules and
    codes of the JAX auditor's ``check_reshard``, all of them errors."""
    out = [(c, f"[old] {m}") for c, m in
           layout_findings(old_spec, shard_count=old_count)]
    out += [(c, f"[new] {m}") for c, m in
            layout_findings(new_spec, shard_count=new_count)]
    if (old_spec.shapes != new_spec.shapes
            or tuple(map(str, old_spec.dtypes))
            != tuple(map(str, new_spec.dtypes))):
        out.append(("reshard_leaf_mismatch",
                    f"old and new PackSpecs describe different leaf "
                    f"sequences ({old_spec.n_leaves} vs "
                    f"{new_spec.n_leaves} leaves)"))
    return out


def sharded_leaf_indices(flat: Dict[str, object], total: int,
                         candidates: Optional[set] = None) -> List[str]:
    """The keys of :func:`~apex_tpu_torch.resilience.state.flat_leaves` output
    that are packed flat buffers of the layout (1-D, exactly ``total``
    elements) — the leaves the elastic checkpoint shards by rows; all
    other leaves (params, scaler scalars, RNG, counters) replicate in
    host 0's shard. ``candidates`` restricts the search to a key subset
    — the manager passes the opt-state subtree's keys, so a plain state
    leaf that merely COINCIDES with the packed total (totals are round
    chunk multiples) is never misclassified and row-scrambled on a
    topology change."""
    out = []
    for key, leaf in flat.items():
        if candidates is not None and key not in candidates:
            continue
        shape = tuple(getattr(leaf, "shape", ()) or ())
        if shape == (int(total),):
            out.append(key)
    return sorted(out)


# ---------------------------------------------------------------------------
# heartbeats (the supervisor's liveness signal) live in
# resilience.liveness; re-exported here, as the JAX module does
# ---------------------------------------------------------------------------
from .liveness import Heartbeat  # noqa: E402,F401  (re-export)


# ---------------------------------------------------------------------------
# two-phase multi-host checkpoint commit
# ---------------------------------------------------------------------------
class ElasticCheckpointManager(CheckpointManager):
    """Per-host view of a shared checkpoint root with two-phase commit.

    Phase 1 — every host stages its shard (``shard-<host>.tmp-<pid>``,
    fsync'd, renamed to ``shard-<host>.part``) under the step
    directory. Phase 2 — all hosts rendezvous on the directory (each
    re-poll is a :class:`~apex_tpu_torch.resilience.retry.BarrierNotReady`
    retry, so pacing, telemetry and the wall-clock bound all come from
    the one retry policy), then host 0 promotes the step with a fsync'd
    ``COMMIT`` marker. A step without the marker is **garbage**:
    :meth:`restore` skips it with a ``checkpoint_fallback`` event and
    keeps walking — a host killed at ANY point of a save can never
    yield a torn restore, only a discarded step.

    The shard split: leaves of the train state that are packed flat
    buffers (shape ``(spec.total,)``, ``spec`` = the packed
    opt-state's) are row-sliced, host ``h`` saving rows
    ``spec.shard_bounds(world)[h]``; everything else (params, scaler,
    RNG, telemetry counters, ``data``) replicates in host 0's shard.
    Restore reassembles all committed shards on the template's devices
    and — when the saved world or layout differs from this world's —
    re-flattens through :func:`reflatten_flat`, checked by
    :func:`reshard_findings` (findings raise rather than restore corrupt
    state).

    ``world`` is THIS incarnation's world size; the saved world rides
    the ``COMMIT`` marker. ``barrier_timeout_s`` bounds both the
    all-shards rendezvous and the non-zero ranks' wait-for-COMMIT.
    """

    def __init__(self, root: str, *, host: int, world: int,
                 keep_n: int = 3, async_save: bool = True,
                 save_every: int = 0, sink=None, watchdog=None,
                 retry: Optional[RetryPolicy] = None, chaos=None,
                 barrier_timeout_s: float = 120.0,
                 barrier_policy: Optional[RetryPolicy] = None):
        self.host = int(host)
        self.world = int(world)
        if not (0 <= self.host < self.world):
            raise ValueError(
                f"host {host} outside world of size {world}")
        self.barrier_timeout_s = float(barrier_timeout_s)
        self._barrier_policy = barrier_policy or ELASTIC_BARRIER_POLICY
        super().__init__(root, keep_n=keep_n, async_save=async_save,
                         save_every=save_every, sink=sink,
                         watchdog=watchdog, retry=retry, chaos=chaos)
        # save->stage->barrier->COMMIT as spans, host-tagged through the
        # same sink the structured events ride (the fake-host harness
        # wraps it in a TaggedRecorder, so multi-host traces merge).
        # Span ids carry the host so shards of one ``ckpt-<step>`` trace
        # from different PROCESSES never collide; timestamps are wall
        # clock — the only scale fake hosts on one machine share.
        self.tracer = Tracer(sink=self._record, tags={"host": self.host})

    # -- directory bookkeeping (marker-aware) ------------------------------
    def _raw_step_dirs(self) -> List[int]:
        """Every ``step_XXXXXXXX`` directory, committed or not."""
        out = []
        for name in os.listdir(self.root):
            m = _STEP_DIR.match(name)  # the base manager's one pattern
            if m:
                out.append(int(m.group(1)))
        return sorted(out)

    def _is_committed(self, step: int) -> bool:
        return os.path.exists(
            os.path.join(self._step_dir(step), COMMIT_MARKER))

    def all_steps(self) -> List[int]:
        """COMMITTED steps only — a markerless directory is garbage
        from a killed world, never a restorable checkpoint."""
        return [s for s in self._raw_step_dirs() if self._is_committed(s)]

    def _shard_dir(self, step: int, host: int) -> str:
        return os.path.join(self._step_dir(step), f"shard-{int(host)}.part")

    # -- multi-writer-safe sweeping ----------------------------------------
    def _sweep_stale_tmp(self) -> None:
        """Sweep dead writers' leftovers from the SHARED root.

        Multi-writer discipline (the satellite fix, pinned by seeded-
        violation tests): a staging dir is swept only when its recorded
        writer pid is provably dead (or our own) — a concurrent live
        host's in-flight ``shard-*.tmp-<pid>`` is NEVER deleted. Whole
        markerless step directories are swept only when (a) they are
        strictly older than the newest committed step (the world never
        re-writes those) and (b) every shard meta's writer pid is dead
        — garbage from a killed incarnation, reclaimed without racing a
        peer that is mid-save on a newer step. Valid because fake hosts
        share this machine; a ``torch.distributed`` world of several
        processes skips sweeping exactly like the base manager."""
        if _multi_process():
            return
        swept = []
        committed = [s for s in self._raw_step_dirs()
                     if self._is_committed(s)]
        newest_committed = committed[-1] if committed else None
        for step in self._raw_step_dirs():
            d = self._step_dir(step)
            try:
                entries = os.listdir(d)
            except OSError:
                continue
            # shard/marker staging with dead writers
            for name in entries:
                m = re.match(
                    rf"^(?:shard-\d+|{COMMIT_MARKER})"
                    rf"\.tmp-(\d+)(?:-emergency)?$", name)
                if m and stale_writer(int(m.group(1))):
                    victim = os.path.join(d, name)
                    if os.path.isdir(victim):
                        shutil.rmtree(victim, ignore_errors=True)
                    else:
                        try:
                            os.remove(victim)
                        except OSError:
                            pass
                    swept.append(f"step_{step:08d}/{name}")
            if self._is_committed(step):
                continue
            if newest_committed is None or step >= newest_committed:
                continue  # a live world may still be writing here
            dead = True
            for name in os.listdir(d):
                pid = None
                if name.endswith(".part"):
                    meta = _read_json(os.path.join(d, name,
                                                   "meta.json"))
                    pid = (meta or {}).get("pid")
                else:
                    # phase-1 staging (shard-*.tmp-<pid>): anything the
                    # dead-writer pass above left standing belongs to a
                    # LIVE (or unprobeable) writer — the whole dir must
                    # survive, .part or not
                    m = re.search(r"\.tmp-(\d+)", name)
                    if m:
                        pid = int(m.group(1))
                if pid is None or not stale_writer(int(pid)):
                    dead = False
                    break
            if dead:
                shutil.rmtree(d, ignore_errors=True)
                swept.append(f"step_{step:08d}")
        if swept:
            self._emit({"event": "checkpoint_gc", "host": self.host,
                        "deleted_tmp": sorted(swept)})

    # -- save (phase 1: shard; phase 2: barrier + marker) ------------------
    # ``save()`` itself is INHERITED — async tracking, emergency
    # validation and the prev-save barrier are the base manager's; the
    # elastic difference is entirely in what gets snapshotted:
    def _snapshot_and_meta(self, state: TrainState, emergency: bool):
        flat = flat_leaves(device_part(state))
        spec = getattr(state.opt_state, "spec", None)
        sharded: List[str] = []
        spec_meta = None
        if isinstance(spec, PackSpec):
            # only the opt state's own leaves are spec-laid-out; the
            # flattened tuple orders (params, opt_state, ...), so the
            # opt subtree occupies a contiguous index range
            n_params = len(tree_leaves(state.params))
            n_opt = len(tree_leaves(state.opt_state))
            opt_keys = {f"{i:05d}"
                        for i in range(n_params, n_params + n_opt)}
            sharded = sharded_leaf_indices(flat, spec.total,
                                           candidates=opt_keys)
            spec_meta = {"align": spec.align,
                         "chunk_size": spec.chunk_size,
                         "bucket_elems": spec.bucket_elems,
                         "total": spec.total,
                         "n_leaves": spec.n_leaves}
        if emergency:
            # a preemption flush cannot barrier: peers received the
            # same SIGTERM at a different step (or are already dead),
            # so the world-sized rendezvous would burn the grace window
            # and still yield markerless garbage. Instead EVERY host
            # flushes a complete single-host checkpoint — shard-0 of a
            # world-of-1 (full flat buffers = one shard), committed
            # alone. Racing hosts at the same step write byte-identical
            # trees (the compute is replicated), so the rename race is
            # harmless; restore reshards it onto any world like any
            # other topology change.
            snapshot = {k: _snapshot_leaf(v) for k, v in flat.items()}
            meta = {"step": int(state.step), "host": 0, "world": 1,
                    "pid": os.getpid(), "emergency": True,
                    "sharded": sharded, "spec": spec_meta,
                    "n_leaves": len(flat), "data": state.data,
                    "format": "apex_tpu_torch.elastic_shard.v1"}
            return snapshot, meta
        snapshot = {}
        if sharded:
            lo, hi = spec.shard_bounds(self.world)[self.host]
            for key in sharded:
                snapshot[key] = _snapshot_leaf(flat[key][lo:hi])
        if self.host == 0:
            for key, leaf in flat.items():
                if key not in sharded:
                    snapshot[key] = _snapshot_leaf(leaf)
        meta = {"step": int(state.step), "host": self.host,
                "world": self.world, "pid": os.getpid(),
                "emergency": False,
                "sharded": sharded, "spec": spec_meta,
                "n_leaves": len(flat),
                "format": "apex_tpu_torch.elastic_shard.v1"}
        if self.host == 0:
            meta["data"] = state.data
        return snapshot, meta

    def _write(self, step: int, snapshot: dict, meta: dict,
               *, lock_timeout_s: Optional[float] = None,
               ready=None) -> None:
        t0 = time.perf_counter()
        # wall-clock start of THIS save attempt: the non-zero ranks'
        # marker-freshness test orders the COMMIT's t_wall against it
        t_save_start = time.time()
        # one "checkpoint" root per host per attempt, all sharing the
        # ``ckpt-<step>`` trace; child spans decompose it into the
        # stage (shard write) and barrier/COMMIT phases
        root_sid = f"h{self.host}.{next_span_id()}"
        emergency = bool(meta.get("emergency"))
        step_dir = self._step_dir(step)
        # the meta owns the shard identity: a regular save writes THIS
        # host's shard; an emergency flush writes shard-0 of a
        # world-of-1 (see _snapshot_and_meta). The emergency tmp is
        # ALWAYS distinct from the regular writer's (base-manager
        # rule): the SIGTERM handler can interrupt a blocking same-step
        # save in this very thread (RLock re-entry), and sharing the
        # tmp would rmtree that writer's half-written tree
        w_host = int(meta.get("host", self.host))
        part_final = self._shard_dir(step, w_host)
        part_tmp = os.path.join(
            step_dir, f"shard-{w_host}.tmp-{os.getpid()}"
            + ("-emergency" if emergency else ""))
        chaos = self.chaos
        locked = self._lock.acquire(
            timeout=-1 if lock_timeout_s is None else lock_timeout_s)
        try:
            try:
                os.makedirs(step_dir, exist_ok=True)
                if not emergency and self._is_committed(step):
                    if self._is_emergency(step_dir):
                        # a same-step EMERGENCY flush already promoted
                        # this step (world-of-1, complete state): never
                        # destroy the preemption checkpoint for an
                        # equivalent regular commit
                        if self.host == 0:
                            self._gc()
                        return
                    if self.host == 0:
                        # re-saving a step that carries a stale regular
                        # COMMIT (the restore walk fell back past a
                        # corrupt committed step): void the old
                        # promotion FIRST — peers waiting on the marker
                        # must see the fresh commit, not the corpse
                        try:
                            os.remove(os.path.join(step_dir,
                                                   COMMIT_MARKER))
                            fsync_dir(step_dir)
                            self._emit({"event": "checkpoint_uncommit",
                                        "step": step})
                        except OSError:
                            pass
                if chaos is not None:
                    chaos.before_write(step)
                if os.path.exists(part_tmp):
                    shutil.rmtree(part_tmp)
                os.makedirs(part_tmp)
                snapshot = self._host_copy(snapshot, ready, reuse=locked)
                retry_call(
                    lambda: save_checkpoint(
                        os.path.join(part_tmp, "arrays"), snapshot,
                        staged=False, threads=SAVE_WRITERS),
                    policy=self.retry,
                    tag=f"elastic shard h{self.host} step {step}",
                    sink=self._record)
                if chaos is not None and hasattr(chaos, "mid_part_write"):
                    # the SIGKILL-mid-.part-write seam: arrays are on
                    # disk, meta/rename are not — a torn shard
                    chaos.mid_part_write(step)
                with open(os.path.join(part_tmp, "meta.json"),
                          "w") as f:
                    json.dump(meta, f)
                fsync_tree(part_tmp)  # arrays + meta + dir entries
                if os.path.exists(part_final):
                    if not emergency and bool((_read_json(
                            os.path.join(part_final, "meta.json"))
                            or {}).get("emergency")):
                        # a same-step emergency flush won the race
                        # while this regular write was in flight (the
                        # SIGTERM handler re-entered the RLock): that
                        # shard IS the preemption checkpoint — drop our
                        # duplicate and trust its world-of-1 commit
                        shutil.rmtree(part_tmp, ignore_errors=True)
                        return
                    # a dead incarnation's shard for the same step (the
                    # restarted world re-runs this step): replace it
                    shutil.rmtree(part_final, ignore_errors=True)
                try:
                    os.rename(part_tmp, part_final)
                except OSError:
                    if emergency and os.path.isdir(part_final):
                        # lost a same-step emergency race: the winner's
                        # tree is byte-identical (replicated compute) —
                        # success, just not ours
                        shutil.rmtree(part_tmp, ignore_errors=True)
                    else:
                        raise
                fsync_dir(step_dir)
                self._emit({"event": "shard_written", "step": step,
                            "host": self.host, "world": self.world})
                t_staged = time.time()
                self.tracer.emit(
                    "stage", f"ckpt-{step}", t_save_start, t_staged,
                    span_id=f"h{self.host}.{next_span_id()}",
                    parent_id=root_sid, step=step, host=self.host,
                    emergency=emergency, n_leaves=len(snapshot))
                if chaos is not None:
                    # base hook name, elastic meaning: after this
                    # host's shard landed, before the commit barrier
                    chaos.before_commit(step)
                self._commit_barrier(step, meta, t_save_start)
                self.tracer.emit(
                    "commit_barrier", f"ckpt-{step}", t_staged,
                    time.time(),
                    span_id=f"h{self.host}.{next_span_id()}",
                    parent_id=root_sid, step=step, host=self.host,
                    committer=self.host == 0 or emergency)
            except BaseException as e:
                self._emit({"event": "checkpoint_failed", "step": step,
                            "host": self.host, "tmp": part_tmp})
                self.tracer.emit(
                    "checkpoint", f"ckpt-{step}", t_save_start,
                    time.time(), span_id=root_sid, terminal=True,
                    step=step, host=self.host, ok=False,
                    error=f"{type(e).__name__}: {e}")
                self.tracer.dump_blackbox(
                    reason="checkpoint_failed", sink=self.tracer.sink,
                    step=step, host=self.host,
                    error=f"{type(e).__name__}: {e}")
                shutil.rmtree(part_tmp, ignore_errors=True)
                raise
            if self.host == 0:
                self._gc()
        finally:
            if locked:
                self._lock.release()
        self._emit({"event": "checkpoint_saved", "step": step,
                    "host": self.host, "world": self.world,
                    "path": step_dir,
                    "emergency": bool(meta.get("emergency")),
                    "duration_s": round(time.perf_counter() - t0, 4)})
        self.tracer.emit(
            "checkpoint", f"ckpt-{step}", t_save_start, time.time(),
            span_id=root_sid, terminal=True, step=step,
            host=self.host, world=self.world, ok=True,
            emergency=bool(meta.get("emergency")),
            duration_s=round(time.perf_counter() - t0, 4))

    def _commit_barrier(self, step: int, meta: dict,
                    t_save_start: float) -> None:
        """Phase 2. Host 0: wait for every shard, then write the
        fsync'd ``COMMIT`` marker. Hosts > 0: wait for the marker, so a
        returned save means a PROMOTED step on every host. An
        EMERGENCY flush commits alone (world-of-1 shard, no
        rendezvous): its peers got the same SIGTERM at some other step
        and will never show up."""
        import dataclasses

        step_dir = self._step_dir(step)
        chaos = self.chaos
        if meta.get("emergency"):
            self._write_commit_marker(step, meta, t_save_start)
            return
        deadline_policy = dataclasses.replace(
            self._barrier_policy, deadline=self.barrier_timeout_s)

        if self.host == 0:
            def all_shards_landed():
                if chaos is not None and hasattr(chaos, "in_barrier"):
                    chaos.in_barrier(step)
                missing = []
                for h in range(self.world):
                    shard_meta = _read_json(os.path.join(
                        self._shard_dir(step, h), "meta.json"))
                    # a stale .part from a KILLED incarnation must not
                    # satisfy the barrier: at a different world size
                    # its row extents belong to the old layout, and
                    # even at the same size committing it would race
                    # the live host's rmtree+rename replacement — only
                    # a shard whose writer is still alive (or is us)
                    # counts as landed. Dead-writer liveness is the
                    # same local-pid contract the sweep uses.
                    pid = (shard_meta or {}).get("pid")
                    if (shard_meta is None
                            or int(shard_meta.get("world", -1))
                            != self.world
                            or pid is None
                            or (int(pid) != os.getpid()
                                and stale_writer(int(pid)))):
                        missing.append(h)
                if missing:
                    raise BarrierNotReady(
                        f"step {step}: waiting on shard(s) {missing} "
                        f"of world {self.world}")

            retry_call(all_shards_landed, policy=deadline_policy,
                       tag=f"elastic commit barrier step {step}",
                       sink=self._record)
            self._write_commit_marker(step, meta, t_save_start)
        else:
            def committed():
                if chaos is not None and hasattr(chaos, "in_barrier"):
                    chaos.in_barrier(step)
                marker = _read_json(os.path.join(self._step_dir(step),
                                                 COMMIT_MARKER))
                # only a FRESH promotion satisfies the wait: a corpse
                # marker from a prior incarnation's promotion of a
                # fallen-back step (host 0 voids it at the top of its
                # re-save, but we may poll first) would report
                # "promoted" for a step about to go markerless.
                # Freshness is write-time ordering, NOT committer
                # liveness — host 0 commits only after OUR shard
                # landed, so a genuine promotion's t_wall is always
                # past this save's start, even if host 0 has already
                # finished and exited. An emergency marker counts
                # regardless: it is a complete world-of-1 checkpoint.
                fresh = marker is not None and (
                    bool(marker.get("emergency"))
                    or (int(marker.get("world", -1)) == self.world
                        and float(marker.get("t_wall", 0.0))
                        >= t_save_start))
                if not fresh:
                    raise BarrierNotReady(
                        f"step {step}: waiting for host 0's COMMIT")

            retry_call(committed, policy=deadline_policy,
                       tag=f"elastic commit wait step {step}",
                       sink=self._record)

    def _write_commit_marker(self, step: int, meta: dict,
                             t_save_start: Optional[float] = None) -> None:
        """Promote ``step``: fsync'd marker named for the SAVED world
        (``meta['world']`` — 1 for an emergency flush).
        ``t_save_start`` (the attempt's wall-clock start, already read
        in :meth:`_write`) turns the marker's own ``t_wall`` stamp into
        a ``commit_latency_s`` on the event — the health plane's
        checkpoint-commit-latency SLO feeds on it with zero clock reads
        beyond the two the commit protocol already takes."""
        step_dir = self._step_dir(step)
        world = int(meta.get("world", self.world))
        commit = {"step": step, "world": world,
                  "hosts": list(range(world)),
                  "spec": meta.get("spec"),
                  "emergency": bool(meta.get("emergency")),
                  "pid": os.getpid(),  # committer liveness: the
                  #  non-zero ranks' wait rejects a corpse marker
                  "format": "apex_tpu_torch.elastic_commit.v1"}
        stamp_wall(commit)
        marker_tmp = os.path.join(
            step_dir, f"{COMMIT_MARKER}.tmp-{os.getpid()}")
        with open(marker_tmp, "w") as f:
            json.dump(commit, f)
            f.flush()
            os.fsync(f.fileno())
        os.rename(marker_tmp, os.path.join(step_dir, COMMIT_MARKER))
        fsync_dir(step_dir)
        fsync_dir(self.root)
        rec = {"event": "checkpoint_commit", "step": step,
               "world": world,
               "emergency": bool(meta.get("emergency"))}
        if t_save_start is not None:
            rec["commit_latency_s"] = round(
                commit["t_wall"] - t_save_start, 4)
        self._emit(rec)

    def _is_emergency(self, step_dir: str) -> bool:
        marker = _read_json(os.path.join(step_dir, COMMIT_MARKER))
        return bool((marker or {}).get("emergency"))

    def _gc(self) -> None:
        """Committed steps beyond ``keep_n`` (emergency ones exempt) AND
        stale markerless garbage older than the newest commit (dead
        writers only — the multi-writer sweep rule)."""
        super()._gc()
        self._sweep_stale_tmp()

    # -- restore (marker-gated, topology-elastic) --------------------------
    def restore(self, template: TrainState, *,
                step: Optional[int] = None) -> Optional[TrainState]:
        raw = self._raw_step_dirs()
        if step is not None:
            wanted = [s for s in raw if s == int(step)]
            if not wanted:
                raise FileNotFoundError(
                    f"no checkpoint directory for step {int(step)} in "
                    f"{self.root} (available: {raw})")
            raw = wanted
        flat_template = flat_leaves(device_part(template))
        new_spec = getattr(template.opt_state, "spec", None)
        saw_any = bool(raw)
        for s in reversed(raw):
            d = self._step_dir(s)
            if not self._is_committed(s):
                # the torn-save case: some shards present, no marker —
                # garbage by protocol, NEVER loadable
                self._emit({"event": "checkpoint_fallback", "step": s,
                            "error": "uncommitted: no COMMIT marker "
                                     "(world died mid-save)"})
                continue
            try:
                return self._load_committed(s, template, flat_template,
                                            new_spec)
            except (CheckpointCorruptError, OSError, ValueError,
                    KeyError, TypeError, AttributeError) as e:
                self._emit({"event": "checkpoint_fallback", "step": s,
                            "error": f"{type(e).__name__}: {e}"})
                continue
        if saw_any and step is not None:
            raise CheckpointCorruptError(
                self.root,
                RuntimeError(f"step {step} exists but failed to load"))
        committed = [s for s in raw if self._is_committed(s)]
        if committed:
            raise CheckpointCorruptError(
                self.root,
                RuntimeError(
                    f"all {len(committed)} committed checkpoints "
                    f"({committed}) failed to load — corrupt storage or "
                    "a restore template that no longer matches the "
                    "saved state structure"))
        return None

    def _load_committed(self, s: int, template: TrainState,
                        flat_template: dict,
                        new_spec: Optional[PackSpec]) -> TrainState:
        d = self._step_dir(s)
        commit = _read_json(os.path.join(d, COMMIT_MARKER))
        if not commit:
            raise CheckpointCorruptError(d, RuntimeError("unreadable COMMIT"))
        saved_world = int(commit["world"])
        meta0 = _read_json(os.path.join(self._shard_dir(s, 0),
                                             "meta.json"))
        if not meta0:
            raise CheckpointCorruptError(
                d, RuntimeError("missing shard-0 meta"))
        sharded = list(meta0.get("sharded") or [])
        spec_meta = commit.get("spec") or meta0.get("spec")
        if int(meta0.get("n_leaves", len(flat_template))) != \
                len(flat_template):
            raise ValueError(
                f"checkpoint has {meta0.get('n_leaves')} leaves, template "
                f"expects {len(flat_template)} — state structure changed")
        if sharded and spec_meta is None:
            raise CheckpointCorruptError(
                d, RuntimeError("sharded leaves but no spec metadata"))

        # per-host shard loads, onto the template leaves' devices. Each shard's on-disk tree is exactly
        # what that host snapshotted: host 0 = its row slices PLUS every
        # replicated leaf; hosts > 0 = row slices only — the restore
        # target must match that tree shape-for-shape.
        assembled: Dict[str, np.ndarray] = {}
        shard_elems = 0
        if sharded:
            saved_total = int(spec_meta["total"])
            if saved_total % saved_world:
                raise CheckpointCorruptError(
                    d, RuntimeError(
                        f"saved total {saved_total} not divisible by "
                        f"saved world {saved_world}"))
            shard_elems = saved_total // saved_world

        def slice_target(k):
            t = flat_template[k]
            return torch.empty((shard_elems,), dtype=t.dtype,
                               device=t.device)

        rep_keys = [k for k in flat_template if k not in sharded]
        target0 = {k: slice_target(k) for k in sharded}
        target0.update({k: flat_template[k] for k in rep_keys})
        loaded0 = load_checkpoint(
            os.path.join(self._shard_dir(s, 0), "arrays"),
            target=target0)
        for k in rep_keys:
            assembled[k] = loaded0[k]
        if sharded:
            pieces: Dict[str, List[torch.Tensor]] = {
                k: [loaded0[k]] for k in sharded}
            for h in range(1, saved_world):
                loaded = load_checkpoint(
                    os.path.join(self._shard_dir(s, h), "arrays"),
                    target={k: slice_target(k) for k in sharded})
                for k in sharded:
                    pieces[k].append(loaded[k])
            for k in sharded:
                assembled[k] = (pieces[k][0] if len(pieces[k]) == 1
                                else torch.cat(pieces[k]))

        # topology-elastic re-flattening when the layout changed
        if sharded:
            if new_spec is None:
                raise ValueError(
                    "checkpoint carries sharded flat buffers but the "
                    "restore template's opt_state has no PackSpec")
            old_spec = self._rebuild_saved_spec(spec_meta, new_spec)
            if old_spec != new_spec:
                errors = reshard_findings(
                    old_spec, new_spec, old_count=saved_world,
                    new_count=self.world)
                if errors:
                    raise ValueError(
                        f"reshard check failed at step {s}: "
                        + "; ".join(code for code, _ in errors))
                for k in sharded:
                    assembled[k] = reflatten_flat(old_spec, new_spec,
                                                  assembled[k])
                self._emit({"event": "checkpoint_reshard", "step": s,
                            "saved_world": saved_world,
                            "world": self.world,
                            "saved_total": old_spec.total,
                            "total": new_spec.total})

        parts = unflatten_like(device_part(template), assembled)
        return TrainState(int(commit["step"]), *parts[:2],
                          scaler=parts[2], rng=parts[3],
                          data=meta0.get("data"), metrics=parts[4],
                          numerics=parts[5])

    @staticmethod
    def _rebuild_saved_spec(spec_meta: dict,
                            new_spec: PackSpec) -> PackSpec:
        """The SAVED layout, rebuilt from its recorded parameters over
        the template's leaf sequence (leaves are layout-invariant; only
        chunking/bucketing/padding differ between worlds)."""
        dummy = _unflatten_template(
            new_spec.treedef,
            [torch.empty(shape, dtype=dtype, device="meta")
             for shape, dtype in zip(new_spec.shapes, new_spec.dtypes)])
        old = PackSpec(dummy, align=int(spec_meta["align"]),
                       chunk_size=int(spec_meta["chunk_size"]),
                       bucket_elems=spec_meta.get("bucket_elems"))
        if old.total != int(spec_meta["total"]):
            raise ValueError(
                f"rebuilt saved spec total {old.total} != recorded "
                f"{spec_meta['total']} — the template's leaf sequence "
                "no longer matches the saved run")
        return old


# ---------------------------------------------------------------------------
# the supervisor (fake hosts as real subprocesses)
# ---------------------------------------------------------------------------
class WorldFailedError(RuntimeError):
    """The supervised world kept failing past ``max_restarts``."""


@dataclass
class _Host:
    host: int
    proc: subprocess.Popen
    heartbeat: str
    launched_at: float


@dataclass
class Incident:
    kind: str           # host_death | host_hang | host_startup_timeout
    host: int
    incarnation: int
    detail: str
    t_detect: float
    recovery_s: Optional[float] = None  # detect -> next incarnation's
    #                                     first heartbeat


class Supervisor:
    """Run N fake hosts, detect death and hangs, restart the world.

    - ``build_cmd(host, world, incarnation) -> argv`` builds each
      host's command line (the fake-host program resumes from the
      shared checkpoint root by itself; the supervisor knows nothing
      about training state).
    - Death: a host exiting non-zero. Hang: a host whose heartbeat file
      (``hb-<host>`` under ``heartbeat_dir``, written via
      :class:`Heartbeat`) goes stale past ``heartbeat_timeout_s`` after
      its first beat, or that never beats within ``startup_timeout_s``.
    - Any incident kills the WHOLE world (SIGKILL — a fake host gets no
      chance to flush, exactly like a preempted real one) and relaunches
      at incarnation+1; ``on_restart(incarnation, world) -> world'``
      may change the world size (topology-elastic resume does the
      rest). More than ``max_restarts`` restarts raises
      :class:`WorldFailedError`.
    - ``host_env(host, world, incarnation) -> dict`` (optional) merges
      extra environment into a host's process — the chaos trace uses it
      to arm :class:`~apex_tpu_torch.resilience.chaos.ChaosHost` faults on
      chosen incarnations only.

    Events (``sink``): ``host_launched``, ``host_exit``, ``host_death``,
    ``host_hang``, ``host_startup_timeout``, ``world_restart``,
    ``world_done`` — hang/death events carry ``host``/``rank`` so
    multi-host dumps are attributable (the supervisor-side mirror of
    the in-host ``HangWatchdog(context=...)``).
    """

    def __init__(self, build_cmd: Callable[[int, int, int], Sequence[str]],
                 world: int, *, heartbeat_dir: str,
                 heartbeat_timeout_s: float = 60.0,
                 startup_timeout_s: float = 300.0,
                 max_restarts: int = 3, poll_s: float = 0.05,
                 sink=None, env: Optional[dict] = None,
                 host_env: Optional[
                     Callable[[int, int, int], Optional[dict]]] = None,
                 on_restart: Optional[
                     Callable[[int, int], Optional[int]]] = None):
        self.build_cmd = build_cmd
        self.world = int(world)
        self.heartbeat_dir = str(heartbeat_dir)
        self.heartbeat_timeout_s = float(heartbeat_timeout_s)
        self.startup_timeout_s = float(startup_timeout_s)
        self.max_restarts = int(max_restarts)
        self.poll_s = float(poll_s)
        self.env = env
        self.host_env = host_env
        self.on_restart = on_restart
        self._record = as_record(sink)
        self.incidents: List[Incident] = []
        self.world_history: List[int] = []
        self.restarts = 0
        # incident spans (detect -> kill -> relaunch -> restore): the
        # MTTR decomposition, one ``incident-<n>`` trace per incident,
        # timestamps on the same ``time.monotonic`` scale the detector
        # uses. The ring doubles as the supervisor's flight recorder,
        # dumped on every incident and on world failure.
        self.tracer = Tracer(sink=self._record, tags={"role": "supervisor"})

    # -- events ------------------------------------------------------------
    def _emit(self, rec: dict) -> None:
        if self._record is not None:
            try:
                self._record(stamp_wall(dict(rec)))
            except Exception:
                pass

    def heartbeat_path(self, host: int) -> str:
        return os.path.join(self.heartbeat_dir, f"hb-{int(host)}")

    def _emit_incident_spans(self, inc: Incident) -> None:
        """One ``incident-<n>`` trace per incident: the MTTR
        (detect -> restored world's first heartbeat) decomposed into
        kill / relaunch / restore child spans. Emitted when recovery
        resolves — or, for the final unrecovered incident on the
        world-failed path, with whatever phases actually happened."""
        n = self.incidents.index(inc)
        tid = f"incident-{n}"
        root = next_span_id()
        t_kill = getattr(inc, "_t_kill", None)
        t_relaunch = getattr(inc, "_t_relaunch", None)
        t_end = inc.t_detect
        self.tracer.emit("detect", tid, inc.t_detect, inc.t_detect,
                         parent_id=root, kind=inc.kind, host=inc.host,
                         detail=inc.detail)
        if t_kill is not None:
            self.tracer.emit("kill", tid, inc.t_detect, t_kill,
                             parent_id=root)
            t_end = t_kill
        if t_relaunch is not None and t_kill is not None:
            self.tracer.emit("relaunch", tid, t_kill, t_relaunch,
                             parent_id=root)
            t_end = t_relaunch
        if inc.recovery_s is not None:
            t_end = inc.t_detect + inc.recovery_s
            if t_relaunch is not None:
                self.tracer.emit("restore", tid, t_relaunch, t_end,
                                 parent_id=root)
        self.tracer.emit(
            "incident", tid, inc.t_detect, t_end, span_id=root,
            terminal=True, kind=inc.kind, host=inc.host,
            incarnation=inc.incarnation, detail=inc.detail,
            mttr_s=inc.recovery_s, recovered=inc.recovery_s is not None)

    # -- lifecycle ---------------------------------------------------------
    def _launch_world(self, incarnation: int) -> List[_Host]:
        os.makedirs(self.heartbeat_dir, exist_ok=True)
        hosts = []
        for h in range(self.world):
            hb = self.heartbeat_path(h)
            try:
                os.remove(hb)
            except OSError:
                pass
            env = dict(self.env if self.env is not None else os.environ)
            extra = self.host_env(h, self.world, incarnation) \
                if self.host_env else None
            if extra:
                env.update({k: str(v) for k, v in extra.items()})
            argv = [str(a) for a in self.build_cmd(h, self.world,
                                                   incarnation)]
            proc = subprocess.Popen(argv, env=env)
            hosts.append(_Host(host=h, proc=proc, heartbeat=hb,
                               launched_at=time.monotonic()))
            self._emit({"event": "host_launched", "host": h, "rank": h,
                        "incarnation": incarnation, "pid": proc.pid,
                        "world": self.world})
        return hosts

    @staticmethod
    def _kill_world(hosts: List[_Host]) -> None:
        for hp in hosts:
            if hp.proc.poll() is None:
                try:
                    hp.proc.kill()  # SIGKILL: no flush, like preemption
                except OSError:
                    pass
        for hp in hosts:
            try:
                hp.proc.wait(timeout=10)
            except Exception:
                pass

    def _find_incident(self, hosts: List[_Host],
                       incarnation: int) -> Optional[Incident]:
        now = time.monotonic()
        for hp in hosts:
            rc = hp.proc.poll()
            if rc is not None and rc != 0:
                return Incident("host_death", hp.host, incarnation,
                                f"exit code {rc}", now)
            if rc is not None:
                continue  # exited clean; not an incident
            age = Heartbeat.age_s(hp.heartbeat)
            if age is not None:
                if age > self.heartbeat_timeout_s:
                    return Incident(
                        "host_hang", hp.host, incarnation,
                        f"heartbeat stale {age:.1f}s "
                        f"(> {self.heartbeat_timeout_s:.1f}s)", now)
            elif now - hp.launched_at > self.startup_timeout_s:
                return Incident(
                    "host_startup_timeout", hp.host, incarnation,
                    f"no heartbeat within {self.startup_timeout_s:.1f}s",
                    now)
        return None

    def run(self) -> dict:
        """Supervise until every host exits 0. Returns the summary dict
        (also useful as the bench MTTR record)."""
        incarnation = 0
        t_start = time.monotonic()
        pending_recovery: Optional[Incident] = None
        while True:
            self.world_history.append(self.world)
            hosts = self._launch_world(incarnation)
            if pending_recovery is not None:
                pending_recovery._t_relaunch = time.monotonic()
            incident = None
            while True:
                if pending_recovery is not None and any(
                        Heartbeat.age_s(hp.heartbeat) is not None
                        for hp in hosts):
                    # recovery = incident detection -> the restarted
                    # world's first heartbeat. Stamped INSIDE the
                    # monitor loop: a relaunched world that dies before
                    # ever beating still gets incident detection at
                    # normal speed (recovery_s stays None for it).
                    pending_recovery.recovery_s = round(
                        time.monotonic() - pending_recovery.t_detect, 3)
                    self._emit_incident_spans(pending_recovery)
                    pending_recovery = None
                rcs = [hp.proc.poll() for hp in hosts]
                if all(rc == 0 for rc in rcs):
                    break  # world finished clean
                incident = self._find_incident(hosts, incarnation)
                if incident is not None:
                    break
                time.sleep(self.poll_s)
            if incident is None:
                for hp in hosts:
                    self._emit({"event": "host_exit", "host": hp.host,
                                "rank": hp.host,
                                "incarnation": incarnation, "code": 0})
                summary = self.summary(
                    ok=True, wall_s=time.monotonic() - t_start)
                self._emit({"event": "world_done", **summary})
                return summary
            self.incidents.append(incident)
            self._emit({"event": incident.kind, "host": incident.host,
                        "rank": incident.host,
                        "incarnation": incarnation,
                        "detail": incident.detail})
            self._kill_world(hosts)
            incident._t_kill = time.monotonic()
            self.tracer.dump_blackbox(
                reason=incident.kind, sink=self.tracer.sink,
                host=incident.host, incarnation=incarnation,
                detail=incident.detail)
            self.restarts += 1
            if self.restarts > self.max_restarts:
                self._emit_incident_spans(incident)
                summary = self.summary(
                    ok=False, wall_s=time.monotonic() - t_start)
                self._emit({"event": "world_failed", **summary})
                raise WorldFailedError(
                    f"world failed {self.restarts} times "
                    f"(max_restarts={self.max_restarts}); last incident: "
                    f"{incident.kind} host {incident.host} "
                    f"({incident.detail})")
            if self.on_restart is not None:
                new_world = self.on_restart(incarnation, self.world)
                if new_world:
                    self.world = int(new_world)
            incarnation += 1
            pending_recovery = incident
            self._emit({"event": "world_restart",
                        "incarnation": incarnation, "world": self.world,
                        "after": incident.kind, "host": incident.host})

    def summary(self, *, ok: bool, wall_s: float) -> dict:
        return {
            "ok": bool(ok),
            "restarts": self.restarts,
            "incarnations": self.restarts + 1,
            "world_history": list(self.world_history),
            "wall_s": round(wall_s, 3),
            "incidents": [
                {"kind": i.kind, "host": i.host,
                 "incarnation": i.incarnation, "detail": i.detail,
                 "recovery_s": i.recovery_s}
                for i in self.incidents],
        }
