"""Preemption-safe checkpoint manager: atomic, retained, async, restartable
(counterpart of ``apex_tpu/resilience/manager.py``, over this package's
``checkpoint.py`` format: ``arrays.bin`` + ``index.json``, no orbax).

What a single ``save_checkpoint`` call does not give a production run,
this does:

- **Atomic step directories** — each save stages into
  ``step_XXXXXXXX.tmp-<pid>/`` (the flat leaf tree under ``arrays/`` +
  a ``meta.json`` with the host-side state) and commits with one
  ``os.rename``. A crash, preemption, or injected write failure at ANY
  point leaves either a complete committed checkpoint or an ignorable
  tmp directory — never a half-checkpoint at a committed path.
- **Retention + GC** — ``keep_n`` newest committed steps survive; older
  ones are deleted after each successful commit (emergency preemption
  checkpoints are exempt).
- **Corruption fallback** — :meth:`restore` walks committed steps newest
  first; a step that fails to load (typed
  :class:`~apex_tpu_torch.checkpoint.CheckpointCorruptError` from the
  loader, or a damaged ``meta.json``) emits a ``checkpoint_fallback``
  event and the walk continues to the next older step.
- **Async save** — :meth:`save` snapshots with a *device-side* copy
  (``clone()`` per card tensor, queued on the current stream, so the
  caller pays launch cost only) and records a CUDA event after the
  copies. The copies alias nothing, so the live state may be updated in
  place by the next step immediately. A background thread waits on the
  event from a stream of its own, copies the clones into one pinned host
  buffer (kept by the manager and reused by every later save), and
  writes, commits and collects from there; it holds the clones until
  its copy is done. The barrier is at the *next* save (or an explicit
  :meth:`wait_until_finished`), so storage latency overlaps training
  compute. The snapshot holds device memory until its host copy is done
  — budget one extra state-size worth of card memory while a save is in
  flight.
- **Preemption flush** — :meth:`install_preemption_handler` arms
  SIGTERM (the cloud preemption notice): the handler synchronously
  writes an emergency checkpoint of the loop's current state, emits a
  ``preemption`` event, and sets :attr:`preempted` for the loop to exit
  cleanly.
- **Bounded waits** — with a :class:`~apex_tpu_torch.resilience.watchdog.
  HangWatchdog` attached, the save barrier raises :class:`HangError`
  with an all-thread stack dump instead of deadlocking when storage
  wedges.

IO runs under :mod:`~apex_tpu_torch.resilience.retry` (jittered
exponential backoff on ``OSError``-class blips). Fault injection for all
of the above lives in :mod:`~apex_tpu_torch.resilience.chaos`.
"""
from __future__ import annotations

import json
import os
import re
import shutil
import signal
import threading
import time
from typing import Callable, List, Optional

import torch

from ..checkpoint import (
    CheckpointCorruptError,
    fsync_dir,
    fsync_tree,
    load_checkpoint,
    save_checkpoint,
    stale_writer,
)
from ..ops import hostio
from ..telemetry.recorder import stamp_wall
from .retry import RetryPolicy, as_record, retry_call
from .state import TrainState, device_part, flat_leaves, unflatten_like


def _snapshot_leaf(x):
    """Copy of one leaf that aliases nothing: a tensor is cloned on its
    device (on the card a copy queued on the current stream — the caller
    does not wait for it); other leaves are kept as they are."""
    if isinstance(x, torch.Tensor):
        return x.detach().clone()
    return x


def _card_event(snapshot: dict):
    """A CUDA event recorded after the snapshot's card copies (None when
    it holds no card tensor): the host copy waits on it."""
    devs = {v.device for v in snapshot.values()
            if isinstance(v, torch.Tensor) and v.device.type == "cuda"}
    if not devs:
        return None
    (dev,) = devs
    ev = torch.cuda.Event()
    ev.record(torch.cuda.current_stream(dev))
    return ev


def _multi_process() -> bool:
    """True in a ``torch.distributed`` world of more than one process:
    a peer's pid then means nothing locally."""
    import torch.distributed as dist

    return (dist.is_available() and dist.is_initialized()
            and dist.get_world_size() > 1)


_STEP_DIR = re.compile(r"^step_(\d{8})$")

#: the host IO engine's writer threads for a save: 2, where its default
#: is 8. While an async save of the 345M step's ~5.0 GB state was in
#: flight, the step's p50 was 96.4 ms with 2 writers and 105.9 ms with
#: 8 (98.0 ms before the save), the slowest step 235.8 against 453.8 ms,
#: and the save took 6.2 s against 7.4 s (H100 80GB HBM3, 700 W;
#: ``tools/torch_ckpt_stall.py``): fewer threads leave the training
#: thread its core and write no slower
SAVE_WRITERS = 2

#: Storage-blip policy for checkpoint IO: OSErrors retry with backoff;
#: anything else (including chaos-injected faults) surfaces immediately.
CHECKPOINT_IO_POLICY = RetryPolicy(
    attempts=3, retry_on=(OSError,), base_delay=0.05, max_delay=2.0)


class PreemptionError(RuntimeError):
    """Raised (optionally) after the emergency checkpoint is flushed."""


class CheckpointManager:
    """Atomic, retained, optionally-async checkpointing of a TrainState.

    Parameters:

    - ``root``: directory holding the ``step_XXXXXXXX`` checkpoints.
    - ``keep_n``: committed checkpoints to retain (emergency saves are
      kept regardless unless ``gc_emergency=True``).
    - ``async_save``: write in a background thread (default); the
      barrier is at the next :meth:`save` / :meth:`wait_until_finished`.
    - ``save_every``: cadence for :meth:`maybe_save` (0 = every call).
    - ``sink``: recorder for structured events (``checkpoint_saved``,
      ``checkpoint_failed``, ``checkpoint_fallback``, ``checkpoint_gc``,
      ``preemption``).
    - ``watchdog``: bounds the save barrier (:class:`HangError` + stack
      dump instead of an unbounded join).
    - ``retry``: IO retry policy (default :data:`CHECKPOINT_IO_POLICY`).
    - ``chaos``: a :class:`~apex_tpu_torch.resilience.chaos.ChaosMonkey` whose
      write/commit hooks inject faults (tests only).
    """

    def __init__(
        self,
        root: str,
        *,
        keep_n: int = 3,
        async_save: bool = True,
        save_every: int = 0,
        sink=None,
        watchdog=None,
        retry: Optional[RetryPolicy] = None,
        chaos=None,
    ):
        self.root = os.path.abspath(root)
        os.makedirs(self.root, exist_ok=True)
        self.keep_n = int(keep_n)
        self.async_save = bool(async_save)
        self.save_every = int(save_every)
        self.watchdog = watchdog
        self.retry = retry or CHECKPOINT_IO_POLICY
        self.chaos = chaos
        self._record = as_record(sink)
        self._thread: Optional[threading.Thread] = None
        self._done = threading.Event()
        self._done.set()
        self._error: Optional[BaseException] = None
        # RLock, not Lock: the preemption handler runs in the MAIN
        # thread between bytecodes — if SIGTERM lands while a blocking
        # save in the main thread holds the lock, the handler's
        # emergency save must be able to re-enter rather than deadlock
        self._lock = threading.RLock()  # serializes writes + GC
        self.preempted = False
        self._prev_handlers: dict = {}
        #: the pinned host buffer card snapshots are copied into, reused
        #: by every save that fits it (grown when one does not)
        self._stage = hostio.PinnedStage()
        self._sweep_stale_tmp()

    # -- events ------------------------------------------------------------
    def _emit(self, rec: dict) -> None:
        if self._record is not None:
            try:
                self._record(stamp_wall(dict(rec)))
            except Exception:
                pass  # telemetry must never sink a checkpoint

    # -- directory bookkeeping ---------------------------------------------
    def _step_dir(self, step: int) -> str:
        return os.path.join(self.root, f"step_{int(step):08d}")

    def _sweep_stale_tmp(self) -> None:
        """Remove ``step_*.tmp-<pid>`` trees left by crashed writers.

        A hard kill mid-async-save leaves the full-size partial tree on
        disk with no one to clean it; accumulated across restarts on
        flaky storage that fills the volume. Only trees whose writer pid
        is dead are swept — and only in single-process runs: on a
        shared multi-host root another HOST's live writer has a pid
        that means nothing locally (the ROADMAP multi-host follow-on;
        ``checkpoint.save_checkpoint`` skips its sweep there for the
        same reason)."""
        if _multi_process():
            return
        swept = []
        for name in os.listdir(self.root):
            m = re.match(r"^step_\d{8}\.tmp-(\d+)(?:-emergency)?$", name)
            if not m or not stale_writer(int(m.group(1))):
                continue
            shutil.rmtree(os.path.join(self.root, name),
                          ignore_errors=True)
            swept.append(name)
        if swept:
            self._emit({"event": "checkpoint_gc",
                        "deleted_tmp": sorted(swept)})

    def all_steps(self) -> List[int]:
        """Committed checkpoint steps, ascending."""
        out = []
        for name in os.listdir(self.root):
            m = _STEP_DIR.match(name)
            if m:
                out.append(int(m.group(1)))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    # -- save --------------------------------------------------------------
    def maybe_save(self, state: TrainState) -> bool:
        """Save iff ``state.step`` is on the ``save_every`` cadence (and
        not step 0); ``save_every=0`` saves on every call. Returns
        whether a save was initiated."""
        step = int(state.step)
        if self.save_every > 0 and (step == 0 or step % self.save_every):
            return False
        self.save(state)
        return True

    def save(self, state: TrainState, *, blocking: Optional[bool] = None,
             emergency: bool = False) -> None:
        """Checkpoint ``state`` at ``state.step``.

        Asynchronous by default: the snapshot (copies on the card, launch
        cost only, and a CUDA event after them) happens here — after it
        returns, the caller may update every tensor in place in the next
        step — while the host copy, directory write, commit and GC happen
        on a background thread. The previous in-flight save is barriered
        first — a failed previous write raises HERE, before new work is
        queued. An ``emergency`` save skips that barrier (a wedged
        background write must not block the preemption flush; the RLock
        still serializes the actual directory writes) and is therefore
        always synchronous: it cannot share the single-slot async
        tracking with the in-flight save it deliberately did not wait
        for (clearing ``_done``/``_error`` under a live writer would let
        that writer's completion mark THIS write finished — and the
        whole point of an emergency flush is durability before the
        process dies). ``blocking=False`` with ``emergency=True`` is a
        :class:`ValueError`.
        """
        if emergency:
            if blocking is False:
                raise ValueError(
                    "emergency saves are always blocking: the flush "
                    "skips the async barrier, so a background emergency "
                    "write could not be tracked or waited on")
            blocking = True
        else:
            blocking = (not self.async_save) if blocking is None else blocking
            self.wait_until_finished()  # barrier + surface prev failure
        step = int(state.step)
        snapshot, meta = self._snapshot_and_meta(state, emergency)
        ready = _card_event(snapshot)
        if blocking:
            self._write(step, snapshot, meta,
                        lock_timeout_s=(30.0 if emergency else None),
                        ready=ready)
            return
        self._done.clear()
        self._error = None
        self._thread = threading.Thread(
            target=self._write_async, args=(step, snapshot, meta, ready),
            name=f"apex-tpu-torch-ckpt-save-{step}", daemon=True)
        self._thread.start()

    def _snapshot_and_meta(self, state: TrainState, emergency: bool):
        """Alias-free snapshot + host-side meta for one save — THE
        subclass hook: :class:`~apex_tpu_torch.resilience.elastic.
        ElasticCheckpointManager` overrides it to snapshot only this
        host's shard, while the save/async/emergency scaffolding stays
        inherited."""
        snapshot = {k: _snapshot_leaf(v)
                    for k, v in flat_leaves(device_part(state)).items()}
        meta = {"step": int(state.step), "data": state.data,
                "emergency": bool(emergency),
                "format": "apex_tpu_torch.train_state.v1"}
        return snapshot, meta

    def _host_copy(self, snapshot: dict, ready, reuse: bool = True) -> dict:
        """The snapshot with every card tensor copied to the host by
        :func:`~apex_tpu_torch.ops.hostio.to_host`, on a stream that
        first waits on ``ready`` (the event after the clones), into this
        manager's pinned buffer. ``reuse=False`` (a writer that does not
        hold the write lock) stages into a buffer of its own."""
        card = [k for k, v in snapshot.items()
                if isinstance(v, torch.Tensor) and v.device.type == "cuda"]
        if not card:
            return snapshot
        host = hostio.to_host([snapshot[k] for k in card],
                              stage=self._stage if reuse else None,
                              ready=ready)
        return {**snapshot, **dict(zip(card, host))}

    def _write_async(self, step, snapshot, meta, ready=None) -> None:
        try:
            self._write(step, snapshot, meta, ready=ready)
        except BaseException as e:  # surfaced at the next barrier
            self._error = e
        finally:
            self._done.set()

    def _write(self, step: int, snapshot: dict, meta: dict,
               *, lock_timeout_s: Optional[float] = None,
               ready=None) -> None:
        t0 = time.perf_counter()
        final = self._step_dir(step)
        tmp = f"{final}.tmp-{os.getpid()}"
        if meta.get("emergency"):
            # ALWAYS distinct from the regular writer's tmp: the SIGTERM
            # handler can interrupt a blocking same-step save in this
            # very thread (RLock re-entry!) or time out on another
            # thread's lock — sharing the tmp would rmtree that writer's
            # half-written tree and interleave two writers in one
            # directory. Disjoint trees reduce the residual race to two
            # complete same-step commits, handled at the rename below.
            tmp += "-emergency"
        # an emergency flush bounds the lock wait: a background write
        # wedged INSIDE the lock must not block the preemption handler
        # forever
        locked = self._lock.acquire(
            timeout=-1 if lock_timeout_s is None else lock_timeout_s)
        try:
            try:
                if os.path.exists(tmp):  # stale partial from a crash
                    shutil.rmtree(tmp)
                os.makedirs(tmp)
                if self.chaos is not None:
                    self.chaos.before_write(step)
                snapshot = self._host_copy(snapshot, ready, reuse=locked)
                retry_call(
                    # staged=False: `tmp` IS this write's staging dir —
                    # atomicity comes from the step-dir rename at commit,
                    # an inner tmp+rename would stage twice
                    lambda: save_checkpoint(
                        os.path.join(tmp, "arrays"), snapshot,
                        staged=False, threads=SAVE_WRITERS),
                    policy=self.retry, tag=f"ckpt arrays step {step}",
                    sink=self._record)
                with open(os.path.join(tmp, "meta.json"), "w") as f:
                    json.dump(meta, f)
                # durability, not just atomicity: rename orders nothing
                # on its own — a MACHINE crash straddling the commit
                # could persist the rename while the array payload,
                # meta.json or the tmp dir's entries were still
                # page-cache-only, leaving a committed-looking step
                # with empty files. Flush the whole staged tree (arrays
                # included), rename, then flush the parent so the
                # commit itself is on stable storage.
                fsync_tree(tmp)
                if self.chaos is not None:
                    self.chaos.before_commit(step)
                try:
                    if os.path.exists(final):
                        if not meta.get("emergency") and \
                                self._is_emergency(final):
                            # a same-step EMERGENCY flush won the race
                            # while this write was in flight: that tree
                            # is the preemption checkpoint (GC-exempt,
                            # asserted on resume) — never destroy it
                            # for an equivalent regular commit
                            shutil.rmtree(tmp, ignore_errors=True)
                            self._gc()
                            return
                        # re-save of the same step (ignore_errors: a
                        # racing same-step committer may have just
                        # removed it)
                        shutil.rmtree(final, ignore_errors=True)
                    os.rename(tmp, final)
                    fsync_dir(self.root)
                except OSError:
                    if os.path.isdir(final):
                        # lost a same-step commit race (rename cannot
                        # replace a non-empty dir): the winner's tree is
                        # a complete checkpoint of this same step —
                        # success, just not ours; drop our duplicate
                        shutil.rmtree(tmp, ignore_errors=True)
                    else:
                        raise
            except BaseException:
                self._emit({"event": "checkpoint_failed", "step": step,
                            "tmp": tmp})
                # a failed write must not strand a full-size partial
                # tree on disk (flaky storage would fill the volume)
                shutil.rmtree(tmp, ignore_errors=True)
                raise
            self._gc()
        finally:
            if locked:
                self._lock.release()
        self._emit({"event": "checkpoint_saved", "step": step,
                    "path": final, "emergency": bool(meta.get("emergency")),
                    "duration_s": round(time.perf_counter() - t0, 4)})

    def _is_emergency(self, step_dir: str) -> bool:
        try:
            with open(os.path.join(step_dir, "meta.json")) as f:
                return bool(json.load(f).get("emergency"))
        except Exception:
            return False

    def _gc(self) -> None:
        """Drop committed checkpoints beyond ``keep_n`` (oldest first);
        emergency checkpoints are retained."""
        if self.keep_n <= 0:
            return
        steps = self.all_steps()
        doomed = []
        for step in steps[:-self.keep_n] if len(steps) > self.keep_n else []:
            if self._is_emergency(self._step_dir(step)):
                continue
            shutil.rmtree(self._step_dir(step), ignore_errors=True)
            doomed.append(step)
        if doomed:
            self._emit({"event": "checkpoint_gc", "deleted_steps": doomed})

    def wait_until_finished(self, *, timeout_s: Optional[float] = None) -> None:
        """Barrier on the in-flight async save; re-raises its failure.

        With a watchdog attached the wait is bounded: past the deadline
        all thread stacks are dumped and :class:`HangError` raises
        instead of the run deadlocking on a wedged storage write.
        """
        if not self._done.is_set():
            if self.watchdog is not None:
                self.watchdog.wait(self._done, "checkpoint wait_until_finished",
                                   timeout_s=timeout_s)
            elif not self._done.wait(timeout_s):
                raise TimeoutError(
                    f"checkpoint write still running after {timeout_s}s")
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    # -- restore -----------------------------------------------------------
    def restore(self, template: TrainState, *,
                step: Optional[int] = None) -> Optional[TrainState]:
        """Load the newest good checkpoint (or exactly ``step``).

        Walks committed steps newest-first; a corrupted/partial entry
        emits ``checkpoint_fallback`` and the walk continues. Returns
        ``None`` only when NO committed checkpoint exists; if
        checkpoints exist but every one fails to load, raises
        :class:`CheckpointCorruptError` — "all corrupt" usually means a
        template/structure mismatch (a field added to the train state),
        and silently reinitializing from step 0 would discard the run's
        progress without a visible error. For the same reason an
        explicit ``step=`` with no committed checkpoint at that step
        raises :class:`FileNotFoundError` (listing what IS available)
        instead of returning ``None``. ``template`` supplies
        structure, dtypes and devices — the saved flat leaves are read
        straight onto the template's devices.
        """
        steps = self.all_steps()
        if step is not None:
            wanted = [s for s in steps if s == int(step)]
            if not wanted:
                # an EXPLICITLY requested step that is not committed
                # (GC'd, mistyped) must not read as "no checkpoints" —
                # resume_or_init would silently restart from step 0
                raise FileNotFoundError(
                    f"no committed checkpoint for step {int(step)} in "
                    f"{self.root} (available: {steps})")
            steps = wanted
        flat_template = flat_leaves(device_part(template))
        for s in reversed(steps):
            d = self._step_dir(s)
            try:
                with open(os.path.join(d, "meta.json")) as f:
                    meta = json.load(f)
                # validate INSIDE the fallback scope: a meta.json that
                # still parses as JSON but lost its shape ('{}', '4')
                # must fall back too, not crash the restore
                meta_step = int(meta["step"])
                data = meta.get("data")
                flat = load_checkpoint(
                    os.path.join(d, "arrays"), target=flat_template)
            except (CheckpointCorruptError, OSError, ValueError,
                    KeyError, TypeError, AttributeError) as e:
                self._emit({"event": "checkpoint_fallback", "step": s,
                            "error": f"{type(e).__name__}: {e}"})
                continue
            parts = unflatten_like(device_part(template), flat)
            return TrainState(meta_step, *parts[:2],
                              scaler=parts[2], rng=parts[3],
                              data=data, metrics=parts[4],
                              numerics=parts[5])
        if steps:
            raise CheckpointCorruptError(
                self.root,
                RuntimeError(
                    f"all {len(steps)} committed checkpoints "
                    f"({steps}) failed to load — corrupt storage or a "
                    "restore template that no longer matches the saved "
                    "state structure"))
        return None

    # -- preemption --------------------------------------------------------
    def install_preemption_handler(
        self,
        get_state: Callable[[], TrainState],
        *,
        signals=(signal.SIGTERM,),
        raise_after: bool = False,
    ) -> None:
        """Arm SIGTERM (the preemption notice) to flush an emergency
        checkpoint.

        The handler runs in the main thread between bytecodes:
        ``get_state()`` must return the loop's latest complete state (a
        closure over the loop variable — the dispatched-but-unread next
        step does not matter, the captured state is a consistent
        boundary). It saves synchronously (there may be no later
        barrier), emits a ``preemption`` event, sets :attr:`preempted`
        so a polling loop can exit cleanly, and — with
        ``raise_after=True`` — raises :class:`PreemptionError` to unwind
        immediately.
        """

        def _handler(signum, frame):
            self.preempted = True
            state = get_state()
            # emergency saves skip the usual next-save barrier (a wedged
            # background write must not block the flush) and bound their
            # wait on the write lock instead — see save()/_write()
            self.save(state, blocking=True, emergency=True)
            self._emit({"event": "preemption", "signal": int(signum),
                        "step": int(state.step)})
            if raise_after:
                raise PreemptionError(
                    f"preempted (signal {signum}); emergency checkpoint "
                    f"at step {int(state.step)}")

        for sig in signals:
            self._prev_handlers[sig] = signal.signal(sig, _handler)

    def uninstall_preemption_handler(self) -> None:
        for sig, prev in self._prev_handlers.items():
            signal.signal(sig, prev)
        self._prev_handlers.clear()

    # -- lifecycle ---------------------------------------------------------
    def close(self) -> None:
        """Barrier any in-flight save and disarm signal handlers."""
        try:
            self.wait_until_finished()
        finally:
            self.uninstall_preemption_handler()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
