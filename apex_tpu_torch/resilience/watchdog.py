"""Hang watchdog: bounded blocking points + all-thread stack dumps
(counterpart of ``apex_tpu/resilience/watchdog.py``; host code, copied).

A pod-scale training job dies two ways: loudly (an exception) or —
much worse — silently, with one host wedged in a blocking call (a
checkpoint barrier whose storage write lost its connection, a telemetry
drain whose callback deadlocked, a device-to-host copy stuck behind a
hung kernel) while the other hosts burn their step budget waiting at the
next collective. The watchdog converts the second failure mode into the
first: every known blocking point runs under a deadline, and when the
deadline passes the watchdog dumps **all** thread stacks (the evidence a
post-mortem needs — which thread holds what), emits a structured
``hang`` event, and raises :class:`HangError` instead of waiting
forever.

Two integration shapes:

- :meth:`HangWatchdog.wait` — for blocking points the caller owns as a
  poll loop (a ``threading.Event``, a predicate): fully deterministic,
  raises in the calling thread.
- :meth:`HangWatchdog.armed` — a context manager around a call we do
  *not* own (the serving step's ``.cpu()`` fetch, a third-party
  ``.result()``). A
  monitor thread fires at the deadline: dump + event + ``on_hang``
  (default ``_thread.interrupt_main()``, converted to :class:`HangError`
  inside the context). Best-effort by nature — a block stuck in native
  code without releasing the GIL cannot be interrupted, but the stack
  dump and the event still land, which is the difference between a
  diagnosable incident and a silent wedge.

``serving.ServingEngine(watchdog=...)`` arms its one host sync per step
(the emitted-token fetch) through it.
"""
from __future__ import annotations

import sys
import threading
import time
import traceback
from contextlib import contextmanager
from typing import Callable, Optional


class HangError(RuntimeError):
    """A watched blocking point exceeded its deadline.

    ``what`` names the blocking point; ``stacks`` carries the all-thread
    stack dump captured at the moment the deadline fired.
    """

    def __init__(self, what: str, timeout_s: float, stacks: str):
        self.what = what
        self.timeout_s = timeout_s
        self.stacks = stacks
        super().__init__(
            f"hang watchdog: {what!r} exceeded {timeout_s:.1f}s; "
            f"all-thread stacks:\n{stacks}")


def dump_all_stacks() -> str:
    """Format every live thread's current stack (the ``py-spy dump``
    a wedged pod cannot give you, taken from inside)."""
    names = {t.ident: t.name for t in threading.enumerate()}
    out = []
    for ident, frame in sys._current_frames().items():
        name = names.get(ident, "unknown")
        out.append(f"--- thread {name} (ident {ident}) ---")
        out.append("".join(traceback.format_stack(frame)).rstrip())
    return "\n".join(out)


class _Armed:
    __slots__ = ("what", "deadline", "timeout_s", "tripped", "dump",
                 "interrupt_done", "context")

    def __init__(self, what: str, timeout_s: float, context=None):
        self.what = what
        self.timeout_s = timeout_s
        self.deadline = time.monotonic() + timeout_s
        self.tripped = False
        self.dump = ""
        self.context = context
        # set once the monitor has finished firing (interrupt delivered
        # or skipped) — armed()'s exit path synchronizes on it
        self.interrupt_done = threading.Event()


class HangWatchdog:
    """Deadline monitor for blocking points.

    ``timeout_s`` is the default deadline (per blocking point, not
    global); individual waits may override. ``sink`` receives the
    structured ``{"event": "hang", "what", "timeout_s", "stacks"}``
    record (a recorder with ``.record`` or a bare callable). ``on_hang``
    replaces the default main-thread interrupt for :meth:`armed` blocks
    — it runs on the monitor thread with ``(what, stacks)``.

    ``context`` is a small dict merged into EVERY hang event this
    watchdog emits (per-call ``wait(context=)``/``armed(context=)``
    keys win on conflict) — the training-side mirror of serving's
    ``telemetry.TaggedRecorder``: a supervised fake host constructs its
    watchdog with ``context={"host": h, "rank": h}`` so a multi-host
    hang dump is attributable to the host that wedged without every
    blocking point having to thread the ids through.
    """

    def __init__(self, timeout_s: float = 300.0, *, sink=None,
                 on_hang: Optional[Callable[[str, str], None]] = None,
                 poll_s: float = 0.05, context: Optional[dict] = None):
        self.timeout_s = float(timeout_s)
        self.poll_s = float(poll_s)
        self.on_hang = on_hang
        self.context = dict(context) if context else None
        from .retry import as_record

        self._record = as_record(sink)
        self._lock = threading.Lock()
        self._armed: list[_Armed] = []
        self._monitor: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self.trips = 0  # lifetime count of fired deadlines

    # -- deterministic wait (poll loop we own) -----------------------------
    def wait(self, ready, what: str, *,
             timeout_s: Optional[float] = None, context=None) -> None:
        """Block until ``ready`` — a ``threading.Event`` or a bool
        predicate — or raise :class:`HangError` with a stack dump at the
        deadline. Runs entirely in the calling thread; no interrupt
        machinery involved. ``context`` (a small dict — e.g. the serving
        step number) is merged into the hang event record."""
        timeout_s = self.timeout_s if timeout_s is None else float(timeout_s)
        deadline = time.monotonic() + timeout_s
        is_event = hasattr(ready, "wait") and hasattr(ready, "is_set")
        while True:
            if is_event:
                left = max(0.0, deadline - time.monotonic())
                if ready.wait(min(self.poll_s, left)):
                    return
            else:
                if ready():
                    return
                time.sleep(self.poll_s)
            if time.monotonic() >= deadline:
                stacks = dump_all_stacks()
                self._fire(what, timeout_s, stacks, interrupt=False,
                           context=context)
                raise HangError(what, timeout_s, stacks)

    # -- armed context (blocks we don't own) -------------------------------
    @contextmanager
    def armed(self, what: str, *, timeout_s: Optional[float] = None,
              context=None):
        """Arm a deadline around a blocking call. If the block does not
        exit in time, the monitor thread dumps stacks, emits the hang
        event and calls ``on_hang`` (default: interrupt the main thread,
        which this context converts into :class:`HangError`).
        ``context`` is merged into the hang event record — the
        post-mortem's "where were we" (e.g. the serving step number)."""
        timeout_s = self.timeout_s if timeout_s is None else float(timeout_s)
        entry = _Armed(what, timeout_s, context=context)
        with self._lock:
            self._armed.append(entry)
            self._ensure_monitor()
        completed = False
        try:
            yield entry
            completed = True
        except KeyboardInterrupt:
            if entry.tripped:
                raise HangError(what, timeout_s, entry.dump) from None
            raise
        finally:
            with self._lock:
                if entry in self._armed:
                    self._armed.remove(entry)
            if entry.tripped and completed:
                # the block finished at ~the deadline: the monitor's
                # interrupt may still be in flight. Wait for the firing
                # to conclude, then give the pending KeyboardInterrupt a
                # bytecode window to land HERE, where it is absorbed —
                # otherwise it would kill unrelated later code. (The
                # monitor skips the interrupt if it saw the entry
                # deregister first; best-effort either way.)
                try:
                    entry.interrupt_done.wait(
                        max(1.0, 4 * self.poll_s))
                    time.sleep(0.05)
                except KeyboardInterrupt:
                    pass

    def close(self) -> None:
        self._stop.set()
        m = self._monitor
        if m is not None and m.is_alive():
            m.join(timeout=1.0)
        self._monitor = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # -- internals ---------------------------------------------------------
    def _ensure_monitor(self) -> None:
        if self._monitor is None or not self._monitor.is_alive():
            self._stop = threading.Event()
            self._monitor = threading.Thread(
                target=self._run, name="apex-tpu-torch-hang-watchdog",
                daemon=True)
            self._monitor.start()

    def _run(self) -> None:
        while not self._stop.wait(self.poll_s):
            now = time.monotonic()
            fired = []
            with self._lock:
                for entry in self._armed:
                    if not entry.tripped and now >= entry.deadline:
                        entry.tripped = True
                        fired.append(entry)
                if not self._armed:
                    # retire UNDER the lock: clearing self._monitor here
                    # means a concurrent armed() (which also holds the
                    # lock in _ensure_monitor) either sees a live
                    # monitor that will observe its new entry on the
                    # next poll, or None and starts a fresh one — never
                    # an is_alive()-but-exiting thread that would leave
                    # the new entry unwatched
                    self._monitor = None
                    return
            for entry in fired:
                entry.dump = dump_all_stacks()
                try:
                    # skip the interrupt if the block exited while the
                    # dump was being taken — a stray KeyboardInterrupt
                    # into a SUCCEEDED caller is worse than a missed one
                    with self._lock:
                        still_armed = entry in self._armed
                    self._fire(entry.what, entry.timeout_s, entry.dump,
                               interrupt=still_armed,
                               context=entry.context)
                finally:
                    entry.interrupt_done.set()

    def _fire(self, what: str, timeout_s: float, stacks: str,
              *, interrupt: bool, context=None) -> None:
        self.trips += 1
        print(f"hang watchdog fired: {what!r} exceeded {timeout_s:.1f}s",
              file=sys.stderr)
        print(stacks, file=sys.stderr)
        if self._record is not None:
            try:
                rec = {"event": "hang", "what": what,
                       "timeout_s": timeout_s, "stacks": stacks}
                if self.context:
                    rec.update(self.context)
                if context:  # per-call context wins on conflict
                    rec.update(context)
                self._record(rec)
            except Exception:
                pass  # the sink must never mask the hang itself
        if interrupt:
            if self.on_hang is not None:
                self.on_hang(what, stacks)
            else:
                import _thread

                _thread.interrupt_main()
