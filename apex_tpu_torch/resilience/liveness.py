"""Shared process-liveness machinery: heartbeat files + writer-pid sweeps
(counterpart of ``apex_tpu/resilience/liveness.py``; host code, copied).

The elastic training :class:`~apex_tpu_torch.resilience.elastic.Supervisor`
and, later, a real-process serving fleet read the same liveness signal:

- :class:`Heartbeat` — one small JSON record per process, atomically
  replaced on every beat. The beat-file FORMAT is pinned (``{"host",
  "step", "pid", "t_wall"}``, staged as ``<path>.tmp-<pid>`` then
  ``os.replace``) — the elastic supervisor, the serving fleet
  supervisor and the tests all read the same bytes, which are the JAX
  package's.
- :func:`live_beat` — corpse-incarnation hygiene: a beat whose WRITER
  pid is dead is a corpse from a previous incarnation, never fresh —
  a restarted worker (or its supervisor) must not mistake the dead
  incarnation's last beat for progress, however recent its mtime.
- :func:`sweep_stale` — remove beat/staging files whose writer pid is
  dead, and ONLY those: a live concurrent writer's files are spared
  (the multi-writer sweep rule ``ElasticCheckpointManager`` pins with
  seeded-violation red tests).

Writer-pid probing rides :func:`apex_tpu_torch.checkpoint.stale_writer` —
local pids only, which is why both supervisors sweep only directories
they own on the local host.
"""
from __future__ import annotations

import json
import os
import re
import time
from typing import List, Optional

from ..checkpoint import stale_writer

__all__ = [
    "Heartbeat",
    "live_beat",
    "read_json_tolerant",
    "stale_writer",
    "sweep_stale",
    "writer_alive",
]


def read_json_tolerant(path: str) -> Optional[dict]:
    """Best-effort JSON read: ``None`` for missing/unreadable/garbage —
    the tolerant reader every liveness/protocol file shares (heartbeat,
    shard meta, COMMIT marker); callers treat ``None`` as absence."""
    try:
        with open(path) as f:
            return json.load(f)
    except (OSError, ValueError):
        return None


class Heartbeat:
    """A per-host liveness file: one small JSON record, atomically
    replaced on every beat. The supervisor reads the file's mtime for
    staleness (monotonic enough across local processes) and the content
    for attribution (host, step, pid)."""

    def __init__(self, path: str, host: int):
        self.path = str(path)
        self.host = int(host)
        os.makedirs(os.path.dirname(os.path.abspath(self.path)),
                    exist_ok=True)

    def beat(self, step: int) -> None:
        tmp = f"{self.path}.tmp-{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump({"host": self.host, "step": int(step),
                       "pid": os.getpid(), "t_wall": time.time()}, f)
        os.replace(tmp, self.path)

    @staticmethod
    def read(path: str) -> Optional[dict]:
        return read_json_tolerant(path)

    @staticmethod
    def age_s(path: str) -> Optional[float]:
        """Seconds since the last beat, or None when no beat landed."""
        try:
            return max(0.0, time.time() - os.stat(path).st_mtime)
        except OSError:
            return None


def writer_alive(pid: int) -> bool:
    """True when ``pid`` is a live local process. Unlike
    :func:`stale_writer` (whose job is sweeping OUR OWN leftover
    staging files, so it calls the current pid stale), a process's own
    pid is alive here — a worker reading back its own beat must see
    itself as live."""
    if pid == os.getpid():
        return True
    return not stale_writer(pid)


def live_beat(path: str) -> Optional[dict]:
    """The beat at ``path`` — but only if its WRITER is still alive.

    Corpse-incarnation hygiene: a dead incarnation's final beat file
    survives the process (SIGKILL flushes nothing, deletes nothing),
    and its mtime can be arbitrarily recent. Freshness therefore
    requires both a readable record AND a live writer pid; anything
    else returns ``None`` — absence, exactly like no beat at all."""
    rec = read_json_tolerant(path)
    if rec is None:
        return None
    pid = rec.get("pid")
    if not isinstance(pid, int) or not writer_alive(pid):
        return None
    return rec


_TMP_PID = re.compile(r"\.tmp-(\d+)$")


def sweep_stale(dir_: str, *, prefix: str = "") -> List[str]:
    """Remove beat/staging files under ``dir_`` whose writer is dead.

    Two classes of garbage a SIGKILLed process leaves behind:

    - ``*.tmp-<pid>`` staging files (a beat torn mid-replace): swept
      when ``<pid>`` is dead (:func:`stale_writer` — same rule as the
      checkpoint managers' multi-writer sweep);
    - committed beat files (matching ``prefix``): swept when their
      recorded writer pid is dead — the corpse heartbeat a restarted
      incarnation must never read as fresh.

    Files belonging to a LIVE writer — a concurrent worker still
    beating into the same directory — are spared in both classes.
    Returns the removed paths."""
    removed: List[str] = []
    try:
        names = os.listdir(dir_)
    except OSError:
        return removed
    for name in names:
        path = os.path.join(dir_, name)
        m = _TMP_PID.search(name)
        if m is not None:
            if stale_writer(int(m.group(1))):
                try:
                    os.remove(path)
                    removed.append(path)
                except OSError:
                    pass
            continue
        if not prefix or not name.startswith(prefix):
            # committed files are swept only under an explicit prefix —
            # an empty prefix sweeps staging garbage alone
            continue
        rec = read_json_tolerant(path)
        if rec is None:
            continue  # not a beat file (or torn): leave it alone
        pid = rec.get("pid")
        if isinstance(pid, int) and not writer_alive(pid):
            try:
                os.remove(path)
                removed.append(path)
            except OSError:
                pass
    return removed
