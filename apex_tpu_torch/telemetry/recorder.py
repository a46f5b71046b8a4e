"""Host-side telemetry sinks: JSONL, ring buffer, fan-out (counterpart of
``apex_tpu/telemetry/recorder.py``).

Every recorder accepts free-form dicts via :meth:`record` and implements
the ``add_scalar(name, value, step)`` writer protocol. Records are
byte-compatible with the JAX package's: the same keys in the same order,
non-finite floats as their repr strings (JSON has no inf/nan), tensors and
numpy values as Python numbers or lists.

Rank gating follows the reference's rank-0 convention: by default only
the logging process (rank 0 of ``torch.distributed`` when it is
initialised, else the one process) writes; other ranks' records are
dropped at the sink, so instrumented step functions stay identical
across ranks.

:func:`defer` is the drains' way to the host without a sync (the JAX
package's async ``jax.debug.callback``): it copies a step's device values
into pinned host memory (``non_blocking``), records a CUDA event, and runs
the step's emission once that event has completed, at a later
:func:`defer` or at :func:`flush` (the counterpart of
``jax.effects_barrier()``). Emissions run in the order they were
deferred. On the CPU they run at once.
"""
from __future__ import annotations

import collections
import json
import os
import threading
import time
from typing import Callable, Dict, Optional

import numpy as np
import torch


def is_logging_process(log_rank: Optional[int] = None) -> bool:
    """True on the process that should write telemetry: the
    ``torch.distributed`` rank ``log_rank`` (default 0) when a process
    group is initialised, else the one process (rank 0)."""
    rank = 0
    if torch.distributed.is_available() and \
            torch.distributed.is_initialized():
        rank = torch.distributed.get_rank()
    return rank == (0 if log_rank is None else int(log_rank))


def _jsonable(v):
    """Strict-JSON-safe conversion: tensors, numpy scalars and arrays
    become Python numbers/lists, non-finite floats their repr strings
    (json has no inf/nan), unknown objects their repr."""
    if isinstance(v, (str, bool, int, type(None))):
        return v
    if isinstance(v, float):
        return v if np.isfinite(v) else repr(v)
    if isinstance(v, dict):
        return {str(k): _jsonable(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return [_jsonable(x) for x in v]
    if isinstance(v, torch.Tensor):
        return _jsonable(v.detach().cpu().tolist())
    try:
        arr = np.asarray(v)
    except Exception:
        return repr(v)
    if arr.ndim == 0:
        return _jsonable(arr.item())
    return [_jsonable(x) for x in arr.tolist()]


def stamp_wall(rec: dict) -> dict:
    """Stamp ``t_wall`` (wall-clock seconds) on a record in place,
    keeping an existing value. The ONE place the cross-sink record
    schema gets its timestamp — every sink that persists records
    (:class:`JsonlRecorder`, :class:`RingBufferRecorder`) stamps here,
    so ring-sourced flight-recorder dumps carry the same ``t_wall`` a
    JSONL stream would."""
    rec.setdefault("t_wall", time.time())
    return rec


class NullRecorder:
    """Drops everything (the non-logging ranks' sink)."""

    def record(self, rec: dict) -> None:
        pass

    def add_scalar(self, name, value, step) -> None:
        pass

    def flush(self) -> None:
        pass

    def close(self) -> None:
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class RingBufferRecorder(NullRecorder):
    """In-memory ring of the last ``capacity`` records — the cheap
    always-on sink for tests and interactive inspection."""

    def __init__(self, capacity: int = 1024, *, only_logging_process=False,
                 log_rank: Optional[int] = None):
        self.records = collections.deque(maxlen=capacity)
        self._enabled = (not only_logging_process
                         or is_logging_process(log_rank))

    def record(self, rec: dict) -> None:
        if self._enabled:
            self.records.append(stamp_wall(dict(rec)))

    def add_scalar(self, name, value, step) -> None:
        self.record({"event": "scalar", "name": str(name),
                     "value": _jsonable(value), "step": _jsonable(step)})

    def events(self, kind: str) -> list:
        """The captured records with ``record["event"] == kind`` — the
        one-liner every chaos/robustness assertion wants ("exactly one
        ``request_end``", "a ``hang`` with stacks", ...)."""
        return [r for r in self.records if r.get("event") == kind]

    def counts_by_event(self) -> dict:
        """``{event: count}`` over the captured window (the overload
        bench's reject/shed/degrade tally)."""
        return dict(collections.Counter(
            r.get("event", "?") for r in self.records))

    def __len__(self):
        return len(self.records)


class JsonlRecorder(NullRecorder):
    """Append-only JSONL file sink, one record per line.

    Multi-PROCESS safe by construction, not by lock: the file is opened
    ``O_APPEND`` and every record goes out as ONE ``os.write`` of a
    complete line, so concurrent per-replica writers (the real-process
    serving fleet runs one recorder per worker subprocess against one
    shared stream) can never interleave partial lines — POSIX appends
    each ``write`` atomically at end-of-file. A buffered file handle
    would silently break this: ``BufferedWriter`` splits writes larger
    than its buffer, and the torn halves interleave. The threading lock
    still guards in-process concurrency and the close race. Only the
    logging process writes (``only_logging_process``, default True —
    the MLPerf/Megatron rank-0 convention); other ranks construct the
    recorder fine and silently drop records.
    """

    def __init__(self, path, *, only_logging_process: bool = True,
                 log_rank: Optional[int] = None, append: bool = False):
        self.path = str(path)
        self._lock = threading.Lock()
        self._enabled = (not only_logging_process
                         or is_logging_process(log_rank))
        self._fd: Optional[int] = None
        if self._enabled:
            d = os.path.dirname(os.path.abspath(self.path))
            os.makedirs(d, exist_ok=True)
            flags = os.O_WRONLY | os.O_CREAT | os.O_APPEND
            if not append:
                flags |= os.O_TRUNC
            self._fd = os.open(self.path, flags, 0o644)

    def record(self, rec: dict) -> None:
        if self._fd is None:
            return
        rec = stamp_wall({k: _jsonable(v) for k, v in rec.items()})
        data = (json.dumps(rec) + "\n").encode()
        with self._lock:
            if self._fd is None:  # closed between check and write
                return
            os.write(self._fd, data)  # ONE write: the atomicity unit

    def add_scalar(self, name, value, step) -> None:
        self.record({"event": "scalar", "name": str(name),
                     "value": _jsonable(value), "step": _jsonable(step)})

    def flush(self) -> None:
        pass  # os.write is unbuffered; nothing to drain

    def close(self) -> None:
        with self._lock:
            if self._fd is not None:
                os.close(self._fd)
                self._fd = None


class TaggedRecorder(NullRecorder):
    """Inject fixed key/value tags into every record before forwarding.

    The attribution shim for multi-instance telemetry: a replica fleet
    hands each ``ServingEngine`` a ``TaggedRecorder(sink,
    replica_id=i)`` so every ``request_end`` / ``hang`` / quarantine /
    ``serving_step`` event lands in the shared stream carrying the
    replica that emitted it — fleet traces stay attributable without
    threading an id through every ``record`` call site. A record's own
    keys win over the tags (an event that already carries
    ``replica_id`` keeps it); ``add_scalar`` writes are tagged too (as
    ``scalar`` records, like the ring buffer does).

    The tagger does NOT own the sink by default: a fleet hands every
    replica a tagged view over ONE shared stream, so one replica's
    teardown must not close the file out from under the others —
    ``close()`` only flushes. A tagger that wraps a sink nobody else
    holds (e.g. a fake host's private JSONL) passes ``owns_sink=True``
    to get the close cascade back.

    ``labels`` is the generic label dict for the fleet health plane's
    aggregation layer (``telemetry.timeseries`` — the multi-tenant
    hook): unlike ``tags`` (merged at the record's top level), labels
    merge into each record's ``labels`` dict, where the record's own
    label keys win on collision (a per-request tenant overrides the
    stream-level one).
    """

    def __init__(self, sink, tags: Optional[dict] = None, *,
                 owns_sink: bool = False,
                 labels: Optional[dict] = None, **tag_kw):
        self.sink = sink
        self.owns_sink = owns_sink
        self.tags = {**(tags or {}), **tag_kw}
        self.labels = dict(labels) if labels else None

    def record(self, rec: dict) -> None:
        if self.labels is not None:
            rec_labels = rec.get("labels")
            rec = {**self.tags, **rec,
                   "labels": {**self.labels,
                              **(rec_labels if isinstance(rec_labels,
                                                          dict) else {})}}
            self.sink.record(rec)
            return
        self.sink.record({**self.tags, **rec})

    def add_scalar(self, name, value, step) -> None:
        self.record({"event": "scalar", "name": str(name),
                     "value": _jsonable(value), "step": _jsonable(step)})

    def flush(self) -> None:
        self.sink.flush()

    def close(self) -> None:
        if self.owns_sink:
            self.sink.close()
        else:
            self.sink.flush()


class MultiRecorder(NullRecorder):
    """Fan a record out to several sinks (e.g. JSONL + ring buffer)."""

    def __init__(self, *recorders):
        self.recorders = list(recorders)

    def record(self, rec: dict) -> None:
        for r in self.recorders:
            r.record(rec)

    def add_scalar(self, name, value, step) -> None:
        for r in self.recorders:
            r.add_scalar(name, value, step)

    def flush(self) -> None:
        for r in self.recorders:
            r.flush()

    def close(self) -> None:
        for r in self.recorders:
            r.close()


def percentiles(values, ps=(50, 90, 99), *, field=None):
    """p50/p90/p99-style reducer over a sequence of numbers OR of JSONL
    records (dicts; ``field`` names the value key).

    The shared percentile math for everything that folds a telemetry
    stream — the serving engine's per-request latency summary, the
    ``serving_throughput`` bench leg, ``tools/health_report.py`` — so no
    caller hand-rolls interpolation again. Non-numeric / missing /
    non-finite entries are skipped (JSONL round-trips ``nan``/``inf`` as
    repr strings, see :func:`_jsonable`). Returns ``{"p50": ..., ...}``
    (linear interpolation, numpy convention), or ``{}`` when nothing
    numeric survives.
    """
    out_vals = []
    for v in values:
        if field is not None:
            if not isinstance(v, dict):
                continue
            v = v.get(field)
        if isinstance(v, bool) or v is None:
            continue
        if isinstance(v, str):
            try:
                v = float(v)
            except ValueError:
                continue
        try:
            f = float(v)
        except (TypeError, ValueError):
            continue
        if np.isfinite(f):
            out_vals.append(f)
    if not out_vals:
        return {}
    arr = np.asarray(out_vals, np.float64)
    return {f"p{int(p) if float(p).is_integer() else p}":
            float(np.percentile(arr, p)) for p in ps}


def read_jsonl(path, *, stats: Optional[dict] = None) -> list:
    """Parse a telemetry JSONL file back into a list of dicts.

    Post-mortem hardened: a writer SIGKILLed mid-write leaves a torn
    FINAL line, and the black box must still open — a truncated tail is
    skipped (and counted in ``stats["torn_lines"]`` when a stats dict is
    passed) instead of refusing the whole file. Corruption anywhere
    before the final line is a different failure (the format is
    append-only, a mid-file tear means the file is not what we wrote)
    and still raises ``json.JSONDecodeError``.
    """
    with open(path) as f:
        lines = [ln.strip() for ln in f]
    out = []
    torn = 0
    nonempty = [i for i, ln in enumerate(lines) if ln]
    for i in nonempty:
        try:
            out.append(json.loads(lines[i]))
        except json.JSONDecodeError:
            if i != nonempty[-1]:
                raise
            torn += 1
    if stats is not None:
        stats["torn_lines"] = stats.get("torn_lines", 0) + torn
    return out


_NP_DTYPES = {torch.float32: np.float32, torch.int32: np.int32,
              torch.int64: np.int64, torch.bool: np.bool_}


class _Deferred:
    """One step's values on their way to the host: a pinned fp64 buffer
    filled by a ``non_blocking`` copy, the event after it, and how to cut
    the buffer back into the named values."""

    def __init__(self, payload: Dict[str, torch.Tensor],
                 emit: Callable[[Dict[str, np.ndarray]], None]):
        self.emit = emit
        self.layout = [(k, tuple(t.shape), t.dtype)
                       for k, t in payload.items()]
        flat = torch.cat([t.detach().reshape(-1).to(torch.float64)
                          for t in payload.values()])
        if flat.device.type == "cuda":
            self.host = torch.empty(flat.shape, dtype=torch.float64,
                                    pin_memory=True)
            self.host.copy_(flat, non_blocking=True)
            self.event = torch.cuda.Event()
            self.event.record()
        else:
            self.host, self.event = flat, None

    def ready(self) -> bool:
        return self.event is None or self.event.query()

    def run(self) -> None:
        if self.event is not None:
            self.event.synchronize()
        buf = self.host.numpy()
        values, o = {}, 0
        for key, shape, dtype in self.layout:
            n = int(np.prod(shape)) if shape else 1
            # back to the value's own dtype: fp64 holds fp32, int32 and
            # bool exactly, so the host sees the device's bits
            values[key] = buf[o:o + n].astype(
                _NP_DTYPES.get(dtype, np.float64)).reshape(shape)
            o += n
        self.emit(values)


#: emissions deferred and not yet run, oldest first. One queue for the
#: process, as the JAX runtime keeps one order of effects: a numerics
#: event and a metrics record of the same step come out in program order
#: whichever object deferred them.
_PENDING: "collections.deque[_Deferred]" = collections.deque()


def defer(payload: Dict[str, torch.Tensor],
          emit: Callable[[Dict[str, np.ndarray]], None]) -> None:
    """Run ``emit(values)`` with ``values`` the host copies (numpy, in
    each tensor's own dtype and shape) of the tensors of ``payload`` once
    the card has produced them, then every earlier deferred emission whose
    values have arrived, in order. Adds no host sync: the copy is
    ``non_blocking`` into pinned memory and completion is polled."""
    _PENDING.append(_Deferred(payload, emit))
    while _PENDING and _PENDING[0].ready():
        _PENDING.popleft().run()


def flush() -> None:
    """Wait for every deferred emission and run it (the counterpart of
    ``jax.effects_barrier()``; call once at the end of a run or before
    reading a sink)."""
    while _PENDING:
        _PENDING.popleft().run()
