"""Distributed request tracing, latency attribution, and the flight
recorder — the causality layer over the recorder stack (counterpart of
``apex_tpu/telemetry/spans.py``; host code, copied: the records are
the JAX package's, field for field).

Three pieces, all riding the existing sinks (spans are ordinary records
with ``event == "span"``, so every :class:`~.recorder.JsonlRecorder` /
:class:`~.recorder.RingBufferRecorder` / :class:`~.recorder.TaggedRecorder`
stream is already a trace stream, tagged and rank-gated for free):

- **Spans** — :class:`Tracer` emits one record per span *at close*
  (``t_start``/``t_end``/``trace_id``/``span_id``/``parent_id``), with a
  :class:`TraceContext` stamped once per request at ``try_submit`` and
  carried on the :class:`~apex_tpu_torch.serving.scheduler.Request` object
  itself, so spans from the fleet router, the owning engine, a
  *different* engine after migration, and the fleet's finalize all join
  ONE tree. Timestamps are never read by the tracer — every emission
  site passes a clock value the instrumented code already read, so
  tracing adds ZERO clock reads and traces are deterministic under
  :class:`~apex_tpu_torch.serving.robustness.VirtualClock` (whose budgets are
  denominated in reads).
- **Attribution** — :func:`attr_account` partitions every request's
  wall time into :data:`ATTR_TERMS` buckets using the SAME clock values
  that stamp ``t_arrival`` / ``t_first_token`` / ``t_done``, so the
  TTFT terms sum to the measured TTFT *exactly* (and end-to-end terms
  to the end-to-end latency); :func:`attribution_summary` folds the
  per-request dicts into per-term percentiles plus a dominant-cause
  tally over SLO violators, for ``_summarize``.
- **Flight recorder** — every span also lands in a bounded
  :attr:`Tracer.ring` (including high-frequency ``ring_only`` step
  spans that never hit the sink); :meth:`Tracer.dump_blackbox` writes
  the ring as a black-box JSONL (or replays it into a sink), merged
  with ``HangError.stacks`` on the hang path.

The JAX package's ``tools/trace_report.py`` reads the stream as it
reads its own (same JSONL records).
"""
from __future__ import annotations

import dataclasses
import itertools
import json
import os
import time
from collections import deque
from typing import Callable, Dict, List, Optional

from .recorder import NullRecorder, percentiles, stamp_wall

# one process-wide span-id allocator: ids stay unique when a fleet's
# tracer and every engine's tracer contribute spans to the same trace
# (allocation order is deterministic in a single-threaded run, so
# VirtualClock traces are reproducible end to end)
_span_ids = itertools.count(1)


def next_span_id() -> int:
    return next(_span_ids)


# the latency-attribution partition: every second of a request's life
# between t_arrival and t_done lands in exactly one of these buckets
ATTR_TERMS = ("queue_wait", "cached_skip", "prefill_compute", "decode",
              "replay", "migration")


@dataclasses.dataclass
class TraceContext:
    """The per-request trace identity, stamped once at submit and
    carried on the Request object across engines/migrations. ``ended``
    flips when the terminal span is emitted; a resubmission after a
    terminal state (request-level retry) begins a fresh attempt trace
    (``req-<rid>#<attempt>``) so every trace keeps exactly one terminal
    span."""

    trace_id: str
    span_id: int  # the root ("request") span's id — children parent to it
    attempt: int = 0
    ended: bool = False


class Tracer:
    """Span emitter over a recorder sink + the bounded flight ring.

    ``sink`` is any recorder (or a ``record(dict)``-style callable, the
    checkpoint manager's ``as_record`` shape); ``None`` keeps the ring
    alive with no stream. ``clock`` is only used to timestamp black-box
    *headers* (never spans — emission sites pass explicit clock values,
    see module docstring).
    """

    def __init__(self, sink=None, *, clock: Optional[Callable] = None,
                 ring_capacity: int = 256, tags: Optional[dict] = None):
        if sink is None:
            sink = NullRecorder()
        elif callable(sink) and not hasattr(sink, "record"):
            sink = _CallableSink(sink)
        self.sink = sink
        self.clock = clock if clock is not None else time.time
        self.ring: deque = deque(maxlen=ring_capacity)
        self.tags = dict(tags or {})

    def begin_request_trace(self, req) -> TraceContext:
        """Ensure ``req.trace`` holds a live :class:`TraceContext` —
        idempotent across fleet submit → engine submit → migration
        resubmit; a NEW attempt trace only begins when the previous one
        already emitted its terminal span (request-level retry)."""
        ctx = getattr(req, "trace", None)
        if ctx is not None and not ctx.ended:
            return ctx
        attempt = 0 if ctx is None else ctx.attempt + 1
        tid = (f"req-{req.rid}" if attempt == 0
               else f"req-{req.rid}#{attempt}")
        ctx = TraceContext(trace_id=tid, span_id=next_span_id(),
                           attempt=attempt)
        req.trace = ctx
        return ctx

    def emit(self, name: str, trace_id: str, t_start: float, t_end: float,
             *, span_id: Optional[int] = None,
             parent_id: Optional[int] = None, terminal: bool = False,
             ring_only: bool = False, **attrs) -> int:
        """Emit one closed span record. Returns its span id (callers
        that allocated the id up front — request roots — pass it in)."""
        sid = span_id if span_id is not None else next_span_id()
        rec = {"event": "span", "name": name, "trace_id": trace_id,
               "span_id": sid, "parent_id": parent_id,
               "t_start": float(t_start), "t_end": float(t_end),
               "terminal": bool(terminal), **self.tags, **attrs}
        self.ring.append(rec)
        if not ring_only:
            self.sink.record(rec)
        return sid

    def dump_blackbox(self, *, reason: str, path: Optional[str] = None,
                      sink=None, stacks: Optional[str] = None,
                      **extra) -> List[dict]:
        """Dump the flight ring as a post-mortem black box: a header
        record (``event == "blackbox"``, carrying the reason and —
        on the hang path — ``HangError.stacks``) followed by every
        ring span, written as JSONL to ``path`` and/or replayed into
        ``sink``. Returns the records."""
        header = stamp_wall({"event": "blackbox", "reason": str(reason),
                             "t": float(self.clock()),
                             "n_spans": len(self.ring), **self.tags,
                             **extra})
        if stacks is not None:
            header["stacks"] = str(stacks)
        # replayed spans are post-mortem COPIES — some were already
        # written to the live stream; the marker lets readers
        # (trace_report) keep causality validation over originals only
        records = [header] + [
            {**r, "blackbox_replay": True} for r in self.ring]
        if path is not None:
            d = os.path.dirname(os.path.abspath(path))
            os.makedirs(d, exist_ok=True)
            with open(path, "w") as f:
                for rec in records:
                    f.write(json.dumps(_best_effort_jsonable(rec)) + "\n")
        if sink is not None:
            for rec in records:
                sink.record(rec)
        return records


class _CallableSink:
    """Adapt a ``record(dict)`` callable (the checkpoint stack's
    ``as_record`` shape) to the recorder protocol."""

    def __init__(self, fn):
        self._fn = fn

    def record(self, rec: dict) -> None:
        self._fn(rec)

    def flush(self) -> None:
        pass

    def close(self) -> None:
        pass


def _best_effort_jsonable(rec: dict) -> dict:
    from .recorder import _jsonable

    return {str(k): _jsonable(v) for k, v in rec.items()}


# ---------------------------------------------------------------------------
# latency attribution

def attr_init(req, now: float) -> None:
    """Start the attribution ledger at ``t_arrival`` — idempotent (a
    migrated/resubmitted request keeps its running totals, so terms
    still sum to the latency measured from the ORIGINAL arrival)."""
    if getattr(req, "attr", None) is None:
        req.attr = {t: 0.0 for t in ATTR_TERMS}
        req._t_attr = float(now)


def attr_account(req, now: float, term: str) -> None:
    """Attribute the interval since the last accounting point to
    ``term`` and advance the cursor. Every call site passes a clock
    value it already read (the engine's boundary/post-step ``now``, the
    fleet's placement ``now``), so the ledger partitions the exact
    wall-time the latency stamps measure — no clock reads, no gaps, no
    double counting."""
    if getattr(req, "attr", None) is None:
        attr_init(req, now)
        return
    prev = req._t_attr
    now = float(now)
    if now > prev:
        req.attr[term] += now - prev
        req._t_attr = now


def attr_snapshot_ttft(req) -> None:
    """Freeze the ledger at the first-token instant (called under the
    same ``now`` that stamps ``t_first_token``): these terms sum to the
    measured TTFT exactly."""
    if getattr(req, "attr", None) is not None and req.attr_ttft is None:
        req.attr_ttft = dict(req.attr)


def emit_terminal_span(tracer, req, status: str, reason: str, *,
                       now: float, term: str = "queue_wait",
                       slo_ok: Optional[bool] = None) -> None:
    """Close a request trace: account the final interval to ``term``
    and emit the single TERMINAL "request" root span (plus the "decode"
    child for completed requests), carrying the attribution breakdown
    and — on SLO violators — the dominant-cause label. Shared by
    ``ServingEngine._finalize`` and ``ReplicaFleet._finalize`` so a
    request finalized on either side closes identically. Idempotent
    per attempt (``ctx.ended``)."""
    ctx = getattr(req, "trace", None)
    if tracer is None or ctx is None or ctx.ended:
        return
    attr_account(req, now, term)
    t0 = req.t_arrival if req.t_arrival is not None else now
    if status == "completed" and req.t_first_token is not None:
        tracer.emit("decode", ctx.trace_id, req.t_first_token, now,
                    parent_id=ctx.span_id, tokens=len(req.out_tokens))
    attrs = {"rid": req.rid, "status": status, "reason": reason,
             "generated": len(req.out_tokens),
             "preemptions": req.preemptions, "restarts": req.restarts}
    if req.attr is not None:
        attrs["attr_ms"] = {t: 1e3 * v for t, v in req.attr.items()}
        if req.attr_ttft is not None:
            attrs["attr_ttft_ms"] = {
                t: 1e3 * v for t, v in req.attr_ttft.items()}
        if slo_ok is False:
            attrs["slo_violated"] = True
            attrs["dominant_cause"] = dominant_cause(req.attr)
    tracer.emit("request", ctx.trace_id, t0, now, span_id=ctx.span_id,
                terminal=True, **attrs)
    ctx.ended = True


def dominant_cause(attr: Optional[Dict[str, float]]) -> Optional[str]:
    """The largest attribution term — the one-word answer to "where did
    this request's budget go?"."""
    if not attr or all(v <= 0.0 for v in attr.values()):
        return None
    return max(ATTR_TERMS, key=lambda t: attr.get(t, 0.0))


def attribution_summary(reqs, *, violators=None) -> Optional[dict]:
    """Fold per-request attribution ledgers into the summary block:
    per-term percentiles (ms) for the TTFT decomposition (requests that
    produced a first token) and the end-to-end decomposition (all
    attributed requests), the max relative error of the
    sum-of-terms-vs-measured-TTFT identity, and a dominant-cause tally
    over ``violators`` (the SLO-missing subset). ``None`` when nothing
    was attributed (tracing off)."""
    e2e = [r for r in reqs if getattr(r, "attr", None)]
    if not e2e:
        return None
    ttft = [r for r in e2e if r.attr_ttft is not None
            and r.t_first_token is not None and r.t_arrival is not None]
    out = {
        "terms": list(ATTR_TERMS),
        "ttft_ms": {t: percentiles(
            [1e3 * r.attr_ttft[t] for r in ttft]) for t in ATTR_TERMS},
        "e2e_ms": {t: percentiles(
            [1e3 * r.attr[t] for r in e2e]) for t in ATTR_TERMS},
        "n_attributed": len(e2e),
    }
    errs = []
    for r in ttft:
        measured = r.t_first_token - r.t_arrival
        total = sum(r.attr_ttft.values())
        if measured > 0:
            errs.append(abs(total - measured) / measured)
    out["ttft_sum_rel_err_max"] = max(errs) if errs else 0.0
    if violators is not None:
        tally: Dict[str, int] = {}
        for r in violators:
            cause = dominant_cause(getattr(r, "attr", None))
            if cause is not None:
                tally[cause] = tally.get(cause, 0) + 1
        out["dominant_causes"] = tally
    return out
