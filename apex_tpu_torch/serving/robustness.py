"""Serving robustness: request lifecycle, admission control, degradation
(counterpart of ``apex_tpu/serving/robustness.py``; host code, copied).

The engine's recompute-preemption machinery is already a
correctness-proven way to move a request across a disruption, so the
same replay path carries requests across timeouts, sheds, poisoned
batches, and full engine restarts:

- **lifecycle** — :class:`RequestStatus`: every request ends in exactly
  one typed terminal state (``COMPLETED | REJECTED | TIMED_OUT | FAILED
  | CANCELLED``), finalized with a structured ``request_end`` telemetry
  event instead of silently occupying capacity;
- **typed rejection** — :class:`RejectionReason` /
  :class:`RejectionError`: one taxonomy for every refusal, covering the
  scheduler's own refusals (pool-infeasible, replay-prompt-overflow)
  and the admission-control rejections alike;
- **admission control** — :class:`AdmissionController` over
  :class:`AdmissionConfig`: a bounded queue with watermark-hysteresis
  backpressure, plus token-budget admission — refuse work whose
  estimated latency lower bound (queue wait + token-at-a-time service,
  at the measured EWMA step time) already exceeds its deadline;
- **graceful degradation** — :class:`DegradationPolicy`: under
  sustained pressure, cap ``max_new_tokens`` at admission and shed
  deadline-infeasible / lowest-priority queued requests, emitting
  ``reject``/``shed``/``degrade`` telemetry through the recorder sink;
- **recovery** — :func:`recover_requests`: pull every non-terminal
  request out of a dead engine in seniority order so a fresh
  :class:`~apex_tpu_torch.serving.engine.ServingEngine` replays them to
  completion (``ServingEngine.recover_from``), token-identical for
  survivors.

Deadlines are wall-clock (``Request.ttft_budget_ms`` /
``latency_budget_ms``) against the engine's injectable clock;
:class:`VirtualClock` makes the timeout machinery deterministic for
tests and the chaos harness (one tick per clock read).
"""
from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import TYPE_CHECKING, List, Optional

if TYPE_CHECKING:  # pragma: no cover - typing only, no runtime cycle
    from .scheduler import Request


class RequestStatus(enum.Enum):
    """Request lifecycle. Exactly one terminal state per request."""

    PENDING = "pending"       # constructed, not yet submitted
    QUEUED = "queued"         # accepted into the waiting queue
    RUNNING = "running"       # occupying a slot
    COMPLETED = "completed"   # all tokens emitted (or EOS)
    REJECTED = "rejected"     # refused at admission (or shed)
    TIMED_OUT = "timed_out"   # TTFT / total-latency budget expired
    FAILED = "failed"         # fault-isolated (e.g. non-finite logits)
    CANCELLED = "cancelled"   # caller withdrew it


TERMINAL_STATES = frozenset({
    RequestStatus.COMPLETED, RequestStatus.REJECTED,
    RequestStatus.TIMED_OUT, RequestStatus.FAILED,
    RequestStatus.CANCELLED,
})


def is_terminal(status: RequestStatus) -> bool:
    return status in TERMINAL_STATES


class RejectionCode(enum.Enum):
    """Why a request was refused — one taxonomy for the scheduler's
    refusals and the admission-control rejections (the JAX package's
    values)."""

    EMPTY_PROMPT = "empty_prompt"
    PROMPT_TOO_LONG = "prompt_too_long"
    REPLAY_OVERFLOW = "replay_overflow"        # legacy: preemption replay
    EXCEEDS_MAX_SEQ = "exceeds_max_seq"
    POOL_INFEASIBLE = "pool_infeasible"        # legacy: pool can never hold
    BAD_MAX_NEW = "bad_max_new"
    QUEUE_FULL = "queue_full"                  # hard queue bound
    BACKPRESSURE = "backpressure"              # watermark hysteresis
    DEADLINE_INFEASIBLE = "deadline_infeasible"
    SHED = "shed"                              # degradation shed
    ALREADY_IN_FLIGHT = "already_in_flight"    # duplicate submission
    NO_FEASIBLE_REPLICA = "no_feasible_replica"  # fleet router: none fit
    UNSUPPORTED_SAMPLING = "unsupported_sampling"  # TP: top_k beyond filter


@dataclass(frozen=True)
class RejectionReason:
    """Structured refusal: machine-readable code + human message +
    free-form detail (budgets, estimates, limits)."""

    code: RejectionCode
    message: str
    detail: dict = field(default_factory=dict)

    def as_record(self) -> dict:
        return {"code": self.code.value, "message": self.message,
                **({"detail": self.detail} if self.detail else {})}


class SchedulerError(RuntimeError):
    """Scheduling-contract violation. Lives here (not ``scheduler.py``,
    which re-exports it) so :class:`RejectionError` can subclass it
    without an import cycle."""


class RejectionError(SchedulerError):
    """Raised by the raising submit paths; carries the typed reason.

    Subclasses :class:`SchedulerError` so pre-existing ``except
    SchedulerError`` / ``pytest.raises(SchedulerError, match=...)``
    call sites keep working unchanged.
    """

    def __init__(self, reason: RejectionReason):
        self.reason = reason
        super().__init__(reason.message)


class VirtualClock:
    """Deterministic test clock: every read advances ``dt``.

    The engine reads its clock a fixed number of times per scheduling
    boundary, so with a VirtualClock the deadline machinery (TTFT /
    total-latency budgets) becomes exactly reproducible — budgets are
    effectively denominated in clock reads instead of wall seconds.
    """

    def __init__(self, dt: float = 1.0, start: float = 0.0):
        self.t = float(start)
        self.dt = float(dt)

    def __call__(self) -> float:
        self.t += self.dt
        return self.t


@dataclass(frozen=True)
class AdmissionConfig:
    """Bounded-queue admission control.

    - ``max_queue``: hard bound on waiting-queue depth; beyond it every
      submit is refused (``QUEUE_FULL``).
    - ``high_watermark``/``low_watermark``: hysteresis fractions of
      ``max_queue``. Depth >= high flips backpressure ON (submissions
      refused with ``BACKPRESSURE``); it stays on until depth drains to
      <= low — the standard two-level watermark, so overload does not
      flap the front door open and shut every request.
    - ``step_time_init_s``: prior for the EWMA step-time estimate used
      by token-budget admission (0 disables feasibility checks until
      the first measured step).
    - ``ewma_alpha``: step-time EWMA smoothing.
    """

    max_queue: int = 64
    high_watermark: float = 0.75
    low_watermark: float = 0.5
    step_time_init_s: float = 0.0
    ewma_alpha: float = 0.2


@dataclass(frozen=True)
class DegradationPolicy:
    """What to give up, and when, under sustained overload.

    - ``shed_after``: consecutive pressured scheduling boundaries
      (queue depth >= high watermark) before shedding starts.
    - ``cap_max_new``: while pressured, newly admitted requests have
      ``max_new_tokens`` capped here (less work per request keeps the
      front door open; a ``degrade`` event records the cut).
    """

    shed_after: int = 3
    cap_max_new: Optional[int] = None


class AdmissionController:
    """Host-side admission state: watermark hysteresis, EWMA step time,
    token-budget feasibility, shed-victim selection.

    The engine consults it at submit (:meth:`check`) and once per
    scheduling boundary (:meth:`note_boundary`); it feeds measured step
    times back via :meth:`observe_step`.
    """

    def __init__(self, config: AdmissionConfig, n_slots: int,
                 degradation: Optional[DegradationPolicy] = None):
        self.config = config
        self.n_slots = max(1, int(n_slots))
        self.degradation = degradation
        self._est_step_s = float(config.step_time_init_s)
        self._backpressure = False
        self._pressure_run = 0
        self.max_queue_seen = 0
        self.rejected = 0
        self.shed = 0

    # -- derived thresholds --------------------------------------------------
    @property
    def high_count(self) -> int:
        return max(1, int(self.config.max_queue * self.config.high_watermark))

    @property
    def low_count(self) -> int:
        return max(0, int(self.config.max_queue * self.config.low_watermark))

    @property
    def est_step_s(self) -> float:
        return self._est_step_s

    @property
    def estimated_step_time_s(self) -> float:
        """Read-only EWMA step-time estimate (seconds; 0.0 until the
        first measured step) — the per-replica cost model the fleet
        router consumes. Spelled out (vs the terse :attr:`est_step_s`)
        because it is the cross-module contract."""
        return self._est_step_s

    @property
    def backpressure(self) -> bool:
        return self._backpressure

    def observe_step(self, dt_s: float) -> None:
        if dt_s <= 0:
            return
        a = self.config.ewma_alpha
        if self._est_step_s <= 0:
            self._est_step_s = float(dt_s)
        else:
            self._est_step_s = (1 - a) * self._est_step_s + a * float(dt_s)

    # -- alert-driven degradation (telemetry.alerts.FleetResponder) ----------
    def arm_degradation(
            self, policy: Optional[DegradationPolicy]) -> None:
        """Install (or tighten) the degradation policy at runtime — the
        health plane's load-shedding actuator. Policies are frozen
        dataclasses, so swapping the reference is the whole mechanism;
        the next :meth:`check` call sees the new shed/cap thresholds."""
        self.degradation = policy

    def relax_degradation(
            self, policy: Optional[DegradationPolicy] = None) -> None:
        """Restore a previously saved policy (``None`` = fully disarm)
        when the driving alert resolves."""
        self.degradation = policy

    # -- feasibility ---------------------------------------------------------
    def latency_bounds_ms(self, prompt_len: int, max_new: int,
                          queued_tokens: int):
        """(ttft_lb_ms, latency_lb_ms) — estimated lower bounds for a
        request submitted now: queue wait (queued tokens ahead shared
        over ``n_slots`` token-at-a-time slots) plus its own service
        (one step per prompt token to first token, one per new token
        after), at the EWMA step time. ``(None, None)`` when no step
        has been measured yet.

        ``prompt_len`` is really *steps until the first token once
        scheduled*: with a prefix cache and chunked prefill the engine
        passes ``ceil(uncached prompt / prefill_chunk)`` — admission
        feasibility counts only the prefill work actually owed, so a
        request whose shared head sits in the cache is not refused
        against flops it will never spend."""
        est = self._est_step_s
        if est <= 0:
            return None, None
        wait_steps = queued_tokens / self.n_slots
        ttft = (wait_steps + prompt_len) * est * 1e3
        total = (wait_steps + prompt_len + max_new) * est * 1e3
        return ttft, total

    def _next_backpressure(self, queue_depth: int) -> bool:
        """The hysteresis latch value a submit at this depth would see
        (ON at high, OFF only back at low) — pure function of current
        latch + depth, shared by the mutating :meth:`check` and the
        read-only :meth:`probe`."""
        if self._backpressure and queue_depth <= self.low_count:
            return False
        if not self._backpressure and queue_depth >= self.high_count:
            return True
        return self._backpressure

    def _admission_reason(self, req: "Request", queue_depth: int,
                          queued_tokens: int, backpressure: bool,
                          prefill_steps: Optional[int] = None
                          ) -> Optional[RejectionReason]:
        """The admission verdict for one submit, given an (already
        resolved) hysteresis state; ``None`` = admit. Pure — no counter
        or latch updates. ``prefill_steps`` overrides the raw prompt
        length in the feasibility bound (the engine's uncached,
        chunk-adjusted steps-to-first-token estimate)."""
        if queue_depth >= self.config.max_queue:
            return RejectionReason(
                RejectionCode.QUEUE_FULL,
                f"request {req.rid}: queue full "
                f"({queue_depth}/{self.config.max_queue})",
                {"queue_depth": queue_depth,
                 "max_queue": self.config.max_queue})
        if backpressure:
            return RejectionReason(
                RejectionCode.BACKPRESSURE,
                f"request {req.rid}: backpressure (queue {queue_depth} >= "
                f"high watermark {self.high_count}, drains at "
                f"{self.low_count})",
                {"queue_depth": queue_depth, "high": self.high_count,
                 "low": self.low_count})
        # token-budget admission: refuse work that (by the measured
        # estimate) cannot meet its own deadline even if nothing else
        # goes wrong
        ttft_lb, lat_lb = self.latency_bounds_ms(
            prefill_steps if prefill_steps is not None
            else len(req.prompt),
            req.max_new_tokens, queued_tokens)
        if lat_lb is not None:
            if (req.latency_budget_ms is not None
                    and lat_lb > req.latency_budget_ms):
                return RejectionReason(
                    RejectionCode.DEADLINE_INFEASIBLE,
                    f"request {req.rid}: estimated latency lower bound "
                    f"{lat_lb:.1f}ms exceeds budget "
                    f"{req.latency_budget_ms:.1f}ms",
                    {"latency_lb_ms": round(lat_lb, 1),
                     "latency_budget_ms": req.latency_budget_ms,
                     "est_step_ms": round(self._est_step_s * 1e3, 3)})
            # TTFT infeasibility only while the first token is still
            # owed (same rule as pick_shed_victim): a re-admitted
            # request that already attained its TTFT — a preempted,
            # recovered, or fleet-migrated survivor — must not be
            # refused against a deadline it already met
            if (req.ttft_budget_ms is not None
                    and req.t_first_token is None
                    and ttft_lb > req.ttft_budget_ms):
                return RejectionReason(
                    RejectionCode.DEADLINE_INFEASIBLE,
                    f"request {req.rid}: estimated TTFT lower bound "
                    f"{ttft_lb:.1f}ms exceeds budget "
                    f"{req.ttft_budget_ms:.1f}ms",
                    {"ttft_lb_ms": round(ttft_lb, 1),
                     "ttft_budget_ms": req.ttft_budget_ms,
                     "est_step_ms": round(self._est_step_s * 1e3, 3)})
        return None

    def check(self, req: "Request", *, queue_depth: int,
              queued_tokens: int,
              prefill_steps: Optional[int] = None
              ) -> Optional[RejectionReason]:
        """Admission decision for one submit; ``None`` = admit.
        Mutating: latches the watermark hysteresis and counts
        rejections — this is the door a request actually walks
        through. Use :meth:`probe` for advisory routing queries."""
        self.max_queue_seen = max(self.max_queue_seen, queue_depth)
        # queue-full precedes the latch update (a hard-bound refusal
        # does not flip hysteresis state — historical behaviour)
        if queue_depth < self.config.max_queue:
            self._backpressure = self._next_backpressure(queue_depth)
        reason = self._admission_reason(req, queue_depth, queued_tokens,
                                        self._backpressure,
                                        prefill_steps=prefill_steps)
        if reason is not None:
            self.rejected += 1
        return reason

    def probe(self, req: "Request", *, queue_depth: int,
              queued_tokens: int,
              prefill_steps: Optional[int] = None
              ) -> Optional[RejectionReason]:
        """The verdict :meth:`check` WOULD return for this submit,
        without acting through admission side effects: no hysteresis
        latch flip, no rejection counters, no high-water marks. The
        fleet router costs every replica per request — a mutating
        feasibility sweep would latch backpressure (or pad the reject
        tally) on replicas the request never touches."""
        return self._admission_reason(
            req, queue_depth, queued_tokens,
            self._next_backpressure(queue_depth)
            if queue_depth < self.config.max_queue
            else self._backpressure,
            prefill_steps=prefill_steps)

    # -- degradation ---------------------------------------------------------
    @property
    def pressured(self) -> bool:
        return self._backpressure

    def cap_for(self, req: "Request",
                queue_depth: int) -> Optional[int]:
        """The ``max_new_tokens`` cap to apply to this submit, or
        ``None``. Only caps while the queue sits at/above the high
        watermark (or backpressure is latched)."""
        d = self.degradation
        if d is None or d.cap_max_new is None:
            return None
        if not (self._backpressure or queue_depth >= self.high_count):
            return None
        if req.max_new_tokens <= d.cap_max_new:
            return None
        return int(d.cap_max_new)

    def note_boundary(self, queue_depth: int) -> bool:
        """Once per scheduling boundary: track sustained pressure.
        Returns True when the degradation policy says shedding should
        run now."""
        self.max_queue_seen = max(self.max_queue_seen, queue_depth)
        if queue_depth >= self.high_count:
            self._pressure_run += 1
        else:
            self._pressure_run = 0
        return (self.degradation is not None
                and self._pressure_run >= self.degradation.shed_after)

    def pick_shed_victim(self, waiting, queued_tokens: int):
        """Who to shed: deadline-infeasible requests first (they are
        dead weight — they will time out anyway), then lowest priority,
        youngest (highest rid) among equals. ``None`` when the queue is
        empty."""
        waiting = list(waiting)
        if not waiting:
            return None
        for req in waiting:
            ttft_lb, lat_lb = self.latency_bounds_ms(
                len(req.prompt) + len(req.out_tokens),
                req.max_new_tokens - len(req.out_tokens), queued_tokens)
            if lat_lb is None:
                break
            if (req.latency_budget_ms is not None
                    and lat_lb > req.latency_budget_ms):
                return req
            # TTFT infeasibility only matters while the first token is
            # still owed (a preempted request that already attained its
            # TTFT is not dead weight)
            if (req.ttft_budget_ms is not None and ttft_lb is not None
                    and req.t_first_token is None
                    and ttft_lb > req.ttft_budget_ms):
                return req
        return min(waiting, key=lambda r: (r.priority, -r.rid))


def already_in_flight(req: "Request",
                      where: Optional[str] = None) -> RejectionReason:
    """The duplicate-submission refusal — ONE constructor for the
    engine's submit/probe doors and the fleet's (which also fires for
    fleet-owned migrants, passing ``where="awaiting migration"`` since
    their status reads ``pending``)."""
    return RejectionReason(
        RejectionCode.ALREADY_IN_FLIGHT,
        f"request {req.rid}: already in flight "
        f"({where or req.status.value})")


def request_expired(req: "Request", now: float) -> Optional[str]:
    """Which deadline (if any) this request has blown at ``now``:
    ``"latency_budget"`` past its total budget, ``"ttft_budget"``
    still owed a first token past its TTFT budget, else ``None``.

    THE deadline predicate: the engine's boundary eviction and the
    fleet's migrant expiry both call it, so a request times out under
    one rule wherever it happens to be waiting.
    """
    if req.t_arrival is None:
        return None
    age_ms = (now - req.t_arrival) * 1e3
    if (req.latency_budget_ms is not None
            and age_ms > req.latency_budget_ms):
        return "latency_budget"
    if (req.ttft_budget_ms is not None
            and req.t_first_token is None
            and age_ms > req.ttft_budget_ms):
        return "ttft_budget"
    return None


class TransientRequestFailure(RuntimeError):
    """Raised (internally) when FAILED-transient requests survive a
    drain pass — the signal ``RetryPolicy`` retries on for
    request-level retry (``ServingEngine.generate(retry_failed=...)``)."""

    def __init__(self, requests):
        self.requests = list(requests)
        rids = [r.rid for r in self.requests]
        super().__init__(
            f"{len(rids)} transient-FAILED serving request(s): {rids}")


def recover_requests(engine) -> List["Request"]:
    """Pull every non-terminal request out of a (dead) engine for
    replay on a fresh one.

    Running slots come first in seniority order (``admit_seq``), then
    the waiting queue front-to-back — so FIFO re-admission on the new
    engine preserves the old service order. Each request is reset to
    ``PENDING`` with ``admit_seq`` cleared (the new scheduler assigns
    fresh seniority in the same order) and ``arrival_step`` zeroed
    (recovered work is past due, not future); generated tokens are
    KEPT — re-admission folds them into the replay prompt exactly like
    a recompute-mode preemption, so deterministic (greedy) replay
    continues token-identically where the dead engine stopped.
    """
    sched = engine.scheduler
    running = [run.req for _, run in
               sorted(sched.running(), key=lambda ir: ir[1].admit_seq)]
    reqs = running + list(sched.waiting)
    out = []
    for req in reqs:
        if is_terminal(req.status):
            continue
        req.status = RequestStatus.PENDING
        req.admit_seq = None
        req.arrival_step = 0
        req.restarts += 1
        out.append(req)
    return out
