"""Jittered-exponential-backoff retry — the one transient-failure policy
(counterpart of ``apex_tpu/resilience/retry.py``; host code, copied).

A :class:`RetryPolicy` names *which* exceptions are transient —
per-exception-class filters plus an optional message predicate — and how
to pace the re-attempts (exponential backoff with full jitter, the
standard thundering-herd-safe schedule). Every attempt can be mirrored
into telemetry (``{"event": "retry", ...}`` through any recorder sink),
so flaky infrastructure shows up in the run's JSONL instead of only on
stderr.

Consumers here: the serving engine's request-level retry
(``ServingEngine.generate(retry_failed=...)``), the checkpoint managers'
IO (``CHECKPOINT_IO_POLICY``) and the elastic commit barrier
(:data:`ELASTIC_BARRIER_POLICY`).

The JAX package's ``TRANSIENT_COMPILE_POLICY`` has no counterpart: it
retries a remote TPU compiler's transport flakes, and this package
compiles its kernels with a local ``nvcc``.

Usage::

    from apex_tpu_torch.resilience import RetryPolicy, retry_call

    policy = RetryPolicy(attempts=4, retry_on=(OSError,), base_delay=0.1)
    result = retry_call(fn, policy=policy, tag="ckpt write", sink=rec)
"""
from __future__ import annotations

import random
import sys
import time
from dataclasses import dataclass, field
from typing import Callable, Optional, Tuple, Type


def as_record(sink):
    """Coerce a telemetry sink to a ``callable(dict)``: recorders expose
    ``.record``, bare callables pass through, ``None`` stays ``None``.
    The one sink-contract shim for the whole resilience package."""
    if sink is None:
        return None
    return sink.record if hasattr(sink, "record") else sink


@dataclass(frozen=True)
class RetryPolicy:
    """What to retry and how to pace it.

    - ``attempts``: total tries (first call included).
    - ``retry_on``: exception classes considered transient. An exception
      not matching any class surfaces immediately.
    - ``message_filter``: optional extra predicate over the exception —
      both the class match AND the predicate must hold (used to narrow
      e.g. ``Exception`` to a known transport signature).
    - ``base_delay``/``max_delay``: exponential backoff bounds in
      seconds; attempt *k* sleeps ``uniform(0, min(max_delay, base_delay
      * 2**k))`` — "full jitter", so a fleet of preempted workers does
      not re-stampede the storage service in lockstep. ``base_delay=0``
      disables sleeping.
    - ``deadline``: overall wall-clock budget in seconds across ALL
      attempts (None = attempt-count only). When the elapsed time plus
      the next backoff would cross the budget, the retry loop gives up
      and the last exception surfaces — a request-level SLO must bound
      the *total* time burned retrying, not just how many times it spun
      (serving request retry, ``ServingEngine.generate(retry_failed=...)``).
    - ``emit_every``: stderr/telemetry cadence — only every N-th failed
      transient attempt is printed and recorded (default 1: every
      attempt). High-frequency poll loops driven through retry set this
      so a *normal* wait does not flood the event stream; the first
      attempt and the deadline event always emit.
    """

    attempts: int = 3
    retry_on: Tuple[Type[BaseException], ...] = (Exception,)
    message_filter: Optional[Callable[[BaseException], bool]] = None
    base_delay: float = 0.0
    max_delay: float = 30.0
    deadline: Optional[float] = None
    emit_every: int = 1
    rng: random.Random = field(default_factory=random.Random, repr=False)

    def is_transient(self, e: BaseException) -> bool:
        if not isinstance(e, self.retry_on):
            return False
        return self.message_filter is None or bool(self.message_filter(e))

    def delay(self, attempt: int) -> float:
        """Sleep before re-attempt number ``attempt`` (1-based)."""
        if self.base_delay <= 0:
            return 0.0
        cap = min(self.max_delay, self.base_delay * (2.0 ** (attempt - 1)))
        return self.rng.uniform(0.0, cap)


class BarrierNotReady(RuntimeError):
    """A filesystem rendezvous poll found peers still missing.

    The elastic commit barrier (``resilience.elastic``) raises this per
    attempt so :func:`retry_call` owns the pacing: each re-poll is a
    jittered-backoff "attempt", every one mirrored into telemetry as a
    ``retry`` event — slow peers show up in the run's JSONL the same way
    flaky storage does. The final attempt's :class:`BarrierNotReady`
    surfaces as the barrier timeout."""


#: The elastic multi-host commit barrier: many short re-polls of the
#: shared checkpoint directory with bounded jittered backoff. Peers
#: normally land within a step time; the generous attempt budget is for
#: a peer still starting up on its first save. Pair with ``deadline=``
#: (the manager derives it from ``barrier_timeout_s``) so the wall-clock
#: bound — not the attempt count — is the contract.
ELASTIC_BARRIER_POLICY = RetryPolicy(
    attempts=10_000,
    retry_on=(BarrierNotReady,),
    base_delay=0.02,
    max_delay=0.5,
    emit_every=25,
)


#: Router->worker transport I/O for a real-process serving fleet: every
#: connect/reconnect and framed RPC routes through this policy, so a
#: worker restart mid-request reads as ONE slow RPC, not an exception.
#: ``retry_on=(OSError,)`` covers the whole transport failure surface
#: (broken pipes, connection resets); full-jitter backoff avoids
#: re-stampeding a restarting worker, and the wall-clock ``deadline`` —
#: not the attempt count — is the contract. ``emit_every`` keeps a
#: normal restart from flooding the event stream.
TRANSPORT_POLICY = RetryPolicy(
    attempts=10_000,
    retry_on=(OSError,),
    base_delay=0.05,
    max_delay=1.0,
    deadline=30.0,
    emit_every=5,
)


def retry_call(
    fn: Callable,
    *,
    policy: Optional[RetryPolicy] = None,
    tag: str = "call",
    sink=None,
    sleep: Callable[[float], None] = time.sleep,
    clock: Callable[[], float] = time.monotonic,
):
    """Run ``fn()`` under ``policy`` (default :class:`RetryPolicy`());
    return its result.

    Each failed transient attempt emits ``{"event": "retry", "tag",
    "attempt", "of", "error", "delay_s"}`` to ``sink`` (a recorder with
    ``.record(dict)`` or a bare callable; ``None`` logs to stderr only)
    and sleeps the policy's jittered backoff. The final attempt's
    exception — or any non-transient one — propagates unchanged.

    ``policy.deadline`` bounds the whole loop in wall-clock seconds
    (measured by ``clock``, injectable for tests): when elapsed time
    plus the next backoff would cross it, a ``retry_deadline`` event is
    emitted and the last exception surfaces as if attempts had run out.
    """
    if policy is None:
        policy = RetryPolicy()
    record = as_record(sink)
    t0 = clock()
    last: Optional[BaseException] = None
    for attempt in range(1, policy.attempts + 1):
        try:
            return fn()
        except BaseException as e:
            last = e
            if not policy.is_transient(e) or attempt == policy.attempts:
                raise
            d = policy.delay(attempt)
            if policy.deadline is not None:
                elapsed = clock() - t0
                if elapsed + d >= policy.deadline:
                    print(
                        f"{tag}: deadline {policy.deadline:.2f}s "
                        f"exhausted after {attempt} attempt(s) "
                        f"({elapsed:.2f}s elapsed)",
                        file=sys.stderr,
                    )
                    if record is not None:
                        record({"event": "retry_deadline", "tag": tag,
                                "attempt": attempt,
                                "deadline_s": policy.deadline,
                                "elapsed_s": round(elapsed, 3)})
                    raise
            emit = (attempt == 1
                    or policy.emit_every <= 1
                    or attempt % policy.emit_every == 0)
            if emit:
                print(
                    f"{tag}: transient {type(e).__name__}, retrying "
                    f"(attempt {attempt + 1}/{policy.attempts}"
                    + (f", backoff {d:.2f}s" if d else "") + ")",
                    file=sys.stderr,
                )
                if record is not None:
                    record({"event": "retry", "tag": tag,
                            "attempt": attempt, "of": policy.attempts,
                            "error": f"{type(e).__name__}: {e}",
                            "delay_s": round(d, 3)})
            if d:
                sleep(d)
    raise last  # unreachable; keeps type-checkers honest
