"""apex_tpu_torch.resilience: the serving engine's fault story
(counterpart of ``apex_tpu.resilience``, its serving parts):

- :mod:`~apex_tpu_torch.resilience.watchdog` — :class:`HangWatchdog`:
  bounded blocking points with all-thread stack dumps instead of a
  silent stall (the serving step arms its one host sync through it);
- :mod:`~apex_tpu_torch.resilience.retry` — the jittered-backoff
  :class:`RetryPolicy` and :func:`retry_call` (request-level retry of
  quarantined serving requests);
- :mod:`~apex_tpu_torch.resilience.chaos` — :class:`ServingChaos` fault
  injection (poisoned logits, wedged syncs, engine kills, stolen page
  allocations, forced cache evictions) and :func:`request_storm`.

Checkpointing, rewind, training chaos and the elastic service are not
ported yet.
"""
from .chaos import (  # noqa: F401
    ChaosError,
    ServingChaos,
    WorkerChaos,
    request_storm,
)
from .retry import RetryPolicy, as_record, retry_call  # noqa: F401
from .watchdog import HangError, HangWatchdog, dump_all_stacks  # noqa: F401

__all__ = [
    "ChaosError", "ServingChaos", "WorkerChaos", "request_storm",
    "RetryPolicy", "as_record", "retry_call",
    "HangError", "HangWatchdog", "dump_all_stacks",
]
