"""apex_tpu_torch.telemetry: training-run observability (counterpart of
``apex_tpu/telemetry``), with no host sync on the hot path:

- :mod:`~apex_tpu_torch.telemetry.metrics` — a :class:`MetricsState` of
  device scalars accumulated in the step and drained every N steps;
- :mod:`~apex_tpu_torch.telemetry.recorder` — host sinks (JSONL writer,
  ring buffer, tagging, fan-out) with rank-0 gating, the JSONL format of
  the JAX package's, and :func:`flush`, which emits what the drains have
  deferred (the counterpart of ``jax.effects_barrier()``);
- :mod:`~apex_tpu_torch.telemetry.numerics` — the numerics health
  monitor: per-tensor overflow provenance (pytree and packed flat-buffer
  paths, the latter on the ``packed_row_stats`` kernel), activation-watch
  taps, and the anomaly rules.

Alerts, SLOs, spans, tracing, time series and pipeline accounting are not
ported yet.
"""
from . import numerics  # noqa: F401
from .metrics import (  # noqa: F401
    MetricsState,
    accumulate,
    drain,
    init_metrics,
    observe_scale_update,
    summarize,
)
from .numerics import (  # noqa: F401
    ActivationWatch,
    NumericsMonitor,
    NumericsState,
    activation_watch,
)
from .recorder import (  # noqa: F401
    JsonlRecorder,
    MultiRecorder,
    NullRecorder,
    RingBufferRecorder,
    TaggedRecorder,
    flush,
    is_logging_process,
    percentiles,
    read_jsonl,
    stamp_wall,
)

__all__ = [
    "MetricsState", "accumulate", "drain", "init_metrics",
    "observe_scale_update", "summarize",
    "numerics", "NumericsMonitor", "NumericsState", "ActivationWatch",
    "activation_watch",
    "JsonlRecorder", "MultiRecorder", "NullRecorder",
    "RingBufferRecorder", "TaggedRecorder", "flush", "is_logging_process",
    "percentiles", "read_jsonl", "stamp_wall",
]
