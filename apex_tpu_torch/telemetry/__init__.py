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
  taps, and the anomaly rules;
- :mod:`~apex_tpu_torch.telemetry.spans` — end-to-end request tracing
  over the recorder sinks: :class:`Tracer`/:class:`TraceContext` span
  records (deterministic under ``VirtualClock``), the exact-sum
  latency-attribution ledger, and the bounded flight-recorder ring
  dumped as a black box on hangs and recovery.

Alerts, SLOs, profiler tracing, time series and pipeline accounting are
not ported yet.
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
from . import spans  # noqa: F401
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
from .spans import (  # noqa: F401
    ATTR_TERMS,
    TraceContext,
    Tracer,
    attr_account,
    attr_init,
    attr_snapshot_ttft,
    attribution_summary,
    dominant_cause,
    emit_terminal_span,
)

__all__ = [
    "MetricsState", "accumulate", "drain", "init_metrics",
    "observe_scale_update", "summarize",
    "numerics", "NumericsMonitor", "NumericsState", "ActivationWatch",
    "activation_watch",
    "JsonlRecorder", "MultiRecorder", "NullRecorder",
    "RingBufferRecorder", "TaggedRecorder", "flush", "is_logging_process",
    "percentiles", "read_jsonl", "stamp_wall",
    "spans", "ATTR_TERMS", "TraceContext", "Tracer", "attr_account",
    "attr_init", "attr_snapshot_ttft", "attribution_summary",
    "dominant_cause", "emit_terminal_span",
]
