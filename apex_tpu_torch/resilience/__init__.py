"""apex_tpu_torch.resilience: keep training and serving through the
failures the monitors see (counterpart of ``apex_tpu.resilience``):

- :mod:`~apex_tpu_torch.resilience.manager` — preemption-safe
  :class:`CheckpointManager`: atomic step directories (tmp + rename),
  ``keep_n`` retention + GC, async saves (card copies, then a host copy
  on a stream of their own) barriered at the next save,
  corrupted-checkpoint fallback on restore, SIGTERM emergency flush;
  over this package's checkpoint format (``arrays.bin`` +
  ``index.json``);
- :mod:`~apex_tpu_torch.resilience.state` — :class:`TrainState`
  capture/restore (params, packed or pytree optimizer state, scaler,
  the generator state, data-iterator position, telemetry counters) and
  the :func:`resume_or_init` one-liner; resumed runs continue the loss
  curve bit-exactly;
- :mod:`~apex_tpu_torch.resilience.rewind` — :class:`RewindController`:
  a host ring of the last K good states, triggered by the numerics
  monitor's ``scaler_stall`` / ``scale_collapse`` events or the scaler's
  consecutive-skip counter; rewinds past poisoned data windows;
- :mod:`~apex_tpu_torch.resilience.watchdog` — :class:`HangWatchdog`:
  bounded blocking points with all-thread stack dumps instead of a
  silent stall (the serving step arms its one host sync through it);
- :mod:`~apex_tpu_torch.resilience.retry` — the jittered-backoff
  :class:`RetryPolicy` and :func:`retry_call` (checkpoint IO, the
  elastic barrier, request-level retry of quarantined serving
  requests);
- :mod:`~apex_tpu_torch.resilience.liveness` — heartbeat files and
  dead-writer sweeps;
- :mod:`~apex_tpu_torch.resilience.chaos` — fault injection (NaN
  gradients, failed/truncated checkpoint writes, fake preemption,
  stalled callbacks, SIGKILLed fake hosts, and the serving engine's
  :class:`ServingChaos`);
- :mod:`~apex_tpu_torch.resilience.elastic` — the elastic service: a
  :class:`Supervisor` running the train loop as N fake-host
  subprocesses (``_elastic_host.py``, on the card by default) with
  death/hang detection and world restart, the two-phase multi-host
  checkpoint commit (:class:`ElasticCheckpointManager`), and
  topology-elastic resume (:func:`reflatten_flat`). CLI:
  ``tools/torch_elastic_supervisor.py``.
"""
from .chaos import (  # noqa: F401
    ChaosError,
    ChaosHost,
    ChaosMonkey,
    ServingChaos,
    StallingSink,
    WorkerChaos,
    corrupt_checkpoint,
    poison_grads,
    request_storm,
    send_preemption,
)
from .elastic import (  # noqa: F401
    COMMIT_MARKER,
    ElasticCheckpointManager,
    Heartbeat,
    Supervisor,
    WorldFailedError,
    grad_buckets_for_world,
    pack_spec_for_world,
    reflatten_flat,
    sharded_leaf_indices,
    world_chunk_size,
)
from .liveness import (  # noqa: F401
    live_beat,
    read_json_tolerant,
    sweep_stale,
    writer_alive,
)
from .manager import (  # noqa: F401
    CHECKPOINT_IO_POLICY,
    CheckpointManager,
    PreemptionError,
)
from .retry import (  # noqa: F401
    ELASTIC_BARRIER_POLICY,
    TRANSPORT_POLICY,
    BarrierNotReady,
    RetryPolicy,
    as_record,
    retry_call,
)
from .rewind import (  # noqa: F401
    RewindController,
    RewindExhaustedError,
)
from .state import (  # noqa: F401
    IndexedBatches,
    ResumableIterator,
    TrainState,
    capture,
    host_snapshot,
    resume_or_init,
)
from .watchdog import (  # noqa: F401
    HangError,
    HangWatchdog,
    dump_all_stacks,
)

__all__ = [
    "CHECKPOINT_IO_POLICY", "CheckpointManager", "PreemptionError",
    "ELASTIC_BARRIER_POLICY", "TRANSPORT_POLICY",
    "BarrierNotReady", "RetryPolicy", "as_record", "retry_call",
    "RewindController", "RewindExhaustedError",
    "IndexedBatches", "ResumableIterator", "TrainState", "capture",
    "host_snapshot", "resume_or_init",
    "HangError", "HangWatchdog", "dump_all_stacks",
    "ChaosError", "ChaosHost", "ChaosMonkey", "ServingChaos",
    "StallingSink", "WorkerChaos", "corrupt_checkpoint", "poison_grads",
    "request_storm", "send_preemption",
    "COMMIT_MARKER", "ElasticCheckpointManager", "Heartbeat",
    "Supervisor", "WorldFailedError", "grad_buckets_for_world",
    "pack_spec_for_world", "reflatten_flat", "sharded_leaf_indices",
    "world_chunk_size",
    "live_beat", "read_json_tolerant", "sweep_stale", "writer_alive",
]
