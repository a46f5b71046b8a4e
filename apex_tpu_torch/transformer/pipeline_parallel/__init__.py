"""Pipeline parallelism (counterpart of
``apex_tpu/transformer/pipeline_parallel/__init__.py``): stages are
processes, the hops ``torch.distributed`` point-to-point ops over the
``parallel_state`` pipeline group, and the schedules eager loops that
run each microbatch's backward (``schedules.common``)."""
from . import p2p_communication  # noqa: F401
from .schedules import (  # noqa: F401
    build_model,
    forward_backward_no_pipelining,
    get_forward_backward_func,
    pipeline_forward_backward,
    pipeline_forward_backward_interleaved,
    run_pipeline,
    run_pipeline_interleaved,
)
from ._timers import Timers  # noqa: F401
