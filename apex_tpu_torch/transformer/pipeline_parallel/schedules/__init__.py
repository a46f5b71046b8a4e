"""Schedule dispatcher (counterpart of
``apex_tpu/transformer/pipeline_parallel/schedules/__init__.py``;
reference ``schedules/__init__.py:22-59``)."""
from ... import parallel_state
from .common import build_model  # noqa: F401
from .fwd_bwd_no_pipelining import forward_backward_no_pipelining  # noqa: F401
from .fwd_bwd_pipelining_with_interleaving import (  # noqa: F401
    pipeline_forward_backward_interleaved,
    run_pipeline_interleaved,
)
from .fwd_bwd_1f1b import pipeline_forward_backward_1f1b  # noqa: F401
from .fwd_bwd_pipelining_without_interleaving import (  # noqa: F401
    pipeline_forward_backward,
    run_pipeline,
)


def get_forward_backward_func(
    virtual_pipeline_model_parallel_size=None,
    pipeline_model_parallel_size=None,
):
    """The reference's choice (``__init__.py:22-59``): no pipelining at
    pp 1; the interleaved schedule with virtual pipelining; else
    :func:`pipeline_forward_backward` (all forwards, then all backwards;
    :func:`pipeline_forward_backward_1f1b` holds at most ``pp - rank``
    microbatches in flight). The sizes default to ``parallel_state``'s."""
    if pipeline_model_parallel_size is None:
        pipeline_model_parallel_size = (
            parallel_state.get_pipeline_model_parallel_world_size())
    if virtual_pipeline_model_parallel_size is None:
        virtual_pipeline_model_parallel_size = (
            parallel_state.get_virtual_pipeline_model_parallel_world_size())
    if pipeline_model_parallel_size > 1:
        if virtual_pipeline_model_parallel_size is not None:
            return pipeline_forward_backward_interleaved
        return pipeline_forward_backward
    return forward_backward_no_pipelining
