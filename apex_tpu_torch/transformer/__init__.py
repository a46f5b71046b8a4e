"""Megatron-style transformer library (counterpart of
``apex_tpu/transformer``): ``parallel_state`` over ``torch.distributed``
and ``tensor_parallel``, and at first access the fused ``functional``
ops, ``layers``, the model-parallel ``amp``, the ``testing`` models and
harness, the ``_data`` samplers and the ``microbatches`` calculators.
``pipeline_parallel`` (the schedules and the stage-to-stage hops)."""
from . import parallel_state  # noqa: F401
from . import tensor_parallel  # noqa: F401
from .. import _lazy_import

_LAZY = ("pipeline_parallel", "functional", "layers", "amp", "testing",
         "_data", "microbatches")
_NOT_PORTED: dict = {}


def __getattr__(name):
    if name in _LAZY or name in _NOT_PORTED:
        return _lazy_import(__name__, globals(), name, _NOT_PORTED)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def __dir__():
    return sorted(set(globals()) | set(_LAZY))
