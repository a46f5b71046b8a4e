"""apex_tpu_torch: the PyTorch / NVIDIA Hopper port of ``apex_tpu``.

The JAX package ``apex_tpu`` stays the reference; this package mirrors
its module paths (``apex_tpu_torch/serving/engine.py`` is the
counterpart of ``apex_tpu/serving/engine.py``) and never imports it or
JAX. Each TPU kernel on a ported path becomes a kernel written by hand
for the H100 (``csrc/``, built with ``nvcc`` for ``sm_90a`` at first
use), beside a plain PyTorch version of the same function. Entry points
run on the card unless the caller asks for the CPU.

Ported so far, on one device: serving — ``serving.ServingEngine`` over
``serving.decode_model`` with the ``ops.flash_decode`` and
``ops.layer_norm`` (forward) kernels; the unfused train step —
``transformer.testing.gpt_loss`` with the ``ops.layer_norm`` (forward
and backward) and ``ops.flash_attention`` (forward and backward)
kernels, and ``optimizers.FusedAdam`` over the ``ops.packed_optimizer``
packed Adam kernel; the fused block tails (``ops.fused_block``);
attention without flash through ``transformer.functional.fused_softmax``
(forward and backward kernels); BERT (``bert_forward``,
``standalone_bert``) with ``contrib.xentropy.softmax_cross_entropy_loss``
and ``optimizers.FusedLAMB``, pytree or packed (the ``ops.packed_optimizer``
row reduce, LAMB stage 1 and trust-ratio apply kernels);
``optimizers.FusedSGD``, pytree or packed (the packed SGD kernel); the
norms, the telemetry core, the attention contribs, the amp frontend and
``fp16_utils``; and ``fused_dense`` (with the fp8 delayed-scaling recipe
of ``fused_dense.fp8``, whose GEMM is ``torch._scaled_mm`` on the fp8
tensor cores, and the GPT's ``GPTConfig(fp8=True)``), ``mlp``,
``transformer.functional.fused_rope`` and
``contrib.openfold.FusedAdamSWA``; the single-device contribs
(``contrib.focal_loss``, ``group_norm``, ``groupbn``, ``cudnn_gbn``,
``conv_bias_relu``, ``bottleneck``, ``index_mul_2d``, ``sparsity``,
``transducer``, the legacy ``contrib.optimizers``), the single-device
``parallel.sync_batch_norm`` and ``RNN``, plain PyTorch over cuDNN and
cuBLAS; the rest of the single-device library — the multi-tensor
applier (``multi_tensor_apply.multi_tensor_applier``), the optimizers'
base ``optimizers.FusedOptimizer``, the package logger below, host IO
over a native engine built with g++ (``ops.hostio``,
``contrib.gpu_direct_storage.GDSFile``), ``checkpoint`` and
``transformer.testing.gpt_model_provider`` with the ``cpu_offload`` of
``torch.autograd.graph.save_on_cpu``; and the model-parallel state over
``torch.distributed`` (``transformer.parallel_state``, the fp8 amax
reduction over its group, ``transformer.amp.GradScaler``,
``parallel.initialize_distributed``).

Subpackages import as in the JAX package: ``amp``, ``optimizers``,
``normalization`` and ``multi_tensor_apply`` eagerly, the others of its
``_LAZY_SUBMODULES`` at first attribute access.
"""
import logging
import sys

from ._device import (  # noqa: F401
    kernel_route,
    launch_counts,
    reset_launch_counts,
    resolve_device,
)

__version__ = "0.1.0"


class RankInfoFormatter(logging.Formatter):
    """Log formatter prefixing each record with ``[rank/world]`` of the
    initialised ``torch.distributed`` process group, or ``[-/-]`` before
    one exists (the reference's rank-aware formatter,
    ``apex/__init__.py:31-43``)."""

    def format(self, record):
        import torch.distributed as dist

        if dist.is_available() and dist.is_initialized():
            rank_info = f"[{dist.get_rank()}/{dist.get_world_size()}]"
        else:
            rank_info = "[-/-]"
        record.rank_info = rank_info
        return super().format(record)


_library_root_logger = logging.getLogger(__name__)


def _setup_logger() -> None:
    handler = logging.StreamHandler(sys.stderr)
    handler.setFormatter(RankInfoFormatter(
        "%(asctime)s - %(name)s - %(levelname)s - %(rank_info)s - "
        "%(message)s"))
    _library_root_logger.addHandler(handler)
    _library_root_logger.propagate = False


_setup_logger()


def set_logging_level(level) -> None:
    """Set the library's logging level (reference ``apex/__init__.py:60``)."""
    _library_root_logger.setLevel(level)


def _lazy_import(package: str, namespace: dict, name: str,
                 not_ported: dict):
    """Import ``package.name`` into ``namespace`` at first access, or
    raise ``AttributeError`` naming the queue item of a name the port
    does not have yet (shared by the packages' ``__getattr__``)."""
    if name in not_ported:
        raise AttributeError(
            f"module {package!r} has no attribute {name!r}: not ported "
            f"yet (ROADMAP.md, queue {not_ported[name]})")
    import importlib

    module = importlib.import_module(f".{name}", package)
    namespace[name] = module
    return module


from . import amp  # noqa: F401,E402
from . import multi_tensor_apply  # noqa: F401,E402
from . import normalization  # noqa: F401,E402
from . import optimizers  # noqa: F401,E402

_LAZY_SUBMODULES = (
    "analysis",
    "parallel",
    "transformer",
    "contrib",
    "fp16_utils",
    "mlp",
    "fused_dense",
    "ops",
    "RNN",
    "checkpoint",
    "telemetry",
    "resilience",
)

#: lazy names of the JAX package that the port does not have yet, with
#: the ROADMAP.md queue item that brings each
_NOT_PORTED = {"analysis": "A8"}


def __getattr__(name):
    if name in _LAZY_SUBMODULES:
        return _lazy_import(__name__, globals(), name, _NOT_PORTED)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def __dir__():
    return sorted(set(globals()) | set(_LAZY_SUBMODULES))
