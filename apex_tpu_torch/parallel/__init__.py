"""The data-parallel layer (counterpart of ``apex_tpu/parallel``). So far
the single-device form of ``sync_batch_norm`` and
``initialize_distributed``; the statistics synced over a group of ranks,
``SyncBatchNorm`` and ``convert_syncbn_model`` and ``LARC`` come with
queue A6.3, and ``DistributedDataParallel``, ``Reducer``, the gradient
buckets, ``flatten`` and ``unflatten`` with A6.2 (ROADMAP.md)."""
from .multiproc import initialize_distributed  # noqa: F401
from .sync_batchnorm import sync_batch_norm  # noqa: F401

#: names of the JAX package's ``parallel`` that the port does not have
#: yet, with the ROADMAP.md queue item that brings each
_NOT_PORTED = {
    **dict.fromkeys(("BucketBuffers", "DistributedDataParallel",
                     "GradBuckets", "Reducer", "flatten",
                     "sync_gradients", "sync_gradients_bucketed",
                     "unflatten"), "A6.2"),
    **dict.fromkeys(("LARC", "larc_adjust_gradients", "larc_transform",
                     "SyncBatchNorm", "convert_syncbn_model"), "A6.3"),
}


def __getattr__(name):
    if name in _NOT_PORTED:
        raise AttributeError(
            f"module {__name__!r} has no attribute {name!r}: not ported "
            f"yet (ROADMAP.md, queue {_NOT_PORTED[name]})")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
