"""The data-parallel layer (counterpart of ``apex_tpu/parallel``):
gradient synchronisation over ``torch.distributed`` (DDP, the gradient
buckets, ``Reducer``, ``flatten`` / ``unflatten``), BatchNorm synced over
a group of ranks (``sync_batch_norm``, ``SyncBatchNorm``,
``convert_syncbn_model``), ``LARC`` and ``initialize_distributed``."""
from .distributed import (  # noqa: F401
    BucketBuffers,
    DistributedDataParallel,
    GradBuckets,
    Reducer,
    flatten,
    sync_gradients,
    sync_gradients_bucketed,
    unflatten,
)
from .LARC import LARC, larc_adjust_gradients, larc_transform  # noqa: F401
from .multiproc import initialize_distributed  # noqa: F401
from .sync_batchnorm import (  # noqa: F401
    SyncBatchNorm,
    convert_syncbn_model,
    sync_batch_norm,
)
