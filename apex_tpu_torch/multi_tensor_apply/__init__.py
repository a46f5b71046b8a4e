"""Flat-buffer packing and the multi-tensor applier (counterpart of
``apex_tpu/multi_tensor_apply``)."""
from .multi_tensor_apply import MultiTensorApply, multi_tensor_applier  # noqa: F401
from .packing import (  # noqa: F401
    DEFAULT_CHUNK,
    ROW,
    BucketBuffers,
    PackSpec,
    is_row_aligned,
)
