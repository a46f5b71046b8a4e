"""Flat-buffer packing and the multi-tensor applier (counterpart of
``apex_tpu/multi_tensor_apply``)."""
from .multi_tensor_apply import MultiTensorApply, multi_tensor_applier  # noqa: F401
from .packing import DEFAULT_CHUNK, ROW, PackSpec, is_row_aligned  # noqa: F401
