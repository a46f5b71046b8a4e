"""Batch broadcast over the tensor-parallel group (counterpart of
``apex_tpu/transformer/tensor_parallel/data.py``)."""
from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch
import torch.distributed as dist

from .. import parallel_state
from .mappings import axis_world


def broadcast_data(keys: Sequence[str], data: Dict[str, torch.Tensor],
                   datatype=None, axis_name: Optional[str] = None
                   ) -> Dict[str, torch.Tensor]:
    """``{k: data[k]}`` for ``k`` in ``keys``, cast to ``datatype`` when
    given, and the same on every rank of the tensor group: each tensor is
    broadcast (a copy, the caller's tensors untouched) from the group's
    first rank, ``parallel_state.get_tensor_model_parallel_src_rank()``
    (a global rank) when model parallelism is initialised, else rank 0 of
    the group. Without a process group it is the projection of
    ``data``."""
    out = {}
    for k in keys:
        v = data[k]
        out[k] = v if datatype is None else v.to(datatype)
    group, _, _, active = axis_world(axis_name)
    if not active:
        return out
    if parallel_state.model_parallel_is_initialized():
        src = parallel_state.get_tensor_model_parallel_src_rank()
    else:
        src = 0 if group is None else dist.get_global_rank(group, 0)
    for k, v in out.items():
        v = v.contiguous().clone()
        dist.broadcast(v, src=src, group=group)
        out[k] = v
    return out
