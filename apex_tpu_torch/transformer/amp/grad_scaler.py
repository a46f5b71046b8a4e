"""Model-parallel-aware loss scaler (counterpart of
``apex_tpu/transformer/amp/grad_scaler.py``).

The reference's ``GradScaler`` (``apex/transformer/amp/grad_scaler.py``)
all-reduces ``found_inf`` with MAX over the model-parallel group before
the step and in ``update``, so a tensor- or pipeline-parallel shard that
overflowed makes every shard of its model replica skip the step. Here
that is one ``all_reduce`` over ``parallel_state``'s group of the
``model_parallel_axes`` (tensor x pipeline by default) on top of the
port's :class:`~apex_tpu_torch.amp.scaler.LossScaler`. Where no process
group exists, the model-parallel state is not initialised or the group
holds one rank, the reduction is skipped (the JAX one skips axes that
are not bound). The numerics monitor's provenance stays per rank.
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.distributed as dist

from ...amp.scaler import LossScaleState, LossScaler
from .. import parallel_state


class GradScaler(LossScaler):
    """A :class:`LossScaler` whose overflow flag is agreed across the
    model-parallel group (``model_parallel_axes``, default tensor and
    pipeline: the reference's model-parallel group)."""

    def __init__(self, *args, model_parallel_axes: Sequence[str] = (
            parallel_state.TENSOR_AXIS, parallel_state.PIPELINE_AXIS),
            **kwargs):
        super().__init__(*args, **kwargs)
        self.model_parallel_axes = tuple(model_parallel_axes)

    def _allreduce_found_inf(self, found_inf: torch.Tensor) -> torch.Tensor:
        """MAX of the flag over the model-parallel group, on the device
        (no host read)."""
        if not (parallel_state.model_parallel_is_initialized()
                and dist.is_available() and dist.is_initialized()):
            return found_inf
        if len(parallel_state.get_group_ranks(self.model_parallel_axes)) < 2:
            return found_inf
        f = found_inf.to(torch.float32).reshape(1)
        dist.all_reduce(f, op=dist.ReduceOp.MAX,
                        group=parallel_state.get_group(
                            self.model_parallel_axes))
        return (f > 0).reshape(found_inf.shape)

    def unscale(self, state: LossScaleState, grads, out_dtype=None,
                numerics=None):
        out = super().unscale(state, grads, out_dtype, numerics=numerics)
        grads, new_state = out[0], out[1]
        new_state = new_state._replace(
            found_inf=self._allreduce_found_inf(new_state.found_inf))
        if numerics is not None:
            return grads, new_state, out[2]
        return grads, new_state

    def unscale_with_stashed(self, state, new_scaled_grads, stashed_grads):
        grads, new_state = super().unscale_with_stashed(
            state, new_scaled_grads, stashed_grads)
        return grads, new_state._replace(
            found_inf=self._allreduce_found_inf(new_state.found_inf))

    def update_scale(self, state: LossScaleState, metrics=None,
                     numerics=None):
        synced = state._replace(
            found_inf=self._allreduce_found_inf(state.found_inf))
        return super().update_scale(synced, metrics, numerics=numerics)
