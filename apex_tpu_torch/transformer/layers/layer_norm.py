"""Sequence-parallel-aware LayerNorm wrappers (counterpart of
``apex_tpu/transformer/layers/layer_norm.py``).

Thin subclasses of the fused LayerNorms whose one addition is the
sequence-parallel tag: under sequence parallelism the norm's parameters
are replicated while the activations are sharded along the sequence, so
their gradients are all-reduced over the tensor-parallel group. The tag
is ``sequence_parallel_param_names`` (the parameter names ``weight`` and
``bias`` when enabled), the names the JAX package's gradient sync
matches; the sync itself comes with the distributed slice.
``FastLayerNorm`` is the same kernels under the contrib name.
"""
from __future__ import annotations

from typing import Tuple

from ...normalization import FusedLayerNorm as _FusedLayerNorm
from ...normalization import MixedFusedLayerNorm as _MixedFusedLayerNorm


class _SequenceParallelTag:
    sequence_parallel_enabled: bool = False

    @property
    def sequence_parallel_param_names(self) -> Tuple[str, ...]:
        return ("weight", "bias") if self.sequence_parallel_enabled else ()


class FusedLayerNorm(_SequenceParallelTag, _FusedLayerNorm):
    """:class:`apex_tpu_torch.normalization.FusedLayerNorm` with
    ``sequence_parallel_enabled``."""

    def __init__(self, *args, sequence_parallel_enabled: bool = False,
                 **kw):
        super().__init__(*args, **kw)
        self.sequence_parallel_enabled = sequence_parallel_enabled


class MixedFusedLayerNorm(_SequenceParallelTag, _MixedFusedLayerNorm):
    """:class:`apex_tpu_torch.normalization.MixedFusedLayerNorm` with
    ``sequence_parallel_enabled``."""

    def __init__(self, *args, sequence_parallel_enabled: bool = False,
                 **kw):
        super().__init__(*args, **kw)
        self.sequence_parallel_enabled = sequence_parallel_enabled


class FastLayerNorm(FusedLayerNorm):
    """The contrib ``fast_layer_norm`` entry point: the same kernels serve
    every hidden size, so this is :class:`FusedLayerNorm` under that
    name, with the sequence-parallel tag."""
