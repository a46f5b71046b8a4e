"""contrib FastLayerNorm (counterpart of
``apex_tpu/contrib/layer_norm/layer_norm.py``): the reference's contrib
API shape over the port's LayerNorm kernels, which take any hidden size —
``FastLayerNormFN.apply(x, gamma, beta, eps, memory_efficient)`` and the
``FastLayerNorm(hidden_size)`` module with fp32 ones/zeros parameters.
"""
from __future__ import annotations

from ...normalization import FusedLayerNorm
from ...ops.layer_norm import layer_norm


class FastLayerNormFN:
    """The reference's autograd-Function entry point, as a static
    ``apply``."""

    @staticmethod
    def apply(x, gamma, beta, epsilon=1e-5, memory_efficient=False):
        return layer_norm(x, gamma, beta, epsilon,
                          normalized_ndim=gamma.ndim,
                          memory_efficient=memory_efficient)


class FastLayerNorm(FusedLayerNorm):
    """:class:`~apex_tpu_torch.normalization.FusedLayerNorm` over the last
    dim of size ``hidden_size``, under the contrib name."""

    def __init__(self, hidden_size: int, eps: float = 1e-5, **kw):
        super().__init__(hidden_size, eps, **kw)
