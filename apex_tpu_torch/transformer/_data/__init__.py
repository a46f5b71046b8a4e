from ._batchsampler import (  # noqa: F401
    MegatronPretrainingRandomSampler,
    MegatronPretrainingSampler,
)

__all__ = [
    "MegatronPretrainingSampler",
    "MegatronPretrainingRandomSampler",
]
