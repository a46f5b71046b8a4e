from .layer_norm import FastLayerNorm, FastLayerNormFN

__all__ = ["FastLayerNorm", "FastLayerNormFN"]
