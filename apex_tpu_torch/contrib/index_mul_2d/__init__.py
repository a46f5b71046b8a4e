"""contrib.index_mul_2d (counterpart of ``apex_tpu/contrib/index_mul_2d``):
the gather-multiply ``in1[idx1] * in2``, plain PyTorch."""
from .index_mul_2d import index_mul_2d

__all__ = ["index_mul_2d"]
