"""contrib.bottleneck (counterpart of ``apex_tpu/contrib/bottleneck``): the
ResNet bottleneck block. Its spatial-parallel form (``spatial_conv3x3``,
``SpatialBottleneck``) and the halo exchangers need ranks, and come with
the distributed slice (ROADMAP.md, queue A6.6)."""
from .bottleneck import Bottleneck  # noqa: F401

__all__ = ["Bottleneck"]
