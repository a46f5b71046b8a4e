"""contrib.bottleneck (counterpart of ``apex_tpu/contrib/bottleneck``):
the ResNet bottleneck block, its spatial-parallel form
(``spatial_conv3x3``, ``SpatialBottleneck``: the image height sharded
over the ranks of a group) and the halo exchangers under it."""
from .bottleneck import (  # noqa: F401
    Bottleneck,
    SpatialBottleneck,
    spatial_conv3x3,
)
from .halo_exchangers import (  # noqa: F401
    HaloExchanger,
    HaloExchangerAllGather,
    HaloExchangerNoComm,
    HaloExchangerPeer,
    HaloExchangerSendRecv,
    halo_pad_1d,
)

__all__ = [
    "Bottleneck",
    "SpatialBottleneck",
    "spatial_conv3x3",
    "HaloExchanger",
    "HaloExchangerNoComm",
    "HaloExchangerAllGather",
    "HaloExchangerSendRecv",
    "HaloExchangerPeer",
    "halo_pad_1d",
]
