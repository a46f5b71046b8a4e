"""Raw tensor <-> file IO (counterpart of
``apex_tpu/contrib/gpu_direct_storage``)."""
from .gds import GDSFile  # noqa: F401

__all__ = ["GDSFile"]
