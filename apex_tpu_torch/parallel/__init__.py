"""The data-parallel layer (counterpart of ``apex_tpu/parallel``). So far
the single-device form of ``sync_batch_norm``; the statistics synced
over a group of ranks, ``SyncBatchNorm`` and ``convert_syncbn_model``
come with the distributed slice (ROADMAP.md, queue A6.3)."""
from .sync_batchnorm import sync_batch_norm  # noqa: F401
