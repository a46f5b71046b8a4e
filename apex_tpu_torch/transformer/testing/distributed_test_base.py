"""Distributed test base (counterpart of
``apex_tpu/transformer/testing/distributed_test_base.py``).

The reference's ``DistributedTestBase`` subclasses torch's
``MultiProcessTestCase`` and spawns a process per GPU. Here a test runs
in each process of a ``torch.distributed`` world its launcher made (or
alone, a world of 1): the base tears ``parallel_state`` down around each
test, and its ``world_size`` is the process group's, capped by
``MAX_WORLD_SIZE``. The NCCL and UCC variants are the same class: the
backend is the world's.
"""
from __future__ import annotations

import unittest
from typing import Optional

import torch.distributed as dist

from .. import parallel_state


class DistributedTestBase(unittest.TestCase):
    """``parallel_state`` torn down around each test."""

    #: a cap on the world size (the reference's ``min(#GPUs, 4)``); None
    #: takes the whole world
    MAX_WORLD_SIZE: Optional[int] = None

    @property
    def world_size(self) -> int:
        n = dist.get_world_size() if dist.is_initialized() else 1
        if self.MAX_WORLD_SIZE is not None:
            n = min(n, self.MAX_WORLD_SIZE)
        return n

    def setUp(self) -> None:
        super().setUp()
        parallel_state.destroy_model_parallel()

    def tearDown(self) -> None:
        parallel_state.destroy_model_parallel()
        super().tearDown()

    def initialize_model_parallel(self, tp=1, pp=1, vpp=None, **kwargs):
        return parallel_state.initialize_model_parallel(
            tensor_model_parallel_size_=tp,
            pipeline_model_parallel_size_=pp,
            virtual_pipeline_model_parallel_size_=vpp, **kwargs)


NcclDistributedTestBase = DistributedTestBase
UccDistributedTestBase = DistributedTestBase
