"""Microbatch calculators (counterpart of
``apex_tpu/transformer/microbatches.py``, the same code: pure Python).

``ConstantNumMicroBatches`` and ``RampupBatchsizeNumMicroBatches``
compute the number of microbatches a step from the global batch size,
the micro batch size and the data-parallel size; the ramp-up variant
grows the global batch linearly with the samples consumed (the
reference's ``apex/transformer/microbatches.py``).
"""
from __future__ import annotations

from abc import ABC, abstractmethod
from typing import List, Optional


def build_num_microbatches_calculator(
    rank: int,
    rampup_batch_size: Optional[List[int]],
    global_batch_size: int,
    micro_batch_size: int,
    data_parallel_size: int,
):
    """Reference ``microbatches.py:26-70``."""
    if rampup_batch_size is None:
        calculator = ConstantNumMicroBatches(
            global_batch_size, micro_batch_size, data_parallel_size
        )
        if rank == 0:
            print(
                f"setting number of micro-batches to constant "
                f"{calculator.get()}",
                flush=True,
            )
        return calculator
    if len(rampup_batch_size) != 3:
        raise ValueError(
            "expected the following format: --rampup-batch-size <start batch "
            "size> <batch size increment> <ramp-up samples>"
        )
    start_batch_size, batch_size_increment, ramup_samples = map(
        int, rampup_batch_size
    )
    if rank == 0:
        print(
            f"will use batch size rampup starting from global batch size "
            f"{start_batch_size} to global batch size {global_batch_size} "
            f"with batch size increments {batch_size_increment} over "
            f"{ramup_samples} samples.",
            flush=True,
        )
    return RampupBatchsizeNumMicroBatches(
        start_batch_size, batch_size_increment, ramup_samples,
        global_batch_size, micro_batch_size, data_parallel_size,
    )


class NumMicroBatchesCalculator(ABC):
    """Reference ``microbatches.py:73-90``."""

    def __init__(self):
        self.num_micro_batches = None
        self.current_global_batch_size = None

    def get(self) -> int:
        return self.num_micro_batches

    def get_current_global_batch_size(self) -> int:
        return self.current_global_batch_size

    @abstractmethod
    def update(self, consumed_samples, consistency_check):
        ...


class ConstantNumMicroBatches(NumMicroBatchesCalculator):
    """Reference ``microbatches.py:93-109``."""

    def __init__(self, global_batch_size, micro_batch_size, data_parallel_size):
        super().__init__()
        micro_batch_times_data_parallel = micro_batch_size * data_parallel_size
        if global_batch_size % micro_batch_times_data_parallel != 0:
            raise ValueError(
                f"global batch size ({global_batch_size}) is not divisible by "
                f"micro batch size ({micro_batch_size}) times data parallel "
                f"size ({data_parallel_size})"
            )
        self.num_micro_batches = (
            global_batch_size // micro_batch_times_data_parallel
        )
        if self.num_micro_batches < 1:
            raise ValueError("number of microbatches must be at least 1")
        self.current_global_batch_size = global_batch_size
        self.micro_batch_size = micro_batch_size

    def update(self, consumed_samples, consistency_check):
        pass


class RampupBatchsizeNumMicroBatches(NumMicroBatchesCalculator):
    """Reference ``microbatches.py:112-195``: global batch grows linearly
    from ``start_batch_size`` by ``batch_size_increment`` per
    ``ramup_samples / steps`` consumed samples."""

    def __init__(
        self,
        start_batch_size,
        batch_size_increment,
        ramup_samples,
        global_batch_size,
        micro_batch_size,
        data_parallel_size,
    ):
        super().__init__()
        self.micro_batch_size = micro_batch_size
        self.data_parallel_size = data_parallel_size
        self.micro_batch_times_data_parallel_size = (
            micro_batch_size * data_parallel_size
        )
        if self.micro_batch_times_data_parallel_size <= 0:
            raise ValueError("micro batch size * dp size must be positive")
        if start_batch_size <= 0:
            raise ValueError("start batch size must be positive")
        self.start_batch_size = start_batch_size
        if global_batch_size <= 0:
            raise ValueError("global batch size must be positive")
        self.global_batch_size = global_batch_size
        diff_batch_size = self.global_batch_size - self.start_batch_size
        if diff_batch_size < 0:
            raise ValueError(
                "global batch size must be greater than or equal to start "
                "batch size"
            )
        if batch_size_increment <= 0:
            raise ValueError("batch size increment must be positive")
        self.batch_size_increment = batch_size_increment
        if diff_batch_size % batch_size_increment != 0:
            raise ValueError(
                f"expected global batch size interval ({diff_batch_size}) to "
                f"be divisible by global batch size increment "
                f"({batch_size_increment})"
            )
        num_increments = diff_batch_size // self.batch_size_increment
        self.ramup_samples = ramup_samples
        if self.ramup_samples < 0:
            raise ValueError("ramp-up samples must be non-negative")
        self.rampup_samples_per_increment = self.ramup_samples / max(
            num_increments, 1
        )
        self.update(0, False)

    def update(self, consumed_samples, consistency_check):
        if (
            consumed_samples > self.ramup_samples
            or self.rampup_samples_per_increment == 0
        ):
            self.current_global_batch_size = self.global_batch_size
        else:
            steps = int(consumed_samples / self.rampup_samples_per_increment)
            self.current_global_batch_size = (
                self.start_batch_size + steps * self.batch_size_increment
            )
            if self.current_global_batch_size > self.global_batch_size:
                self.current_global_batch_size = self.global_batch_size
        if consistency_check:
            if (
                self.current_global_batch_size
                % self.micro_batch_times_data_parallel_size
                != 0
            ):
                raise ValueError(
                    f"current global batch size "
                    f"({self.current_global_batch_size}) is not divisible by "
                    f"micro-batch-size ({self.micro_batch_size}) times data "
                    f"parallel size ({self.data_parallel_size})"
                )
        self.num_micro_batches = (
            self.current_global_batch_size
            // self.micro_batch_times_data_parallel_size
        )
