"""Megatron-style batch samplers with checkpoint-resume semantics
(counterpart of ``apex_tpu/transformer/_data/_batchsampler.py``, the same
code: pure Python and numpy).

Each sampler yields index lists for this data-parallel rank, resumes
mid-epoch from ``consumed_samples`` and lets the local minibatch size
change during training (batch-size ramp-up, see
``apex_tpu_torch.transformer.microbatches``). The yielded lists can feed
any data source, a ``torch.utils.data.DataLoader`` through
``batch_sampler=`` included. The random sampler permutes with numpy's
``default_rng(epoch)``, as the JAX package does, so its indices equal
the JAX package's (the reference's ``torch.Generator`` permutation
differs; the semantics, a deterministic shuffle an epoch, buckets by
rank and exact resume, are the same).
"""
import abc
from typing import Optional

import numpy as np

__all__ = [
    "MegatronPretrainingSampler",
    "MegatronPretrainingRandomSampler",
]


class _Base(abc.ABC):
    """Base class for Megatron-style batch samplers."""

    @abc.abstractmethod
    def __len__(self) -> int:
        ...

    @abc.abstractmethod
    def __iter__(self):
        ...

    @property
    @abc.abstractmethod
    def local_minibatch_size(self) -> int:
        ...


class MegatronPretrainingSampler(_Base):
    """Sequential sampler: walks ``[consumed_samples, total_samples)`` in order.

    Yields this DP rank's slice of each global minibatch.  Resume is exact: a
    restart with the checkpointed ``consumed_samples`` continues at the same
    sample.  Reference behavior ``_batchsampler.py:86-99``.
    """

    def __init__(
        self,
        total_samples: int,
        consumed_samples: int,
        local_minibatch_size: int,
        data_parallel_rank: int,
        data_parallel_size: int,
        drop_last: bool = True,
    ):
        if total_samples <= 0:
            raise RuntimeError(f"no sample to consume: {total_samples}")
        if consumed_samples >= total_samples:
            raise RuntimeError(
                f"no samples left to consume: {consumed_samples}, {total_samples}"
            )
        if local_minibatch_size <= 0:
            raise RuntimeError(
                f"local minibatch size must be greater than 0: {local_minibatch_size}"
            )
        if data_parallel_size <= 0:
            raise RuntimeError(
                f"data parallel size must be greater than 0: {data_parallel_size}"
            )
        if data_parallel_rank >= data_parallel_size:
            raise RuntimeError(
                "data_parallel_rank should be smaller than data size: "
                f"{data_parallel_rank}, {data_parallel_size}"
            )
        self.total_samples = total_samples
        self.consumed_samples = consumed_samples
        self._local_minibatch_size = local_minibatch_size
        self.data_parallel_rank = data_parallel_rank
        self.data_parallel_size = data_parallel_size
        self.local_minibatch_times_data_parallel_size = (
            self._local_minibatch_size * data_parallel_size
        )
        self.drop_last = drop_last

    def __len__(self):
        # Parity quirk kept from the reference (`_batchsampler.py:69-70`):
        # this is the *sample* count, not the number of yielded batches.
        # Divide by local_minibatch_size * data_parallel_size for batches.
        return self.total_samples

    def get_start_end_idx(self, batch_len: Optional[int] = None):
        if batch_len is not None and batch_len < self.local_minibatch_times_data_parallel_size:
            # partial tail (drop_last=False): split the remainder evenly
            # across ranks (sizes differ by at most 1; empty only when
            # batch_len < data_parallel_size)
            start_idx = batch_len * self.data_parallel_rank // self.data_parallel_size
            end_idx = batch_len * (self.data_parallel_rank + 1) // self.data_parallel_size
            return start_idx, end_idx
        start_idx = self.data_parallel_rank * self.local_minibatch_size
        end_idx = start_idx + self.local_minibatch_size
        return start_idx, end_idx

    @property
    def local_minibatch_size(self) -> int:
        return self._local_minibatch_size

    @local_minibatch_size.setter
    def local_minibatch_size(self, new_local_minibatch_size) -> None:
        self._local_minibatch_size = new_local_minibatch_size
        self.local_minibatch_times_data_parallel_size = (
            self._local_minibatch_size * self.data_parallel_size
        )

    def __iter__(self):
        batch = []
        # NOTE: the reference fills `batch` up to local_minibatch_size and then
        # slices [rank*local : (rank+1)*local] out of it, which is only
        # non-degenerate for dp_rank 0 unless callers accumulate the *global*
        # minibatch.  We replicate the global-batch accumulation Megatron-LM
        # intended: fill to local*dp_size, slice the rank's window.
        for idx in range(self.consumed_samples, self.total_samples):
            batch.append(idx)
            if len(batch) == self.local_minibatch_times_data_parallel_size:
                start_idx, end_idx = self.get_start_end_idx()
                yield batch[start_idx:end_idx]
                batch = []

        if len(batch) > 0 and not self.drop_last:
            start_idx, end_idx = self.get_start_end_idx(len(batch))
            yield batch[start_idx:end_idx]


class MegatronPretrainingRandomSampler(_Base):
    """Shuffled sampler: deterministic per-epoch permutation over a rank bucket.

    The sample space is split into ``data_parallel_size`` contiguous buckets;
    each rank permutes its own bucket with a generator seeded by the epoch
    number, then skips ``consumed_samples`` worth of already-seen indices —
    so resume mid-epoch reproduces the remainder of the epoch exactly.
    Reference behavior ``_batchsampler.py:156-180``.
    """

    def __init__(
        self,
        total_samples: int,
        consumed_samples: int,
        local_minibatch_size: int,
        data_parallel_rank: int,
        data_parallel_size: int,
    ) -> None:
        if total_samples <= 0:
            raise ValueError(f"no sample to consume: total_samples of {total_samples}")
        if local_minibatch_size <= 0:
            raise ValueError(f"Invalid local_minibatch_size: {local_minibatch_size}")
        if data_parallel_size <= 0:
            raise ValueError(f"Invalid data_parallel_size: {data_parallel_size}")
        if data_parallel_rank >= data_parallel_size:
            raise ValueError(
                "data_parallel_rank should be smaller than data parallel size: "
                f"{data_parallel_rank} < {data_parallel_size}"
            )
        if total_samples < local_minibatch_size * data_parallel_size:
            raise ValueError(
                f"total_samples ({total_samples}) must be at least one global "
                f"batch ({local_minibatch_size * data_parallel_size}) — no "
                "complete batch to shuffle"
            )
        self.total_samples = total_samples
        self.consumed_samples = consumed_samples
        self._local_minibatch_size = local_minibatch_size
        self.data_parallel_rank = data_parallel_rank
        self.data_parallel_size = data_parallel_size
        self.local_minibatch_times_data_parallel_size = (
            self._local_minibatch_size * self.data_parallel_size
        )
        self.last_batch_size = (
            self.total_samples % self.local_minibatch_times_data_parallel_size
        )

    def __len__(self) -> int:
        # Sample count, not batch count — reference parity (see above).
        return self.total_samples

    @property
    def local_minibatch_size(self) -> int:
        return self._local_minibatch_size

    @local_minibatch_size.setter
    def local_minibatch_size(self, new_local_minibatch_size) -> None:
        if self.total_samples < new_local_minibatch_size * self.data_parallel_size:
            raise ValueError(
                f"total_samples ({self.total_samples}) must be at least one "
                f"global batch "
                f"({new_local_minibatch_size * self.data_parallel_size})"
            )
        self._local_minibatch_size = new_local_minibatch_size
        self.local_minibatch_times_data_parallel_size = (
            self._local_minibatch_size * self.data_parallel_size
        )
        # epoch/resume math depends on the tail size; keep it in sync after
        # a batch-size rampup
        self.last_batch_size = (
            self.total_samples % self.local_minibatch_times_data_parallel_size
        )

    def __iter__(self):
        active_total_samples = self.total_samples - self.last_batch_size
        self.epoch = self.consumed_samples // active_total_samples
        current_epoch_samples = self.consumed_samples % active_total_samples

        bucket_size = (
            self.total_samples // self.local_minibatch_times_data_parallel_size
        ) * self.local_minibatch_size
        bucket_offset = current_epoch_samples // self.data_parallel_size
        start_idx = self.data_parallel_rank * bucket_size

        g = np.random.default_rng(self.epoch)
        random_idx = g.permutation(bucket_size).tolist()
        idx_range = [start_idx + x for x in random_idx[bucket_offset:]]

        batch = []
        # Last incomplete batch is dropped.
        for idx in idx_range:
            batch.append(idx)
            if len(batch) == self.local_minibatch_size:
                self.consumed_samples += self.local_minibatch_times_data_parallel_size
                yield batch
                batch = []
