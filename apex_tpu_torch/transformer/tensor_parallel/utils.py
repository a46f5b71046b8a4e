"""Tensor-parallel utilities (counterpart of
``apex_tpu/transformer/tensor_parallel/utils.py``)."""
from __future__ import annotations

from typing import Tuple

import torch


def ensure_divisibility(numerator: int, denominator: int) -> None:
    """Raise ``ValueError`` unless ``denominator`` divides ``numerator``."""
    if numerator % denominator != 0:
        raise ValueError(f"{numerator} is not divisible by {denominator}")


def divide(numerator: int, denominator: int) -> int:
    """``numerator // denominator``, checked to divide exactly."""
    ensure_divisibility(numerator, denominator)
    return numerator // denominator


def split_tensor_along_last_dim(
    tensor: torch.Tensor, num_partitions: int,
    contiguous_split_chunks: bool = False,
) -> Tuple[torch.Tensor, ...]:
    """``num_partitions`` equal views of ``tensor`` along its last dim;
    with ``contiguous_split_chunks`` each one a contiguous copy."""
    size = divide(tensor.shape[-1], num_partitions)
    parts = torch.split(tensor, size, dim=-1)
    if contiguous_split_chunks:
        return tuple(p.contiguous() for p in parts)
    return tuple(parts)


class VocabUtility:
    """The ``[first, last)`` vocab range a rank owns in a vocab-parallel
    embedding or logits tensor."""

    @staticmethod
    def vocab_range_from_per_partition_vocab_size(
            per_partition_vocab_size: int, rank, world_size: int):
        first = rank * per_partition_vocab_size
        return first, first + per_partition_vocab_size

    @staticmethod
    def vocab_range_from_global_vocab_size(global_vocab_size: int, rank,
                                           world_size: int):
        per_partition = divide(global_vocab_size, world_size)
        return VocabUtility.vocab_range_from_per_partition_vocab_size(
            per_partition, rank, world_size)
