"""Preallocated activation buffers (counterpart of
``apex_tpu/transformer/tensor_parallel/memory.py``): one contiguous
allocation handed out as views (:class:`MemoryBuffer`), and a ring of
them (:class:`RingMemBuffer`). The buffer lies on ``device`` (None: the
card); ``get`` returns a view of it, so writes to the view land in the
buffer, as in the reference."""
from __future__ import annotations

import operator
from functools import reduce
from typing import Tuple

import torch

from ..._device import resolve_device


class MemoryBuffer:
    """``numel`` elements of ``dtype``, zeroed, handed out as views."""

    def __init__(self, name: str, numel: int, dtype, track_usage: bool = False,
                 device=None):
        self.name = name
        self.numel = numel
        self.dtype = dtype
        self.data = torch.zeros((numel,), dtype=dtype,
                                device=resolve_device(device))
        self.track_usage = track_usage
        self.in_use_value = 0.0
        self.total_value = 0.0

    def zero(self) -> None:
        self.data.zero_()

    def get(self, shape: Tuple[int, ...], start_index: int) -> torch.Tensor:
        """A view of ``shape`` into the buffer from ``start_index``."""
        numel = reduce(operator.mul, shape, 1)
        end_index = start_index + numel
        if end_index > self.numel:
            raise ValueError("requested tensor is out of buffer range")
        if self.track_usage:
            self.in_use_value += float(numel)
            self.total_value += float(self.numel)
        return self.data[start_index:end_index].view(shape)

    def get_in_use(self) -> float:
        return self.in_use_value

    def get_total(self) -> float:
        return self.total_value

    def print_average_usage(self) -> None:
        print(f"Average usage of {self.name} buffer: "
              f"{100.0 * self.in_use_value / max(self.total_value, 1.0):.2f}%")


class RingMemBuffer:
    """``num_buffers`` :class:`MemoryBuffer` s handed out in turn."""

    def __init__(self, name: str, num_buffers: int, numel: int, dtype,
                 track_usage: bool = False, device=None):
        self.num_buffers = num_buffers
        self.buffers = [MemoryBuffer(f"{name} {i}", numel, dtype, track_usage,
                                     device) for i in range(num_buffers)]
        self._index = -1

    def get_next_buffer(self) -> MemoryBuffer:
        self._index = (self._index + 1) % self.num_buffers
        return self.buffers[self._index]
