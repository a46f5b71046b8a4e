"""``GDSFile``: a tensor's bytes to and from a file (counterpart of
``apex_tpu/contrib/gpu_direct_storage/gds.py``).

The reference (``apex/contrib/gpu_direct_storage/__init__.py`` over
``csrc/gpu_direct_storage/gds.cpp:108-170``) is a ``GDSFile(filename,
mode)`` context manager whose ``save_data(tensor)`` / ``load_data(tensor)``
move a tensor's bytes between the card and storage through cuFile
(GPUDirect Storage), bypassing host memory. The machines this port runs
on have no cuFile: a card tensor's bytes go through pinned host memory
and the native host IO engine (``pread`` / ``pwrite``,
``apex_tpu_torch/ops/hostio.py``), with one copy between the card and
the pinned buffer each way.

The file is the tensor's raw bytes, no header, written at a stream
position that each ``save_data`` advances (each ``load_data`` likewise):
the reference's format and the JAX package's, byte for byte.
``load_data(tensor)`` fills the caller's preallocated tensor in place, as
the reference does, and returns it (the JAX one returns a new array).
"""
from __future__ import annotations

import os
from contextlib import contextmanager

import torch

from ...ops.hostio import read_arrays, write_arrays


class _GDSFile:
    def __init__(self, filename: str, mode: str):
        if mode not in ("r", "w", "rw"):
            raise ValueError(f"mode must be r, w or rw, got {mode!r}")
        self._filename = filename
        self._mode = mode
        self._pos = 0  # stream position, advanced per save/load
        flags = {
            "r": os.O_RDONLY,
            "w": os.O_RDWR | os.O_CREAT | os.O_TRUNC,
            "rw": os.O_RDWR,  # must exist (reference parity)
        }[mode]
        # one descriptor for the file's lifetime: every save and load is
        # a pread / pwrite against it
        self._fd = os.open(filename, flags, 0o644)

    def _live_fd(self) -> int:
        if self._fd is None:
            raise ValueError("I/O operation on closed GDSFile")
        return self._fd

    def save_data(self, tensor: torch.Tensor) -> None:
        """Append ``tensor``'s raw bytes at the stream position."""
        if "w" not in self._mode:
            raise RuntimeError(f"file opened with mode {self._mode!r}")
        fd = self._live_fd()
        write_arrays(fd, [tensor], offsets=[self._pos])
        self._pos += tensor.numel() * tensor.element_size()

    def load_data(self, tensor: torch.Tensor) -> torch.Tensor:
        """Read ``tensor``'s size in bytes from the stream position into
        ``tensor`` itself (any device) and return it."""
        if "r" not in self._mode:
            raise RuntimeError(f"file opened with mode {self._mode!r}")
        fd = self._live_fd()
        need = tensor.numel() * tensor.element_size()
        if self._pos + need > os.fstat(fd).st_size:
            raise EOFError(f"expected {need} bytes at offset {self._pos} "
                           f"of {self._filename}")
        read_arrays(fd, None, [self._pos], out=[tensor])
        self._pos += need
        return tensor

    # the reference's raw-bytes entry points without GPUDirect Storage
    load_data_no_gds = load_data
    save_data_no_gds = save_data

    def close(self) -> None:
        if self._fd is not None:
            os.close(self._fd)
            self._fd = None


@contextmanager
def GDSFile(filename: str, mode: str):
    """Context manager over one open file (the reference's
    ``contrib/gpu_direct_storage/__init__.py:5-13``)."""
    assert type(filename) == str
    assert type(mode) == str
    handle = _GDSFile(filename, mode)
    try:
        yield handle
    finally:
        handle.close()
