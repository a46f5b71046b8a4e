"""Host-side tensor IO and bucket packing over the native engine
(counterpart of ``apex_tpu/ops/hostio.py``).

The Python surface of ``apex_tpu_torch/csrc/hostio.cpp``, built with
g++ at first use (``_build.load_hostio``):

- :func:`write_arrays` / :func:`read_arrays`: offset-based multithreaded
  tensor <-> file IO (the reference's ``gds.cpp`` capability without
  cuFile: file bytes move through host memory);
- :func:`flatten` / :func:`unflatten`: many tensors <-> one byte arena
  by parallel gather and scatter (``apex_C.flatten`` / ``unflatten``).

Inputs are tensors. A CPU tensor's bytes are handed to the engine where
they lie; card tensors are copied into one pinned host staging buffer
(``non_blocking`` copies, then one synchronisation) and written from
there, and reads into card tensors land in pinned memory first, then go
up with one copy each. The files hold each tensor's raw bytes at its
offset, no header: the same bytes as the JAX package writes for the
same array.

The native engine is the only route unless the caller passes
``native=False``: a failed build raises. The plain Python route
(``os.pwrite`` / ``os.pread``) exists for the tests that hold the two
against each other.
"""
from __future__ import annotations

import ctypes
import os
from typing import List, Optional, Sequence, Tuple

import torch

from .. import _build

_DEFAULT_THREADS = 8


def native_available() -> bool:
    """True when the native engine builds and loads here."""
    try:
        _build.load_hostio()
    except (RuntimeError, OSError):
        return False
    return True


def _nbytes(t) -> int:
    if isinstance(t, tuple):
        shape, dtype = t
        n = 1
        for s in shape:
            n *= int(s)
        return n * dtype.itemsize
    return t.numel() * t.element_size()


def _bytes_view(t: torch.Tensor) -> torch.Tensor:
    """``t``'s bytes as a flat uint8 tensor (``t`` must be contiguous)."""
    return t.reshape(-1).view(torch.uint8)


def _ptrs(ptrs: Sequence[int]):
    return (ctypes.c_void_p * len(ptrs))(*ptrs)


def _i64(vals) -> "ctypes.Array":
    return (ctypes.c_int64 * len(vals))(*[int(v) for v in vals])


def _check(rc: int, what: str) -> None:
    if rc != 0:
        raise OSError(-rc, f"hostio {what} failed: {os.strerror(-rc)}")


def _check_counts(offsets, n: int, what: str) -> None:
    if len(offsets) != n:
        raise ValueError(f"{what}: got {len(offsets)} offsets for {n} "
                         f"arrays")


def layout(arrays, align: int = 64) -> Tuple[List[int], int]:
    """``(offsets, total)`` laying the arrays (tensors, or ``(shape,
    dtype)`` pairs) out back to back, each at an ``align``-byte
    boundary."""
    offsets, off = [], 0
    for a in arrays:
        off = (off + align - 1) // align * align
        offsets.append(off)
        off += _nbytes(a)
    return offsets, off


def _to_host(tensors) -> List[torch.Tensor]:
    """Contiguous CPU tensors with the inputs' bytes: CPU inputs as they
    are (made contiguous), card inputs staged through one pinned
    buffer with one synchronisation for all of them."""
    tensors = [t.contiguous() for t in tensors]
    card = [i for i, t in enumerate(tensors) if t.device.type != "cpu"]
    if not card:
        return tensors
    offsets, total = layout([tensors[i] for i in card])
    stage = torch.empty(total, dtype=torch.uint8, pin_memory=True)
    host = list(tensors)
    for i, off in zip(card, offsets):
        t = tensors[i]
        dst = stage[off:off + _nbytes(t)]
        dst.copy_(_bytes_view(t), non_blocking=True)
        host[i] = dst.view(t.dtype).view(t.shape)
    for dev in {tensors[i].device for i in card}:
        torch.cuda.synchronize(dev)
    return host


def write_arrays(path, arrays, offsets: Optional[Sequence[int]] = None,
                 threads: int = _DEFAULT_THREADS, *, native: bool = True
                 ) -> List[int]:
    """Write each tensor's raw bytes at its offset (default: the aligned
    back-to-back :func:`layout`); returns the offsets used. ``path`` is a
    path, or an open writable file descriptor (to amortise the open over
    many calls). The file is created if needed and never truncated."""
    host = _to_host(arrays)
    if offsets is None:
        offsets, _ = layout(host)
    _check_counts(offsets, len(host), "write_arrays")
    if not native:
        _write_python(path, host, offsets)
        return list(offsets)
    lib = _build.load_hostio()
    sizes = _i64([_nbytes(a) for a in host])
    ptrs = _ptrs([a.data_ptr() for a in host])
    if isinstance(path, int):
        rc = lib.hostio_write_fd(path, len(host), _i64(offsets), sizes, ptrs,
                                 int(threads))
    else:
        rc = lib.hostio_write(os.fsencode(path), len(host), _i64(offsets),
                              sizes, ptrs, int(threads))
    _check(rc, "write")
    return list(offsets)


def _write_python(path, host, offsets) -> None:
    fd = path if isinstance(path, int) else os.open(
        path, os.O_WRONLY | os.O_CREAT, 0o644)
    try:
        for a, off in zip(host, offsets):
            buf = memoryview(_bytes_view(a).numpy())
            done = 0
            while done < len(buf):  # pwrite may write less than asked
                n = os.pwrite(fd, buf[done:], off + done)
                if n <= 0:
                    raise OSError(f"pwrite returned {n} at {off + done}")
                done += n
    finally:
        if not isinstance(path, int):
            os.close(fd)


def _templates(templates, out) -> List[Tuple[tuple, torch.dtype]]:
    if out is not None:
        return [(tuple(t.shape), t.dtype) for t in out]
    return [t if isinstance(t, tuple) else (tuple(t.shape), t.dtype)
            for t in templates]


def read_arrays(path, templates, offsets: Sequence[int],
                threads: int = _DEFAULT_THREADS, *, out=None,
                native: bool = True) -> List[torch.Tensor]:
    """Read one array per ``(template, offset)``: raw bytes taken as the
    template's shape and dtype (templates are tensors or ``(shape,
    dtype)`` pairs). Returns new CPU tensors, or, with ``out`` (a list of
    tensors on any device, which then stand for the templates), fills
    those in place and returns them. Reading past the end of the file
    raises ``OSError``."""
    specs = _templates(templates, out)
    _check_counts(offsets, len(specs), "read_arrays")
    if out is None:
        host = [torch.empty(shape, dtype=dtype) for shape, dtype in specs]
    else:
        host = [t if t.device.type == "cpu" and t.is_contiguous() else None
                for t in out]
        staged = [i for i, t in enumerate(host) if t is None]
        if staged:
            soff, total = layout([specs[i] for i in staged])
            stage = torch.empty(total, dtype=torch.uint8, pin_memory=any(
                out[i].device.type == "cuda" for i in staged))
            for i, off in zip(staged, soff):
                shape, dtype = specs[i]
                host[i] = stage[off:off + _nbytes(specs[i])].view(
                    dtype).view(shape)
    if native:
        lib = _build.load_hostio()
        sizes = _i64([_nbytes(s) for s in specs])
        ptrs = _ptrs([a.data_ptr() for a in host])
        if isinstance(path, int):
            rc = lib.hostio_read_fd(path, len(host), _i64(offsets), sizes,
                                    ptrs, int(threads))
        else:
            rc = lib.hostio_read(os.fsencode(path), len(host),
                                 _i64(offsets), sizes, ptrs, int(threads))
        _check(rc, "read")
    else:
        _read_python(path, host, offsets)
    if out is None:
        return host
    for t, h in zip(out, host):
        if t is not h:
            t.copy_(h, non_blocking=True)
    return list(out)


def _read_python(path, host, offsets) -> None:
    fd = path if isinstance(path, int) else os.open(path, os.O_RDONLY)
    try:
        for a, off in zip(host, offsets):
            dst = memoryview(_bytes_view(a).numpy())
            got = 0
            while got < len(dst):  # stop at a true end of file
                chunk = os.pread(fd, len(dst) - got, off + got)
                if not chunk:
                    raise OSError(5, f"hostio read failed: expected "
                                     f"{len(dst)} bytes at {off}")
                dst[got:got + len(chunk)] = chunk
                got += len(chunk)
    finally:
        if not isinstance(path, int):
            os.close(fd)


def flatten(arrays, align: int = 64, threads: int = _DEFAULT_THREADS, *,
            native: bool = True) -> Tuple[torch.Tensor, List[int]]:
    """Pack tensors into one contiguous uint8 CPU arena (parallel
    gather); returns ``(arena, byte offsets)``. Card tensors go straight
    into the arena, which is then pinned, with one synchronisation."""
    arrays = [a.contiguous() for a in arrays]
    offsets, total = layout(arrays, align)
    card = any(a.device.type == "cuda" for a in arrays)
    arena = torch.zeros(total, dtype=torch.uint8, pin_memory=card)
    host = [(a, off) for a, off in zip(arrays, offsets)
            if a.device.type == "cpu"]
    for a, off in zip(arrays, offsets):
        if a.device.type != "cpu":
            arena[off:off + _nbytes(a)].copy_(_bytes_view(a),
                                              non_blocking=True)
    if host and native:
        lib = _build.load_hostio()
        rc = lib.hostio_pack(
            arena.data_ptr(), len(host), _ptrs([a.data_ptr() for a, _ in
                                                 host]),
            _i64([_nbytes(a) for a, _ in host]),
            _i64([off for _, off in host]), int(threads))
        _check(rc, "pack")
    else:
        for a, off in host:
            arena[off:off + _nbytes(a)].copy_(_bytes_view(a))
    if card:
        torch.cuda.synchronize()
    return arena, offsets


def unflatten(arena: torch.Tensor, templates, offsets: Sequence[int],
              threads: int = _DEFAULT_THREADS, *, native: bool = True
              ) -> List[torch.Tensor]:
    """Scatter arena slices back out into new CPU tensors shaped like
    the templates (tensors or ``(shape, dtype)`` pairs;
    ``apex_C.unflatten``). Slices outside the arena raise
    ``ValueError`` before any copy."""
    arena = arena.contiguous().reshape(-1).view(torch.uint8)
    if arena.device.type != "cpu":
        raise ValueError("unflatten reads a host arena; got one on "
                         f"{arena.device}")
    specs = _templates(templates, None)
    _check_counts(offsets, len(specs), "unflatten")
    outs = [torch.empty(shape, dtype=dtype) for shape, dtype in specs]
    nbytes = arena.numel()
    for spec, off in zip(specs, offsets):
        off = int(off)
        if off < 0 or off + _nbytes(spec) > nbytes:
            raise ValueError(
                f"unflatten: slice [{off}, {off + _nbytes(spec)}) out of "
                f"bounds for arena of {nbytes} bytes")
    if native:
        lib = _build.load_hostio()
        rc = lib.hostio_unpack(
            arena.data_ptr(), len(outs), _ptrs([o.data_ptr() for o in outs]),
            _i64([_nbytes(s) for s in specs]), _i64(offsets), int(threads))
        _check(rc, "unpack")
    else:
        for o, spec, off in zip(outs, specs, offsets):
            _bytes_view(o).copy_(arena[int(off):int(off) + _nbytes(spec)])
    return outs


def file_size(path) -> int:
    """The size of the file at ``path`` in bytes (``stat``)."""
    n = _build.load_hostio().hostio_file_size(os.fsencode(path))
    if n < 0:
        _check(int(n), "stat")
    return int(n)
