"""The port's host IO engine and ``GDSFile`` against the JAX package's.

The cases of the JAX package's ``tests/test_hostio.py`` run against
``apex_tpu_torch.ops.hostio`` on CPU tensors, and more:

- the files the port writes are byte-identical to the ones
  ``apex_tpu.ops.hostio.write_arrays`` writes for the same numpy-seeded
  arrays and offsets, and the arenas of ``flatten`` too;
- ``GDSFile`` files are byte-identical to the JAX ``GDSFile``'s (the
  cases of ``tests/test_checkpoint.py``'s GDS tests), and ``load_data``
  fills the caller's tensor in place;
- the plain Python route (``native=False``, which only tests take)
  writes the same bytes as the native engine;
- a build of a source that does not compile raises with the compiler's
  output: there is no silent fallback.

Every comparison is exact: these are bytes.
"""
import os

import ml_dtypes
import numpy as np
import pytest
import torch

from apex_tpu.ops import hostio as jhostio
from apex_tpu_torch import _build
from apex_tpu_torch.contrib.gpu_direct_storage import GDSFile
from apex_tpu_torch.contrib.gpu_direct_storage.gds import _GDSFile
from apex_tpu_torch.ops import hostio


def _arrays(seed=0):
    rng = np.random.default_rng(seed)
    return [
        rng.standard_normal((17, 33)).astype(np.float32),
        rng.integers(0, 255, (5,), dtype=np.uint8),
        rng.standard_normal((128, 64)).astype(np.float32),
        np.asarray(3.25, np.float64).reshape(()),
        rng.standard_normal((9, 3)).astype(ml_dtypes.bfloat16),
    ]


def _tensor(a: np.ndarray) -> torch.Tensor:
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _np(t: torch.Tensor) -> np.ndarray:
    if t.dtype == torch.bfloat16:
        return t.view(torch.uint16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


def _same(tensors, arrays):
    assert len(tensors) == len(arrays)
    for t, a in zip(tensors, arrays):
        assert tuple(t.shape) == a.shape
        assert _np(t).tobytes() == a.tobytes()


def test_native_library_builds():
    assert hostio.native_available()


def test_write_read_roundtrip(tmp_path):
    arrs = _arrays(1)
    ts = [_tensor(a) for a in arrs]
    path = str(tmp_path / "blob.bin")
    offsets = hostio.write_arrays(path, ts, threads=4)
    back = hostio.read_arrays(path, [(t.shape, t.dtype) for t in ts],
                              offsets, threads=4)
    _same(back, arrs)
    assert hostio.file_size(path) >= max(
        o + a.nbytes for o, a in zip(offsets, arrs))


def test_files_are_byte_identical_to_jax(tmp_path):
    arrs = _arrays(5)
    ts = [_tensor(a) for a in arrs]
    joff = jhostio.write_arrays(str(tmp_path / "jax.bin"), arrs)
    toff = hostio.write_arrays(str(tmp_path / "port.bin"), ts)
    assert toff == joff
    assert (tmp_path / "port.bin").read_bytes() == \
        (tmp_path / "jax.bin").read_bytes()
    # and at the same explicit offsets, out of order and with gaps
    offs = [4096, 0, 2048, 8000, 9000]
    jhostio.write_arrays(str(tmp_path / "jax2.bin"), arrs, offsets=offs)
    hostio.write_arrays(str(tmp_path / "port2.bin"), ts, offsets=offs)
    assert (tmp_path / "port2.bin").read_bytes() == \
        (tmp_path / "jax2.bin").read_bytes()
    # each reads what the other wrote
    _same(hostio.read_arrays(str(tmp_path / "jax.bin"), ts, joff), arrs)


def test_explicit_offsets_and_overwrite(tmp_path):
    path = str(tmp_path / "slots.bin")
    a = torch.arange(16, dtype=torch.int64)
    b = torch.arange(16, 32, dtype=torch.int64)
    hostio.write_arrays(path, [a, b], offsets=[0, 1024])
    hostio.write_arrays(path, [b], offsets=[0])  # overwrite slot 0
    (r0,) = hostio.read_arrays(path, [(a.shape, a.dtype)], [0])
    (r1,) = hostio.read_arrays(path, [(b.shape, b.dtype)], [1024])
    assert torch.equal(r0, b) and torch.equal(r1, b)


def test_read_into_out_tensors(tmp_path):
    arrs = _arrays(6)
    ts = [_tensor(a) for a in arrs]
    path = str(tmp_path / "out.bin")
    offsets = hostio.write_arrays(path, ts)
    out = [torch.zeros_like(t) for t in ts]
    # a strided destination is filled through a staging buffer
    wide = torch.zeros(17, 66)
    out[0] = wide[:, ::2]
    back = hostio.read_arrays(path, None, offsets, out=out)
    assert all(b is o for b, o in zip(back, out))
    _same([o.contiguous() for o in out], arrs)
    assert torch.equal(wide[:, 1::2], torch.zeros(17, 33))


def test_flatten_unflatten_roundtrip():
    arrs = _arrays(2)
    ts = [_tensor(a) for a in arrs]
    arena, offsets = hostio.flatten(ts, threads=4)
    assert arena.dtype == torch.uint8
    assert all(o % 64 == 0 for o in offsets)
    jarena, joffsets = jhostio.flatten(arrs)
    assert offsets == joffsets
    assert arena.numpy().tobytes() == jarena.tobytes()
    _same(hostio.unflatten(arena, ts, offsets, threads=4), arrs)


def test_python_route_matches_native(tmp_path):
    arrs = _arrays(3)
    ts = [_tensor(a) for a in arrs]
    p_native = str(tmp_path / "native.bin")
    hostio.write_arrays(p_native, ts)
    arena_native, off = hostio.flatten(ts)
    p_py = str(tmp_path / "py.bin")
    offsets = hostio.write_arrays(p_py, ts, native=False)
    assert open(p_native, "rb").read() == open(p_py, "rb").read()
    _same(hostio.read_arrays(p_py, ts, offsets, native=False), arrs)
    arena_py, _ = hostio.flatten(ts, native=False)
    assert torch.equal(arena_native, arena_py)
    _same(hostio.unflatten(arena_py, ts, off, native=False), arrs)


def test_read_missing_file_raises(tmp_path):
    with pytest.raises(OSError):
        hostio.read_arrays(str(tmp_path / "nope.bin"),
                           [((4,), torch.float32)], [0])


@pytest.mark.parametrize("native", [True, False])
def test_read_past_eof_raises(tmp_path, native):
    path = str(tmp_path / "short.bin")
    hostio.write_arrays(path, [torch.zeros(4)])
    with pytest.raises(OSError):
        hostio.read_arrays(path, [((1024,), torch.float32)], [0],
                           native=native)


def test_offsets_count_validation(tmp_path):
    path = str(tmp_path / "v.bin")
    a = torch.zeros(4)
    with pytest.raises(ValueError, match="offsets"):
        hostio.write_arrays(path, [a, a], offsets=[0])
    hostio.write_arrays(path, [a])
    with pytest.raises(ValueError, match="offsets"):
        hostio.read_arrays(path, [(a.shape, a.dtype)] * 2, [0])
    arena, offs = hostio.flatten([a, a])
    with pytest.raises(ValueError, match="offsets"):
        hostio.unflatten(arena, [a, a], offs[:1])


def test_fd_based_io(tmp_path):
    path = str(tmp_path / "fd.bin")
    arrs = _arrays(4)
    ts = [_tensor(a) for a in arrs]
    fd = os.open(path, os.O_RDWR | os.O_CREAT, 0o644)
    try:
        offsets = hostio.write_arrays(fd, ts)
        back = hostio.read_arrays(fd, [(t.shape, t.dtype) for t in ts],
                                  offsets)
    finally:
        os.close(fd)
    _same(back, arrs)


def test_unflatten_noncontiguous_arena():
    a = torch.arange(64, dtype=torch.float32)
    arena, offs = hostio.flatten([a])
    wide = torch.zeros(arena.numel() // 4, 2)
    wide[:, 0] = arena.view(torch.float32)
    (back,) = hostio.unflatten(wide[:, 0], [a], offs)
    assert torch.equal(back, a)


def test_unflatten_out_of_bounds_offset_raises():
    a = torch.arange(64, dtype=torch.float32)
    arena, offs = hostio.flatten([a])
    with pytest.raises(ValueError, match="out of bounds"):
        hostio.unflatten(arena, [a], [arena.numel() - 4])
    with pytest.raises(ValueError, match="out of bounds"):
        hostio.unflatten(arena, [a], [-8])


def test_failed_build_raises_with_the_compiler_output(tmp_path):
    bad = tmp_path / "broken.cpp"
    bad.write_text("int main( { return 0; }\n")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed") as info:
        _build.build_hostio(src=bad, build_dir=tmp_path / "build")
    assert "error" in str(info.value)
    assert not list((tmp_path / "build").glob("*.so*"))


def test_build_is_keyed_by_the_source(tmp_path):
    src = tmp_path / "hostio.cpp"
    src.write_bytes(_build.HOSTIO_SRC.read_bytes())
    so = _build.build_hostio(src=src, build_dir=tmp_path / "b")
    assert so.exists() and so.parent == tmp_path / "b"
    assert _build.build_hostio(src=src, build_dir=tmp_path / "b") == so
    src.write_bytes(src.read_bytes() + b"\n// edited\n")
    assert _build.build_hostio(src=src, build_dir=tmp_path / "b") != so


# ---------------------------------------------------------------------------
# GDSFile
# ---------------------------------------------------------------------------

def test_gdsfile_bytes_equal_jax(tmp_path):
    import jax.numpy as jnp

    from apex_tpu.contrib.gpu_direct_storage import GDSFile as JGDSFile

    rng = np.random.default_rng(11)
    x = (np.arange(24, dtype=np.float32).reshape(4, 6) * 1.5)
    a = rng.standard_normal(8).astype(ml_dtypes.bfloat16)
    b = np.ones((2, 3), np.int32) * 7
    with JGDSFile(str(tmp_path / "jax.bin"), "w") as f:
        for arr in (x, a, b):
            f.save_data(jnp.asarray(arr))
    with GDSFile(str(tmp_path / "port.bin"), "w") as f:
        for arr in (x, a, b):
            f.save_data(_tensor(arr))
    raw = (tmp_path / "port.bin").read_bytes()
    assert raw == (tmp_path / "jax.bin").read_bytes()
    assert raw == x.tobytes() + a.tobytes() + b.tobytes()
    # the port reads the JAX package's file in place
    outs = [torch.zeros(4, 6), torch.zeros(8, dtype=torch.bfloat16),
            torch.zeros(2, 3, dtype=torch.int32)]
    with GDSFile(str(tmp_path / "jax.bin"), "r") as f:
        back = [f.load_data(o) for o in outs]
    assert all(b_ is o for b_, o in zip(back, outs))
    _same(outs, [x, a, b])


def test_gdsfile_roundtrip(tmp_path):
    fn = str(tmp_path / "t.bin")
    x = torch.arange(24, dtype=torch.float32).reshape(4, 6) * 1.5
    with GDSFile(fn, "w") as f:
        f.save_data(x)
        f.save_data_no_gds(x * 2)
    y, z = torch.zeros_like(x), torch.zeros_like(x)
    with GDSFile(fn, "r") as f:
        assert f.load_data(y) is y
        assert f.load_data_no_gds(z) is z
    assert torch.equal(y, x) and torch.equal(z, x * 2)
    with GDSFile(fn, "r") as f:
        f.load_data(torch.zeros(48))
        with pytest.raises(EOFError):
            f.load_data(torch.zeros(1))


def test_gdsfile_mode_enforcement(tmp_path):
    fn = str(tmp_path / "t.bin")
    x = torch.zeros(2)
    with GDSFile(fn, "w") as f:
        f.save_data(x)
        with pytest.raises(RuntimeError):
            f.load_data(x)
    with GDSFile(fn, "r") as f:
        with pytest.raises(RuntimeError):
            f.save_data(x)
    with pytest.raises(ValueError):
        with GDSFile(fn, "x"):
            pass
    with pytest.raises(FileNotFoundError):
        with GDSFile(str(tmp_path / "absent.bin"), "rw"):
            pass


def test_gdsfile_use_after_close_raises(tmp_path):
    path = str(tmp_path / "closed.bin")
    f = _GDSFile(path, "w")
    f.save_data(torch.ones(4))
    f.close()
    with pytest.raises(ValueError, match="closed"):
        f.save_data(torch.ones(4))
    g = _GDSFile(path, "r")
    g.close()
    with pytest.raises(ValueError, match="closed"):
        g.load_data(torch.zeros(4))
