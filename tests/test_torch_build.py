"""The kernel build's bookkeeping, on the CPU (no nvcc is run).

``_build._stale`` decides whether the shared library is rebuilt: it must
turn true when any source or shared header under ``csrc/`` is newer than
the library, so an edited header never leaves a stale library in place.
"""
import ctypes
import os
import re
import shutil

import pytest

from apex_tpu_torch import _build


def _copy(tmp_path):
    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC_DIR, csrc)
    lib = tmp_path / _build.LIB_NAME
    lib.write_bytes(b"")
    newest = max(f.stat().st_mtime for f in csrc.iterdir())
    os.utime(lib, (newest + 10, newest + 10))
    return csrc, lib


def test_stale_watches_every_source_and_header(tmp_path):
    csrc, lib = _copy(tmp_path)
    assert not _build._stale(lib, csrc)
    later = lib.stat().st_mtime + 10
    os.utime(csrc / "hash_dropout.cuh", (later, later))
    assert _build._stale(lib, csrc)
    os.utime(lib, (later + 10, later + 10))
    assert not _build._stale(lib, csrc)
    os.utime(csrc / "fused_block.cu", (later + 20, later + 20))
    assert _build._stale(lib, csrc)
    lib.unlink()
    assert _build._stale(lib, csrc)


def test_every_source_is_built_and_every_include_resolves():
    """Each ``.cu`` under ``csrc/`` is compiled, and each local include
    names a header that is there (the one shared header is included by
    both kernels that draw the dropout hash)."""
    cu = {f.name for f in _build.CSRC_DIR.glob("*.cu")}
    assert cu == set(_build.SOURCES)
    includers = set()
    for src in cu:
        text = (_build.CSRC_DIR / src).read_text()
        for inc in re.findall(r'#include "([^"]+)"', text):
            assert (_build.CSRC_DIR / inc).exists(), (src, inc)
            includers.add((src, inc))
    assert {("flash_attention.cu", "hash_dropout.cuh"),
            ("fused_block.cu", "hash_dropout.cuh")} <= includers
    for name in ("apex_bias_gelu_fwd", "apex_bias_gelu_bwd", "apex_bdr_fwd",
                 "apex_bdr_bwd", "apex_raln_fwd", "apex_raln_bwd"):
        assert name in _build._ARGTYPES
        assert f'extern "C" int {name}(' in (
            _build.CSRC_DIR / "fused_block.cu").read_text()


_C_TYPES = {"int": ctypes.c_int, "float": ctypes.c_float,
            "long long": ctypes.c_longlong, "uint32_t": ctypes.c_uint32}


def test_argtypes_match_the_c_declarations():
    """Every ``_ARGTYPES`` entry has the C entry point's parameters in
    order (a pointer as ``c_void_p``; an int, float, long long or
    uint32_t as its ctypes twin), and every entry point has an entry:
    ctypes converts by these lists alone, so a mismatch passes a wrong
    value without an error."""
    decls = {}
    for src in _build.SOURCES:
        text = (_build.CSRC_DIR / src).read_text()
        for name, params in re.findall(
                r'extern "C" int (\w+)\(([^)]*)\)', text):
            decls[name] = [p.strip() for p in params.split(",")
                           if p.strip()]
    assert set(decls) == set(_build._ARGTYPES)
    for name, params in decls.items():
        want = []
        for p in params:
            ctype = p.rsplit(" ", 1)[0].replace("const ", "").strip()
            want.append(ctypes.c_void_p if "*" in p else _C_TYPES[ctype])
        assert _build._ARGTYPES[name] == want, name


@pytest.mark.parametrize("name,source", [
    ("apex_scale_flat", "packed_flat.cu"),
    ("apex_axpby_flat", "packed_flat.cu"),
    ("apex_packed_novograd", "packed_novograd.cu"),
    ("apex_flash_attn_fwd", "flash_attention.cu"),
    ("apex_flash_attn_bwd", "flash_attention.cu"),
    ("apex_raln_fwd", "fused_block.cu"),
    ("apex_raln_bwd", "fused_block.cu"),
    ("apex_layer_norm_bwd", "layer_norm.cu"),
    ("apex_rms_norm_fwd", "layer_norm.cu"),
    ("apex_rms_norm_bwd", "layer_norm.cu"),
    ("apex_packed_row_stats", "packed_row_stats.cu")])
def test_entry_point_is_declared_in_its_source(name, source):
    """Each entry point the wrappers call is bound (``_ARGTYPES``) and
    defined in the source that the build compiles."""
    assert source in _build.SOURCES
    assert name in _build._ARGTYPES
    assert f'extern "C" int {name}(' in (_build.CSRC_DIR / source
                                         ).read_text()
