"""The kernel build's bookkeeping, on the CPU (no nvcc is run).

``_build._stale`` decides whether the shared library is rebuilt: it must
turn true when any source or shared header under ``csrc/`` is newer than
the library, so an edited header never leaves a stale library in place.
"""
import os
import re
import shutil

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
