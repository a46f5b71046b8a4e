"""Build and load the port's CUDA kernels and its host IO engine.

The sources under ``apex_tpu_torch/csrc/`` have a plain C interface (no
PyTorch headers), so each compiles in seconds: one ``nvcc -c`` per
source, all started together, then one link into
``apex_tpu_torch/build/libapex_tpu_torch_kernels.so``, which is loaded
with ``ctypes``. The build happens at the first kernel launch in a
process (never at import: the CPU tests import every module on a host
with no ``nvcc``) and is reused while it is newer than every file under
``csrc/`` (the shared headers ``*.cuh`` included).

The host IO engine ``csrc/hostio.cpp`` (plain C++, no CUDA) is built
apart with ``g++`` by :func:`load_hostio` at its first use, into
``build/libapex_hostio_<hash>.so`` keyed by a hash of the source. A
failed build raises with the compiler's output: nothing falls back to
Python IO behind the caller's back.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import List, Optional

import torch

PKG_DIR = Path(__file__).resolve().parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "build"
LIB_NAME = "libapex_tpu_torch_kernels.so"
SOURCES = ("flash_attention.cu", "flash_attention_bf16.cu",
           "flash_decode.cu", "fused_block.cu", "fused_softmax.cu",
           "layer_norm.cu", "packed_adam.cu", "packed_flat.cu",
           "packed_lamb.cu", "packed_novograd.cu", "packed_row_stats.cu",
           "packed_sgd.cu")
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = ("-std=c++17", "-O3", "-Xcompiler", "-fPIC")

#: the dtype codes of the kernels' C interfaces (0 fp32, 1 bf16, 2 fp16)
DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_U = ctypes.c_uint32
_L = ctypes.c_longlong
_ARGTYPES = {
    # q, k_pages, v_pages, page_table, kv_lens, out,
    # n_slots, n_heads, head_dim, page_size, pages_per_seq, n_splits,
    # split_len, scale, q_dtype, kv_dtype, device, stream
    "apex_flash_decode": [_P] * 6 + [_I] * 7 + [_F, _I, _I, _I, _P],
    # x, w, b, y, mu, rstd, rows, hidden, eps, x_dtype, blocks,
    # rows_per_block, warps_per_row, vecs, device, stream
    "apex_layer_norm_fwd": [_P] * 6 + [_I, _I, _F] + [_I] * 6 + [_P],
    # dy, x, mu, rstd, w, dx, dw_part, db_part, dw, db, rows, hidden,
    # dy_dtype, x_dtype, x_is_xhat, n_part, rows_per_block,
    # warps_per_row, quads, device, stream
    "apex_layer_norm_bwd": [_P] * 10 + [_I] * 10 + [_P],
    # x, w, y, rstd, rows, hidden, eps, x_dtype, blocks, rows_per_block,
    # warps_per_row, vecs, device, stream
    "apex_rms_norm_fwd": [_P] * 4 + [_I, _I, _F] + [_I] * 6 + [_P],
    # dy, x, rstd, w, dx, dw_part, dw, rows, hidden, dy_dtype, x_dtype,
    # x_is_xhat, n_part, rows_per_block, warps_per_row, quads, device, stream
    "apex_rms_norm_bwd": [_P] * 7 + [_I] * 10 + [_P],
    # q, k, v, kv_mask, bias, seg_q, seg_k, o, lse, b, n, s_q, s_k, d,
    # scale, causal, dropout, seed, threshold, drop_scale, bias_dtype,
    # bias_sb, bias_sh, bias_sq, seg_sb_q, seg_sb_k, dtype, device, stream
    "apex_flash_attn_fwd": [_P] * 9 + [_I] * 5 + [_F, _I, _I, _U, _U, _F, _I]
    + [_L] * 5 + [_I, _I, _P],
    # q, k, v, o, do, lse, kv_mask, bias, seg_q, seg_k, delta, dq, dk, dv,
    # dbias, b, n, s_q, s_k, d, scale, causal, dropout, seed, threshold,
    # drop_scale, bias_dtype, bias_sb, bias_sh, bias_sq, seg_sb_q, seg_sb_k,
    # dtype, device, stream
    "apex_flash_attn_bwd": [_P] * 15 + [_I] * 5
    + [_F, _I, _I, _U, _U, _F, _I] + [_L] * 5 + [_I, _I, _P],
    # rows -> number of partial rows of the fused-block column sums
    "apex_fused_block_partials": [_I],
    # x, b, y, rows, n, dtype, device, stream
    "apex_bias_gelu_fwd": [_P] * 3 + [_I] * 4 + [_P],
    # dy, x, b, dx, part, db, rows, n, dtype, device, stream
    "apex_bias_gelu_bwd": [_P] * 6 + [_I] * 4 + [_P],
    # x, b, res, out, rows, n, dropout, seed, threshold, drop_scale,
    # dtype, device, stream
    "apex_bdr_fwd": [_P] * 4 + [_I] * 3 + [_U, _U, _F, _I, _I, _P],
    # dy, dx, part, db, rows, n, dropout, seed, threshold, drop_scale,
    # dtype, device, stream
    "apex_bdr_bwd": [_P] * 4 + [_I] * 3 + [_U, _U, _F, _I, _I, _P],
    # x, b, res, w, lb, sum, y, mu, rstd, rows, n, eps, dropout, seed,
    # threshold, drop_scale, dtype, device, stream
    "apex_raln_fwd": [_P] * 9 + [_I, _I, _F, _I, _U, _U, _F, _I, _I, _P],
    # dsum_out, dy, sum, mu, rstd, w, dres, dx, part, grads, rows, n,
    # dropout, seed, threshold, drop_scale, dtype, device, stream
    "apex_raln_bwd": [_P] * 10 + [_I] * 3 + [_U, _U, _F, _I, _I, _P],
    # g, m, v, src, p_out, lr, bc1, bc2, inv_scale, noop, n, beta1,
    # 1 - beta1, beta2, 1 - beta2, eps, wd, adam_w_mode, write_mv,
    # write_master, g_dtype, p_dtype, device, stream
    "apex_packed_adam": [_P] * 10 + [_L] + [_F] * 6 + [_I] * 6 + [_P],
    # x, out, inv_scale, rows, op_max, x_dtype, device, stream
    "apex_packed_row_reduce": [_P] * 3 + [_L] + [_I] * 3 + [_P],
    # x, sq, ma, nf, inv_scale, n, x_dtype, device, stream
    "apex_packed_row_stats": [_P] * 5 + [_L] + [_I] * 2 + [_P],
    # g, m, v, src, u, row_u, row_p, inv_scale, clip, bc1, bc2, noop, rows,
    # beta1, beta2, beta3, 1 - beta2, eps, wd, adam_w_mode, g_dtype,
    # device, stream
    "apex_packed_lamb_stage1": [_P] * 12 + [_L] + [_F] * 6 + [_I] * 3
    + [_P],
    # u, src, coef, p_out, lr, noop, rows, write_master, p_dtype, device,
    # stream
    "apex_packed_scale_update": [_P] * 6 + [_L] + [_I] * 3 + [_P],
    # g, buf, src, p_out, lr, first_run, inv_scale, noop, n, momentum,
    # 1 - dampening, wd, nesterov, wd_after_momentum, write_master,
    # g_dtype, p_dtype, device, stream
    "apex_packed_sgd": [_P] * 8 + [_L] + [_F] * 3 + [_I] * 6 + [_P],
    # x, out, scale, row_bad, found, n, x_dtype, out_dtype, device,
    # stream
    "apex_scale_flat": [_P] * 5 + [_L] + [_I] * 3 + [_P],
    # x, y, out, a, b, found, n, x_dtype, y_dtype, out_dtype, device,
    # stream
    "apex_axpby_flat": [_P] * 6 + [_L] + [_I] * 4 + [_P],
    # g, m, src, denom, p_out, lr, bc1, inv_scale, noop, n, beta1, beta3,
    # wd, reg_inside_moment, g_dtype, p_dtype, device, stream
    "apex_packed_novograd": [_P] * 9 + [_L] + [_F] * 3 + [_I] * 4 + [_P],
    # x, y, rows, sk, sq, scale, causal, dtype, vec, device, stream
    "apex_softmax_fwd": [_P, _P, _L, _I, _I, _F, _I, _I, _I, _I, _P],
    # x, mask, y, rows, sk, sq, heads, mask strides (b, h, q), scale,
    # dtype, vec, device, stream
    "apex_softmax_masked_fwd": [_P, _P, _P, _L, _I, _I, _I, _L, _L, _L, _F,
                                _I, _I, _I, _P],
    # dy, y, dx, rows, sk, scale, dtype, vec, device, stream
    "apex_softmax_bwd": [_P, _P, _P, _L, _I, _F, _I, _I, _I, _P],
}


def find_nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (looked on PATH and in /usr/local/cuda/bin): the "
        "CUDA kernels are built on the machine that has the card")


def _stale(lib: Path, csrc: Path = CSRC_DIR) -> bool:
    """True when ``lib`` is missing or older than any source or header
    under ``csrc`` (an edited header rebuilds every source)."""
    if not lib.exists():
        return True
    built = lib.stat().st_mtime
    return any(f.stat().st_mtime > built
               for pat in ("*.cu", "*.cuh") for f in csrc.glob(pat))


def build(extra_flags: List[str] = ()) -> Path:
    """Compile every source in parallel and link the shared library;
    a no-op when the library is newer than every file under ``csrc/``.
    Returns the library's path. ``extra_flags`` go to each compile (for
    example ``["-Xptxas", "-v"]`` to print registers and spills)."""
    lib = BUILD_DIR / LIB_NAME
    if not extra_flags and not _stale(lib):
        return lib
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs, procs = [], []
        for src in SOURCES:
            obj = Path(tmp) / (Path(src).stem + ".o")
            objs.append(str(obj))
            procs.append((src, subprocess.Popen(
                [nvcc, *ARCH_FLAGS, *NVCC_FLAGS, *extra_flags, "-c",
                 str(CSRC_DIR / src), "-o", str(obj)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        failed = []
        for src, p in procs:
            log, _ = p.communicate()
            if log.strip():
                print(f"[nvcc {src}]\n{log.rstrip()}", flush=True)
            if p.returncode:
                failed.append(src)
        if failed:
            raise RuntimeError(f"nvcc failed on {failed}")
        tmp_lib = Path(tmp) / LIB_NAME
        link = subprocess.run(
            [nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp_lib), *objs],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if link.returncode:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
        os.replace(tmp_lib, lib)  # atomic: a reader never sees half a file
    return lib


def kernels() -> ctypes.CDLL:
    """The loaded kernel library (built on first use)."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, argtypes in _ARGTYPES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _lib = lib
    return _lib


def current_stream(device: torch.device) -> int:
    """The raw ``cudaStream_t`` of PyTorch's current stream on
    ``device`` (the stream every kernel launches on)."""
    return torch._C._cuda_getCurrentRawStream(device.index)


@functools.lru_cache(maxsize=None)
def sm_count(index: int) -> int:
    """Streaming multiprocessors of CUDA device ``index`` (read once): the
    backward norm and decode kernels size their grids by it."""
    return torch.cuda.get_device_properties(index).multi_processor_count


def dtype_code(t: torch.Tensor) -> int:
    """The kernels' code for ``t``'s dtype (:data:`DTYPE_CODE`)."""
    return DTYPE_CODE[t.dtype]


def check(rc: int, what: str) -> None:
    """Raise on a non-zero ``cudaError_t`` returned by a launch."""
    if rc:
        raise RuntimeError(f"{what}: CUDA error {rc} at launch")


# ---------------------------------------------------------------------------
# the host IO engine (g++)
# ---------------------------------------------------------------------------

HOSTIO_SRC = CSRC_DIR / "hostio.cpp"
HOSTIO_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC", "-pthread")

_hostio: Optional[ctypes.CDLL] = None


def build_hostio(src: Path = HOSTIO_SRC, build_dir: Path = BUILD_DIR
                 ) -> Path:
    """Compile ``src`` with g++ into ``build_dir/libapex_hostio_<hash>.so``
    (the hash of the source's bytes), or reuse that file when it exists.
    Raises ``RuntimeError`` carrying the compiler's output when the
    build fails."""
    src = Path(src)
    tag = hashlib.sha256(src.read_bytes()).hexdigest()[:16]
    so = Path(build_dir) / f"libapex_hostio_{tag}.so"
    if so.exists():
        return so
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError("g++ not found on PATH: the host IO engine "
                           f"({src.name}) is built with it")
    so.parent.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.name}.tmp{os.getpid()}")
    proc = subprocess.run([gxx, *HOSTIO_FLAGS, str(src), "-o", str(tmp)],
                          capture_output=True, text=True, timeout=300)
    if proc.returncode:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed to build {src}:\n"
                           f"{proc.stderr[-4000:]}")
    os.replace(tmp, so)  # atomic against a concurrent build
    return so


def _configure(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the engine's C signatures (the JAX loader's)."""
    i64 = ctypes.c_int64
    p64 = ctypes.POINTER(ctypes.c_int64)
    pptr = ctypes.POINTER(ctypes.c_void_p)
    for name in ("hostio_write", "hostio_read"):
        fn = getattr(lib, name)
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_char_p, i64, p64, p64, pptr, ctypes.c_int]
    for name in ("hostio_write_fd", "hostio_read_fd"):
        fn = getattr(lib, name)
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_int, i64, p64, p64, pptr, ctypes.c_int]
    lib.hostio_file_size.restype = i64
    lib.hostio_file_size.argtypes = [ctypes.c_char_p]
    for name in ("hostio_pack", "hostio_unpack"):
        fn = getattr(lib, name)
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p, i64, pptr, p64, p64, ctypes.c_int]
    return lib


def load_hostio() -> ctypes.CDLL:
    """The host IO engine, built on first call (:func:`build_hostio`)
    and configured. Raises where it cannot be built or loaded."""
    global _hostio
    with _lock:
        if _hostio is None:
            _hostio = _configure(ctypes.CDLL(str(build_hostio())))
    return _hostio
