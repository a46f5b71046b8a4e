"""Fused transformer-block tails: CUDA kernels for Hopper and their plain
PyTorch versions (counterpart of ``apex_tpu/ops/fused_block.py``).

Three ops, each one sweep over a ``[..., n]`` activation instead of a
chain of elementwise passes:

- :func:`bias_gelu`: ``gelu_tanh(x + bias)``, the MLP up-projection
  epilogue (fc1 runs bias-free);
- :func:`bias_dropout_residual`: ``residual + dropout(x + bias)``, the
  MLP tail (Megatron's ``bias_dropout_add``);
- :func:`residual_add_layer_norm`: ``sum = residual + dropout(x + bias)``
  and ``y = LayerNorm(sum)``, the attention tail and the MLP's pre-LN.

Numerics are those of the TPU kernel bodies (``_bias_gelu_fwd_kernel``
and the rest), not of the JAX module's XLA fallbacks: fp32 inside, one
rounding per output. So ``bias_gelu`` adds the bias in fp32 before the
GeLU (the fallback rounds ``x + bias`` first), and the LayerNorm of
``residual_add_layer_norm`` runs on the sum after its rounding to the
residual dtype, with fp32 statistics. Rows are every leading index
(``[s, b, h]`` gives row ``s_i * b + b_i``); dropout is the counter hash
of flash attention keyed on ``(seed, 0, row, col)``, so forward,
backward, kernel and plain version regenerate one mask from the seed
alone and no mask tensor exists.

The kernels are ``csrc/fused_block.cu`` (#8-#13 of the TPU kernel table
in PERF.md): each forward is a ``torch.library`` custom op
(:data:`BIAS_GELU_FWD`, :data:`BIAS_DROPOUT_RESIDUAL_FWD`,
:data:`RESIDUAL_LN_FWD`), which is what lets the ``selective_elementwise``
recompute policy of ``standalone_transformer_lm`` save their outputs
(the counterpart of JAX's name-matched ``pallas_call`` policy); each
backward is a plain call. The ``*_reference`` functions are the plain
versions. Route (``_device.kernel_route``): CUDA tensors go through the
kernels, CPU tensors through the plain versions. On the card the kernels
take x, residual and gradients of one dtype (fp32, bf16 or fp16) and any
trailing dim; other inputs raise ``ValueError`` before any launch.
"""
from typing import Optional, Tuple

import torch

from .. import _build, _device
from .._build import dtype_code as _code
from .flash_attention import (
    _dropout_args,
    _hash_keep_bits,
    _i32,
    _threshold,
    _u32,
)

# the forward ops the selective_elementwise recompute policy saves
# (standalone_transformer_lm._FUSED_BLOCK_SAVEABLE_OPS)
BIAS_GELU_FWD = "apex_tpu_torch::bias_gelu_fwd"
BIAS_DROPOUT_RESIDUAL_FWD = "apex_tpu_torch::bias_dropout_residual_fwd"
RESIDUAL_LN_FWD = "apex_tpu_torch::residual_ln_fwd"

_SQRT_2_OVER_PI = 0.7978845608028654  # sqrt(2/pi)
_GELU_C = 0.044715


# ---------------------------------------------------------------------------
# plumbing
# ---------------------------------------------------------------------------

def _flat2d(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Size]:
    """View ``[..., n]`` as ``(rows, n)``."""
    return x.reshape(-1, x.shape[-1]), x.shape


def _resolve_seed(dropout_p: float, seed) -> Optional[int]:
    """None without dropout, else the seed as an int32 value (a tensor
    seed is read to the host once)."""
    if not 0.0 <= dropout_p < 1.0:
        raise ValueError(f"dropout_p must be in [0, 1), got {dropout_p}")
    if dropout_p > 0.0 and seed is None:
        raise ValueError(
            "dropout_p > 0 requires a seed (an int or an int tensor; "
            "derive one per step)")
    return None if dropout_p == 0.0 else _i32(int(seed))


def dropout_mask_reference(seed, rows: int, n: int, dropout_p: float,
                           device="cpu") -> torch.Tensor:
    """The exact float32 {0, 1} ``(rows, n)`` keep mask the fused ops use
    (``_keep_mask(seed, 0, row, col, p)`` of the JAX module)."""
    row = torch.arange(rows, dtype=torch.int64, device=device)[:, None]
    col = torch.arange(n, dtype=torch.int64, device=device)[None, :]
    seed_t = torch.tensor(_i32(int(seed)), dtype=torch.int64, device=device)
    zero = torch.zeros((), dtype=torch.int64, device=device)
    bits = _u32(_hash_keep_bits(seed_t, zero, row, col))
    return (bits >= _threshold(dropout_p)).to(torch.float32)


def _drop(v: torch.Tensor, seed: Optional[int],
          dropout_p: float) -> torch.Tensor:
    """``v * keep * 1/(1-p)`` on an fp32 ``(rows, n)`` tensor; ``v``
    itself without dropout."""
    if seed is None:
        return v
    keep = dropout_mask_reference(seed, v.shape[0], v.shape[1], dropout_p,
                                  v.device)
    return v * keep * (1.0 / (1.0 - dropout_p))


def _gelu_tanh_f32(x: torch.Tensor) -> torch.Tensor:
    """tanh-approximate GeLU in fp32."""
    inner = _SQRT_2_OVER_PI * (x + _GELU_C * x * x * x)
    return 0.5 * x * (1.0 + torch.tanh(inner))


def _dgelu_tanh_f32(x: torch.Tensor) -> torch.Tensor:
    """d/dx of the tanh-approximate GeLU, fp32."""
    inner = _SQRT_2_OVER_PI * (x + _GELU_C * x * x * x)
    t = torch.tanh(inner)
    dinner = _SQRT_2_OVER_PI * (1.0 + 3.0 * _GELU_C * x * x)
    return 0.5 * (1.0 + t) + 0.5 * x * (1.0 - t * t) * dinner


# ---------------------------------------------------------------------------
# plain versions: the math of the TPU kernel bodies on (rows, n) tensors
# ---------------------------------------------------------------------------

def bias_gelu_reference(x2d: torch.Tensor, bias: torch.Tensor
                        ) -> torch.Tensor:
    """``gelu_tanh(x + bias)`` in fp32, rounded to x's dtype
    (``_bias_gelu_fwd_kernel``)."""
    return _gelu_tanh_f32(x2d.float() + bias.float()).to(x2d.dtype)


def bias_gelu_bwd_reference(dy2d, x2d, bias):
    """``(dx in dy's dtype, db fp32 [n])`` with ``db`` the column sum of
    the unrounded fp32 ``dx`` (``_bias_gelu_bwd_kernel``)."""
    dx = dy2d.float() * _dgelu_tanh_f32(x2d.float() + bias.float())
    return dx.to(dy2d.dtype), dx.sum(dim=0)


def bias_dropout_residual_reference(x2d, bias, r2d, seed, dropout_p):
    """``residual + drop(x + bias)`` in fp32, rounded to the residual's
    dtype (``_bdr_fwd_kernel``)."""
    xb = _drop(x2d.float() + bias.float(), seed, dropout_p)
    return (r2d.float() + xb).to(r2d.dtype)


def bias_dropout_residual_bwd_reference(dy2d, seed, dropout_p, dx_dtype):
    """``(dx = drop(dy) in dx_dtype, db fp32 [n])`` (``_bdr_bwd_kernel``);
    the residual's gradient is ``dy`` itself."""
    dx = _drop(dy2d.to(torch.float32, copy=True), seed, dropout_p)
    return dx.to(dx_dtype), dx.sum(dim=0)


def residual_ln_reference(x2d, bias, r2d, w, lb, seed, eps, dropout_p):
    """``(sum, y, mu [rows, 1], rstd [rows, 1])`` (``_raln_fwd_kernel``):
    the sum rounded to the residual's dtype, the LayerNorm's fp32
    statistics over that rounded sum (centred two-pass variance), y in
    the residual's dtype."""
    xb = _drop(x2d.float() + bias.float(), seed, dropout_p)
    s = (r2d.float() + xb).to(r2d.dtype)
    sf = s.float()
    mu = sf.mean(dim=1, keepdim=True)
    sc = sf - mu
    rstd = torch.rsqrt((sc * sc).mean(dim=1, keepdim=True) + eps)
    y = (sc * rstd) * w.float() + lb.float()
    return s, y.to(s.dtype), mu, rstd


def residual_ln_bwd_reference(dsum2d, dy2d, s2d, mu, rstd, w, seed,
                              dropout_p):
    """``(dres, dx, dw, dlb, db)`` (``_raln_bwd_kernel``): dres and dx in
    the sum's dtype, the three column sums fp32 ``[n]``, db over the
    unrounded fp32 dx."""
    dy = dy2d.float()
    xhat = (s2d.float() - mu) * rstd
    wdy = dy * w.float()
    c1 = (xhat * wdy).mean(dim=1, keepdim=True)
    c2 = wdy.mean(dim=1, keepdim=True)
    dsum = (wdy - xhat * c1 - c2) * rstd + dsum2d.float()
    dx = _drop(dsum, seed, dropout_p)
    return (dsum.to(s2d.dtype, copy=True), dx.to(s2d.dtype, copy=True),
            (dy * xhat).sum(dim=0), dy.sum(dim=0), dx.sum(dim=0))


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

def fused_block_available(n: int) -> bool:
    """Whether the kernels of all three ops take trailing dim ``n`` on
    the card: any ``n >= 1`` (rows wider than 4096, or not a multiple of
    8, take the kernels' column-walking and element-by-element
    instances), as the JAX package runs the tails at any width."""
    return n >= 1


def _kernel_args(name: str, rows_: Tuple[torch.Tensor, ...],
                 params: Tuple[torch.Tensor, ...]):
    """Check what the kernel takes; return the row tensors contiguous and
    the parameter vectors as contiguous fp32 (widening is exact)."""
    n = rows_[0].shape[-1]
    dtype = rows_[0].dtype
    if dtype not in _build.DTYPE_CODE or any(
            t.dtype != dtype for t in rows_):
        raise ValueError(
            f"{name} kernel takes row tensors of one dtype, fp32, bf16 or "
            f"fp16; got {[t.dtype for t in rows_]}")
    if not fused_block_available(n):
        raise ValueError(f"{name} kernel takes a trailing dim of at least "
                         f"1, got {n}")
    if any(t.shape != rows_[0].shape for t in rows_):
        raise ValueError(f"{name}: row tensors differ in shape "
                         f"{[tuple(t.shape) for t in rows_]}")
    rows_ = tuple(t.contiguous() for t in rows_)
    params = tuple(p.to(torch.float32).contiguous() for p in params)
    for t in rows_ + params:
        if t.data_ptr() % 16:
            raise ValueError(f"{name} kernel needs 16-byte aligned tensors")
    return rows_, params


def _launch_bias_gelu_fwd(x2d, bias):
    (x2d,), (b,) = _kernel_args("bias_gelu_fwd", (x2d,), (bias,))
    rows, n = x2d.shape
    lib = _build.kernels()
    dev = x2d.device
    y = torch.empty_like(x2d)
    rc = lib.apex_bias_gelu_fwd(x2d.data_ptr(), b.data_ptr(), y.data_ptr(),
                                rows, n, _code(x2d), dev.index,
                                _build.current_stream(dev))
    _build.check(rc, "bias_gelu_fwd")
    _device.LAUNCHES["bias_gelu_fwd"] += 1
    return y


def _partials(lib, rows: int, n: int, k: int, dev):
    return torch.empty((k, lib.apex_fused_block_partials(rows), n),
                       dtype=torch.float32, device=dev)


def _launch_bias_gelu_bwd(dy2d, x2d, bias):
    (dy2d, x2d), (b,) = _kernel_args("bias_gelu_bwd", (dy2d, x2d), (bias,))
    rows, n = x2d.shape
    lib = _build.kernels()
    dev = x2d.device
    dx = torch.empty_like(dy2d)
    part = _partials(lib, rows, n, 1, dev)
    db = torch.empty(n, dtype=torch.float32, device=dev)
    rc = lib.apex_bias_gelu_bwd(dy2d.data_ptr(), x2d.data_ptr(), b.data_ptr(),
                                dx.data_ptr(), part.data_ptr(), db.data_ptr(),
                                rows, n, _code(x2d), dev.index,
                                _build.current_stream(dev))
    _build.check(rc, "bias_gelu_bwd")
    _device.LAUNCHES["bias_gelu_bwd"] += 1
    return dx, db


def _launch_bdr_fwd(x2d, bias, r2d, seed, dropout_p):
    (x2d, r2d), (b,) = _kernel_args("bias_dropout_residual_fwd",
                                    (x2d, r2d), (bias,))
    rows, n = x2d.shape
    lib = _build.kernels()
    dev = x2d.device
    out = torch.empty_like(r2d)
    rc = lib.apex_bdr_fwd(x2d.data_ptr(), b.data_ptr(), r2d.data_ptr(),
                          out.data_ptr(), rows, n,
                          *_dropout_args(dropout_p, seed), _code(x2d),
                          dev.index, _build.current_stream(dev))
    _build.check(rc, "bias_dropout_residual_fwd")
    _device.LAUNCHES["bias_dropout_residual_fwd"] += 1
    return out


def _launch_bdr_bwd(dy2d, seed, dropout_p, dx_dtype):
    if dx_dtype != dy2d.dtype:
        raise ValueError(
            f"bias_dropout_residual_bwd kernel writes dx in dy's dtype "
            f"{dy2d.dtype}, asked for {dx_dtype}")
    (dy2d,), _ = _kernel_args("bias_dropout_residual_bwd", (dy2d,), ())
    rows, n = dy2d.shape
    lib = _build.kernels()
    dev = dy2d.device
    dx = torch.empty_like(dy2d)
    part = _partials(lib, rows, n, 1, dev)
    db = torch.empty(n, dtype=torch.float32, device=dev)
    rc = lib.apex_bdr_bwd(dy2d.data_ptr(), dx.data_ptr(), part.data_ptr(),
                          db.data_ptr(), rows, n,
                          *_dropout_args(dropout_p, seed), _code(dy2d),
                          dev.index, _build.current_stream(dev))
    _build.check(rc, "bias_dropout_residual_bwd")
    _device.LAUNCHES["bias_dropout_residual_bwd"] += 1
    return dx, db


def _launch_raln_fwd(x2d, bias, r2d, w, lb, seed, eps, dropout_p):
    (x2d, r2d), (b, w, lb) = _kernel_args(
        "residual_ln_fwd", (x2d, r2d), (bias, w, lb))
    rows, n = x2d.shape
    lib = _build.kernels()
    dev = x2d.device
    s = torch.empty_like(r2d)
    y = torch.empty_like(r2d)
    mu = torch.empty((rows, 1), dtype=torch.float32, device=dev)
    rstd = torch.empty((rows, 1), dtype=torch.float32, device=dev)
    rc = lib.apex_raln_fwd(x2d.data_ptr(), b.data_ptr(), r2d.data_ptr(),
                           w.data_ptr(), lb.data_ptr(), s.data_ptr(),
                           y.data_ptr(), mu.data_ptr(), rstd.data_ptr(),
                           rows, n, float(eps),
                           *_dropout_args(dropout_p, seed), _code(x2d),
                           dev.index, _build.current_stream(dev))
    _build.check(rc, "residual_ln_fwd")
    _device.LAUNCHES["residual_ln_fwd"] += 1
    return s, y, mu, rstd


def _launch_raln_bwd(dsum2d, dy2d, s2d, mu, rstd, w, seed, dropout_p):
    (dsum2d, dy2d, s2d), (w,) = _kernel_args(
        "residual_ln_bwd", (dsum2d, dy2d, s2d), (w,))
    rows, n = s2d.shape
    for name, t in (("mu", mu), ("rstd", rstd)):
        if t.dtype != torch.float32 or t.numel() != rows:
            raise ValueError(f"{name} must be fp32 [{rows}, 1]")
    mu, rstd = mu.contiguous(), rstd.contiguous()
    lib = _build.kernels()
    dev = s2d.device
    dres = torch.empty_like(s2d)
    dx = torch.empty_like(s2d)
    part = _partials(lib, rows, n, 3, dev)
    grads = torch.empty((3, n), dtype=torch.float32, device=dev)
    rc = lib.apex_raln_bwd(dsum2d.data_ptr(), dy2d.data_ptr(),
                           s2d.data_ptr(), mu.data_ptr(), rstd.data_ptr(),
                           w.data_ptr(), dres.data_ptr(), dx.data_ptr(),
                           part.data_ptr(), grads.data_ptr(), rows, n,
                           *_dropout_args(dropout_p, seed), _code(s2d),
                           dev.index, _build.current_stream(dev))
    _build.check(rc, "residual_ln_bwd")
    _device.LAUNCHES["residual_ln_bwd"] += 1
    return dres, dx, grads[0], grads[1], grads[2]


# ---------------------------------------------------------------------------
# routed forward ops (named, for the recompute policy) and backwards
# ---------------------------------------------------------------------------

def _bias_gelu_fwd_impl(x2d, bias):
    if _device.kernel_route(x2d, bias):
        return _launch_bias_gelu_fwd(x2d, bias)
    return bias_gelu_reference(x2d, bias)


def _bdr_fwd_impl(x2d, bias, r2d, seed, dropout_p):
    if _device.kernel_route(x2d, bias, r2d):
        return _launch_bdr_fwd(x2d, bias, r2d, seed, dropout_p)
    return bias_dropout_residual_reference(x2d, bias, r2d, seed, dropout_p)


def _raln_fwd_impl(x2d, bias, r2d, w, lb, seed, eps, dropout_p):
    if _device.kernel_route(x2d, bias, r2d, w, lb):
        return _launch_raln_fwd(x2d, bias, r2d, w, lb, seed, eps, dropout_p)
    return residual_ln_reference(x2d, bias, r2d, w, lb, seed, eps,
                                 dropout_p)


_bias_gelu_fwd = torch.library.custom_op(
    BIAS_GELU_FWD, _bias_gelu_fwd_impl, mutates_args=(),
    schema="(Tensor x, Tensor bias) -> Tensor")
_bdr_fwd = torch.library.custom_op(
    BIAS_DROPOUT_RESIDUAL_FWD, _bdr_fwd_impl, mutates_args=(),
    schema="(Tensor x, Tensor bias, Tensor residual, int? seed, "
           "float dropout_p) -> Tensor")
_raln_fwd = torch.library.custom_op(
    RESIDUAL_LN_FWD, _raln_fwd_impl, mutates_args=(),
    schema="(Tensor x, Tensor bias, Tensor residual, Tensor w, Tensor lb, "
           "int? seed, float eps, float dropout_p) "
           "-> (Tensor, Tensor, Tensor, Tensor)")


def _bias_gelu_bwd(dy2d, x2d, bias):
    if _device.kernel_route(dy2d, x2d, bias):
        return _launch_bias_gelu_bwd(dy2d, x2d, bias)
    return bias_gelu_bwd_reference(dy2d, x2d, bias)


def _bdr_bwd(dy2d, seed, dropout_p, dx_dtype):
    if _device.kernel_route(dy2d):
        return _launch_bdr_bwd(dy2d, seed, dropout_p, dx_dtype)
    return bias_dropout_residual_bwd_reference(dy2d, seed, dropout_p,
                                               dx_dtype)


def _raln_bwd(dsum2d, dy2d, s2d, mu, rstd, w, seed, dropout_p):
    if _device.kernel_route(dsum2d, dy2d, s2d, mu, rstd, w):
        return _launch_raln_bwd(dsum2d, dy2d, s2d, mu, rstd, w, seed,
                                dropout_p)
    return residual_ln_bwd_reference(dsum2d, dy2d, s2d, mu, rstd, w, seed,
                                     dropout_p)


# ---------------------------------------------------------------------------
# autograd Functions (the JAX module's custom VJPs)
# ---------------------------------------------------------------------------

class _BiasGelu(torch.autograd.Function):
    """Saves ``(x, bias)``; the backward returns dx in dy's dtype and the
    fp32 column sum cast to the bias's dtype."""

    @staticmethod
    def forward(ctx, x2d, bias):
        ctx.save_for_backward(x2d, bias)
        return _bias_gelu_fwd(x2d, bias)

    @staticmethod
    def backward(ctx, dy):
        x2d, bias = ctx.saved_tensors
        dx, db = _bias_gelu_bwd(dy, x2d, bias)
        return dx, db.to(bias.dtype)


class _BiasDropoutResidual(torch.autograd.Function):
    """Saves no tensor, only the seed and the dtypes (the backward
    regenerates the mask from the seed and needs only dy); the residual's
    gradient is dy itself."""

    @staticmethod
    def forward(ctx, x2d, bias, r2d, seed, dropout_p):
        ctx.cfg = (seed, dropout_p, x2d.dtype, bias.dtype)
        return _bdr_fwd(x2d, bias, r2d, seed, dropout_p)

    @staticmethod
    def backward(ctx, dy):
        seed, dropout_p, x_dtype, b_dtype = ctx.cfg
        dx, db = _bdr_bwd(dy, seed, dropout_p, x_dtype)
        return dx, db.to(b_dtype), dy, None, None


class _ResidualAddLayerNorm(torch.autograd.Function):
    """Returns ``(sum, y)``; saves the rounded sum, its statistics and
    the LayerNorm weight (x and the residual are not kept). The backward
    takes both cotangents."""

    @staticmethod
    def forward(ctx, x2d, bias, r2d, w, lb, seed, eps, dropout_p):
        s, y, mu, rstd = _raln_fwd(x2d, bias, r2d, w, lb, seed, eps,
                                   dropout_p)
        ctx.save_for_backward(w, s, mu, rstd)
        ctx.cfg = (seed, dropout_p, bias.dtype, lb.dtype)
        return s, y

    @staticmethod
    def backward(ctx, dsum_out, dy):
        w, s, mu, rstd = ctx.saved_tensors
        seed, dropout_p, b_dtype, lb_dtype = ctx.cfg
        dres, dx, dw, dlb, db = _raln_bwd(dsum_out, dy, s, mu, rstd, w, seed,
                                          dropout_p)
        return (dx, db.to(b_dtype), dres, dw.to(w.dtype), dlb.to(lb_dtype),
                None, None, None)


# ---------------------------------------------------------------------------
# public ops
# ---------------------------------------------------------------------------

def _check_bias(x: torch.Tensor, bias: torch.Tensor) -> None:
    if bias.dim() != 1 or bias.shape[0] != x.shape[-1]:
        raise ValueError(
            f"bias must be [{x.shape[-1]}], got {tuple(bias.shape)}")


def _check_residual(x: torch.Tensor, residual: torch.Tensor) -> None:
    if x.shape != residual.shape:
        raise ValueError(f"x {tuple(x.shape)} and residual "
                         f"{tuple(residual.shape)} must match")


def bias_gelu(x: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """Fused ``gelu(x + bias, approximate="tanh")`` over the trailing
    dim, in x's dtype; ``bias`` is 1-D ``[n]``. Call the projection
    bias-free and fuse its bias here."""
    _check_bias(x, bias)
    x2d, shape = _flat2d(x)
    return _BiasGelu.apply(x2d, bias).reshape(shape)


def bias_dropout_residual(x: torch.Tensor, bias: torch.Tensor,
                          residual: torch.Tensor, *, dropout_p: float = 0.0,
                          seed=None) -> torch.Tensor:
    """Fused ``residual + dropout(x + bias)`` in the residual's dtype.
    Dropout is the counter hash keyed on ``(seed, row, col)``: a fixed
    seed reproduces the mask in forward, backward, kernel and plain
    version; with ``dropout_p == 0`` it is a bias + residual sweep."""
    _check_bias(x, bias)
    _check_residual(x, residual)
    seed = _resolve_seed(dropout_p, seed)
    x2d, shape = _flat2d(x)
    r2d, _ = _flat2d(residual)
    return _BiasDropoutResidual.apply(x2d, bias, r2d, seed,
                                      float(dropout_p)).reshape(shape)


def residual_add_layer_norm(x: torch.Tensor, bias: torch.Tensor,
                            residual: torch.Tensor, ln_weight: torch.Tensor,
                            ln_bias: torch.Tensor, *, eps: float = 1e-5,
                            dropout_p: float = 0.0, seed=None
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused ``sum = residual + dropout(x + bias); y = LayerNorm(sum)``.

    Returns ``(sum, y)``, both in the residual's dtype: ``sum`` is the
    onward residual stream, ``y`` the next sublayer's pre-LN input. The
    LayerNorm statistics are fp32 per row over the rounded sum, as the
    unfused ``astype(dt) -> layer_norm(f32)`` chain computes them."""
    _check_bias(x, bias)
    _check_residual(x, residual)
    seed = _resolve_seed(dropout_p, seed)
    x2d, shape = _flat2d(x)
    r2d, _ = _flat2d(residual)
    s, y = _ResidualAddLayerNorm.apply(
        x2d, bias, r2d, ln_weight.reshape(-1), ln_bias.reshape(-1), seed,
        float(eps), float(dropout_p))
    return s.reshape(shape), y.reshape(shape)
