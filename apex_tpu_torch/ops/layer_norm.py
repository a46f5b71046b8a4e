"""LayerNorm and RMSNorm forward and backward: CUDA kernels for Hopper and
their plain PyTorch versions (counterpart of ``apex_tpu/ops/layer_norm.py``).

Inputs are viewed as ``[rows, hidden]``; statistics (mean, rstd) are
fp32 per row for any input dtype, the variance is the centred two-pass
form, ``y`` takes the input's dtype and ``dx`` the incoming gradient's.
The kernels are in ``csrc/layer_norm.cu``: the forward replaces the TPU
kernel ``_ln_fwd_pallas``, the backward ``_ln_bwd_pallas``;
:func:`layer_norm_reference` and :func:`layer_norm_bwd_reference` are
the plain versions.

:func:`layer_norm` is a ``torch.autograd.Function`` that saves ``(x, mu,
rstd)`` as the JAX custom VJP does. Route (``_device.kernel_route``): a
CUDA tensor goes through the kernels, a CPU tensor through the plain
versions. Under ``torch.no_grad`` (serving) only the forward kernel runs.
The forward is the custom op :data:`LAYER_NORM_FWD`, so a selective
recompute policy can keep its outputs instead of replaying it.

RMSNorm is the same in both respects: :func:`rms_norm` over the kernels
that replace ``_rms_fwd_pallas`` and ``_rms_bwd_pallas`` (same source),
with :func:`rms_norm_reference` and :func:`rms_norm_bwd_reference`, its
forward the custom op :data:`RMS_NORM_FWD`. With ``memory_efficient``
either norm saves its output instead of its input, and the backward
rebuilds x-hat from it in fp32 (``(y - b) / w``, ``w`` clamped away from
0 with its sign kept) and hands it to the backward kernel as x-hat
(``x_is_xhat``). The backward kernels take any width.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from .. import _build, _device


def layer_norm_reference(x2d: torch.Tensor, w: torch.Tensor,
                         b: torch.Tensor, eps: float
                         ) -> Tuple[torch.Tensor, torch.Tensor,
                                    torch.Tensor]:
    """Plain version: ``(y, mu [rows, 1], rstd [rows, 1])`` with fp32
    statistics — the math of ``_ln_fwd_xla`` / the TPU kernel."""
    x = x2d.float()
    mu = x.mean(dim=1, keepdim=True)
    xc = x - mu
    var = (xc * xc).mean(dim=1, keepdim=True)
    rstd = torch.rsqrt(var + eps)
    y = xc * rstd * w.float() + b.float()
    return y.to(x2d.dtype), mu, rstd


def layer_norm_bwd_reference(dy2d: torch.Tensor, x2d: torch.Tensor,
                             mu: torch.Tensor, rstd: torch.Tensor,
                             w: torch.Tensor, x_is_xhat: bool = False
                             ) -> Tuple[torch.Tensor, torch.Tensor,
                                        torch.Tensor]:
    """Plain version of the backward: ``(dx, dgamma, dbeta)``, dx in
    dy's dtype and the parameter gradients fp32 ``[hidden]`` — the math
    of ``_ln_bwd_xla`` / ``_ln_bwd_kernel``. With ``x_is_xhat``, ``x2d``
    is the normalized input itself (``mu`` is not read)."""
    dy = dy2d.float()
    xhat = x2d.float() if x_is_xhat else (x2d.float() - mu) * rstd
    wdy = dy * w.float()
    c1 = (xhat * wdy).mean(dim=1, keepdim=True)
    c2 = wdy.mean(dim=1, keepdim=True)
    dx = ((wdy - xhat * c1 - c2) * rstd).to(dy2d.dtype)
    return dx, (dy * xhat).sum(dim=0), dy.sum(dim=0)


def rms_norm_reference(x2d: torch.Tensor, w: torch.Tensor, eps: float
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the RMSNorm forward: ``(y, rstd [rows, 1])``, the
    statistic fp32 — the math of ``_rms_fwd_xla`` / the TPU kernel."""
    x = x2d.float()
    rstd = torch.rsqrt((x * x).mean(dim=1, keepdim=True) + eps)
    return (x * rstd * w.float()).to(x2d.dtype), rstd


def rms_norm_bwd_reference(dy2d: torch.Tensor, x2d: torch.Tensor,
                           rstd: torch.Tensor, w: torch.Tensor,
                           x_is_xhat: bool = False
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the RMSNorm backward: ``(dx, dgamma)``, dx in dy's
    dtype and dgamma fp32 ``[hidden]`` — the math of ``_rms_bwd_xla``."""
    dy = dy2d.float()
    xhat = x2d.float() if x_is_xhat else x2d.float() * rstd
    wdy = dy * w.float()
    c1 = (xhat * wdy).mean(dim=1, keepdim=True)
    dx = ((wdy - xhat * c1) * rstd).to(dy2d.dtype)
    return dx, (dy * xhat).sum(dim=0)


def _check_kernel_args(x2d, tensors) -> None:
    hidden = x2d.shape[1]
    if x2d.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"layer_norm kernel takes f32/bf16 x, got {x2d.dtype}")
    for name, t in tensors:
        if t.dtype != torch.float32 or tuple(t.shape) != (hidden,):
            raise ValueError(
                f"{name} must be fp32 [{hidden}], got {t.dtype} "
                f"{tuple(t.shape)}")
    for t in (x2d, *(t for _, t in tensors)):
        if not t.is_contiguous():
            raise ValueError("layer_norm kernel needs contiguous tensors")


def _launch(x2d: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
            eps: float) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Launch the forward kernel on CUDA tensors: x ``[rows, hidden]``
    fp32 or bf16, w/b fp32 ``[hidden]``, all contiguous."""
    rows, hidden = x2d.shape
    _check_kernel_args(x2d, (("weight", w), ("bias", b)))
    lib = _build.kernels()
    y = torch.empty_like(x2d)
    mu = torch.empty((rows, 1), dtype=torch.float32, device=x2d.device)
    rstd = torch.empty((rows, 1), dtype=torch.float32, device=x2d.device)
    dev = x2d.device
    rc = lib.apex_layer_norm_fwd(
        x2d.data_ptr(), w.data_ptr(), b.data_ptr(), y.data_ptr(),
        mu.data_ptr(), rstd.data_ptr(), rows, hidden, float(eps),
        int(x2d.dtype == torch.bfloat16), dev.index,
        _build.current_stream(dev))
    _build.check(rc, "layer_norm_fwd")
    _device.LAUNCHES["layer_norm_fwd"] += 1
    return y, mu, rstd


def _check_bwd_args(dy2d, x2d, stats) -> None:
    rows = x2d.shape[0]
    if dy2d.dtype not in (torch.float32, torch.bfloat16) or \
            dy2d.shape != x2d.shape or not dy2d.is_contiguous():
        raise ValueError(
            f"dy must be a contiguous f32/bf16 {tuple(x2d.shape)} tensor, "
            f"got {dy2d.dtype} {tuple(dy2d.shape)}")
    for name, t in stats:
        if t.dtype != torch.float32 or t.numel() != rows \
                or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous fp32 [{rows}, 1]")


def _launch_bwd(dy2d: torch.Tensor, x2d: torch.Tensor, mu: torch.Tensor,
                rstd: torch.Tensor, w: torch.Tensor, x_is_xhat: bool = False
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Launch the backward kernels on CUDA tensors: dy and x ``[rows,
    hidden]`` fp32 or bf16 (x the fp32 x-hat with ``x_is_xhat``), mu/rstd
    fp32 ``[rows, 1]``, w fp32; any hidden."""
    rows, hidden = x2d.shape
    _check_kernel_args(x2d, (("weight", w),))
    _check_bwd_args(dy2d, x2d, (("mu", mu), ("rstd", rstd)))
    lib = _build.kernels()
    dev = x2d.device
    n_part = lib.apex_layer_norm_bwd_blocks(rows)
    dx = torch.empty_like(dy2d)
    part = torch.empty((2, n_part, hidden), dtype=torch.float32, device=dev)
    grads = torch.empty((2, hidden), dtype=torch.float32, device=dev)
    rc = lib.apex_layer_norm_bwd(
        dy2d.data_ptr(), x2d.data_ptr(), mu.data_ptr(), rstd.data_ptr(),
        w.data_ptr(), dx.data_ptr(), part[0].data_ptr(),
        part[1].data_ptr(), grads[0].data_ptr(), grads[1].data_ptr(),
        rows, hidden, int(dy2d.dtype == torch.bfloat16),
        int(x2d.dtype == torch.bfloat16), int(x_is_xhat), dev.index,
        _build.current_stream(dev))
    _build.check(rc, "layer_norm_bwd")
    _device.LAUNCHES["layer_norm_bwd"] += 1
    return dx, grads[0], grads[1]


def _launch_rms(x2d: torch.Tensor, w: torch.Tensor, eps: float
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the RMSNorm forward kernel on CUDA tensors: x ``[rows,
    hidden]`` fp32 or bf16, w fp32 ``[hidden]``, both contiguous."""
    rows, hidden = x2d.shape
    _check_kernel_args(x2d, (("weight", w),))
    y = torch.empty_like(x2d)
    rstd = torch.empty((rows, 1), dtype=torch.float32, device=x2d.device)
    dev = x2d.device
    rc = _build.kernels().apex_rms_norm_fwd(
        x2d.data_ptr(), w.data_ptr(), y.data_ptr(), rstd.data_ptr(), rows,
        hidden, float(eps), int(x2d.dtype == torch.bfloat16), dev.index,
        _build.current_stream(dev))
    _build.check(rc, "rms_norm_fwd")
    _device.LAUNCHES["rms_norm_fwd"] += 1
    return y, rstd


def _launch_rms_bwd(dy2d: torch.Tensor, x2d: torch.Tensor,
                    rstd: torch.Tensor, w: torch.Tensor,
                    x_is_xhat: bool = False
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the RMSNorm backward kernels on CUDA tensors, as
    :func:`_launch_bwd` without mu and dbeta."""
    rows, hidden = x2d.shape
    _check_kernel_args(x2d, (("weight", w),))
    _check_bwd_args(dy2d, x2d, (("rstd", rstd),))
    lib = _build.kernels()
    dev = x2d.device
    dx = torch.empty_like(dy2d)
    part = torch.empty((lib.apex_layer_norm_bwd_blocks(rows), hidden),
                       dtype=torch.float32, device=dev)
    dw = torch.empty(hidden, dtype=torch.float32, device=dev)
    rc = lib.apex_rms_norm_bwd(
        dy2d.data_ptr(), x2d.data_ptr(), rstd.data_ptr(), w.data_ptr(),
        dx.data_ptr(), part.data_ptr(), dw.data_ptr(), rows, hidden,
        int(dy2d.dtype == torch.bfloat16), int(x2d.dtype == torch.bfloat16),
        int(x_is_xhat), dev.index, _build.current_stream(dev))
    _build.check(rc, "rms_norm_bwd")
    _device.LAUNCHES["rms_norm_bwd"] += 1
    return dx, dw


#: the forwards as named ops, which the selective recompute policies of
#: ``standalone_transformer_lm`` save (the JAX policy's
#: ``apex_tpu_layer_norm_fwd`` and ``apex_tpu_rms_norm_fwd``)
LAYER_NORM_FWD = "apex_tpu_torch::layer_norm_fwd"
RMS_NORM_FWD = "apex_tpu_torch::rms_norm_fwd"


def _fwd_impl(x2d: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
              eps: float):
    if _device.kernel_route(x2d, weight, bias):
        return _launch(x2d.contiguous(), weight.float().contiguous(),
                       bias.float().contiguous(), eps)
    return layer_norm_reference(x2d, weight, bias, eps)


def _rms_fwd_impl(x2d: torch.Tensor, weight: torch.Tensor, eps: float):
    if _device.kernel_route(x2d, weight):
        return _launch_rms(x2d.contiguous(), weight.float().contiguous(),
                           eps)
    return rms_norm_reference(x2d, weight, eps)


_fwd_op = torch.library.custom_op(
    LAYER_NORM_FWD, _fwd_impl, mutates_args=(),
    schema="(Tensor x, Tensor weight, Tensor bias, float eps) "
           "-> (Tensor, Tensor, Tensor)")
_rms_fwd_op = torch.library.custom_op(
    RMS_NORM_FWD, _rms_fwd_impl, mutates_args=(),
    schema="(Tensor x, Tensor weight, float eps) -> (Tensor, Tensor)")


def layer_norm_fwd(x: torch.Tensor, weight: torch.Tensor,
                   bias: torch.Tensor, eps: float = 1e-5):
    """``(y, mu [rows, 1], rstd [rows, 1])`` over the last dim, rows
    being every leading index of ``x``."""
    y, mu, rstd = _fwd_op(x.reshape(-1, x.shape[-1]), weight, bias, eps)
    return y.reshape(x.shape), mu, rstd


def layer_norm_bwd(dy: torch.Tensor, x: torch.Tensor, mu: torch.Tensor,
                   rstd: torch.Tensor, weight: torch.Tensor,
                   x_is_xhat: bool = False):
    """``(dx, dgamma, dbeta)`` for the LayerNorm over the last dim whose
    forward saved ``(x, mu, rstd)`` (or, with ``x_is_xhat``, whose
    normalized input ``x`` was rebuilt in fp32); dx has ``x``'s shape and
    ``dy``'s dtype, the parameter gradients are fp32 ``[hidden]``."""
    hidden = x.shape[-1]
    x2d = x.reshape(-1, hidden)
    dy2d = dy.reshape(-1, hidden)
    if _device.kernel_route(dy2d, x2d, mu, rstd, weight):
        dx, dw, db = _launch_bwd(dy2d.contiguous(), x2d.contiguous(),
                                 mu.contiguous(), rstd.contiguous(),
                                 weight.float().contiguous(), x_is_xhat)
    else:
        dx, dw, db = layer_norm_bwd_reference(dy2d, x2d, mu, rstd, weight,
                                              x_is_xhat)
    return dx.reshape(x.shape), dw, db


def rms_norm_fwd(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-5):
    """``(y, rstd [rows, 1])`` of the RMSNorm over the last dim."""
    y, rstd = _rms_fwd_op(x.reshape(-1, x.shape[-1]), weight, eps)
    return y.reshape(x.shape), rstd


def rms_norm_bwd(dy: torch.Tensor, x: torch.Tensor, rstd: torch.Tensor,
                 weight: torch.Tensor, x_is_xhat: bool = False):
    """``(dx, dgamma)`` for the RMSNorm over the last dim, as
    :func:`layer_norm_bwd` without mu and dbeta."""
    hidden = x.shape[-1]
    x2d = x.reshape(-1, hidden)
    dy2d = dy.reshape(-1, hidden)
    if _device.kernel_route(dy2d, x2d, rstd, weight):
        dx, dw = _launch_rms_bwd(dy2d.contiguous(), x2d.contiguous(),
                                 rstd.contiguous(),
                                 weight.float().contiguous(), x_is_xhat)
    else:
        dx, dw = rms_norm_bwd_reference(dy2d, x2d, rstd, weight, x_is_xhat)
    return dx.reshape(x.shape), dw


def _clamp_by_magnitude(w: torch.Tensor, floor: float) -> torch.Tensor:
    """|w| kept at least ``floor``, its sign kept (the reference's guard
    for the memory-efficient inverse of the affine)."""
    mag = torch.clamp_min(w.abs(), floor)
    return torch.where(w < 0, -mag, mag)


def _xhat_from_y(y: torch.Tensor, weight: torch.Tensor,
                 bias: Optional[torch.Tensor], eps: float) -> torch.Tensor:
    """x-hat rebuilt in fp32 from a norm's output: ``(y - b) / w`` with
    ``w`` clamped away from 0 (``bias`` None for RMSNorm). Never rounded
    back to y's dtype."""
    yf = y.float()
    if bias is not None:
        yf = yf - bias.float()
    return yf / _clamp_by_magnitude(weight.float(), eps)


class _LayerNorm(torch.autograd.Function):
    """The JAX package's ``layer_norm`` custom VJP: the forward saves
    ``(x, mu, rstd)``, or with ``memory_efficient`` ``(y, mu, rstd)``
    from which the backward rebuilds x-hat; the backward is the backward
    kernel (or its plain version on the CPU)."""

    @staticmethod
    def forward(ctx, x, weight, bias, eps, memory_efficient):
        y, mu, rstd = layer_norm_fwd(x, weight, bias, eps)
        # the bias only where the backward reads it (each saved tensor is
        # one more detach under a recompute policy)
        if memory_efficient:
            ctx.save_for_backward(y, weight, mu, rstd, bias)
        else:
            ctx.save_for_backward(x, weight, mu, rstd)
        ctx.eps, ctx.memory_efficient = eps, memory_efficient
        ctx.bias_dtype = bias.dtype
        return y

    @staticmethod
    def backward(ctx, dy):
        xy, weight, mu, rstd, *bias = ctx.saved_tensors
        if ctx.memory_efficient:
            x = _xhat_from_y(xy, weight, bias[0], ctx.eps)
        else:
            x = xy
        dx, dw, db = layer_norm_bwd(dy, x, mu, rstd, weight,
                                    x_is_xhat=ctx.memory_efficient)
        return dx, dw.to(weight.dtype), db.to(ctx.bias_dtype), None, None


class _RMSNorm(torch.autograd.Function):
    """The JAX package's ``rms_norm`` custom VJP: the forward is the custom
    op :data:`RMS_NORM_FWD` and saves ``(x, rstd)`` (``(y, rstd)`` with
    ``memory_efficient``); the backward is the backward kernel."""

    @staticmethod
    def forward(ctx, x, weight, eps, memory_efficient):
        y, rstd = rms_norm_fwd(x, weight, eps)
        ctx.save_for_backward(y if memory_efficient else x, weight, rstd)
        ctx.eps, ctx.memory_efficient = eps, memory_efficient
        return y

    @staticmethod
    def backward(ctx, dy):
        xy, weight, rstd = ctx.saved_tensors
        if ctx.memory_efficient:
            x = _xhat_from_y(xy, weight, None, ctx.eps)
        else:
            x = xy
        dx, dw = rms_norm_bwd(dy, x, rstd, weight,
                              x_is_xhat=ctx.memory_efficient)
        return dx, dw.to(weight.dtype), None, None


def _flat_hidden(x: torch.Tensor, normalized_ndim: int) -> int:
    hidden = 1
    for d in x.shape[x.ndim - normalized_ndim:]:
        hidden *= d
    return hidden


def _ones(hidden: int, x: torch.Tensor) -> torch.Tensor:
    return torch.ones(hidden, dtype=torch.float32, device=x.device)


def layer_norm(x: torch.Tensor, weight: Optional[torch.Tensor],
               bias: Optional[torch.Tensor], eps: float = 1e-5, *,
               normalized_ndim: int = 1,
               memory_efficient: bool = False) -> torch.Tensor:
    """Fused LayerNorm over the trailing ``normalized_ndim`` dims (the
    JAX package's ``layer_norm``), differentiable in ``x``, ``weight``
    and ``bias``. ``weight``/``bias`` ``None`` is the non-affine norm.
    ``memory_efficient`` keeps the output instead of the input for the
    backward."""
    hidden = _flat_hidden(x, normalized_ndim)
    x2 = x.reshape(*x.shape[:x.ndim - normalized_ndim], hidden)
    if weight is None:
        weight, bias = _ones(hidden, x), torch.zeros(
            hidden, dtype=torch.float32, device=x.device)
    elif bias is None:
        bias = torch.zeros_like(weight)
    y = _LayerNorm.apply(x2, weight.reshape(hidden), bias.reshape(hidden),
                         eps, memory_efficient)
    return y.reshape(x.shape)


def rms_norm(x: torch.Tensor, weight: Optional[torch.Tensor],
             eps: float = 1e-5, *, normalized_ndim: int = 1,
             memory_efficient: bool = False) -> torch.Tensor:
    """Fused RMSNorm over the trailing ``normalized_ndim`` dims (the JAX
    package's ``rms_norm``, arXiv:1910.07467), differentiable in ``x``
    and ``weight``; ``weight`` ``None`` is the non-affine norm."""
    hidden = _flat_hidden(x, normalized_ndim)
    x2 = x.reshape(*x.shape[:x.ndim - normalized_ndim], hidden)
    w = _ones(hidden, x) if weight is None else weight.reshape(hidden)
    return _RMSNorm.apply(x2, w, eps, memory_efficient).reshape(x.shape)
