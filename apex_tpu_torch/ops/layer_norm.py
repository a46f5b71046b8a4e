"""LayerNorm forward and backward: CUDA kernels for Hopper and their plain
PyTorch versions (counterpart of ``apex_tpu/ops/layer_norm.py``).

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
``memory_efficient`` (re-deriving x from y) and RMSNorm are not ported
yet (ROADMAP.md, queue A2/B) and raise.
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
                             w: torch.Tensor
                             ) -> Tuple[torch.Tensor, torch.Tensor,
                                        torch.Tensor]:
    """Plain version of the backward: ``(dx, dgamma, dbeta)``, dx in
    dy's dtype and the parameter gradients fp32 ``[hidden]`` — the math
    of ``_ln_bwd_xla`` / ``_ln_bwd_kernel``."""
    dy = dy2d.float()
    xhat = (x2d.float() - mu) * rstd
    wdy = dy * w.float()
    c1 = (xhat * wdy).mean(dim=1, keepdim=True)
    c2 = wdy.mean(dim=1, keepdim=True)
    dx = ((wdy - xhat * c1 - c2) * rstd).to(dy2d.dtype)
    return dx, (dy * xhat).sum(dim=0), dy.sum(dim=0)


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


def _launch_bwd(dy2d: torch.Tensor, x2d: torch.Tensor, mu: torch.Tensor,
                rstd: torch.Tensor, w: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Launch the backward kernels on CUDA tensors: dy and x ``[rows,
    hidden]`` fp32 or bf16, mu/rstd fp32 ``[rows, 1]``, w fp32."""
    rows, hidden = x2d.shape
    _check_kernel_args(x2d, (("weight", w),))
    if dy2d.dtype not in (torch.float32, torch.bfloat16) or \
            dy2d.shape != x2d.shape or not dy2d.is_contiguous():
        raise ValueError(
            f"dy must be a contiguous f32/bf16 {tuple(x2d.shape)} tensor, "
            f"got {dy2d.dtype} {tuple(dy2d.shape)}")
    if 2 * hidden * 4 > 227 * 1024:
        raise ValueError(f"layer_norm backward kernel takes hidden <= "
                         f"{227 * 1024 // 8}, got {hidden}")
    for name, t in (("mu", mu), ("rstd", rstd)):
        if t.dtype != torch.float32 or t.numel() != rows \
                or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous fp32 [{rows}, 1]")
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
        int(x2d.dtype == torch.bfloat16), dev.index,
        _build.current_stream(dev))
    _build.check(rc, "layer_norm_bwd")
    _device.LAUNCHES["layer_norm_bwd"] += 1
    return dx, grads[0], grads[1]


def layer_norm_fwd(x: torch.Tensor, weight: torch.Tensor,
                   bias: torch.Tensor, eps: float = 1e-5):
    """``(y, mu [rows, 1], rstd [rows, 1])`` over the last dim, rows
    being every leading index of ``x``."""
    x2d = x.reshape(-1, x.shape[-1])
    if _device.kernel_route(x2d, weight, bias):
        y, mu, rstd = _launch(x2d.contiguous(), weight.float().contiguous(),
                              bias.float().contiguous(), eps)
    else:
        y, mu, rstd = layer_norm_reference(x2d, weight, bias, eps)
    return y.reshape(x.shape), mu, rstd


def layer_norm_bwd(dy: torch.Tensor, x: torch.Tensor, mu: torch.Tensor,
                   rstd: torch.Tensor, weight: torch.Tensor):
    """``(dx, dgamma, dbeta)`` for the LayerNorm over the last dim whose
    forward saved ``(x, mu, rstd)``; dx has ``x``'s shape and ``dy``'s
    dtype, the parameter gradients are fp32 ``[hidden]``."""
    hidden = x.shape[-1]
    x2d = x.reshape(-1, hidden)
    dy2d = dy.reshape(-1, hidden)
    if _device.kernel_route(dy2d, x2d, mu, rstd, weight):
        dx, dw, db = _launch_bwd(dy2d.contiguous(), x2d.contiguous(),
                                 mu.contiguous(), rstd.contiguous(),
                                 weight.float().contiguous())
    else:
        dx, dw, db = layer_norm_bwd_reference(dy2d, x2d, mu, rstd, weight)
    return dx.reshape(x.shape), dw, db


class _LayerNorm(torch.autograd.Function):
    """The JAX package's ``layer_norm`` custom VJP: the forward saves
    ``(x, mu, rstd)``, the backward is the backward kernel (or its plain
    version on the CPU)."""

    @staticmethod
    def forward(ctx, x, weight, bias, eps):
        y, mu, rstd = layer_norm_fwd(x, weight, bias, eps)
        ctx.save_for_backward(x, weight, mu, rstd)
        ctx.bias_dtype = bias.dtype
        return y

    @staticmethod
    def backward(ctx, dy):
        x, weight, mu, rstd = ctx.saved_tensors
        dx, dw, db = layer_norm_bwd(dy, x, mu, rstd, weight)
        return dx, dw.to(weight.dtype), db.to(ctx.bias_dtype), None


def layer_norm(x: torch.Tensor, weight: Optional[torch.Tensor],
               bias: Optional[torch.Tensor], eps: float = 1e-5, *,
               normalized_ndim: int = 1,
               memory_efficient: bool = False) -> torch.Tensor:
    """Fused LayerNorm over the trailing ``normalized_ndim`` dims (the
    JAX package's ``layer_norm``), differentiable in ``x``, ``weight``
    and ``bias``. ``weight``/``bias`` ``None`` is the non-affine norm."""
    if memory_efficient:
        raise NotImplementedError(
            "layer_norm(memory_efficient=True) is not ported yet "
            "(ROADMAP.md, queue A2: LayerNorm memory_efficient)")
    lead = x.shape[:x.ndim - normalized_ndim]
    norm_shape = x.shape[x.ndim - normalized_ndim:]
    hidden = 1
    for d in norm_shape:
        hidden *= d
    x2 = x.reshape(*lead, hidden)
    if weight is None:
        y = _LayerNorm.apply(
            x2, torch.ones(hidden, dtype=torch.float32, device=x.device),
            torch.zeros(hidden, dtype=torch.float32, device=x.device), eps)
        return y.reshape(x.shape)
    if bias is None:
        bias = torch.zeros_like(weight)
    y = _LayerNorm.apply(x2, weight.reshape(hidden), bias.reshape(hidden),
                         eps)
    return y.reshape(x.shape)
