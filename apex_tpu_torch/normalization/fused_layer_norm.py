"""FusedLayerNorm / FusedRMSNorm modules and functional API (counterpart
of ``apex_tpu/normalization/fused_layer_norm.py``).

All go through :func:`apex_tpu_torch.ops.layer_norm.layer_norm` and
:func:`~apex_tpu_torch.ops.layer_norm.rms_norm`, the autograd Functions
over the forward and backward kernels. Module parameters follow
``param_dtype``; the ``Mixed*`` variants (Megatron's fp32 parameters
under low-precision activations) pin it to fp32.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple, Union

import torch
from torch import nn

from .._device import resolve_device
from ..ops.layer_norm import layer_norm as _layer_norm_op
from ..ops.layer_norm import rms_norm as _rms_norm_op

Shape = Union[int, Sequence[int]]


def _norm_shape(normalized_shape: Shape) -> Tuple[int, ...]:
    if isinstance(normalized_shape, int):
        return (int(normalized_shape),)
    return tuple(int(d) for d in normalized_shape)


def _check_shape(x: torch.Tensor, ns: Tuple[int, ...]) -> None:
    if tuple(x.shape[x.ndim - len(ns):]) != ns:
        raise ValueError(
            f"normalized_shape {ns} does not match trailing input dims "
            f"{tuple(x.shape)}")


def fused_layer_norm_affine(x, weight, bias, normalized_shape, eps=1e-5,
                            memory_efficient=False):
    ns = _norm_shape(normalized_shape)
    _check_shape(x, ns)
    return _layer_norm_op(x, weight, bias, eps, normalized_ndim=len(ns),
                          memory_efficient=memory_efficient)


def fused_layer_norm(x, normalized_shape, eps=1e-5, memory_efficient=False):
    ns = _norm_shape(normalized_shape)
    _check_shape(x, ns)
    return _layer_norm_op(x, None, None, eps, normalized_ndim=len(ns),
                          memory_efficient=memory_efficient)


def fused_rms_norm_affine(x, weight, normalized_shape, eps=1e-5,
                          memory_efficient=False):
    ns = _norm_shape(normalized_shape)
    _check_shape(x, ns)
    return _rms_norm_op(x, weight, eps, normalized_ndim=len(ns),
                        memory_efficient=memory_efficient)


def fused_rms_norm(x, normalized_shape, eps=1e-5, memory_efficient=False):
    ns = _norm_shape(normalized_shape)
    _check_shape(x, ns)
    return _rms_norm_op(x, None, eps, normalized_ndim=len(ns),
                        memory_efficient=memory_efficient)


def mixed_dtype_fused_layer_norm_affine(x, weight, bias, normalized_shape,
                                        eps=1e-5, memory_efficient=False):
    return fused_layer_norm_affine(x, weight, bias, normalized_shape, eps,
                                   memory_efficient)


def mixed_dtype_fused_rms_norm_affine(x, weight, normalized_shape, eps=1e-5,
                                      memory_efficient=False):
    return fused_rms_norm_affine(x, weight, normalized_shape, eps,
                                 memory_efficient)


def manual_rms_norm(x, normalized_shape, weight, eps):
    """Plain RMSNorm with the reference's argument order ``(input,
    normalized_shape, weight, eps)``: the mean square in fp32, the
    product in x's dtype, then ``weight * y``, rounded to x's dtype."""
    ns = _norm_shape(normalized_shape)
    dims = tuple(range(x.ndim - len(ns), x.ndim))
    var = x.float().square().mean(dim=dims, keepdim=True)
    y = x * torch.rsqrt(var + eps)
    if weight is not None:
        y = weight * y
    return y.to(x.dtype)


class _FusedNorm(nn.Module):
    """The shared parameter set-up: ``weight`` ones (and ``bias`` zeros
    when ``with_bias``) in ``param_dtype`` on ``device`` (``None`` is the
    card, as for every entry point; the CPU only when named), or none
    without ``elementwise_affine``."""

    _with_bias = True

    def __init__(self, normalized_shape: Shape, eps: float = 1e-5,
                 elementwise_affine: bool = True,
                 memory_efficient: bool = False,
                 param_dtype: torch.dtype = torch.float32,
                 device: Optional[torch.device] = None):
        super().__init__()
        self.normalized_shape = _norm_shape(normalized_shape)
        self.eps = eps
        self.elementwise_affine = elementwise_affine
        self.memory_efficient = memory_efficient
        device = resolve_device(device)
        if elementwise_affine:
            self.weight = nn.Parameter(torch.ones(
                self.normalized_shape, dtype=param_dtype, device=device))
        else:
            self.register_parameter("weight", None)
        if elementwise_affine and self._with_bias:
            self.bias = nn.Parameter(torch.zeros(
                self.normalized_shape, dtype=param_dtype, device=device))
        elif self._with_bias:
            self.register_parameter("bias", None)


class FusedLayerNorm(_FusedNorm):
    """Drop-in LayerNorm module: weight ones, bias zeros, in
    ``param_dtype`` (fp32 by default), statistics fp32."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.elementwise_affine:
            return fused_layer_norm_affine(
                x, self.weight, self.bias, self.normalized_shape, self.eps,
                self.memory_efficient)
        return fused_layer_norm(x, self.normalized_shape, self.eps,
                                self.memory_efficient)


class FusedRMSNorm(_FusedNorm):
    """Drop-in RMSNorm module: weight ones in ``param_dtype``, the
    statistic fp32."""

    _with_bias = False

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.elementwise_affine:
            return fused_rms_norm_affine(
                x, self.weight, self.normalized_shape, self.eps,
                self.memory_efficient)
        return fused_rms_norm(x, self.normalized_shape, self.eps,
                              self.memory_efficient)


def _pin_fp32(cls_name: str, param_dtype: torch.dtype) -> None:
    if param_dtype != torch.float32:
        raise ValueError(f"{cls_name} pins param_dtype=float32")


class MixedFusedLayerNorm(FusedLayerNorm):
    """Megatron-compatible: fp32 parameters under low-precision
    activations. Another ``param_dtype`` raises: fp32 parameters are the
    contract of the mixed variant."""

    def __init__(self, normalized_shape: Shape, eps: float = 1e-5, **kw):
        _pin_fp32("MixedFusedLayerNorm", kw.get("param_dtype",
                                                torch.float32))
        super().__init__(normalized_shape, eps, **kw)


class MixedFusedRMSNorm(FusedRMSNorm):
    """:class:`FusedRMSNorm` with fp32 parameters pinned."""

    def __init__(self, normalized_shape: Shape, eps: float = 1e-5, **kw):
        _pin_fp32("MixedFusedRMSNorm", kw.get("param_dtype", torch.float32))
        super().__init__(normalized_shape, eps, **kw)
