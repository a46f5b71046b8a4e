"""OpenFold fused attention (counterpart of
``apex_tpu/contrib/openfold/mha.py``): pair-biased multi-head attention,
the reference's ``AttnTri`` / ``FusedAttenionCoreFunc`` surface, over the
flash kernels' additive bias.

Operands are ``[b, h, n, d]`` or ``[1, b, h, n, d]``; ``mask`` is {0, 1}
(1 = attend) and ``bias`` an additive logit bias, both broadcastable to
``[b, h, q, k]``. A key-only mask (``[b, 1, 1, k]``) rides the kernels'
key-padding mask, which excludes masked keys exactly; any other mask
folds into the bias as ``(mask - 1) * inf``, as the reference does. Only
a bias the caller passes carries a gradient (the dq kernel writes it; the
reference returns no dmask); a folded mask alone runs with
``bias_grad=False``.
"""
from __future__ import annotations

import os
import warnings
from typing import Optional

import torch

from ...ops.flash_attention import flash_attention, flash_attention_available

_enabled: Optional[bool] = None


def is_enabled() -> Optional[bool]:
    """The reference's module toggle."""
    return _enabled


def enable() -> None:
    global _enabled
    _enabled = True


def disable() -> None:
    global _enabled
    _enabled = False


def can_use_fused_attention(in_shape, has_bias: bool = True,
                            training: bool = True, device=None) -> bool:
    """The ``CanSchTriMHA`` gate: whether the flash kernels take this head
    dim on ``device`` (the CPU's plain version takes every shape)."""
    del has_bias, training  # the kernels take both uniformly
    n, d = in_shape[-2], in_shape[-1]
    return flash_attention_available(n, n, d, device)


def _drop5(x: torch.Tensor, what: str) -> torch.Tensor:
    """A 5-dim mask or bias without its leading 1 dim (checked)."""
    if x.dim() == 5:
        if x.shape[0] != 1:
            raise ValueError(f"5-dim {what} must have a leading 1 dim, got "
                             f"{tuple(x.shape)}")
        return x[0]
    return x


_warned_fully_masked = False


def _maybe_warn_fully_masked(key_mask: torch.Tensor) -> None:
    """One warning for the key-only mask's edge: the kernels' key-padding
    mask gives a row whose keys are all masked zeros, where the
    reference's ``(mask - 1) * inf`` bias gives a uniform average over the
    values. A mask on the CPU is checked (a host read, every call until
    one warns); a mask on the card is not read, which would synchronise
    the step, and warns only with ``APEX_TPU_WARN_FULLY_MASKED=1``, as the
    JAX package treats a traced mask."""
    global _warned_fully_masked
    if _warned_fully_masked:
        return
    if key_mask.device.type == "cpu":
        possible = bool((~(key_mask != 0).any(dim=-1)).any())
    else:
        possible = os.environ.get("APEX_TPU_WARN_FULLY_MASKED", "0") == "1"
    if possible:
        _warned_fully_masked = True
        warnings.warn(
            "openfold attention_core: key-only masks use the flash "
            "kernel's exact kv_mask path — a row whose keys are ALL "
            "masked returns zeros, where the reference's (mask-1)*inf "
            "bias returns a uniform average over values. If you rely on "
            "the uniform-average behavior for fully-padded rows, fold "
            "the mask into `bias` instead.", stacklevel=4)


def _to_bnsd(x: torch.Tensor):
    """``[*, h, n, d]`` with 4 or 5 dims -> ``([b, h, n, d], had_5dim)``."""
    if x.dim() == 5:
        if x.shape[0] != 1:
            raise ValueError(f"5-dim operands must have a leading 1 dim, "
                             f"got {tuple(x.shape)}")
        return x[0], True
    if x.dim() != 4:
        raise ValueError(f"expected 4- or 5-dim operand, got "
                         f"{tuple(x.shape)}")
    return x, False


def _to4(x: torch.Tensor, s_k: int) -> torch.Tensor:
    """A broadcastable mask or bias as 4 dims with the key dim at
    ``s_k`` (the kernels broadcast size-1 batch, head and query dims
    themselves)."""
    while x.dim() < 4:
        x = x[None]
    if x.shape[-1] != s_k:
        x = x.expand(*x.shape[:3], s_k)
    return x


def attention_core(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   mask: Optional[torch.Tensor] = None,
                   bias: Optional[torch.Tensor] = None, inf: float = 1e9,
                   is_training: bool = True) -> torch.Tensor:
    """``softmax(q k^T / sqrt(d) + (mask - 1) * inf + bias) v`` through
    the flash kernels, differentiable in q, k, v and ``bias``. A row whose
    keys a key-only mask masks wholly yields zeros (the kernels'
    convention; the reference's finite penalty yields the uniform average
    over the values)."""
    del is_training  # a dropout-free core, as in the reference kernel
    q, had5 = _to_bnsd(q)
    k, _ = _to_bnsd(k)
    v, _ = _to_bnsd(v)
    b, s_k = q.shape[0], k.shape[2]
    kv_mask = None
    add_bias = None
    if mask is not None:
        mask = _drop5(mask, "mask")
        if mask.dim() == 4 and mask.shape[1] == 1 and mask.shape[2] == 1:
            _maybe_warn_fully_masked(mask[:, 0, 0, :])
            kv_mask = mask[:, 0, 0, :].expand(b, s_k)
        else:
            # the reference returns no dmask: the folded mask stays out of
            # autograd
            add_bias = ((_to4(mask.float(), s_k) - 1.0) * inf).detach()
    if bias is not None:
        bias = _to4(_drop5(bias, "bias"), s_k)
        add_bias = bias if add_bias is None else add_bias + bias.float()
    o = flash_attention(q, k, v, bias=add_bias, kv_mask=kv_mask,
                        bias_grad=bias is not None)
    return o[None] if had5 else o


#: the reference's alias (``AttnTri = FusedAttenionCoreFunc.apply``)
AttnTri = attention_core


def attention_reference(q, k, v, mask=None, bias=None,
                        inf: float = 1e9) -> torch.Tensor:
    """The reference's eager math (``_attention_bias`` /
    ``_attention_no_bias``), for tests: ``softmax(q k^T / sqrt(d) +
    (mask - 1) * inf [+ bias]) v`` on materialised fp32 scores."""
    q, had5 = _to_bnsd(q)
    k, _ = _to_bnsd(k)
    v, _ = _to_bnsd(v)
    scale = 1.0 / (q.shape[-1] ** 0.5)
    a = torch.matmul((q * scale).float(), k.float().transpose(-1, -2))
    if mask is not None:
        a = a + (_drop5(mask, "mask").float() - 1.0) * inf
    if bias is not None:
        a = a + _drop5(bias, "bias").float()
    a = torch.softmax(a, dim=-1)
    o = torch.matmul(a.to(v.dtype).float(), v.float()).to(q.dtype)
    return o[None] if had5 else o
