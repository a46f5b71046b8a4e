"""Fused scale + mask + softmax of attention scores: CUDA kernels for
Hopper and their plain PyTorch versions (counterpart of
``apex_tpu/transformer/functional/fused_softmax.py``).

Three functions over scores ``x [..., sq, sk]``, each a
``torch.autograd.Function`` as the JAX custom VJPs are: the forward
saves the probabilities ``y`` and the backward is
``dx = scale * y * (dy - rowsum(dy * y))`` for every variant (a masked
probability is 0, so the mask drops out):

- :func:`scaled_upper_triang_masked_softmax`: causal, ``softmax(scale·x)``
  with column ``> q_i`` filled;
- :func:`scaled_masked_softmax`: ``mask`` broadcastable to ``x``,
  nonzero = masked out;
- :func:`scaled_softmax`: no mask.

A masked score is ``-10000`` after scaling (``_NEG_INF``), not ``-inf``,
as in the TPU kernels: it takes part in the row's max and sum, so a
masked probability is 0 only because ``exp(-10000 - max)`` underflows,
and a fully masked row is the uniform ``1 / sk``.

The kernels are ``csrc/fused_softmax.cu`` (#14-#16 of the TPU kernel
table in PERF.md): the forwards replace ``_fwd_pallas`` and
``_fwd_masked_pallas``, the backward ``_bwd_pallas``;
:func:`softmax_fwd_reference`, :func:`softmax_masked_fwd_reference` and
:func:`softmax_bwd_reference` are the plain versions. Route
(``_device.kernel_route``): CUDA tensors go through the kernels (fp32,
bf16 or fp16, ``0 < sk <= 16384``; anything else raises), CPU tensors
through the plain versions. The masked kernel reads the caller's mask
through its broadcast strides; the ``[b, np, sq, sk]`` mask the JAX
wrapper materialises never exists. The forwards are the custom ops
:data:`SOFTMAX_FWD` and :data:`SOFTMAX_MASKED_FWD`; no recompute policy
saves them (they emit the ``[b, np, sq, sk]`` probabilities that
selective recompute exists not to keep), so under ``"selective"`` the
backward replays them.

:class:`FusedScaleMaskSoftmax` is the JAX dispatcher with the same
``is_kernel_available`` decisions; its ``forward_softmax`` (fp32 input,
shapes the kernels do not take) is the JAX semantics of that dispatcher,
plain PyTorch on every device, not a fallback from a failed kernel.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from ... import _build, _device
from ..enums import AttnMaskType

_NEG_INF = -10000.0  # the TPU kernels' mask fill (scaled_masked_softmax.h)
#: the longest row the kernels take (the JAX dispatcher's limit)
MAX_SK = 16384
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}

#: the forwards as named ops (deliberately in no recompute policy's
#: saveable set: see the module docstring)
SOFTMAX_FWD = "apex_tpu_torch::softmax_fwd"
SOFTMAX_MASKED_FWD = "apex_tpu_torch::softmax_masked_fwd"


def _row_block(rows: int, sk: int) -> int:
    """Rows per block of the TPU kernels: the largest of 256, 128, ... 1
    that divides ``rows`` with one fp32 block under ~4 MB."""
    budget = max(1, (4 * 1024 * 1024) // max(sk * 4, 1))
    for br in (256, 128, 64, 32, 16, 8, 4, 2, 1):
        if br <= budget and rows % br == 0:
            return br
    return 1


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def _causal_fill(x: torch.Tensor) -> torch.Tensor:
    sq, sk = x.shape[-2], x.shape[-1]
    q = torch.arange(sq, device=x.device)[:, None]
    k = torch.arange(sk, device=x.device)[None, :]
    return torch.where(k > q, _NEG_INF, x)


def _softmax_plain(x: torch.Tensor, scale: float, causal: bool,
                   mask: Optional[torch.Tensor]) -> torch.Tensor:
    """``softmax(scale·x)`` in fp32 with the causal and/or mask fill,
    rounded to x's dtype (the JAX ``_fwd_xla``); differentiable."""
    xf = x.float() * scale
    if causal:
        xf = _causal_fill(xf)
    if mask is not None:
        xf = xf.masked_fill(mask != 0, _NEG_INF)
    return torch.softmax(xf, dim=-1).to(x.dtype)


def softmax_fwd_reference(x: torch.Tensor, scale: float = 1.0,
                          causal: bool = False) -> torch.Tensor:
    """Plain version of kernel #14 (``_softmax_fwd_kernel``)."""
    return _softmax_plain(x, scale, causal, None)


def softmax_masked_fwd_reference(x: torch.Tensor, mask: torch.Tensor,
                                 scale: float = 1.0) -> torch.Tensor:
    """Plain version of kernel #15 (``_softmax_masked_fwd_kernel``)."""
    return _softmax_plain(x, scale, False, mask)


def softmax_bwd_reference(dy: torch.Tensor, y: torch.Tensor,
                          scale: float = 1.0) -> torch.Tensor:
    """Plain version of kernel #16 (``_softmax_bwd_kernel``): fp32 math,
    dx in dy's dtype."""
    yf, dyf = y.float(), dy.float()
    s = (dyf * yf).sum(dim=-1, keepdim=True)
    return (scale * yf * (dyf - s)).to(dy.dtype)


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

def _check_rows(x: torch.Tensor, what: str) -> None:
    if x.dtype not in _DTYPE_CODE:
        raise TypeError(f"{what} kernel takes fp32/bf16/fp16, got {x.dtype}")
    if x.dim() < 2 or not 0 < x.shape[-1] <= MAX_SK:
        raise ValueError(
            f"{what} kernel takes [..., sq, sk] with 0 < sk <= {MAX_SK}, "
            f"got {tuple(x.shape)}")


def _vec(sk: int, *tensors: torch.Tensor) -> int:
    """1 when every row of every tensor starts 16-byte aligned (the
    kernels' vector loads), else 0."""
    return int(sk % 8 == 0 and all(t.data_ptr() % 16 == 0 for t in tensors))


def _launch_fwd(x: torch.Tensor, scale: float, causal: bool) -> torch.Tensor:
    _check_rows(x, "softmax_fwd")
    x = x.contiguous()
    sq, sk = x.shape[-2], x.shape[-1]
    y = torch.empty_like(x)
    dev = x.device
    rc = _build.kernels().apex_softmax_fwd(
        x.data_ptr(), y.data_ptr(), x.numel() // sk, sk, sq, float(scale),
        int(causal), _DTYPE_CODE[x.dtype], _vec(sk, x, y), dev.index,
        _build.current_stream(dev))
    _build.check(rc, "softmax_fwd")
    _device.LAUNCHES["softmax_fwd"] += 1
    return y


def _kernel_mask(mask: torch.Tensor, shape: torch.Size) -> torch.Tensor:
    """The caller's mask as bytes (nonzero = masked), broadcast to
    ``shape`` [b, np, sq, sk] as a view: strides 0 on the broadcast
    dims, 1 along the keys. Only a mask whose key dim is itself
    broadcast is copied, and then only at its own size."""
    m = mask if mask.dtype in (torch.bool, torch.uint8, torch.int8) \
        else mask != 0
    m = m.contiguous().view(torch.uint8)
    if m.shape[-1] != shape[-1]:
        m = m.expand(*m.shape[:-1], shape[-1]).contiguous()
    return torch.broadcast_to(m, shape)


def _launch_masked_fwd(x: torch.Tensor, mask: torch.Tensor,
                       scale: float) -> torch.Tensor:
    _check_rows(x, "softmax_masked_fwd")
    if x.dim() != 4:
        raise ValueError(f"softmax_masked_fwd kernel takes x [b, np, sq, "
                         f"sk], got {tuple(x.shape)}")
    x = x.contiguous()
    b, heads, sq, sk = x.shape
    m = _kernel_mask(mask, x.shape)
    y = torch.empty_like(x)
    dev = x.device
    rc = _build.kernels().apex_softmax_masked_fwd(
        x.data_ptr(), m.data_ptr(), y.data_ptr(), x.numel() // sk, sk, sq,
        heads, m.stride(0), m.stride(1), m.stride(2), float(scale),
        _DTYPE_CODE[x.dtype], _vec(sk, x, y), dev.index,
        _build.current_stream(dev))
    _build.check(rc, "softmax_masked_fwd")
    _device.LAUNCHES["softmax_masked_fwd"] += 1
    return y


def _launch_bwd(dy: torch.Tensor, y: torch.Tensor,
                scale: float) -> torch.Tensor:
    _check_rows(y, "softmax_bwd")
    if dy.dtype != y.dtype or dy.shape != y.shape:
        raise ValueError(
            f"softmax_bwd kernel takes dy of y's dtype and shape, got "
            f"{dy.dtype} {tuple(dy.shape)} and {y.dtype} {tuple(y.shape)}")
    dy, y = dy.contiguous(), y.contiguous()
    sk = y.shape[-1]
    dx = torch.empty_like(y)
    dev = y.device
    rc = _build.kernels().apex_softmax_bwd(
        dy.data_ptr(), y.data_ptr(), dx.data_ptr(), y.numel() // sk, sk,
        float(scale), _DTYPE_CODE[y.dtype], _vec(sk, dy, y, dx), dev.index,
        _build.current_stream(dev))
    _build.check(rc, "softmax_bwd")
    _device.LAUNCHES["softmax_bwd"] += 1
    return dx


def _fwd_impl(x: torch.Tensor, scale: float, causal: bool) -> torch.Tensor:
    if _device.kernel_route(x):
        return _launch_fwd(x, scale, causal)
    return softmax_fwd_reference(x, scale, causal)


def _masked_fwd_impl(x: torch.Tensor, mask: torch.Tensor,
                     scale: float) -> torch.Tensor:
    if _device.kernel_route(x, mask):
        return _launch_masked_fwd(x, mask, scale)
    return softmax_masked_fwd_reference(x, mask, scale)


_fwd_op = torch.library.custom_op(
    SOFTMAX_FWD, _fwd_impl, mutates_args=(),
    schema="(Tensor x, float scale, bool causal) -> Tensor")
_masked_fwd_op = torch.library.custom_op(
    SOFTMAX_MASKED_FWD, _masked_fwd_impl, mutates_args=(),
    schema="(Tensor x, Tensor mask, float scale) -> Tensor")


def softmax_fwd(x: torch.Tensor, scale: float = 1.0,
                causal: bool = False) -> torch.Tensor:
    """Kernel #14 on a CUDA tensor, its plain version on a CPU tensor:
    ``softmax(scale·x)`` over the last dim, causal or not."""
    return _fwd_op(x, float(scale), bool(causal))


def softmax_masked_fwd(x: torch.Tensor, mask: torch.Tensor,
                       scale: float = 1.0) -> torch.Tensor:
    """Kernel #15 on CUDA tensors, its plain version on CPU tensors:
    ``softmax(scale·x)`` with ``mask != 0`` filled."""
    return _masked_fwd_op(x, mask, float(scale))


def softmax_bwd(dy: torch.Tensor, y: torch.Tensor,
                scale: float = 1.0) -> torch.Tensor:
    """Kernel #16 on CUDA tensors, its plain version on CPU tensors."""
    if _device.kernel_route(dy, y):
        return _launch_bwd(dy, y, scale)
    return softmax_bwd_reference(dy, y, scale)


# ---------------------------------------------------------------------------
# the three differentiable functions
# ---------------------------------------------------------------------------

class _Softmax(torch.autograd.Function):
    """``scaled_upper_triang_masked_softmax`` / ``scaled_softmax``: the
    forward saves y, the backward is kernel #16."""

    @staticmethod
    def forward(ctx, x, scale, causal):
        y = softmax_fwd(x, scale, causal)
        ctx.save_for_backward(y)
        ctx.scale = scale
        return y

    @staticmethod
    def backward(ctx, dy):
        (y,) = ctx.saved_tensors
        return softmax_bwd(dy, y, ctx.scale), None, None


class _MaskedSoftmax(torch.autograd.Function):
    """``scaled_masked_softmax``: the forward saves y, the backward is
    kernel #16; the mask gets no gradient."""

    @staticmethod
    def forward(ctx, x, mask, scale):
        y = softmax_masked_fwd(x, mask, scale)
        ctx.save_for_backward(y)
        ctx.scale = scale
        return y

    @staticmethod
    def backward(ctx, dy):
        (y,) = ctx.saved_tensors
        return softmax_bwd(dy, y, ctx.scale), None, None


def scaled_upper_triang_masked_softmax(x: torch.Tensor,
                                       scale: float = 1.0) -> torch.Tensor:
    """``softmax(scale·x)`` with the causal mask; x is ``[..., sq, sk]``
    (``sq == sk`` in the dispatcher)."""
    return _Softmax.apply(x, float(scale), True)


def scaled_masked_softmax(x: torch.Tensor, mask: torch.Tensor,
                          scale: float = 1.0) -> torch.Tensor:
    """``softmax(scale·x + mask)``: x ``[b, np, sq, sk]``, mask
    broadcastable to it (``[b, 1, sq, sk]`` or ``[b, 1, 1, sk]``),
    nonzero = masked out."""
    return _MaskedSoftmax.apply(x, mask, float(scale))


def scaled_softmax(x: torch.Tensor, scale: float = 1.0) -> torch.Tensor:
    """``softmax(scale·x)``, no mask."""
    return _Softmax.apply(x, float(scale), False)


def generic_scaled_masked_softmax(x: torch.Tensor,
                                  mask: Optional[torch.Tensor],
                                  scale: float = 1.0) -> torch.Tensor:
    """Any shape (the reference's generic kernel): plain PyTorch,
    differentiable by autograd."""
    return _softmax_plain(x, scale, False, mask)


# ---------------------------------------------------------------------------
# dispatcher
# ---------------------------------------------------------------------------

class FusedScaleMaskSoftmax:
    """Fused scale + mask + softmax dispatcher over ``[b, np, sq, sk]``
    scores, with the JAX module's decisions: the causal kernel, the
    masked kernel or the unmasked kernel for fp16/bf16 input at
    ``16 < sk <= 16384``, ``sk % 128 == 0`` (causal needs ``sq == sk``);
    otherwise :meth:`forward_softmax`. That route, which fp32 input
    always takes, is the JAX dispatcher's own semantics (the reference's
    ``forward_torch_softmax``): plain PyTorch on every device, not a
    fallback from a kernel. ``mask_func`` is used only there;
    ``softmax_in_fp32`` upcasts before it; ``scaled_masked_softmax_fusion``
    gates the kernels."""

    def __init__(self, input_in_fp16: bool = False,
                 input_in_bf16: bool = True,
                 attn_mask_type: AttnMaskType = AttnMaskType.padding,
                 scaled_masked_softmax_fusion: bool = True,
                 mask_func: Optional[Callable] = None,
                 softmax_in_fp32: bool = True,
                 scale: Optional[float] = None):
        if input_in_fp16 and input_in_bf16:
            raise RuntimeError("both fp16 and bf16 flags cannot be active")
        self.input_in_fp16 = input_in_fp16
        self.input_in_bf16 = input_in_bf16
        self.input_in_float16 = input_in_fp16 or input_in_bf16
        self.attn_mask_type = attn_mask_type
        self.scaled_masked_softmax_fusion = scaled_masked_softmax_fusion
        self.mask_func = mask_func
        self.softmax_in_fp32 = softmax_in_fp32
        self.scale = scale
        if self.scale is not None and not self.softmax_in_fp32:
            raise RuntimeError("softmax should be in fp32 when scaled")

    def is_kernel_available(self, mask, b, np_, sq, sk) -> bool:
        """The JAX heuristics (``fused_softmax.py:290-304``)."""
        if not (self.scaled_masked_softmax_fusion and self.input_in_float16
                and 16 < sk <= MAX_SK and sk % 128 == 0):
            return False
        return not (self.attn_mask_type == AttnMaskType.causal and sq != sk)

    def __call__(self, input: torch.Tensor,
                 mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        b, np_, sq, sk = input.shape
        scale = self.scale if self.scale is not None else 1.0
        if self.is_kernel_available(mask, b, np_, sq, sk):
            if self.attn_mask_type == AttnMaskType.causal:
                return scaled_upper_triang_masked_softmax(input, scale)
            if mask is not None:
                return scaled_masked_softmax(input, mask, scale)
            return scaled_softmax(input, scale)
        return self.forward_softmax(input, mask)

    def forward_softmax(self, input: torch.Tensor,
                        mask: Optional[torch.Tensor]) -> torch.Tensor:
        """The reference's ``forward_torch_softmax`` (JAX ``:318-336``)."""
        x = input
        if self.input_in_float16 and self.softmax_in_fp32:
            x = x.float()
        if self.scale is not None:
            x = x * self.scale
        if self.attn_mask_type == AttnMaskType.causal:
            x = _causal_fill(x)
        elif mask is not None:
            x = self.mask_func(x, mask) if self.mask_func \
                else x.masked_fill(mask != 0, _NEG_INF)
        probs = torch.softmax(x, dim=-1)
        if self.input_in_float16 and self.softmax_in_fp32:
            probs = probs.to(input.dtype)
        return probs

    @staticmethod
    def get_batch_per_block(sq: int, sk: int, b: int, np_: int) -> int:
        """The reference's occupancy helper; the JAX package returns the
        TPU kernels' rows per block, and so does this."""
        return _row_block(b * np_ * sq, sk)
