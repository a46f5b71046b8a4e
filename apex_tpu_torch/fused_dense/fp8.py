"""fp8 (e4m3) GEMM with TransformerEngine-style delayed scaling
(counterpart of ``apex_tpu/fused_dense/fp8.py``).

Delayed scaling: each fp8 tensor carries an ``amax_history`` ring of the
last H observed ``max|x|`` values, most recent at index 0; the scale a
step quantizes with is derived from the history BEFORE that step's amax
is recorded, ``scale = fp8_max / (max(history) * 2**margin)``, so no
pre-pass over the data is needed. The states are named tuples of fp32
tensors: a layer's functions return the rolled state, and the stacked
form (``[L, ...]`` leaves, one row a layer) rolls the same way.

Two backward flavors, as in the JAX package: :func:`fp8_fused_dense`
keeps dgrad and wgrad in fp32 (the conservative recipe half), and
:func:`fp8_fused_dense_qgrad` quantizes dY to e5m2 with a delayed
gradient scale (the full recipe), surfacing ``max|dY|`` as the gradient
of a carrier argument (:func:`record_grad_amax` folds it in). Both
backwards are fp32 GEMMs of the dequantized dY against fp32 copies of x
and w, as ``_dgrad_wgrad`` has them; TF32 stays off (torch's default),
so they run at the card's fp32 rate.

The forward product is :func:`fp8_gemm`. The JAX package computes it
outside any Pallas kernel, as an einsum over fp8 operands with fp32
accumulation, so on the card it is one library call, as the bf16
products are ``F.linear``: ``torch._scaled_mm`` on the H100's fp8
tensor cores (cuBLASLt), e4m3 x e4m3 with fp32 accumulation
(``use_fast_accum=False``) and the dequantization folded into the call
(``scale_a = 1/scale_x``, ``scale_b = 1/scale_w``), written in the
output dtype. cuBLASLt takes dims that are multiples of 16; other
shapes are zero-padded (exact: the padding adds zero products) and cut
back. On CPU tensors :func:`fp8_gemm_reference` computes the JAX
expression, an fp32 product of the fp8 values divided by
``scale_x * scale_w``. The product is the ``torch.library`` custom op
:data:`FP8_GEMM`, as the port's forward kernels are: the selective
recompute policies of ``standalone_transformer_lm`` keep its output by
that name (JAX's ``dots_with_no_batch_dims_saveable`` keeps the fp8
einsum), and a replay served from their cache runs nothing. Each call
of the library GEMM adds one to ``_device.LAUNCHES["fp8_gemm"]``. The
amax, scale, clamp and cast passes are plain PyTorch, as they are XLA
ops in the JAX package.

With ``amax_reduction_axes`` (axis names of
``transformer.parallel_state``: ``"data"``, ``"tensor"``, ``"pipeline"``)
the observed amaxes are MAX-reduced over that group of ranks before the
scales are derived, where the JAX package ``pmax``es over mesh axes: one
``all_reduce`` a site (the forward's x and w amaxes go together in one
2-element reduction; a gradient amax in one of its own), so every rank
that holds a shard of a tensor derives the same scale.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from .. import _device
from .._device import resolve_device

FP8_E4M3_MAX = 448.0
FP8_E5M2_MAX = 57344.0

#: the fp8 GEMM's custom op (the selective recompute policies keep it)
FP8_GEMM = "apex_tpu_torch::fp8_gemm"

#: cuBLASLt's fp8 GEMM takes dims that are multiples of this
_FP8_ALIGN = 16


class Fp8TensorMeta(NamedTuple):
    """Per-tensor delayed-scaling state."""

    amax_history: torch.Tensor  # [H] fp32, most recent at index 0
    scale: torch.Tensor  # fp32 scalar: multiply BEFORE the fp8 cast


class Fp8DenseState(NamedTuple):
    """Delayed-scaling state of one fp8 dense layer: the x and w metas
    and, for :func:`fp8_fused_dense_qgrad`, the e5m2 gradient meta
    ``g``."""

    x: Fp8TensorMeta
    w: Fp8TensorMeta
    g: Optional[Fp8TensorMeta] = None


def _init_meta(history_len: int, device: torch.device) -> Fp8TensorMeta:
    return Fp8TensorMeta(
        amax_history=torch.zeros(history_len, dtype=torch.float32,
                                 device=device),
        scale=torch.ones((), dtype=torch.float32, device=device))


def init_fp8_dense_state(history_len: int = 16, with_grad_meta: bool = False,
                         device=None) -> Fp8DenseState:
    """Zero histories and unit scales on ``device`` (None: the card)."""
    device = resolve_device(device)
    return Fp8DenseState(
        x=_init_meta(history_len, device),
        w=_init_meta(history_len, device),
        g=_init_meta(history_len, device) if with_grad_meta else None)


def _quantize(x: torch.Tensor, scale: torch.Tensor, fp8_max: float,
              dtype: torch.dtype) -> torch.Tensor:
    """Scale in fp32, saturate to the format's range, cast: one
    implementation so the two formats cannot diverge."""
    xs = x.float() * scale
    return torch.clamp(xs, -fp8_max, fp8_max).to(dtype)


def quantize_e4m3(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """e4m3: the activation and weight format."""
    return _quantize(x, scale, FP8_E4M3_MAX, torch.float8_e4m3fn)


def quantize_e5m2(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """e5m2: the gradient format (the wide exponent takes dY's long
    dynamic-range tail)."""
    return _quantize(x, scale, FP8_E5M2_MAX, torch.float8_e5m2)


def _reduce_amax(amax: torch.Tensor, amax_reduction_axes) -> torch.Tensor:
    """The amax MAX-reduced over the group of ``amax_reduction_axes``
    (``parallel_state.reduce_amax``, in place on this tensor)."""
    from ..transformer import parallel_state

    return parallel_state.reduce_amax(amax, amax_reduction_axes)


def _updated_meta(meta: Fp8TensorMeta, amax_now: torch.Tensor, margin: float,
                  fp8_max: float = FP8_E4M3_MAX) -> Fp8TensorMeta:
    """Roll the history and derive the NEXT step's scale from it
    (``amax_now`` only moves future scales). Works on a stacked meta
    (``[L, H]`` histories, ``[L]`` amaxes and scales) row by row."""
    hist = torch.cat([amax_now.float()[..., None],
                      meta.amax_history[..., :-1]], dim=-1)
    amax = hist.amax(dim=-1)
    # a true division: ``python_float / tensor`` is a reciprocal and a
    # product in torch, one rounding away from JAX's quotient
    scale = torch.where(
        amax > 0.0,
        torch.full_like(amax, fp8_max) / (amax * (2.0 ** margin)),
        torch.ones_like(amax))
    return Fp8TensorMeta(amax_history=hist, scale=scale.float())


def _forward_metas(x: torch.Tensor, weight: torch.Tensor,
                   state: Fp8DenseState, margin: float,
                   amax_reduction_axes) -> Tuple[Fp8TensorMeta,
                                                 Fp8TensorMeta]:
    """Observe the x and w amaxes and return the rolled metas. The
    amaxes describe the data, not the graph: no gradient flows into
    them."""
    amax_x = x.detach().abs().amax().float()
    amax_w = weight.detach().abs().amax().float()
    if amax_reduction_axes is not None:
        amax_x, amax_w = _reduce_amax(torch.stack([amax_x, amax_w]),
                                      amax_reduction_axes).unbind()
    return (_updated_meta(state.x, amax_x, margin),
            _updated_meta(state.w, amax_w, margin))


def fp8_gemm_reference(qx: torch.Tensor, qw: torch.Tensor,
                       scale_x: torch.Tensor, scale_w: torch.Tensor,
                       out_dtype: torch.dtype) -> torch.Tensor:
    """``(qx @ qw^T) / (scale_x * scale_w)`` in ``out_dtype``: ``qx [M, K]``
    and ``qw [N, K]`` fp8, the product and the division in fp32 (the JAX
    package's einsum with ``preferred_element_type=float32``, then
    ``y / (scale_x * scale_w)``, then the cast)."""
    y = qx.float() @ qw.float().t()
    return (y / (scale_x * scale_w)).to(out_dtype)


def _pad_to(t: torch.Tensor, rows: int, cols: int) -> torch.Tensor:
    if t.shape == (rows, cols):
        return t
    return F.pad(t.view(torch.uint8), (0, cols - t.shape[1],
                                       0, rows - t.shape[0])).view(t.dtype)


def _round_up(n: int) -> int:
    return -(-n // _FP8_ALIGN) * _FP8_ALIGN


def _scaled_mm(qx: torch.Tensor, qw: torch.Tensor, scale_x: torch.Tensor,
               scale_w: torch.Tensor, out_dtype: torch.dtype) -> torch.Tensor:
    """The card route of :func:`fp8_gemm`: one cuBLASLt fp8 GEMM with the
    dequantization folded in. ``mat_a`` is ``qx`` row-major ``[M, K]``,
    ``mat_b`` the column-major ``[K, N]`` view ``qw.t()`` of the row-major
    ``[N, K]`` weight; dims that are not multiples of 16 are zero-padded
    and the result cut back."""
    m, k = qx.shape
    n = qw.shape[0]
    mp, kp, np_ = _round_up(m), _round_up(k), _round_up(n)
    a = _pad_to(qx.contiguous(), mp, kp)
    b = _pad_to(qw.contiguous(), np_, kp)
    _device.LAUNCHES["fp8_gemm"] += 1
    y = torch._scaled_mm(a, b.t(), scale_a=scale_x.reciprocal(),
                         scale_b=scale_w.reciprocal(), out_dtype=out_dtype,
                         use_fast_accum=False)
    if (mp, np_) != (m, n):
        y = y[:m, :n].contiguous()
    return y


def _fp8_gemm_impl(qx: torch.Tensor, qw: torch.Tensor,
                   scale_x: torch.Tensor, scale_w: torch.Tensor,
                   out_dtype: torch.dtype) -> torch.Tensor:
    if _device.kernel_route(qx, qw, scale_x, scale_w):
        return _scaled_mm(qx, qw, scale_x, scale_w, out_dtype)
    return fp8_gemm_reference(qx, qw, scale_x, scale_w, out_dtype)


_fp8_gemm_op = torch.library.custom_op(
    FP8_GEMM, _fp8_gemm_impl, mutates_args=(),
    schema="(Tensor qx, Tensor qw, Tensor scale_x, Tensor scale_w, "
           "ScalarType out_dtype) -> Tensor")


def fp8_gemm(qx: torch.Tensor, qw: torch.Tensor, scale_x: torch.Tensor,
             scale_w: torch.Tensor, out_dtype: torch.dtype) -> torch.Tensor:
    """The dequantized product of e4m3 ``qx [M, K]`` and ``qw [N, K]``
    (quantized with ``scale_x`` and ``scale_w``) -> ``[M, N]`` in
    ``out_dtype``: the library fp8 GEMM on CUDA tensors, the plain
    version on CPU tensors."""
    if qx.dim() != 2 or qw.dim() != 2 or qx.shape[1] != qw.shape[1]:
        raise ValueError(f"fp8_gemm takes qx [M, K] and qw [N, K], got "
                         f"{tuple(qx.shape)} and {tuple(qw.shape)}")
    return _fp8_gemm_op(qx, qw, scale_x, scale_w, out_dtype)


def _fp8_matmul_fwd(x: torch.Tensor, w: torch.Tensor, scale_x: torch.Tensor,
                    scale_w: torch.Tensor) -> torch.Tensor:
    """e4m3 quantization with the CURRENT scales, the fp8 GEMM, the
    dequantization, the cast to ``x.dtype``; ``x [..., in]``, ``w [out,
    in]``."""
    qx = quantize_e4m3(x, scale_x)
    qw = quantize_e4m3(w, scale_w)
    y = fp8_gemm(qx.reshape(-1, x.shape[-1]), qw, scale_x, scale_w, x.dtype)
    return y.reshape(*x.shape[:-1], w.shape[0])


def _dgrad_wgrad(x: torch.Tensor, w: torch.Tensor,
                 dyf: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """fp32 dgrad and wgrad shared by both backward flavors."""
    dx = (dyf @ w.float()).to(x.dtype)
    dw = (dyf.reshape(-1, dyf.shape[-1]).t()
          @ x.float().reshape(-1, x.shape[-1])).to(w.dtype)
    return dx, dw


class _Fp8Matmul(torch.autograd.Function):
    """Straight-through backward: dgrad and wgrad in fp32 of the
    unquantized dY."""

    @staticmethod
    def forward(ctx, x, w, scale_x, scale_w):
        ctx.save_for_backward(x, w)
        return _fp8_matmul_fwd(x, w, scale_x, scale_w)

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        dx, dw = _dgrad_wgrad(x, w, dy.float())
        return dx, dw, None, None


class _Fp8MatmulQgrad(torch.autograd.Function):
    """The full recipe's backward: dY quantized to e5m2 with the delayed
    gradient scale, dequantized, then the fp32 dgrad and wgrad; the
    observed ``max|dY|`` leaves as the gradient of the carrier (a shared
    carrier therefore sums the amaxes, as its cotangent does in JAX)."""

    @staticmethod
    def forward(ctx, x, w, scale_x, scale_w, scale_g, grad_amax_carrier):
        ctx.save_for_backward(x, w, scale_g)
        return _fp8_matmul_fwd(x, w, scale_x, scale_w)

    @staticmethod
    def backward(ctx, dy):
        x, w, scale_g = ctx.saved_tensors
        amax_g = dy.abs().amax().float()
        qdy = quantize_e5m2(dy, scale_g)
        dx, dw = _dgrad_wgrad(x, w, qdy.float() / scale_g)
        return dx, dw, None, None, None, amax_g


def fp8_fused_dense(x: torch.Tensor, weight: torch.Tensor,
                    bias: Optional[torch.Tensor], state: Fp8DenseState, *,
                    margin: float = 0.0, amax_reduction_axes=None):
    """e4m3 GEMM + bias with delayed scaling; returns ``(y, new_state)``.
    ``weight`` is ``[out, in]`` (torch Linear layout). Quantizes with
    the CURRENT state's scales, then records this step's amaxes in the
    returned state."""
    meta_x, meta_w = _forward_metas(x, weight, state, margin,
                                    amax_reduction_axes)
    y = _Fp8Matmul.apply(x, weight, state.x.scale, state.w.scale)
    if bias is not None:
        y = y + bias.to(y.dtype)
    return y, Fp8DenseState(x=meta_x, w=meta_w, g=state.g)


def fp8_fused_dense_qgrad(x: torch.Tensor, weight: torch.Tensor,
                          bias: Optional[torch.Tensor], state: Fp8DenseState,
                          grad_amax_carrier: torch.Tensor, *,
                          margin: float = 0.0, amax_reduction_axes=None):
    """The full recipe: e4m3 forward, e5m2-quantized gradients.

    As :func:`fp8_fused_dense`, and the backward quantizes dY to e5m2
    with ``state.g``'s delayed scale. The gradient amax is observed only
    in the backward, so it leaves as the gradient of
    ``grad_amax_carrier`` (a 0-d fp32 tensor that requires grad, one per
    layer): differentiate with respect to it and fold it in with
    :func:`record_grad_amax`. ``new_state`` carries the rolled x and w
    metas; ``g`` is rolled by :func:`record_grad_amax`."""
    if state.g is None:
        raise ValueError(
            "fp8_fused_dense_qgrad needs a gradient meta: "
            "init_fp8_dense_state(with_grad_meta=True)")
    meta_x, meta_w = _forward_metas(x, weight, state, margin,
                                    amax_reduction_axes)
    y = _Fp8MatmulQgrad.apply(x, weight, state.x.scale, state.w.scale,
                              state.g.scale, grad_amax_carrier)
    if bias is not None:
        y = y + bias.to(y.dtype)
    return y, Fp8DenseState(x=meta_x, w=meta_w, g=state.g)


def record_grad_amax(state: Fp8DenseState, amax, *, margin: float = 0.0,
                     amax_reduction_axes=None,
                     fp8_max: float = FP8_E5M2_MAX) -> Fp8DenseState:
    """Fold a backward-observed gradient amax (the carrier's gradient)
    into the delayed-scaling g meta (a stacked state takes ``[L]``
    amaxes)."""
    if state.g is None:
        raise ValueError("state has no gradient meta")
    amax = torch.as_tensor(amax, dtype=torch.float32,
                           device=state.g.scale.device)
    if amax_reduction_axes is not None:
        amax = _reduce_amax(amax.clone(), amax_reduction_axes)
    return state._replace(
        g=_updated_meta(state.g, amax, margin, fp8_max=fp8_max))
