"""Flash attention: tiled online-softmax CUDA kernels for Hopper, forward
and backward, beside their plain PyTorch versions (counterpart of
``apex_tpu/ops/flash_attention.py``).

Layout ``[b, n, s, d]`` (:func:`flash_attention`) and the Megatron
``[s, b, n, d]`` wrapper (:func:`flash_attention_sbhd`). The kernels are
``csrc/flash_attention.cu``: the forward replaces the TPU kernel of
``_fwd`` and returns ``o`` in q's dtype and ``lse [b, n, s_q]`` fp32; the
backward replaces ``_bwd``'s dq and dk/dv kernels and recomputes the
scores from ``lse``. :func:`flash_attention_fwd_reference` and
:func:`flash_attention_bwd_reference` are the plain versions: the same
arithmetic on the materialised ``[b, n, s_q, s_k]`` scores (the softmax
scale folded into q, which is rounded back to its dtype before the dot,
as ``_scaled_q`` does; p rounded to the operand dtype before each
product). :func:`mha_reference` is the JAX package's materialised
reference, kept as written there.

Supports causal masking, a key-padding mask ``kv_mask [b, s_k]`` (nonzero
= attend) and in-kernel hash dropout (``dropout_p``, ``dropout_seed``).
A fully masked row outputs zeros with ``lse = -1e30`` (the kernels'
-inf) and gets zero gradients. The additive ``bias`` and packed varlen
segments are not ported yet (ROADMAP.md, queue A2) and raise on every
device.

The dropout keep bit is a counter-based hash (``_i32``, ``_shr_logical``,
``_hash_keep_bits`` of the JAX module, bit-exact). The JAX code computes
in int32 with wrapping multiplies. PyTorch gives no promise about int32
overflow, so the plain versions compute in int64 masked to the low 32
bits, reinterpreted as int32 only at the end. A 32 x 32-bit product would
overflow int64, so :func:`_mul32` splits the constant into 16-bit halves
(each partial product stays below 2^48). Carried sampling keys its draws
with the same hash.

Route (``_device.kernel_route``): CUDA tensors go through the kernels,
CPU tensors through the plain versions.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from .. import _build, _device

_M32 = 0xFFFFFFFF
_NEG_INF = -1e30


def _i32(v: int) -> int:
    """An unsigned 32-bit pattern as its two's-complement int32 value."""
    v = int(v) & _M32
    return v - 0x100000000 if v >= 0x80000000 else v


def _u32(x: torch.Tensor) -> torch.Tensor:
    """int tensor -> int64 holding its low 32 bits as unsigned."""
    return x.to(torch.int64) & _M32


def _mul32(a: torch.Tensor, c: int) -> torch.Tensor:
    """``(a * c) mod 2^32`` for ``a`` in [0, 2^32) (int64) and a
    constant ``c`` in [0, 2^32)."""
    lo, hi = c & 0xFFFF, (c >> 16) & 0xFFFF
    return (a * lo + (((a * hi) & 0xFFFF) << 16)) & _M32


def _to_i32(x: torch.Tensor) -> torch.Tensor:
    """int64 in [0, 2^32) -> the int32 with the same bits."""
    return torch.where(x >= 0x80000000, x - 0x100000000, x).to(torch.int32)


def _shr_logical(x: torch.Tensor, n: int) -> torch.Tensor:
    """Logical (zero-filling) right shift of int32 bit patterns."""
    return _to_i32(_u32(x) >> int(n))


def _hash_keep_bits(seed, bh, qi, ki) -> torch.Tensor:
    """32-bit murmur3-finalised hash per element of the broadcast of
    ``(seed, bh, qi, ki)`` (int tensors), as int32 — bit-identical to
    the JAX package's ``_hash_keep_bits``."""
    x = _mul32(_u32(qi), 0x9E3779B1)
    x = x ^ _mul32(_u32(ki), 0x85EBCA77)
    x = x ^ ((_u32(seed) + _mul32(_u32(bh), 0x27D4EB2F)) & _M32)
    # murmur3 fmix32
    x = x ^ (x >> 16)
    x = _mul32(x, 0x85EBCA6B)
    x = x ^ (x >> 13)
    x = _mul32(x, 0xC2B2AE35)
    x = x ^ (x >> 16)
    return _to_i32(x)


# ---------------------------------------------------------------------------
# dropout keep mask (plain versions; the kernels compute the same bits)
# ---------------------------------------------------------------------------

def _threshold(dropout_p: float) -> int:
    """The keep threshold: a bit pattern at or above it keeps, so
    P(drop) = dropout_p."""
    return int(round(dropout_p * 4294967296.0)) & _M32


def dropout_mask_reference(seed: int, b: int, n: int, s_q: int, s_k: int,
                           dropout_p: float, device="cpu") -> torch.Tensor:
    """The exact keep mask the kernels use, materialised: float32 {0, 1}
    ``[b, n, s_q, s_k]``, the unsigned compare of the hash bits against
    the threshold (``_keep_mask`` of the JAX module)."""
    bh = torch.arange(b * n, dtype=torch.int64,
                      device=device).reshape(b, n, 1, 1)
    qi = torch.arange(s_q, dtype=torch.int64, device=device)[:, None]
    ki = torch.arange(s_k, dtype=torch.int64, device=device)[None, :]
    seed_t = torch.tensor(_i32(seed), dtype=torch.int64, device=device)
    bits = _u32(_hash_keep_bits(seed_t, bh, qi, ki))
    return (bits >= _threshold(dropout_p)).to(torch.float32)


def _resolve_seed(dropout_p: float, dropout_seed) -> Optional[int]:
    """None without dropout, else the seed as an int32 value (a tensor
    seed is read to the host once)."""
    if not 0.0 <= dropout_p < 1.0:
        # out-of-range p would wrap the 32-bit keep threshold silently
        raise ValueError(f"dropout_p must be in [0, 1), got {dropout_p}")
    if dropout_p == 0.0:
        return None
    if dropout_seed is None:
        raise ValueError(
            "dropout_p > 0 requires dropout_seed (an int or an int "
            "tensor; derive a fresh one per step)")
    return _i32(int(dropout_seed))


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def _scaled_q(q: torch.Tensor, scale: float) -> torch.Tensor:
    """The softmax scale folded into q in fp32, rounded back to q's
    dtype before the dot (``_scaled_q`` of the JAX module)."""
    return (q.float() * scale).to(q.dtype)


def _masked(s: torch.Tensor, kv_mask, causal: bool) -> torch.Tensor:
    if causal:
        s_q, s_k = s.shape[-2:]
        qi = torch.arange(s_q, device=s.device)[:, None]
        ki = torch.arange(s_k, device=s.device)[None, :]
        s = s.masked_fill(ki > qi, _NEG_INF)
    if kv_mask is not None:
        s = s.masked_fill(kv_mask[:, None, None, :] == 0, _NEG_INF)
    return s


def _kernel_scores(q, k, kv_mask, causal, scale):
    qs = _scaled_q(q, scale)
    s = torch.matmul(qs.float(), k.float().transpose(-1, -2))
    return _masked(s, kv_mask, causal), qs


def flash_attention_fwd_reference(q, k, v, *, causal=False, kv_mask=None,
                                  scale=None, dropout_p=0.0,
                                  dropout_seed=None
                                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the forward kernel: ``(o [b, n, s_q, d] in q's
    dtype, lse [b, n, s_q] fp32)``."""
    scale = 1.0 / math.sqrt(q.shape[-1]) if scale is None else float(scale)
    seed = _resolve_seed(dropout_p, dropout_seed)
    s, _ = _kernel_scores(q, k, kv_mask, causal, scale)
    m = s.amax(dim=-1, keepdim=True)
    dead = s <= _NEG_INF / 2
    p = torch.exp(s - m).masked_fill(dead, 0.0)
    l = p.sum(dim=-1, keepdim=True)
    if seed is not None:
        b, n, s_q, s_k = s.shape
        keep = dropout_mask_reference(seed, b, n, s_q, s_k, dropout_p,
                                      q.device)
        p = p * keep * (1.0 / (1.0 - dropout_p))
    acc = torch.matmul(p.to(v.dtype).float(), v.float())
    safe_l = torch.where(l == 0.0, 1.0, l)
    o = (acc / safe_l).to(q.dtype)
    lse = torch.where(l == 0.0, _NEG_INF, m + torch.log(safe_l))
    return o, lse[..., 0]


def flash_attention_bwd_reference(q, k, v, o, lse, do, *, causal=False,
                                  kv_mask=None, scale=None, dropout_p=0.0,
                                  dropout_seed=None):
    """Plain version of the backward kernels: ``(dq, dk, dv)`` from the
    forward's ``o`` and ``lse`` (the scores recomputed, delta =
    rowsum(do * o) in fp32)."""
    scale = 1.0 / math.sqrt(q.shape[-1]) if scale is None else float(scale)
    seed = _resolve_seed(dropout_p, dropout_seed)
    s, qs = _kernel_scores(q, k, kv_mask, causal, scale)
    p = torch.exp(s - lse[..., None]).masked_fill(s <= _NEG_INF / 2, 0.0)
    dof = do.float()
    dp = torch.matmul(dof, v.float().transpose(-1, -2))
    delta = (dof * o.float()).sum(dim=-1, keepdim=True)
    p_d = p
    if seed is not None:
        b, n, s_q, s_k = s.shape
        keep = dropout_mask_reference(seed, b, n, s_q, s_k, dropout_p,
                                      q.device)
        inv = 1.0 / (1.0 - dropout_p)
        p_d = p * keep * inv
        dp = dp * keep * inv
    dv = torch.matmul(p_d.to(do.dtype).float().transpose(-1, -2), dof)
    ds = p * (dp - delta)
    dk = torch.matmul(ds.to(q.dtype).float().transpose(-1, -2), qs.float())
    dq = torch.matmul(ds.to(k.dtype).float(), k.float()) * scale
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def masked_scores(q, k, kv_mask, causal, scale) -> torch.Tensor:
    """Dense fp32 ``[b, n, s_q, s_k]`` logits with the kernels' masking
    conventions (``masked_scores`` of the JAX module, without bias)."""
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    return _masked(s, kv_mask, causal)


def mha_reference(q, k, v, *, causal=False, kv_mask=None, bias=None,
                  scale=None, dropout_p=0.0, dropout_seed=None):
    """Materialised-score reference (tests): the JAX module's
    ``mha_reference`` — the scale applied to the fp32 scores, the
    zeros-for-fully-masked-rows convention, the kernels' dropout mask."""
    _refuse_bias(bias)
    scale = 1.0 / math.sqrt(q.shape[-1]) if scale is None else float(scale)
    s = masked_scores(q, k, kv_mask, causal, scale)
    p = torch.softmax(s, dim=-1)
    row_alive = (s > _NEG_INF / 2).any(dim=-1, keepdim=True)
    p = torch.where(row_alive, p, 0.0)
    seed = _resolve_seed(dropout_p, dropout_seed)
    if seed is not None:
        b, n, s_q, s_k = p.shape
        keep = dropout_mask_reference(seed, b, n, s_q, s_k, dropout_p,
                                      q.device)
        p = p * keep * (1.0 / (1.0 - dropout_p))
    return torch.matmul(p.to(v.dtype).float(), v.float()).to(q.dtype)


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

#: the head dim the CUDA kernels are instantiated for (GPT-2's 64)
KERNEL_HEAD_DIM = 64


def _kernel_args(q, k, v, kv_mask):
    if q.dim() != 4 or k.shape != v.shape or q.shape[0] != k.shape[0] \
            or q.shape[1] != k.shape[1] or q.shape[3] != k.shape[3]:
        raise ValueError(
            f"q [b, n, s_q, d] and k, v [b, n, s_k, d] expected, got "
            f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(
            f"flash attention kernels take f32/bf16, got {q.dtype}")
    if q.shape[3] != KERNEL_HEAD_DIM:
        raise NotImplementedError(
            f"flash attention CUDA kernels take head dim "
            f"{KERNEL_HEAD_DIM}, got {q.shape[3]}")
    mask = None
    if kv_mask is not None:
        if tuple(kv_mask.shape) != (k.shape[0], k.shape[2]):
            raise ValueError(f"kv_mask must be [b, s_k], got "
                             f"{tuple(kv_mask.shape)}")
        mask = (kv_mask != 0).to(torch.uint8).contiguous()
    return mask


def _dropout_args(dropout_p: float, seed: Optional[int]):
    if seed is None:
        return 0, 0, 0, 1.0
    return 1, seed & _M32, _threshold(dropout_p), 1.0 / (1.0 - dropout_p)


def _launch_fwd(q, k, v, kv_mask, causal, scale, dropout_p, seed):
    mask = _kernel_args(q, k, v, kv_mask)
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    b, n, s_q, d = q.shape
    s_k = k.shape[2]
    lib = _build.kernels()
    dev = q.device
    o = torch.empty_like(q)
    lse = torch.empty((b, n, s_q), dtype=torch.float32, device=dev)
    drop, seed_u, thresh, drop_scale = _dropout_args(dropout_p, seed)
    rc = lib.apex_flash_attn_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(),
        None if mask is None else mask.data_ptr(), o.data_ptr(),
        lse.data_ptr(), b, n, s_q, s_k, d, float(scale), int(causal), drop,
        seed_u, thresh, drop_scale, int(q.dtype == torch.bfloat16),
        dev.index, _build.current_stream(dev))
    _build.check(rc, "flash_attn_fwd")
    _device.LAUNCHES["flash_attn_fwd"] += 1
    return o, lse


def _launch_bwd(q, k, v, o, lse, do, kv_mask, causal, scale, dropout_p,
                seed):
    mask = _kernel_args(q, k, v, kv_mask)
    if o.shape != q.shape or do.shape != q.shape \
            or tuple(lse.shape) != tuple(q.shape[:3]):
        raise ValueError("o and do must be q's shape and lse [b, n, s_q]")
    q, k, v, o = (t.contiguous() for t in (q, k, v, o))
    do = do.to(q.dtype).contiguous()
    lse = lse.float().contiguous()
    b, n, s_q, d = q.shape
    s_k = k.shape[2]
    lib = _build.kernels()
    dev = q.device
    delta = torch.empty((b, n, s_q), dtype=torch.float32, device=dev)
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    drop, seed_u, thresh, drop_scale = _dropout_args(dropout_p, seed)
    rc = lib.apex_flash_attn_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        do.data_ptr(), lse.data_ptr(),
        None if mask is None else mask.data_ptr(), delta.data_ptr(),
        dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), b, n, s_q, s_k, d,
        float(scale), int(causal), drop, seed_u, thresh, drop_scale,
        int(q.dtype == torch.bfloat16), dev.index,
        _build.current_stream(dev))
    _build.check(rc, "flash_attn_bwd")
    _device.LAUNCHES["flash_attn_bwd"] += 1
    return dq, dk, dv


def _route(*tensors) -> bool:
    return _device.kernel_route(*(t for t in tensors if t is not None))


def _resolve(q, scale, dropout_p, dropout_seed):
    """``(scale, seed)``: the default scale 1/sqrt(d) and the int32
    seed (None without dropout)."""
    scale = 1.0 / math.sqrt(q.shape[-1]) if scale is None else float(scale)
    return scale, _resolve_seed(dropout_p, dropout_seed)


def _fwd(q, k, v, kv_mask, causal, scale, dropout_p, seed):
    """The forward on resolved arguments: the kernel on CUDA tensors,
    the plain version on CPU tensors."""
    if _route(q, k, v, kv_mask):
        return _launch_fwd(q, k, v, kv_mask, causal, scale, dropout_p, seed)
    return flash_attention_fwd_reference(
        q, k, v, causal=causal, kv_mask=kv_mask, scale=scale,
        dropout_p=dropout_p, dropout_seed=seed)


def _bwd(q, k, v, o, lse, do, kv_mask, causal, scale, dropout_p, seed):
    """The backward on resolved arguments, routed as :func:`_fwd`."""
    if _route(q, k, v, o, lse, do, kv_mask):
        return _launch_bwd(q, k, v, o, lse, do, kv_mask, causal, scale,
                           dropout_p, seed)
    return flash_attention_bwd_reference(
        q, k, v, o, lse, do, causal=causal, kv_mask=kv_mask, scale=scale,
        dropout_p=dropout_p, dropout_seed=seed)


def flash_attention_fwd(q, k, v, *, causal=False, kv_mask=None, scale=None,
                        dropout_p=0.0, dropout_seed=None):
    """``(o, lse)``: the forward kernel on CUDA tensors, its plain
    version on CPU tensors. k and v are taken in q's dtype."""
    scale, seed = _resolve(q, scale, dropout_p, dropout_seed)
    return _fwd(q, k.to(q.dtype), v.to(q.dtype), kv_mask, causal, scale,
                dropout_p, seed)


def flash_attention_bwd(q, k, v, o, lse, do, *, causal=False, kv_mask=None,
                        scale=None, dropout_p=0.0, dropout_seed=None):
    """``(dq, dk, dv)``: the backward kernels on CUDA tensors (one call
    issues two launches, dq then dk/dv, and counts once), the plain
    version on CPU tensors."""
    scale, seed = _resolve(q, scale, dropout_p, dropout_seed)
    return _bwd(q, k, v, o, lse, do, kv_mask, causal, scale, dropout_p,
                seed)


class _FlashAttention(torch.autograd.Function):
    """The JAX module's ``_flash`` custom VJP: the forward saves ``(q,
    k, v, o, lse)``, the backward recomputes from ``lse``."""

    @staticmethod
    def forward(ctx, q, k, v, kv_mask, causal, scale, dropout_p, seed):
        o, lse = _fwd(q, k, v, kv_mask, causal, scale, dropout_p, seed)
        ctx.save_for_backward(q, k, v, o, lse, kv_mask)
        ctx.cfg = (causal, scale, dropout_p, seed)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse, kv_mask = ctx.saved_tensors
        causal, scale, dropout_p, seed = ctx.cfg
        dq, dk, dv = _bwd(q, k, v, o, lse, do, kv_mask, causal, scale,
                          dropout_p, seed)
        return dq, dk, dv, None, None, None, None, None


def _refuse_bias(bias) -> None:
    if bias is not None:
        raise NotImplementedError(
            "flash attention's additive bias is not ported yet "
            "(ROADMAP.md, queue A2: flash-attention bias)")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = False,
                    kv_mask: Optional[torch.Tensor] = None,
                    bias: Optional[torch.Tensor] = None,
                    scale: Optional[float] = None,
                    dropout_p: float = 0.0,
                    dropout_seed=None) -> torch.Tensor:
    """Tiled online-softmax attention over ``[b, n, s, d]``:
    ``dropout(softmax(q @ k.T * scale [masked])) @ v`` in q's dtype,
    differentiable (the backward kernels recompute the scores from the
    saved logsumexp and regenerate the dropout mask from its hash)."""
    _refuse_bias(bias)
    scale, seed = _resolve(q, scale, dropout_p, dropout_seed)
    # the kernels run in one dtype: k and v follow q, as in the JAX module
    k, v = k.to(q.dtype), v.to(q.dtype)
    return _FlashAttention.apply(q, k, v, kv_mask, bool(causal), scale,
                                 float(dropout_p), seed)


def flash_attention_sbhd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         **kw) -> torch.Tensor:
    """Megatron ``[s, b, n, d]`` layout wrapper -> context
    ``[s, b, n, d]``."""
    qt, kt, vt = (t.permute(1, 2, 0, 3) for t in (q, k, v))
    return flash_attention(qt, kt, vt, **kw).permute(2, 0, 1, 3)


def flash_attention_varlen(q, k, v, cu_seqlens, **kw):
    """Packed variable-length attention (segment ids): not ported yet."""
    raise NotImplementedError(
        "flash_attention_varlen (packed segments) is not ported yet "
        "(ROADMAP.md, queue A2: flash-attention segments/varlen)")
