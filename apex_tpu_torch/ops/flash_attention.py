"""Flash attention: tiled online-softmax CUDA kernels for Hopper, forward
and backward, beside their plain PyTorch versions (counterpart of
``apex_tpu/ops/flash_attention.py``).

Layout ``[b, n, s, d]`` (:func:`flash_attention`), the Megatron
``[s, b, n, d]`` wrapper (:func:`flash_attention_sbhd`) and packed
variable-length sequences ``[total, n, d]`` with ``cu_seqlens``
(:func:`flash_attention_varlen`). The kernels are
``csrc/flash_attention_bf16.cu`` for bf16 and fp16 (one template on the
tensor cores) and ``csrc/flash_attention.cu`` for fp32 (on the CUDA
cores; it holds every dtype's entry points): the forward replaces the
TPU kernel of ``_fwd`` and returns ``o`` in q's dtype and ``lse [b, n,
s_q]`` fp32; the backward replaces ``_bwd``'s dq and dk/dv kernels and
recomputes the scores from ``lse``. :func:`flash_attention_fwd_reference`
and :func:`flash_attention_bwd_reference` are the plain versions: the
same arithmetic on the materialised ``[b, n, s_q, s_k]`` scores (the
softmax scale folded into q, which is rounded back to its dtype before
the dot, as ``_scaled_q`` does; p rounded to the operand dtype before
each product). :func:`mha_reference` and :func:`mha_reference_varlen`
are the JAX package's materialised references, kept as written there.

Supports causal masking, a key-padding mask ``kv_mask [b, s_k]`` (nonzero
= attend), an additive logit bias ``[b|1, n|1, s_q|1, s_k]`` (added in
fp32 after the scale and before the masks; its gradient, with
``bias_grad``, is the fp32 ``ds`` that the dq kernel writes, summed here
over the broadcast dims), per-token segment ids (a query attends only to
keys of its own segment; :func:`flash_attention_varlen` derives them from
``cu_seqlens``) and in-kernel hash dropout (``dropout_p``,
``dropout_seed``). A fully masked row, a ``-1e30`` folded into the bias
included, outputs zeros with ``lse = -1e30`` (the kernels' -inf) and gets
zero gradients.

The dropout keep bit is a counter-based hash (``_i32``, ``_shr_logical``,
``_hash_keep_bits`` of the JAX module, bit-exact). The JAX code computes
in int32 with wrapping multiplies. PyTorch gives no promise about int32
overflow, so the plain versions compute in int64 masked to the low 32
bits, reinterpreted as int32 only at the end. A 32 x 32-bit product would
overflow int64, so :func:`_mul32` splits the constant into 16-bit halves
(each partial product stays below 2^48). Carried sampling keys its draws
with the same hash.

Route (``_device.kernel_route``): CUDA tensors go through the kernels,
CPU tensors through the plain versions. The kernels are instantiated at
head dims :data:`KERNEL_HEAD_DIMS`; any other up to 256 runs zero-padded
to the next of them (:func:`kernel_head_dim`), which is exact. The
forward is the custom op :data:`FLASH_ATTN_FWD`, so a selective
recompute policy can keep ``(o, lse)`` instead of replaying the kernel.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

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
    the threshold (``_keep_mask`` of the JAX module). One (batch, head)
    plane at a time, so the int64 arithmetic holds one plane's
    temporaries, not ``[b, n, s_q, s_k]`` of them."""
    qi = torch.arange(s_q, dtype=torch.int64, device=device)[:, None]
    ki = torch.arange(s_k, dtype=torch.int64, device=device)[None, :]
    seed_t = torch.tensor(_i32(seed), dtype=torch.int64, device=device)
    thresh = _threshold(dropout_p)
    keep = torch.empty((b * n, s_q, s_k), dtype=torch.float32, device=device)
    for bh in range(b * n):
        bits = _u32(_hash_keep_bits(seed_t, torch.tensor(
            bh, dtype=torch.int64, device=device), qi, ki))
        keep[bh] = (bits >= thresh).to(torch.float32)
    return keep.reshape(b, n, s_q, s_k)


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


def _masked(s: torch.Tensor, kv_mask, causal: bool, seg_q=None,
            seg_k=None) -> torch.Tensor:
    """The masks of ``_mask_scores``: causal ``k > q``, ``kv_mask == 0``,
    query and key of different segments, each as ``_NEG_INF``."""
    if causal:
        s_q, s_k = s.shape[-2:]
        qi = torch.arange(s_q, device=s.device)[:, None]
        ki = torch.arange(s_k, device=s.device)[None, :]
        s = s.masked_fill(ki > qi, _NEG_INF)
    if kv_mask is not None:
        s = s.masked_fill(kv_mask[:, None, None, :] == 0, _NEG_INF)
    if seg_q is not None:
        sq = seg_q if seg_q.dim() == 2 else seg_q[None]
        sk = seg_k if seg_k.dim() == 2 else seg_k[None]
        s = s.masked_fill(sq[:, None, :, None] != sk[:, None, None, :],
                          _NEG_INF)
    return s


def _kernel_scores(q, k, kv_mask, causal, scale, bias=None, seg_q=None,
                   seg_k=None):
    qs = _scaled_q(q, scale)
    s = torch.matmul(qs.float(), k.float().transpose(-1, -2))
    if bias is not None:
        s = s + bias.float()
    return _masked(s, kv_mask, causal, seg_q, seg_k), qs


def _check_segments(seg_q, seg_k) -> None:
    if (seg_q is None) != (seg_k is None):
        raise ValueError("seg_q and seg_k must be provided together")


def flash_attention_fwd_reference(q, k, v, *, causal=False, kv_mask=None,
                                  bias=None, seg_q=None, seg_k=None,
                                  scale=None, dropout_p=0.0,
                                  dropout_seed=None
                                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the forward kernel: ``(o [b, n, s_q, d] in q's
    dtype, lse [b, n, s_q] fp32)``."""
    scale = 1.0 / math.sqrt(q.shape[-1]) if scale is None else float(scale)
    seed = _resolve_seed(dropout_p, dropout_seed)
    _check_segments(seg_q, seg_k)
    s, _ = _kernel_scores(q, k, kv_mask, causal, scale, bias, seg_q, seg_k)
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
                                  kv_mask=None, bias=None, bias_grad=False,
                                  seg_q=None, seg_k=None, scale=None,
                                  dropout_p=0.0, dropout_seed=None):
    """Plain version of the backward kernels: ``(dq, dk, dv)`` from the
    forward's ``o`` and ``lse`` (the scores recomputed, delta =
    rowsum(do * o) in fp32); with a bias and ``bias_grad``, also the fp32
    ``[b, n, s_q, s_k]`` ds that the dq kernel writes as the bias's
    gradient (before any sum over broadcast dims)."""
    scale = 1.0 / math.sqrt(q.shape[-1]) if scale is None else float(scale)
    seed = _resolve_seed(dropout_p, dropout_seed)
    _check_segments(seg_q, seg_k)
    s, qs = _kernel_scores(q, k, kv_mask, causal, scale, bias, seg_q, seg_k)
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
    grads = (dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype))
    if bias is not None and bias_grad:
        return grads + (ds,)
    return grads


def masked_scores(q, k, kv_mask, causal, scale, bias=None) -> torch.Tensor:
    """Dense fp32 ``[b, n, s_q, s_k]`` logits with the kernels' masking
    conventions (``masked_scores`` of the JAX module: scale, then the
    bias, then the causal and key-padding masks)."""
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if bias is not None:
        s = s + bias.float()
    return _masked(s, kv_mask, causal)


def mha_reference(q, k, v, *, causal=False, kv_mask=None, bias=None,
                  scale=None, dropout_p=0.0, dropout_seed=None):
    """Materialised-score reference (tests): the JAX module's
    ``mha_reference`` — the scale applied to the fp32 scores, the
    zeros-for-fully-masked-rows convention, the kernels' dropout mask."""
    scale = 1.0 / math.sqrt(q.shape[-1]) if scale is None else float(scale)
    s = masked_scores(q, k, kv_mask, causal, scale, bias)
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


def segment_ids_from_cu_seqlens(cu_seqlens: torch.Tensor,
                                total: int) -> torch.Tensor:
    """``[total]`` int32 segment ids from ``cu_seqlens [b+1]`` (monotone,
    ``cu_seqlens[0] == 0``). Tokens past ``cu_seqlens[-1]`` get id ``b``
    (a padding segment that only attends to itself)."""
    pos = torch.arange(total, dtype=torch.int32, device=cu_seqlens.device)
    bounds = cu_seqlens.to(torch.int32)[1:].contiguous()
    return torch.searchsorted(bounds, pos, right=True, out_int32=True)


def mha_reference_varlen(q, k, v, cu_seqlens, *, causal=False, scale=None):
    """Per-sequence reference for varlen tests (``mha_reference_varlen``
    of the JAX module): dense attention over ``[total, n, d]`` with the
    scores of different sequences masked."""
    total, n, d = q.shape
    segs = segment_ids_from_cu_seqlens(cu_seqlens, total)
    seg_mask = segs[:, None] == segs[None, :]
    scale = 1.0 / math.sqrt(d) if scale is None else float(scale)
    s = torch.einsum("qnd,knd->nqk", q.float(), k.float()) * scale
    s = torch.where(seg_mask[None], s, _NEG_INF)
    if causal:
        qi = torch.arange(total, device=q.device)[:, None]
        ki = torch.arange(total, device=q.device)[None, :]
        s = torch.where((ki > qi)[None], _NEG_INF, s)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("nqk,knd->qnd", p.to(v.dtype).float(),
                        v.float()).to(q.dtype)


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

#: the head dims the CUDA kernels are instantiated for
#: (``dispatch_f32`` in ``csrc/flash_attention.cu``, ``launch_typed`` in
#: ``csrc/flash_attention_bf16.cu``)
KERNEL_HEAD_DIMS = (32, 64, 96, 128, 256)
#: the widest head dim flash attention takes on the card (the JAX gate's
#: ``d <= 256``): another head dim up to it runs zero-padded to the next
#: instantiated one (:func:`kernel_head_dim`)
MAX_HEAD_DIM = KERNEL_HEAD_DIMS[-1]
#: the dtypes the CUDA kernels take: fp32 on the CUDA cores, bf16 and
#: fp16 on the tensor cores
KERNEL_DTYPES = (torch.float32, torch.bfloat16, torch.float16)


def flash_attention_available(s_q: int, s_k: int, d: int,
                              device=None, dtype=None) -> bool:
    """Whether flash attention runs at these shapes on ``device`` (the
    counterpart of the JAX module's ``flash_attention_available``, which
    takes flash for head dims up to 256 where its kernel tiles and leaves
    the rest to the path without flash). On a CUDA device: head dims up to
    :data:`MAX_HEAD_DIM` in the kernels' dtypes (any sequence length;
    ``dtype`` None asks about the head dim alone); elsewhere the plain
    version, which takes every shape."""
    del s_q, s_k  # the kernels mask ragged tiles themselves
    if device is not None and torch.device(device).type == "cuda":
        return d <= MAX_HEAD_DIM and (dtype is None
                                      or dtype in KERNEL_DTYPES)
    return True


def kernel_head_dim(d: int) -> int:
    """The instantiated head dim that runs head dim ``d``: ``d`` itself,
    else the next wider one, its inputs zero-padded (160 runs at 256: 1.6
    times the work of an exact kernel)."""
    for k in KERNEL_HEAD_DIMS:
        if k >= d:
            return k
    raise ValueError(f"flash attention CUDA kernels take head dims up to "
                     f"{MAX_HEAD_DIM}, got {d}")


def _pad_head(t: torch.Tensor, dp: int) -> torch.Tensor:
    return F.pad(t, (0, dp - t.shape[-1]))


def _head_padded_fwd(fwd, q, k, v, *args):
    """``fwd(q, k, v, *args) -> (o, lse)`` at an instantiated head dim: q,
    k and v zero-padded to :func:`kernel_head_dim`, o cut back. Exact: the
    padded columns of q and k add 0 to every score and those of v give
    the columns that are cut off; the scale (``1/sqrt(d)`` of the unpadded
    d by default) is among ``args``, resolved before."""
    d = q.shape[-1]
    dp = kernel_head_dim(d)
    if dp == d:
        return fwd(q, k, v, *args)
    o, lse = fwd(*(_pad_head(t, dp) for t in (q, k, v)), *args)
    return o[..., :d].contiguous(), lse


def _head_padded_bwd(bwd, q, k, v, o, lse, do, *args):
    """``bwd(q, k, v, o, lse, do, *args) -> (dq, dk, dv, dbias)`` at an
    instantiated head dim: q, k, v, o and do zero-padded (``delta =
    rowsum(do * o)`` is unchanged), dq, dk and dv cut back; ``lse`` and
    dbias have no head dim."""
    d = q.shape[-1]
    dp = kernel_head_dim(d)
    if dp == d:
        return bwd(q, k, v, o, lse, do, *args)
    q, k, v, o, do = (_pad_head(t, dp) for t in (q, k, v, o, do))
    dq, dk, dv, dbias = bwd(q, k, v, o, lse, do, *args)
    return (*(g[..., :d].contiguous() for g in (dq, dk, dv)), dbias)


def _kernel_args(q, k, v, kv_mask):
    if q.dim() != 4 or k.shape != v.shape or q.shape[0] != k.shape[0] \
            or q.shape[1] != k.shape[1] or q.shape[3] != k.shape[3]:
        raise ValueError(
            f"q [b, n, s_q, d] and k, v [b, n, s_k, d] expected, got "
            f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    if q.dtype not in KERNEL_DTYPES:
        raise TypeError(
            f"flash attention kernels take f32/bf16/f16, got {q.dtype}")
    if q.shape[3] not in KERNEL_HEAD_DIMS:
        raise ValueError(
            f"flash attention CUDA kernels take head dims "
            f"{KERNEL_HEAD_DIMS}, got {q.shape[3]}")
    mask = None
    if kv_mask is not None:
        if tuple(kv_mask.shape) != (k.shape[0], k.shape[2]):
            raise ValueError(f"kv_mask must be [b, s_k], got "
                             f"{tuple(kv_mask.shape)}")
        mask = (kv_mask != 0).to(torch.uint8).contiguous()
    return mask


def _check_bias(bias, q, k) -> None:
    """The JAX module's bias shape check: ``[b|1, n|1, s_q|1, s_k]``."""
    b, n, s_q = q.shape[0], q.shape[1], q.shape[2]
    s_k = k.shape[2]
    if (bias.dim() != 4 or bias.shape[0] not in (1, b)
            or bias.shape[1] not in (1, n)
            or bias.shape[2] not in (1, s_q)
            or bias.shape[3] != s_k):
        raise ValueError(
            f"bias shape {tuple(bias.shape)} must be [b|1, n|1, s_q|1, "
            f"s_k] = [{b}|1, {n}|1, {s_q}|1, {s_k}]")


def _bias_args(bias, q):
    """``(bias, dtype code, batch, head and row strides)`` for the
    kernels: the bias contiguous in its own (broadcast) shape, a broadcast
    dim at stride 0, as ``_bias_args`` pins its block index to 0."""
    if bias is None:
        return None, 0, 0, 0, 0
    if bias.dtype not in (torch.float32, q.dtype):
        raise TypeError(f"the kernels read a bias in fp32 or q's dtype "
                        f"{q.dtype}, got {bias.dtype}")
    bias = bias.contiguous()
    bb, bn, br, s_k = bias.shape
    sq = s_k if br > 1 else 0
    sh = br * s_k if bn > 1 else 0
    sb = bn * br * s_k if bb > 1 else 0
    return bias, _build.dtype_code(bias), sb, sh, sq


def _seg_args(seg, b: int, s: int):
    """``(ids, batch stride)``: int32 ``[s]`` (stride 0) or ``[b, s]``."""
    if seg is None:
        return None, 0
    if tuple(seg.shape) not in ((s,), (b, s)):
        raise ValueError(f"segment ids must be [{s}] or [{b}, {s}], got "
                         f"{tuple(seg.shape)}")
    seg = seg.to(torch.int32).contiguous()
    return seg, (s if seg.dim() == 2 else 0)


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """``t`` contiguous at a 16-byte aligned address: the tensor-core
    kernels copy rows into shared memory 16 bytes at a time
    (``cp.async``), which a view at an odd element offset would fault."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _dropout_args(dropout_p: float, seed: Optional[int]):
    if seed is None:
        return 0, 0, 0, 1.0
    return 1, seed & _M32, _threshold(dropout_p), 1.0 / (1.0 - dropout_p)


def _extras(q, k, bias, seg_q, seg_k):
    """The bias and segment arguments of both entry points, checked."""
    _check_segments(seg_q, seg_k)
    b, s_q, s_k = q.shape[0], q.shape[2], k.shape[2]
    bias, bcode, sb, sh, sq = _bias_args(bias, q)
    seg_q, sbq = _seg_args(seg_q, b, s_q)
    seg_k, sbk = _seg_args(seg_k, b, s_k)
    return (bias, seg_q, seg_k), (bcode, sb, sh, sq, sbq, sbk)


def _launch_fwd(q, k, v, kv_mask, bias, seg_q, seg_k, causal, scale,
                dropout_p, seed):
    mask = _kernel_args(q, k, v, kv_mask)
    (bias, seg_q, seg_k), strides = _extras(q, k, bias, seg_q, seg_k)
    q, k, v = _aligned(q), _aligned(k), _aligned(v)
    b, n, s_q, d = q.shape
    s_k = k.shape[2]
    lib = _build.kernels()
    dev = q.device
    o = torch.empty_like(q)
    lse = torch.empty((b, n, s_q), dtype=torch.float32, device=dev)
    rc = lib.apex_flash_attn_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(mask), _ptr(bias),
        _ptr(seg_q), _ptr(seg_k), o.data_ptr(), lse.data_ptr(), b, n, s_q,
        s_k, d, float(scale), int(causal), *_dropout_args(dropout_p, seed),
        *strides, _build.dtype_code(q), dev.index,
        _build.current_stream(dev))
    _build.check(rc, "flash_attn_fwd")
    _device.LAUNCHES["flash_attn_fwd"] += 1
    return o, lse


def _launch_bwd(q, k, v, o, lse, do, kv_mask, bias, seg_q, seg_k, causal,
                scale, dropout_p, seed, emit_dbias):
    mask = _kernel_args(q, k, v, kv_mask)
    (bias, seg_q, seg_k), strides = _extras(q, k, bias, seg_q, seg_k)
    if o.shape != q.shape or do.shape != q.shape \
            or tuple(lse.shape) != tuple(q.shape[:3]):
        raise ValueError("o and do must be q's shape and lse [b, n, s_q]")
    q, k, v, o = (_aligned(t) for t in (q, k, v, o))
    do = _aligned(do.to(q.dtype))
    lse = lse.float().contiguous()
    b, n, s_q, d = q.shape
    s_k = k.shape[2]
    lib = _build.kernels()
    dev = q.device
    delta = torch.empty((b, n, s_q), dtype=torch.float32, device=dev)
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    # every element the dq kernel does not visit (tiles past the causal
    # diagonal or outside a segment's range) keeps this zero
    dbias = (torch.zeros((b, n, s_q, s_k), dtype=torch.float32, device=dev)
             if emit_dbias and bias is not None else None)
    rc = lib.apex_flash_attn_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        do.data_ptr(), lse.data_ptr(), _ptr(mask), _ptr(bias), _ptr(seg_q),
        _ptr(seg_k), delta.data_ptr(), dq.data_ptr(), dk.data_ptr(),
        dv.data_ptr(), _ptr(dbias), b, n, s_q, s_k, d, float(scale),
        int(causal), *_dropout_args(dropout_p, seed), *strides,
        _build.dtype_code(q), dev.index, _build.current_stream(dev))
    _build.check(rc, "flash_attn_bwd")
    _device.LAUNCHES["flash_attn_bwd"] += 1
    return dq, dk, dv, dbias


def _route(*tensors) -> bool:
    return _device.kernel_route(*(t for t in tensors if t is not None))


def _resolve(q, scale, dropout_p, dropout_seed):
    """``(scale, seed)``: the default scale 1/sqrt(d) and the int32
    seed (None without dropout)."""
    scale = 1.0 / math.sqrt(q.shape[-1]) if scale is None else float(scale)
    return scale, _resolve_seed(dropout_p, dropout_seed)


#: the forward as a named op, which the selective recompute policies of
#: ``standalone_transformer_lm`` save (the JAX policy's
#: ``apex_tpu_flash_fwd``)
FLASH_ATTN_FWD = "apex_tpu_torch::flash_attn_fwd"


def _plain_fwd(q, k, v, kv_mask, bias, seg_q, seg_k, causal, scale,
               dropout_p, seed):
    """The plain forward on :func:`_launch_fwd`'s arguments."""
    return flash_attention_fwd_reference(
        q, k, v, causal=causal, kv_mask=kv_mask, bias=bias, seg_q=seg_q,
        seg_k=seg_k, scale=scale, dropout_p=dropout_p, dropout_seed=seed)


def _plain_bwd(q, k, v, o, lse, do, kv_mask, bias, seg_q, seg_k, causal,
               scale, dropout_p, seed, emit_dbias):
    """The plain backward on :func:`_launch_bwd`'s arguments: ``(dq, dk,
    dv, dbias or None)``."""
    out = flash_attention_bwd_reference(
        q, k, v, o, lse, do, causal=causal, kv_mask=kv_mask, bias=bias,
        bias_grad=emit_dbias, seg_q=seg_q, seg_k=seg_k, scale=scale,
        dropout_p=dropout_p, dropout_seed=seed)
    return out if len(out) == 4 else out + (None,)


def _fwd_impl(q, k, v, kv_mask, bias, seg_q, seg_k, causal, scale,
              dropout_p, seed):
    if _route(q, k, v, kv_mask, bias, seg_q, seg_k):
        return _head_padded_fwd(_launch_fwd, q, k, v, kv_mask, bias, seg_q,
                                seg_k, causal, scale, dropout_p, seed)
    return _plain_fwd(q, k, v, kv_mask, bias, seg_q, seg_k, causal, scale,
                      dropout_p, seed)


#: the forward on resolved arguments: the kernel on CUDA tensors, the
#: plain version on CPU tensors
_fwd = torch.library.custom_op(
    FLASH_ATTN_FWD, _fwd_impl, mutates_args=(),
    schema="(Tensor q, Tensor k, Tensor v, Tensor? kv_mask, Tensor? bias, "
           "Tensor? seg_q, Tensor? seg_k, bool causal, float scale, "
           "float dropout_p, int? seed) -> (Tensor, Tensor)")


def _bwd(q, k, v, o, lse, do, kv_mask, bias, seg_q, seg_k, causal, scale,
         dropout_p, seed, emit_dbias):
    """The backward on resolved arguments, routed as :func:`_fwd`:
    ``(dq, dk, dv, dbias)``, dbias the fp32 ``[b, n, s_q, s_k]`` ds when
    ``emit_dbias`` and a bias is given, else None."""
    if _route(q, k, v, o, lse, do, kv_mask, bias, seg_q, seg_k):
        return _head_padded_bwd(_launch_bwd, q, k, v, o, lse, do, kv_mask,
                                bias, seg_q, seg_k, causal, scale, dropout_p,
                                seed, emit_dbias)
    return _plain_bwd(q, k, v, o, lse, do, kv_mask, bias, seg_q, seg_k,
                      causal, scale, dropout_p, seed, emit_dbias)


def flash_attention_fwd(q, k, v, *, causal=False, kv_mask=None, bias=None,
                        seg_q=None, seg_k=None, scale=None, dropout_p=0.0,
                        dropout_seed=None):
    """``(o, lse)``: the forward kernel on CUDA tensors, its plain
    version on CPU tensors. k and v are taken in q's dtype."""
    scale, seed = _resolve(q, scale, dropout_p, dropout_seed)
    return _fwd(q, k.to(q.dtype), v.to(q.dtype), kv_mask, bias, seg_q,
                seg_k, causal, scale, dropout_p, seed)


def flash_attention_bwd(q, k, v, o, lse, do, *, causal=False, kv_mask=None,
                        bias=None, bias_grad=False, seg_q=None, seg_k=None,
                        scale=None, dropout_p=0.0, dropout_seed=None):
    """``(dq, dk, dv)``, and with a bias and ``bias_grad`` the fp32
    ``[b, n, s_q, s_k]`` dbias as a fourth: the backward kernels on CUDA
    tensors (one call issues two launches, dq then dk/dv, and counts
    once), the plain version on CPU tensors."""
    scale, seed = _resolve(q, scale, dropout_p, dropout_seed)
    dq, dk, dv, dbias = _bwd(q, k, v, o, lse, do, kv_mask, bias, seg_q,
                             seg_k, causal, scale, dropout_p, seed,
                             bias_grad)
    return (dq, dk, dv) if dbias is None else (dq, dk, dv, dbias)


def _reduce_dbias(dbias: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """The full fp32 dbias summed over the bias's broadcast dims, in the
    bias's dtype (``_flash_bwd`` leaves this sum to XLA)."""
    dims = tuple(i for i in range(3) if bias.shape[i] == 1)
    if dims:
        dbias = dbias.sum(dim=dims, keepdim=True)
    return dbias.to(bias.dtype)


class _FlashAttention(torch.autograd.Function):
    """The JAX module's ``_flash`` custom VJP: the forward saves ``(q,
    k, v, o, lse)`` and the optional inputs, the backward recomputes from
    ``lse``."""

    @staticmethod
    def forward(ctx, q, k, v, kv_mask, bias, seg_q, seg_k, causal, scale,
                dropout_p, seed, bias_grad):
        o, lse = _fwd(q, k, v, kv_mask, bias, seg_q, seg_k, causal, scale,
                      dropout_p, seed)
        ctx.save_for_backward(q, k, v, o, lse, kv_mask, bias, seg_q, seg_k)
        ctx.cfg = (causal, scale, dropout_p, seed, bias_grad)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse, kv_mask, bias, seg_q, seg_k = ctx.saved_tensors
        causal, scale, dropout_p, seed, bias_grad = ctx.cfg
        want_db = bias is not None and ctx.needs_input_grad[4]
        dq, dk, dv, dbias = _bwd(q, k, v, o, lse, do, kv_mask, bias, seg_q,
                                 seg_k, causal, scale, dropout_p, seed,
                                 bias_grad and want_db)
        db = None
        if want_db:
            # bias_grad=False: a constant bias (a folded mask, ALiBi) whose
            # cotangent is zeros, with no [b, n, s_q, s_k] buffer
            db = (_reduce_dbias(dbias, bias) if dbias is not None
                  else torch.zeros_like(bias))
        return dq, dk, dv, None, db, None, None, None, None, None, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = False,
                    kv_mask: Optional[torch.Tensor] = None,
                    bias: Optional[torch.Tensor] = None,
                    bias_grad: bool = True,
                    scale: Optional[float] = None,
                    dropout_p: float = 0.0,
                    dropout_seed=None) -> torch.Tensor:
    """Tiled online-softmax attention over ``[b, n, s, d]``:
    ``dropout(softmax(q @ k.T * scale + bias [masked])) @ v`` in q's
    dtype, differentiable (the backward kernels recompute the scores from
    the saved logsumexp and regenerate the dropout mask from its hash).

    ``bias`` is an additive logit bias ``[b|1, n|1, s_q|1, s_k]`` (a pair
    bias, ALiBi, a folded additive mask); its gradient is one fp32
    ``[b, n, s_q, s_k]`` buffer summed over the broadcast dims. Pass
    ``bias_grad=False`` for a constant bias: the backward then writes no
    such buffer and the bias's cotangent is zeros."""
    scale, seed = _resolve(q, scale, dropout_p, dropout_seed)
    # the kernels run in one dtype: k and v follow q, as in the JAX module
    k, v = k.to(q.dtype), v.to(q.dtype)
    if bias is not None:
        _check_bias(bias, q, k)
        if bias.dtype not in (torch.float32, q.dtype):
            bias = bias.float()  # the kernels read fp32 or q's dtype
    return _FlashAttention.apply(q, k, v, kv_mask, bias, None, None,
                                 bool(causal), scale, float(dropout_p), seed,
                                 bool(bias_grad))


def flash_attention_sbhd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         **kw) -> torch.Tensor:
    """Megatron ``[s, b, n, d]`` layout wrapper -> context
    ``[s, b, n, d]``."""
    qt, kt, vt = (t.permute(1, 2, 0, 3) for t in (q, k, v))
    return flash_attention(qt, kt, vt, **kw).permute(2, 0, 1, 3)


def flash_attention_varlen(q: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor, cu_seqlens: torch.Tensor, *,
                           causal: bool = False,
                           scale: Optional[float] = None,
                           dropout_p: float = 0.0,
                           dropout_seed=None) -> torch.Tensor:
    """Packed variable-length self-attention over ``[total, n, d]`` with
    ``cu_seqlens [b+1]`` (``cu_seqlens[0] == 0``): tokens attend only
    within their own sequence (segment ids from
    :func:`segment_ids_from_cu_seqlens`; tokens past ``cu_seqlens[-1]``
    form one padding segment); causal uses the packed order, which is the
    local order inside each segment. The kernels walk only the tiles of
    each query tile's own segments, so the cost follows the sum of the
    squared lengths."""
    total, n, d = q.shape
    scale, seed = _resolve(q, scale, dropout_p, dropout_seed)
    segs = segment_ids_from_cu_seqlens(cu_seqlens, total)
    qb, kb, vb = (t.to(q.dtype).transpose(0, 1)[None] for t in (q, k, v))
    o = _FlashAttention.apply(qb, kb, vb, None, None, segs, segs,
                              bool(causal), scale, float(dropout_p), seed,
                              False)
    return o[0].transpose(0, 1)  # [total, n, d]
