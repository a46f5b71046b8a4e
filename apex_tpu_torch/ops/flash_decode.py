"""Flash decode: single-query attention over a paged KV cache — a CUDA
kernel for Hopper and its plain PyTorch version (counterpart of
``apex_tpu/ops/flash_decode.py``).

Layouts (head-major pages, as in the JAX package):

- ``q``          ``[n_slots, n_heads, head_dim]``
- ``k_pages``    ``[n_pages, n_heads, page_size, head_dim]``
- ``v_pages``    ``[n_pages, n_heads, page_size, head_dim]``
- ``page_table`` ``[n_slots, pages_per_seq]`` int32
- ``kv_lens``    ``[n_slots]`` int32 (valid tokens; 0 = inactive slot)

Rows with ``kv_lens == 0`` output zeros. Page-table entries past a
slot's length must still be valid pool indices (the serving layer
points them at the garbage page 0); the kernel never reads them, the
plain version gathers them and masks them off.

The kernel is ``csrc/flash_decode.cu`` (it replaces the TPU kernel
``_decode_pallas``); :func:`paged_decode_reference` is the plain
version (the math of ``_decode_xla``). Route: a CUDA tensor goes
through the kernel, a CPU tensor through the plain version
(``_device.kernel_route``). Neither route casts the pool: mixed dtypes
(f32 q over bf16 pages) are handled inside each.

The kernel splits the token axis (split-K): :func:`decode_plan` picks the
split count (at most :data:`DECODE_MAX_SPLITS`) from the static
``pages_per_seq * page_size`` and the card's SM count, never from
``kv_lens`` (reading them would synchronise the serving step); the
splits of one (slot, head) run as one thread block cluster and merge
through shared memory in split order. :func:`_decode_split_plain` is the
plain model of that split and merge.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from .. import _build, _device

_NEG_INF = -1e30
#: splits of at least this many tokens (where the context allows)
DECODE_MIN_SPLIT = 64
#: at most this many splits: a (slot, head)'s splits are one thread block
#: cluster, whose portable size limit is 8
DECODE_MAX_SPLITS = 8
#: splits until the grid holds about this many blocks an SM: at 8 slots x
#: 1024 tokens 4 (5 splits) ran faster than 2, 6, 8 or 16 (H100 80GB HBM3,
#: 700 W)
_DECODE_BLOCKS_PER_SM = 4


class DecodePlan(NamedTuple):
    """The kernel's split of the token axis: ``splits`` splits of
    ``split_len`` tokens, split ``s`` covering ``[s * split_len, (s + 1) *
    split_len)``; ``splits * split_len`` covers ``pages_per_seq *
    page_size`` and no split starts past it."""
    splits: int
    split_len: int


def decode_plan(n_slots: int, n_heads: int, page_size: int,
                pages_per_seq: int, n_sms: int) -> DecodePlan:
    """Split the longest context a slot can hold, ``pages_per_seq *
    page_size`` tokens, into whole pages so that ``n_slots * n_heads *
    splits`` blocks come near :data:`_DECODE_BLOCKS_PER_SM` an SM, each
    split at least :data:`DECODE_MIN_SPLIT` tokens and at most
    :data:`DECODE_MAX_SPLITS` splits (one split when the (slot, head)
    pairs alone fill the card)."""
    t_max = page_size * pages_per_seq
    want = -(-_DECODE_BLOCKS_PER_SM * n_sms // max(1, n_slots * n_heads))
    n = max(1, min(want, t_max // DECODE_MIN_SPLIT, DECODE_MAX_SPLITS))
    split_len = max(1, -(-pages_per_seq // n)) * page_size
    return DecodePlan(max(1, -(-t_max // split_len)), split_len)


def flash_decode_available(page_size: int, head_dim: int) -> bool:
    """The shapes the kernel takes: ``page_size % 8 == 0`` and
    ``head_dim <= 256`` (the JAX package's rule, kept so a shape the
    TPU kernel refused is refused here too)."""
    return page_size % 8 == 0 and head_dim <= 256


def _decode_plain(q, k_pages, v_pages, page_table, kv_lens, scale):
    b, n, d = q.shape
    ps = k_pages.shape[2]
    mp = page_table.shape[1]
    pt = page_table.long()
    k = k_pages[pt]  # [b, mp, n, ps, d]
    v = v_pages[pt]
    s = torch.einsum("bnd,bmnpd->bnmp", q.float() * scale,
                     k.float()).reshape(b, n, mp * ps)
    pos = torch.arange(mp * ps, device=q.device)
    live = pos[None, None, :] < kv_lens.long()[:, None, None]
    s = torch.where(live, s, _NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    # fully-masked rows (kv_len == 0): zeros out, matching the kernel
    m_safe = torch.where(m <= _NEG_INF / 2, 0.0, m)
    p = torch.exp(s - m_safe)
    p = torch.where(s <= _NEG_INF / 2, 0.0, p)
    l = p.sum(dim=-1, keepdim=True)
    vv = v.float().permute(0, 2, 1, 3, 4).reshape(b, n, mp * ps, d)
    ctx = torch.einsum("bnk,bnkd->bnd", p, vv)
    return (ctx / l.clamp(min=1e-37)).to(q.dtype) * (l > 0.0).to(q.dtype)


def paged_decode_reference(q, k_pages, v_pages, page_table, kv_lens,
                           scale: Optional[float] = None) -> torch.Tensor:
    """Plain version: dense softmax over the gathered pages with the
    zeros-for-empty-slots convention (any device)."""
    if scale is None:
        scale = 1.0 / (q.shape[-1] ** 0.5)
    return _decode_plain(q, k_pages, v_pages, page_table, kv_lens,
                         float(scale))


def _decode_split_plain(q, k_pages, v_pages, page_table, kv_lens,
                        scale: float, split_len: int) -> torch.Tensor:
    """Plain model of the kernel's split and merge: each split of
    ``split_len`` tokens holds a base-2 softmax state ``(m, l, acc)`` over
    its live tokens (scale * log2(e) folded into q; a split past its
    slot's length holds ``l = 0``); the merge takes the largest ``m`` of
    the live splits and adds their rescaled ``acc`` and ``l`` in split
    order; a slot with no live token gives zeros."""
    b, n, d = q.shape
    ps = k_pages.shape[2]
    t_max = page_table.shape[1] * ps
    pt = page_table.long()
    k = k_pages[pt].float().permute(0, 2, 1, 3, 4).reshape(b, n, t_max, d)
    v = v_pages[pt].float().permute(0, 2, 1, 3, 4).reshape(b, n, t_max, d)
    s = torch.einsum("bnd,bntd->bnt", q.float() * (scale * math.log2(math.e)),
                     k)
    pos = torch.arange(t_max, device=q.device)
    lens = kv_lens.long()[:, None, None]
    states = []
    for lo in range(0, t_max, split_len):
        live = (pos >= lo) & (pos < lo + split_len) & (pos < lens)
        m_s = torch.where(live, s, -math.inf).amax(dim=-1)
        p = torch.where(live, torch.exp2(s - torch.where(
            m_s.isinf(), 0.0, m_s)[..., None]), 0.0)
        states.append((m_s, p.sum(dim=-1),
                       torch.einsum("bnt,bntd->bnd", p, v)))
    mx = torch.full((b, n), -math.inf, device=q.device)
    for m_s, l_s, _ in states:
        mx = torch.where(l_s > 0, torch.maximum(mx, m_s), mx)
    num = torch.zeros((b, n, d), device=q.device)
    den = torch.zeros((b, n), device=q.device)
    for m_s, l_s, acc_s in states:  # split order
        c = torch.where(l_s > 0, torch.exp2(m_s - mx), 0.0)
        num = num + c[..., None] * acc_s
        den = den + c * l_s
    out = num / torch.where(den > 0, den, 1.0)[..., None]
    return out.to(q.dtype)


_KV_DTYPES = {(torch.float32, torch.float32), (torch.bfloat16, torch.bfloat16),
              (torch.float16, torch.float16), (torch.float32, torch.bfloat16),
              (torch.float32, torch.float16)}


def _launch(q, k_pages, v_pages, page_table, kv_lens, scale: float,
            plan: Optional[DecodePlan] = None) -> torch.Tensor:
    """Launch ``csrc/flash_decode.cu`` on CUDA tensors. q/pages may be
    f32/f32, bf16/bf16, f16/f16, f32/bf16 or f32/f16; every tensor
    contiguous. ``plan``
    defaults to :func:`decode_plan` for the card."""
    if (q.dtype, k_pages.dtype) not in _KV_DTYPES:
        raise TypeError(
            f"flash_decode kernel takes q/pages f32/f32, bf16/bf16, f16/f16, "
            f"f32/bf16 or f32/f16, got {q.dtype}/{k_pages.dtype}")
    for t in (q, k_pages, v_pages, page_table, kv_lens):
        if not t.is_contiguous():
            raise ValueError("flash_decode kernel needs contiguous tensors")
    if page_table.dtype != torch.int32 or kv_lens.dtype != torch.int32:
        raise TypeError("page_table and kv_lens must be int32")
    b, n, d = q.shape
    _, _, ps, _ = k_pages.shape
    mp = page_table.shape[1]
    if tuple(page_table.shape) != (b, mp) or tuple(kv_lens.shape) != (b,):
        raise ValueError(
            f"page_table {tuple(page_table.shape)} / kv_lens "
            f"{tuple(kv_lens.shape)} do not match {b} slots")
    lib = _build.kernels()
    out = torch.empty_like(q)
    dev = q.device
    plan = plan or decode_plan(b, n, ps, mp, _build.sm_count(dev.index))
    rc = lib.apex_flash_decode(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        page_table.data_ptr(), kv_lens.data_ptr(), out.data_ptr(), b, n, d,
        ps, mp, plan.splits, plan.split_len, float(scale),
        _build.dtype_code(q), _build.dtype_code(k_pages),
        dev.index, _build.current_stream(dev))
    _build.check(rc, "flash_decode")
    _device.LAUNCHES["flash_decode"] += 1
    return out


def flash_decode(q: torch.Tensor, k_pages: torch.Tensor,
                 v_pages: torch.Tensor, page_table: torch.Tensor,
                 kv_lens: torch.Tensor, *,
                 scale: Optional[float] = None) -> torch.Tensor:
    """Single-query paged attention: ``softmax(q @ K_pages^T * scale)
    @ V_pages`` per slot. Returns ``[n_slots, n_heads, head_dim]`` in
    ``q.dtype``; slots with ``kv_lens == 0`` return zeros."""
    if scale is None:
        scale = 1.0 / (q.shape[-1] ** 0.5)
    if k_pages.shape != v_pages.shape:
        raise ValueError(
            f"k_pages {tuple(k_pages.shape)} and v_pages "
            f"{tuple(v_pages.shape)} differ")
    if k_pages.shape[1] != q.shape[1] or k_pages.shape[3] != q.shape[2]:
        raise ValueError(
            f"pages [P, n, ps, d] = {tuple(k_pages.shape)} do not match q "
            f"[b, n, d] = {tuple(q.shape)}")
    if not _device.kernel_route(q, k_pages, v_pages, page_table, kv_lens):
        return _decode_plain(q, k_pages, v_pages, page_table, kv_lens,
                             float(scale))
    if not flash_decode_available(k_pages.shape[2], q.shape[2]):
        raise ValueError(
            f"flash_decode kernel needs page_size {k_pages.shape[2]} % 8 "
            f"== 0 and head_dim {q.shape[2]} <= 256")
    return _launch(
        q.contiguous(), k_pages.contiguous(), v_pages.contiguous(),
        page_table.to(torch.int32).contiguous(),
        kv_lens.to(torch.int32).contiguous(), float(scale))
