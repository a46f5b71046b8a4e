"""Context parallelism: ring attention and Ulysses all-to-all attention
(counterpart of ``apex_tpu/transformer/context_parallel.py``).

The sequence is sharded over a context-parallel group of processes end
to end, so each rank holds ``s / cp`` tokens inside attention too:

- :func:`ring_attention`: the K/V shards rotate around the group's ring
  (``p2p_communication.exchange``: one ``batch_isend_irecv`` a hop, each
  rank sending to the next and receiving from the previous). Each step
  runs the flash kernel on (local Q x visiting K/V) and merges the
  partial results by their log-sum-exp (:func:`_merge`). The backward is
  the flash-attention-2 chunked scheme with the **global** ``o`` and
  ``lse``: each chunk's ``(dq, dk, dv)`` from the flash backward given
  them, ``dq`` summed in fp32 on the rank, the fp32 ``dk`` / ``dv``
  sums travelling with their K/V chunk and taking a last hop home. It is
  one ``torch.autograd.Function`` with that explicit backward, where the
  JAX package writes a ``custom_vjp``.
- :func:`ulysses_attention`: ``all_to_all_single`` swaps the sharded dim
  (sequence to heads), flash attention runs on the whole sequence with
  ``n / cp`` heads, and the reverse all-to-all restores the sequence
  shards; its backward is the reverse all-to-all.

On CUDA tensors every chunk runs the flash kernels (``_launch_fwd`` /
``_launch_bwd`` of ``ops/flash_attention.py``); on CPU tensors their plain
versions, ``flash_attention_fwd_reference`` / ``_bwd_reference``.

Causal ring: step 0 is the local causal block; step ``t > 0`` visits the
chunk of rank ``(i - t) mod cp``, which lies wholly in the past for
ranks ``i >= t`` and wholly in the future otherwise. The rank is a host
integer, so a future chunk is skipped instead of run under an all-zero
key mask (it contributes nothing either way). ``zigzag=True`` assumes
the layout of :func:`zigzag_indices` (rank ``r`` holds global chunks
``(r, 2 cp - 1 - r)``), where every step carries two live half-chunk
attentions on every rank.

An ``axis_name`` names a ``parallel_state`` axis, or is any name when
model parallelism is not initialised (the default group, the whole
world), or a ``ProcessGroup``; without a process group the world is one
rank and both functions are flash attention. On a gloo group the ring's
CUDA tensors cross through host memory, as ``p2p_communication`` stages
them; Ulysses' ``all_to_all_single`` takes them as they lie.
"""
from __future__ import annotations

import importlib
import math
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from .pipeline_parallel.p2p_communication import AxisGroup, exchange

# the module (the package re-exports the function under its name)
_fa = importlib.import_module("..ops.flash_attention", __package__)

#: K/V bytes the ring hops sent (forward and backward), since
#: :func:`reset_ring_counts`
RING_COUNTS = {"hops": 0, "bytes": 0, "chunks_fwd": 0, "chunks_bwd": 0,
               "skipped": 0}


def reset_ring_counts() -> None:
    for k in RING_COUNTS:
        RING_COUNTS[k] = 0


def _chunk_fwd(q, k, v, scale, causal):
    """``(o, lse)`` of one chunk: the flash forward kernel on CUDA
    tensors, its plain version on CPU tensors."""
    RING_COUNTS["chunks_fwd"] += 1
    return _fa._fwd_impl(q, k, v, None, None, None, None, causal, scale,
                         0.0, None)


def _chunk_bwd(q, k, v, o, lse, do, scale, causal):
    """``(dq, dk, dv)`` of one chunk given the GLOBAL ``(o, lse, do)``."""
    RING_COUNTS["chunks_bwd"] += 1
    dq, dk, dv, _ = _fa._bwd(q, k, v, o, lse, do, None, None, None, None,
                             causal, scale, 0.0, None, False)
    return dq, dk, dv


def _merge(o_acc, lse_acc, o_j, lse_j):
    """Online-softmax merge of two normalised partials by their lse; rows
    masked so far (both at the ``-1e30`` sentinel) keep a zero output."""
    lse_new = torch.logaddexp(lse_acc, lse_j)
    w_acc = torch.exp(lse_acc - lse_new)[..., None]
    w_j = torch.exp(lse_j - lse_new)[..., None]
    return o_acc * w_acc + o_j.to(o_acc.dtype) * w_j, lse_new


def zigzag_indices(s: int, cp: int):
    """Permutation laying the global sequence out in zigzag order: with
    ``2 cp`` equal chunks, rank ``r`` owns chunks ``(r, 2 cp - 1 - r)``.
    Returns ``(perm, inv_perm)`` int64 numpy arrays of length ``s``
    (the JAX function's, bit for bit)."""
    if s % (2 * cp) != 0:
        raise ValueError(f"seq {s} must divide into 2*cp={2 * cp} chunks")
    h = s // (2 * cp)
    order = []
    for r in range(cp):
        order.extend([r, 2 * cp - 1 - r])
    perm = np.concatenate([np.arange(c * h, (c + 1) * h) for c in order])
    inv = np.empty_like(perm)
    inv[perm] = np.arange(s)
    return perm, inv


def _empty(t):
    return torch.empty(t.shape, dtype=t.dtype, device=t.device)


def _shift(ax: AxisGroup, *tensors):
    """Every tensor one hop up the ring (rank i to i + 1)."""
    if ax.size == 1:
        return tensors
    out = [_empty(t) for t in tensors]
    exchange(ax, [(t, ax.next(), i) for i, t in enumerate(tensors)],
             [(o, ax.prev(), i) for i, o in enumerate(out)])
    RING_COUNTS["hops"] += 1
    RING_COUNTS["bytes"] += sum(t.numel() * t.element_size()
                                for t in tensors)
    return tuple(out)


def _cat(*ts):
    return torch.cat(ts, dim=0)


def _ring_fwd_plain(ax, q, k, v, causal, scale):
    b, n, s_loc, d = q.shape
    o_acc = torch.zeros((b, n, s_loc, d), dtype=torch.float32,
                        device=q.device)
    lse_acc = torch.full((b, n, s_loc), -1e30, dtype=torch.float32,
                         device=q.device)
    k_t, v_t = k, v
    for t in range(ax.size):
        if causal and t > 0 and ax.index < t:
            RING_COUNTS["skipped"] += 1  # the chunk lies in the future
        else:
            o_j, lse_j = _chunk_fwd(q, k_t, v_t, scale, causal and t == 0)
            o_acc, lse_acc = _merge(o_acc, lse_acc, o_j, lse_j)
        if t != ax.size - 1:
            k_t, v_t = _shift(ax, k_t, v_t)
    return o_acc.to(q.dtype), lse_acc


def _ring_bwd_plain(ax, q, k, v, o, lse, do, causal, scale):
    dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    k_t, v_t = k, v
    dk_t = torch.zeros(k.shape, dtype=torch.float32, device=k.device)
    dv_t = torch.zeros(v.shape, dtype=torch.float32, device=v.device)
    for t in range(ax.size):
        if not (causal and t > 0 and ax.index < t):
            dq_j, dk_j, dv_j = _chunk_bwd(q, k_t, v_t, o, lse, do, scale,
                                          causal and t == 0)
            dq += dq_j.float()
            dk_t += dk_j.float()
            dv_t += dv_j.float()
        # the dK/dV sums travel with their chunk and take the last hop home
        if t != ax.size - 1:
            k_t, v_t, dk_t, dv_t = _shift(ax, k_t, v_t, dk_t, dv_t)
        else:
            dk_t, dv_t = _shift(ax, dk_t, dv_t)
    return dq.to(q.dtype), dk_t.to(k.dtype), dv_t.to(v.dtype)


def _halves(t, h):
    return t[:, :, :h], t[:, :, h:]


def _ring_fwd_zigzag(ax, q, k, v, scale):
    b, n, s_loc, d = q.shape
    if s_loc % 2 != 0:
        raise ValueError("zigzag needs an even local sequence length")
    h = s_loc // 2
    i = ax.index
    q1, q2 = _halves(q, h)
    f32 = dict(dtype=torch.float32, device=q.device)
    o1, o2 = torch.zeros((b, n, h, d), **f32), torch.zeros((b, n, h, d),
                                                            **f32)
    l1, l2 = torch.full((b, n, h), -1e30, **f32), torch.full((b, n, h),
                                                             -1e30, **f32)
    k_t, v_t = k, v
    for t in range(ax.size):
        k1, k2 = _halves(k_t, h)
        v1, v2 = _halves(v_t, h)
        if t == 0:  # the two diagonals causal, q2 x kv1 whole
            oAD, lAD = _chunk_fwd(_cat(q1, q2), _cat(k1, k2), _cat(v1, v2),
                                  scale, True)
            oC, lC = _chunk_fwd(q2, k1, v1, scale, False)
            o1, l1 = _merge(o1, l1, oAD[:b], lAD[:b])
            o2, l2 = _merge(o2, l2, oAD[b:], lAD[b:])
        else:
            # the live pair: A = q1 x kv1 where the visiting chunk is in
            # the past (i >= t), else D = q2 x kv2; stacked with C
            a = i >= t
            o, l = _chunk_fwd(_cat(q1 if a else q2, q2),
                              _cat(k1 if a else k2, k1),
                              _cat(v1 if a else v2, v1), scale, False)
            if a:
                o1, l1 = _merge(o1, l1, o[:b], l[:b])
            else:
                o2, l2 = _merge(o2, l2, o[:b], l[:b])
            oC, lC = o[b:], l[b:]
        o2, l2 = _merge(o2, l2, oC, lC)
        if t != ax.size - 1:
            k_t, v_t = _shift(ax, k_t, v_t)
    return (torch.cat([o1, o2], dim=2).to(q.dtype),
            torch.cat([l1, l2], dim=2))


def _ring_bwd_zigzag(ax, q, k, v, o, lse, do, scale):
    b = q.shape[0]
    h = q.shape[2] // 2
    i = ax.index
    q1, q2 = _halves(q, h)
    o1, o2 = _halves(o, h)
    l1, l2 = lse[:, :, :h], lse[:, :, h:]
    do1, do2 = _halves(do, h)
    dq1 = torch.zeros(q1.shape, dtype=torch.float32, device=q.device)
    dq2 = torch.zeros(q2.shape, dtype=torch.float32, device=q.device)
    k_t, v_t = k, v
    dk_t = torch.zeros(k.shape, dtype=torch.float32, device=k.device)
    dv_t = torch.zeros(v.shape, dtype=torch.float32, device=v.device)
    for t in range(ax.size):
        k1, k2 = _halves(k_t, h)
        v1, v2 = _halves(v_t, h)
        if t == 0:
            dqAD, dkAD, dvAD = _chunk_bwd(
                _cat(q1, q2), _cat(k1, k2), _cat(v1, v2), _cat(o1, o2),
                _cat(l1, l2), _cat(do1, do2), scale, True)
            dqC, dkC, dvC = _chunk_bwd(q2, k1, v1, o2, l2, do2, scale,
                                       False)
            dq1 += dqAD[:b].float()
            dq2 += dqAD[b:].float() + dqC.float()
            dk1 = dkAD[:b].float() + dkC.float()
            dk2 = dkAD[b:].float()
            dv1 = dvAD[:b].float() + dvC.float()
            dv2 = dvAD[b:].float()
        else:
            a = i >= t
            dqS, dkS, dvS = _chunk_bwd(
                _cat(q1 if a else q2, q2), _cat(k1 if a else k2, k1),
                _cat(v1 if a else v2, v1), _cat(o1 if a else o2, o2),
                _cat(l1 if a else l2, l2), _cat(do1 if a else do2, do2),
                scale, False)
            zero = torch.zeros_like(dq1)
            if a:
                dq1 += dqS[:b].float()
            else:
                dq2 += dqS[:b].float()
            dq2 += dqS[b:].float()
            dk1 = (dkS[:b].float() if a else zero) + dkS[b:].float()
            dk2 = zero if a else dkS[:b].float()
            dv1 = (dvS[:b].float() if a else zero) + dvS[b:].float()
            dv2 = zero if a else dvS[:b].float()
        dk_t += torch.cat([dk1, dk2], dim=2)
        dv_t += torch.cat([dv1, dv2], dim=2)
        if t != ax.size - 1:
            k_t, v_t, dk_t, dv_t = _shift(ax, k_t, v_t, dk_t, dv_t)
        else:
            dk_t, dv_t = _shift(ax, dk_t, dv_t)
    dq = torch.cat([dq1, dq2], dim=2)
    return dq.to(q.dtype), dk_t.to(k.dtype), dv_t.to(v.dtype)


class _Ring(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, ax, causal, scale, zigzag):
        if zigzag and causal:
            o, lse = _ring_fwd_zigzag(ax, q, k, v, scale)
        else:
            o, lse = _ring_fwd_plain(ax, q, k, v, causal, scale)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.cfg = (ax, causal, scale, zigzag)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        ax, causal, scale, zigzag = ctx.cfg
        do = do.contiguous()
        if zigzag and causal:
            grads = _ring_bwd_zigzag(ax, q, k, v, o, lse, do, scale)
        else:
            grads = _ring_bwd_plain(ax, q, k, v, o, lse, do, causal, scale)
        return (*grads, None, None, None, None)


def ring_attention(
    q: torch.Tensor,  # [b, n, s_local, d]: this rank's sequence shard
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    axis_name,
    causal: bool = False,
    zigzag: bool = False,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Ring attention over the ranks of ``axis_name``. The shards lie
    contiguously by rank (global position ``rank * s_local + local``,
    which causal masking uses), or with ``zigzag=True`` (causal only; the
    flag is ignored otherwise, as in the JAX function) in the layout of
    :func:`zigzag_indices`. Returns this rank's output shard in q's
    dtype. No dropout on this path: apply it outside attention, or use
    :func:`ulysses_attention`. The JAX function's ``block_q``,
    ``block_k`` and ``interpret`` pick Pallas tiles and its interpreter;
    the kernels here pick their tiles, and CPU tensors run the plain
    versions."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    q = q.contiguous()
    k, v = k.to(q.dtype).contiguous(), v.to(q.dtype).contiguous()
    return _Ring.apply(q, k, v, AxisGroup(axis_name), bool(causal),
                       float(scale), bool(zigzag))


class _AllToAll(torch.autograd.Function):
    """Split ``split`` into the group's ranks and concatenate what they
    send along ``concat`` (the tiled ``jax.lax.all_to_all``); backward
    the same with the two dims swapped."""

    @staticmethod
    def forward(ctx, x, ax, split, concat):
        ctx.cfg = (ax, split, concat)
        return _all_to_all(x, ax, split, concat)

    @staticmethod
    def backward(ctx, g):
        ax, split, concat = ctx.cfg
        return _all_to_all(g, ax, concat, split), None, None, None


def _all_to_all(x, ax: AxisGroup, split: int, concat: int):
    cp = ax.size
    if cp == 1:
        return x
    parts = torch.stack(x.chunk(cp, dim=split)).contiguous()
    out = torch.empty_like(parts)
    dist.all_to_all_single(out, parts, group=ax.group)
    return torch.cat(out.unbind(0), dim=concat)


def ulysses_attention(
    q: torch.Tensor,  # [b, n, s_local, d]
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    axis_name,
    causal: bool = False,
    scale: Optional[float] = None,
    dropout_p: float = 0.0,
    dropout_seed=None,
) -> torch.Tensor:
    """DeepSpeed-Ulysses attention: all-to-all from sequence to head
    shards, flash attention over the whole sequence with ``n / cp``
    heads, all-to-all back. Requires ``n % cp == 0``. With dropout the
    seed is offset by the rank (``seed + rank * 0x632BE5AB``, int32), so
    the ranks' head shards draw different masks, as in the JAX
    function. The all-to-all takes the tensors as they lie (gloo stages
    CUDA tensors through host memory itself)."""
    ax = AxisGroup(axis_name)
    cp = ax.size
    n = q.shape[1]
    if n % cp != 0:
        raise ValueError(
            f"ulysses needs heads ({n}) divisible by axis {axis_name!r} "
            f"size ({cp}); use ring_attention otherwise")
    seed = None
    if dropout_p > 0.0:
        if dropout_seed is None:
            raise ValueError("dropout_p > 0 requires dropout_seed")
        seed = _fa._i32(int(dropout_seed) + ax.index * 0x632BE5AB)
    qh, kh, vh = (_AllToAll.apply(t, ax, 1, 2) for t in (q, k, v))
    o = _fa.flash_attention(qh, kh, vh, causal=causal, scale=scale,
                            dropout_p=dropout_p, dropout_seed=seed)
    return _AllToAll.apply(o, ax, 2, 1)


def ring_attention_reference(q, k, v, *, causal=False, scale=None):
    """Dense single-device reference on the whole sequence (tests)."""
    return _fa.mha_reference(q, k, v, causal=causal, scale=scale)
