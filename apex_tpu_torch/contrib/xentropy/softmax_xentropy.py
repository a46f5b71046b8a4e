"""Softmax cross entropy and the chunk-fused LM-head GEMM + cross
entropy (counterpart of ``apex_tpu/contrib/xentropy/softmax_xentropy.py``:
``softmax_cross_entropy_loss``, ``SoftmaxCrossEntropyLoss``,
``lm_head_cross_entropy`` and ``_lm_head_ce_saved``).

:func:`softmax_cross_entropy_loss` is the label-smoothed cross entropy
of the reference's xentropy kernel, in plain PyTorch as the JAX package
has it in plain XLA. :func:`lm_logits` is the tied head's fp32 logits
(:func:`logits_f32`) as a differentiable function, for a loss over
whole logits (BERT's MLM loss).

Per-row losses ``logsumexp(h @ W^T) - (h @ W^T)[label]`` without the
``[N, vocab]`` fp32 logits ever being whole in memory: rows go through
in chunks, each chunk's fp32 logits come from the GEMM in the
activations' dtype with fp32 accumulation and output
(:func:`logits_f32`), and are reduced to ``lse - gold`` at once. Two
``torch.autograd.Function``s, as the JAX package has two variants:

- recompute (``save_logits_dtype=None``): the backward recomputes each
  chunk's logits (the JAX ``jax.checkpoint`` per chunk);
- saved logits (``save_logits_dtype=torch.bfloat16``, the bench's choice
  without remat): the forward keeps each chunk's logits in that dtype
  (``[N, vocab]`` in total, half the fp32 footprint at bf16) and the
  loss is the cross entropy of those rounded logits; the backward reads
  them instead of repeating the GEMM.

In both backward passes ``d logits = (softmax - onehot) * dloss`` is cast
to the activations' dtype before the two GEMMs (d hidden and d weight),
and d weight is summed over chunks in fp32, then cast to the weight's
dtype. The GEMMs are ``torch.mm`` (cuBLAS on the card), as the JAX
package left them to XLA.
"""
from __future__ import annotations

from typing import Optional

import torch


def logits_f32(h: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``h [c, k] @ w [v, k]^T`` with fp32 accumulation and fp32 output.
    On the card a bf16 GEMM writes fp32 directly (``out_dtype``), reading
    the bf16 operands as they are; elsewhere both go through fp32, which
    for bf16 operands is the same arithmetic."""
    w = w.to(h.dtype)
    if h.is_cuda and h.dtype != torch.float32:
        return torch.mm(h, w.t(), out_dtype=torch.float32)
    return h.float() @ w.float().t()


def _mm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` with fp32 accumulation and fp32 output."""
    if a.is_cuda and a.dtype != torch.float32:
        return torch.mm(a, b, out_dtype=torch.float32)
    return a.float() @ b.float()


class _LmLogits(torch.autograd.Function):
    """:func:`logits_f32` with the backward of the chunked CE: the fp32
    cotangent is cast to h's dtype for both GEMMs, d weight accumulates
    in fp32 and is cast to the weight's dtype."""

    @staticmethod
    def forward(ctx, h, w):
        ctx.save_for_backward(h, w)
        return logits_f32(h, w)

    @staticmethod
    def backward(ctx, g):
        h, w = ctx.saved_tensors
        g = g.to(h.dtype)
        return torch.mm(g, w.to(h.dtype)), _mm_f32(g.t(), h).to(w.dtype)


def lm_logits(h: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Differentiable ``h [c, k] @ w [v, k]^T`` with fp32 accumulation
    and fp32 output (:func:`logits_f32`)."""
    return _LmLogits.apply(h, w)


def softmax_cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor,
                               smoothing: float = 0.0, padding_idx: int = 0,
                               half_to_float: bool = False) -> torch.Tensor:
    """Per-example smoothed cross entropy: ``(N, K)`` logits and ``(N,)``
    integer labels -> ``(N,)`` fp32 losses ``smoothing * (lse - mean(x))
    + (1 - smoothing) * (lse - x[label])``, zero (and zero gradient)
    where ``labels == padding_idx``. A negative label indexes from the
    end, as ``take_along_axis`` does, before the padding zeroes it.
    ``half_to_float`` is accepted for parity: the losses are always
    fp32."""
    del half_to_float
    x = logits.float()
    labels = labels.long()
    lse = torch.logsumexp(x, dim=-1)
    idx = torch.where(labels < 0, labels + x.shape[-1], labels)
    loss = lse - x.gather(-1, idx[:, None])[:, 0]
    if smoothing:
        loss = smoothing * (lse - x.mean(dim=-1)) + (1.0 - smoothing) * loss
    return torch.where(labels == padding_idx, 0.0, loss)


class SoftmaxCrossEntropyLoss:
    """The reference's ``SoftmaxCrossEntropyLoss.apply(logits, labels,
    ...)`` spelling of :func:`softmax_cross_entropy_loss`."""

    @staticmethod
    def apply(logits, labels, smoothing=0.0, padding_idx=0,
              half_to_float=False):
        return softmax_cross_entropy_loss(logits, labels, smoothing,
                                          padding_idx, half_to_float)


def _chunks(n: int, chunk_size: int):
    return range(0, n, chunk_size)


def _ce_backward(get_logits, lse, hidden, weight, labels, g, chunk_size):
    """Shared backward: per chunk dlogits = (exp(logits - lse) - onehot)
    * g in fp32, cast to hidden's dtype; d hidden per chunk, d weight
    summed over chunks in fp32."""
    n = hidden.shape[0]
    w_c = weight.to(hidden.dtype)
    dh = torch.empty_like(hidden)
    dw = torch.zeros(weight.shape, dtype=torch.float32,
                     device=hidden.device)
    for c0 in _chunks(n, chunk_size):
        sl = slice(c0, c0 + chunk_size)
        p = torch.exp(get_logits(sl) - lse[sl, None])
        p[torch.arange(p.shape[0], device=p.device), labels[sl]] -= 1.0
        dlogits = (p * g[sl, None]).to(hidden.dtype)
        dh[sl] = torch.mm(dlogits, w_c)
        dw += _mm_f32(dlogits.t(), hidden[sl])
    return dh, dw.to(weight.dtype)


class _LmHeadCE(torch.autograd.Function):
    """Recompute variant: saves hidden, weight, labels and the per-row
    lse; the backward repeats each chunk's GEMM."""

    @staticmethod
    def forward(ctx, hidden, weight, labels, chunk_size):
        n = hidden.shape[0]
        losses = torch.empty(n, dtype=torch.float32, device=hidden.device)
        lse = torch.empty_like(losses)
        for c0 in _chunks(n, chunk_size):
            sl = slice(c0, c0 + chunk_size)
            logits = logits_f32(hidden[sl], weight)
            lse[sl] = torch.logsumexp(logits, dim=-1)
            gold = logits.gather(1, labels[sl, None])[:, 0]
            losses[sl] = lse[sl] - gold
        ctx.save_for_backward(hidden, weight, labels, lse)
        ctx.chunk_size = chunk_size
        return losses

    @staticmethod
    def backward(ctx, g):
        hidden, weight, labels, lse = ctx.saved_tensors
        dh, dw = _ce_backward(
            lambda sl: logits_f32(hidden[sl], weight), lse, hidden, weight,
            labels, g, ctx.chunk_size)
        return dh, dw, None, None


class _LmHeadCESaved(torch.autograd.Function):
    """Saved-logits variant: the forward keeps every chunk's logits in
    ``logits_dtype``; the loss is the CE of those rounded logits."""

    @staticmethod
    def forward(ctx, hidden, weight, labels, chunk_size, logits_dtype):
        n = hidden.shape[0]
        saved = torch.empty((n, weight.shape[0]), dtype=logits_dtype,
                            device=hidden.device)
        losses = torch.empty(n, dtype=torch.float32, device=hidden.device)
        lse = torch.empty_like(losses)
        for c0 in _chunks(n, chunk_size):
            sl = slice(c0, c0 + chunk_size)
            saved[sl] = logits_f32(hidden[sl], weight)
            lf = saved[sl].float()
            lse[sl] = torch.logsumexp(lf, dim=-1)
            losses[sl] = lse[sl] - lf.gather(1, labels[sl, None])[:, 0]
        ctx.save_for_backward(hidden, weight, labels, saved, lse)
        ctx.chunk_size = chunk_size
        return losses

    @staticmethod
    def backward(ctx, g):
        hidden, weight, labels, saved, lse = ctx.saved_tensors
        dh, dw = _ce_backward(lambda sl: saved[sl].float(), lse, hidden,
                              weight, labels, g, ctx.chunk_size)
        return dh, dw, None, None, None


def lm_head_cross_entropy(hidden: torch.Tensor, head_weight: torch.Tensor,
                          labels: torch.Tensor, *, chunk_size: int = 2048,
                          save_logits_dtype: Optional[torch.dtype] = None
                          ) -> torch.Tensor:
    """Per-row losses ``[N]`` fp32 of the tied-embedding head
    ``hidden [N, h] @ head_weight [V, h]^T`` against ``labels [N]``,
    ``chunk_size`` rows at a time (``N`` must be a multiple of it)."""
    n = hidden.shape[0]
    if n % chunk_size:
        raise ValueError(
            f"N ({n}) must be divisible by chunk_size ({chunk_size})")
    labels = labels.long()
    if save_logits_dtype is not None:
        return _LmHeadCESaved.apply(hidden, head_weight, labels, chunk_size,
                                    save_logits_dtype)
    return _LmHeadCE.apply(hidden, head_weight, labels, chunk_size)
