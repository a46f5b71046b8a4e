"""Vocab-parallel cross entropy (counterpart of
``apex_tpu/transformer/tensor_parallel/cross_entropy.py``).

A ``torch.autograd.Function`` over logits whose vocab dim is split over
the tensor group, with the reference's collectives
(``apex/transformer/tensor_parallel/cross_entropy.py``): a MAX
all-reduce of the row maxima, the target logit gathered on the rank that
owns it and SUM all-reduced, and a SUM all-reduce of the exp-sums. Label
smoothing uses ``smoothing * vocab / (vocab - 1)`` over the global vocab
and the mean log-probability over the global vocab (one more SUM
all-reduce), as the JAX package computes it. The backward is the
softmax minus the (smoothed) one-hot on the owning shard, scaled by the
incoming gradient; it runs no collective.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

from .mappings import all_reduce, axis_world
from .utils import VocabUtility


def _sum(x, group, active):
    return all_reduce(x, group) if active else x


class _VocabParallelCrossEntropy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, vocab_parallel_logits, target, label_smoothing, axis):
        group, world, rank, active = axis
        logits = vocab_parallel_logits.float()
        part = logits.shape[-1]
        logits_max = logits.max(dim=-1).values
        if active:
            logits_max = all_reduce(logits_max, group, dist.ReduceOp.MAX)
        logits = logits - logits_max.unsqueeze(-1)

        start, end = VocabUtility.vocab_range_from_per_partition_vocab_size(
            part, rank, world)
        target_mask = (target < start) | (target >= end)
        masked_target = torch.where(target_mask, 0, target - start).long()
        predicted = torch.gather(logits, -1,
                                 masked_target.unsqueeze(-1)).squeeze(-1)
        predicted = torch.where(target_mask, 0.0, predicted)
        predicted = _sum(predicted, group, active)

        exp_logits = torch.exp(logits)
        sum_exp = _sum(exp_logits.sum(dim=-1), group, active)
        loss = torch.log(sum_exp) - predicted

        vocab_size = part * world
        smoothing = 0.0
        if label_smoothing > 0.0:
            if not 1.0 > label_smoothing:
                raise ValueError(f"label_smoothing {label_smoothing} must "
                                 "be below 1")
            smoothing = label_smoothing * vocab_size / (vocab_size - 1)
            log_probs = logits - torch.log(sum_exp).unsqueeze(-1)
            mean_log_probs = _sum(log_probs.sum(dim=-1), group,
                                  active) / vocab_size
            loss = (1.0 - smoothing) * loss - smoothing * mean_log_probs

        softmax = exp_logits.div_(sum_exp.unsqueeze(-1))
        ctx.save_for_backward(softmax, target_mask, masked_target)
        ctx.smoothing = smoothing
        ctx.vocab_size = vocab_size
        ctx.in_dtype = vocab_parallel_logits.dtype
        return loss

    @staticmethod
    def backward(ctx, grad_output):
        softmax, target_mask, masked_target = ctx.saved_tensors
        grad = softmax.clone()
        hit = (~target_mask).to(grad.dtype).unsqueeze(-1)
        one_hot = torch.zeros_like(grad).scatter_(
            -1, masked_target.unsqueeze(-1), hit)
        if ctx.smoothing > 0.0:
            grad -= (1.0 - ctx.smoothing) * one_hot
            grad -= ctx.smoothing / ctx.vocab_size
        else:
            grad -= one_hot
        grad *= grad_output.unsqueeze(-1)
        return grad.to(ctx.in_dtype), None, None, None


def vocab_parallel_cross_entropy(vocab_parallel_logits: torch.Tensor,
                                 target: torch.Tensor,
                                 label_smoothing: float = 0.0,
                                 axis_name: Optional[str] = None
                                 ) -> torch.Tensor:
    """Per-token fp32 loss of ``[..., vocab/tp]`` logits and ``[...]``
    integer targets over the global vocab (the tensor group's shards in
    rank order)."""
    return _VocabParallelCrossEntropy.apply(
        vocab_parallel_logits, target, float(label_smoothing),
        axis_world(axis_name))
