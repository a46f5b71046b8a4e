"""Packed-qkv varlen fused MHA (counterpart of
``apex_tpu/contrib/fmha/fmha.py``): the reference fmha's calling
convention — ``qkv [total, 3, h, d]`` with ``cu_seqlens`` — over the
flash kernels' segment ids (:func:`flash_attention_varlen`), any length
and dtype, attention dropout by the kernels' counter hash keyed on an int
``dropout_seed`` (bit for bit the JAX package's). ``max_s`` and
``zero_tensors`` are buffer-management knobs of the reference's CUDA
kernels, accepted and ignored as in the JAX package.
"""
from __future__ import annotations

from typing import Optional

import torch

from ...ops.flash_attention import flash_attention_varlen


def fmha_varlen(qkv: torch.Tensor, cu_seqlens: torch.Tensor,
                p_dropout: float = 0.0, max_s: Optional[int] = None,
                is_training: bool = True, zero_tensors: bool = False, *,
                dropout_seed=None, causal: bool = False) -> torch.Tensor:
    """``FMHAFun``: the attention context ``[total, h, d]`` of packed
    ``qkv [total, 3, h, d]``; dropout (``is_training`` and ``p_dropout >
    0``) needs ``dropout_seed``."""
    del max_s, zero_tensors
    if qkv.dim() != 4 or qkv.shape[1] != 3:
        raise ValueError(
            f"qkv must be [total, 3, h, d], got {tuple(qkv.shape)}")
    q, k, v = qkv[:, 0], qkv[:, 1], qkv[:, 2]
    p = p_dropout if is_training else 0.0
    return flash_attention_varlen(q, k, v, cu_seqlens, causal=causal,
                                  dropout_p=p, dropout_seed=dropout_seed)


class FMHA:
    """The ``FMHA`` module: head geometry and the dropout probability,
    mapping ``[total, hidden]`` qkv to heads and back. Parameter-free (the
    projections live in the caller, as in the reference); built from a
    BERT-style config or from explicit fields."""

    def __init__(self, config=None, *, hidden_size: Optional[int] = None,
                 num_attention_heads: Optional[int] = None,
                 attention_probs_dropout_prob: float = 0.0):
        if config is not None:
            hidden_size = config.hidden_size
            num_attention_heads = config.num_attention_heads
            attention_probs_dropout_prob = getattr(
                config, "attention_probs_dropout_prob", 0.0)
        if hidden_size is None or num_attention_heads is None:
            raise ValueError("need hidden_size and num_attention_heads")
        self.p_dropout = attention_probs_dropout_prob
        self.h = num_attention_heads
        self.hidden_size = hidden_size
        self.d = hidden_size // self.h
        if self.d * self.h != hidden_size:
            raise ValueError("Invalid hidden size/num_heads")

    def __call__(self, qkv: torch.Tensor, cu_seqlens: torch.Tensor,
                 max_s: Optional[int] = None, is_training: bool = True,
                 zero_tensors: bool = False, *,
                 dropout_seed=None) -> torch.Tensor:
        total = qkv.shape[0]
        ctx = fmha_varlen(qkv.reshape(total, 3, self.h, self.d), cu_seqlens,
                          self.p_dropout, max_s, is_training, zero_tensors,
                          dropout_seed=dropout_seed)
        return ctx.reshape(total, self.hidden_size)
