"""The test BERT (counterpart of
``apex_tpu/transformer/testing/standalone_bert.py``): a bidirectional
encoder with masked-LM and binary heads, built on the standalone
transformer LM's :func:`bert_forward`."""
from __future__ import annotations

import functools
from typing import Optional

import torch

from .standalone_transformer_lm import (  # noqa: F401
    GPTConfig,
    bert_forward,
    init_gpt_params,
)


def bert_model_provider(cfg: GPTConfig, generator: torch.Generator,
                        device: Optional[torch.device] = None):
    """``(params, forward_fn, loss_fn)`` for the test BERT (the JAX
    ``bert_model_provider``; the weights are drawn from ``generator``).
    ``loss_fn(params, tokens, labels, loss_mask, padding_mask=None,
    binary_labels=None, generator=None, deterministic=True)`` is the
    masked mean MLM cross entropy over fp32 logits, plus the binary
    head's mean cross entropy when it and ``binary_labels`` exist."""
    params = init_gpt_params(cfg, generator, device)
    fwd = functools.partial(bert_forward, cfg)

    def loss_fn(params, tokens, labels, loss_mask, padding_mask=None,
                binary_labels=None, generator=None, deterministic=True):
        lm_logits, binary_logits = fwd(params, tokens, padding_mask,
                                       generator, deterministic)
        logp = torch.log_softmax(lm_logits.float(), dim=-1)
        losses = -logp.gather(-1, labels.long()[..., None])[..., 0]
        m = loss_mask.to(torch.float32)
        lm_loss = (losses * m).sum() / m.sum().clamp_min(1.0)
        if binary_logits is not None and binary_labels is not None:
            logp2 = torch.log_softmax(binary_logits.float(), dim=-1)
            sop = -logp2.gather(-1, binary_labels.long()[..., None]).mean()
            return lm_loss + sop
        return lm_loss

    return params, fwd, loss_fn
