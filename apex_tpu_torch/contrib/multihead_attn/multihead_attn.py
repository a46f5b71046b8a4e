"""Fused multi-head attention modules, self and encoder-decoder
(counterpart of ``apex_tpu/contrib/multihead_attn/multihead_attn.py``).

The projections are plain matrix products (cuBLAS on the card); the
attention core takes the flash kernels for key-padding masks and for
additive masks (through the kernels' bias input, ``bias_grad=False``:
masks carry no gradient, as in the reference's autograd functions), and
the materialised-score path (:func:`mask_softmax_dropout`, plain PyTorch
as the JAX package's is plain XLA) where the card's kernels do not take
the head dim or the mask's layout. ``include_norm_add`` runs the port's
LayerNorm kernels before the projections and adds the residual after the
output projection. Layout is the reference's time x batch x channel
(``[s, b, h]``).

Parameters are a dict (``module.init(generator)``), passed to each call,
as in the JAX package; ``params_from_jax`` carries the JAX package's over.
Attention dropout on the flash path is the kernels' counter hash keyed by
an int ``dropout_seed`` (the JAX package draws its seed from its dropout
key); the residual dropout of ``include_norm_add`` and the probability
dropout of the materialised path draw from a ``torch.Generator``, so they
differ from the JAX package's draws.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from ... import _device
from ...ops.flash_attention import flash_attention, flash_attention_available
from ...ops.layer_norm import layer_norm


def _bernoulli_keep(shape, p: float, generator, device) -> torch.Tensor:
    """A {0, 1} fp32 keep mask with P(keep) = 1 - p."""
    u = torch.rand(shape, generator=generator, device=device)
    return (u < 1.0 - p).float()


def mask_softmax_dropout(scores: torch.Tensor,
                         mask: Optional[torch.Tensor] = None,
                         mask_additive: bool = False,
                         dropout_prob: float = 0.0,
                         generator: Optional[torch.Generator] = None
                         ) -> torch.Tensor:
    """The ``mask_softmax_dropout_func`` composition on ``[b, n, sq, sk]``
    scaled scores: mask (a ``[b, sk]`` key-padding mask, 1 = masked out,
    or additive values, ``[b, sk]`` or broadcastable to the scores), an
    fp32 softmax, dropout on the probabilities; in the scores' dtype."""
    s = scores.float()
    if mask is not None:
        if mask_additive:
            m = mask.detach().float()  # masks carry no gradient
            if m.dim() == 2:
                m = m[:, None, None, :]
            s = s + m
        else:
            s = s.masked_fill(mask[:, None, None, :] != 0, -1e30)
    p = torch.softmax(s, dim=-1)
    if dropout_prob > 0.0:
        if generator is None:
            raise ValueError("dropout_prob > 0 requires a generator")
        keep = _bernoulli_keep(p.shape, dropout_prob, generator, p.device)
        p = p * keep / (1.0 - dropout_prob)
    return p.to(scores.dtype)


def _split_heads(x: torch.Tensor, n: int) -> torch.Tensor:
    """``[s, b, h]`` -> ``[b, n, s, d]``."""
    s, b, h = x.shape
    return x.reshape(s, b, n, h // n).permute(1, 2, 0, 3)


def _merge_heads(x: torch.Tensor) -> torch.Tensor:
    """``[b, n, s, d]`` -> ``[s, b, h]``."""
    b, n, s, d = x.shape
    return x.permute(2, 0, 1, 3).reshape(s, b, n * d)


def _attend(q, k, v, num_heads, scaling, key_padding_mask, attn_mask,
            mask_additive, dropout_prob, dropout_seed, generator):
    """The attention core on ``[s, b, h]`` tensors: flash where the
    kernels take the head dim and the mask, else materialised scores."""
    qh, kh, vh = (_split_heads(t, num_heads) for t in (q, k, v))
    b, n, s_q, d = qh.shape
    s_k = kh.shape[2]
    kernel_ok = flash_attention_available(s_q, s_k, d, qh.device, qh.dtype)
    # additive masks ride the kernels' bias input (constant: no dbias in
    # the backward); other layouts take the materialised scores
    flash_bias = None
    flash_ok = kernel_ok and not mask_additive and attn_mask is None
    if kernel_ok and not flash_ok:
        if (mask_additive and attn_mask is None
                and key_padding_mask is not None
                and key_padding_mask.dim() == 2):
            flash_bias = key_padding_mask.float()[:, None, None, :]
            flash_ok = True
        elif (attn_mask is not None and attn_mask.dim() == 4
                and attn_mask.shape[0] in (1, b)
                and attn_mask.shape[1] in (1, n)
                and attn_mask.shape[2] in (1, s_q)
                and attn_mask.shape[3] == s_k):
            flash_bias = attn_mask.float()
            flash_ok = True
    if flash_ok:
        kv_mask = None
        if key_padding_mask is not None and flash_bias is None:
            kv_mask = key_padding_mask == 0  # flash: True = attend
        if dropout_prob > 0.0 and dropout_seed is None:
            raise ValueError("attention dropout requires dropout_seed")
        ctx = flash_attention(
            qh, kh, vh, kv_mask=kv_mask,
            bias=None if flash_bias is None else flash_bias.detach(),
            bias_grad=False, scale=scaling, dropout_p=dropout_prob,
            dropout_seed=dropout_seed if dropout_prob > 0.0 else None)
    else:
        scores = torch.matmul(qh.float(), kh.float().transpose(-1, -2)) \
            * scaling
        mask = attn_mask if attn_mask is not None else key_padding_mask
        p = mask_softmax_dropout(scores, mask,
                                 mask_additive or attn_mask is not None,
                                 dropout_prob, generator)
        ctx = torch.matmul(p.to(vh.dtype).float(), vh.float()).to(qh.dtype)
    return _merge_heads(ctx)


def _xavier(shape, generator, device, gain=1.0) -> torch.Tensor:
    """``glorot_uniform`` of the JAX package (fan in ``shape[-2]``, fan
    out ``shape[-1]``), times ``gain``."""
    limit = gain * math.sqrt(6.0 / (shape[-2] + shape[-1]))
    w = torch.rand(shape, generator=generator, device=device)
    return (2.0 * w - 1.0) * limit


def _project(x: torch.Tensor, w: torch.Tensor,
             b: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``x @ w.T (+ b)`` in x's dtype (``einsum('sbh,oh->sbo')``)."""
    out = torch.matmul(x, w.to(x.dtype).t())
    return out if b is None else out + b.to(out.dtype)


class SelfMultiheadAttn:
    """The reference's ``SelfMultiheadAttn``: options ``bias``,
    ``include_norm_add`` (pre-LayerNorm and the residual dropout-add),
    ``separate_qkv_params`` and ``mask_additive``; ``impl`` is accepted
    and ignored (one path serves both)."""

    def __init__(self, embed_dim, num_heads, dropout=0.0, bias=False,
                 include_norm_add=False, impl="fast",
                 separate_qkv_params=False, mask_additive=False):
        del impl
        if embed_dim % num_heads:
            raise ValueError("embed_dim must be divisible by num_heads")
        if mask_additive and include_norm_add:
            raise ValueError(
                "additive mask not supported with layer norm (reference "
                "assert, self_multihead_attn.py:52)")
        self.embed_dim = embed_dim
        self.num_heads = num_heads
        self.dropout = dropout
        self.bias = bias
        self.include_norm_add = include_norm_add
        self.separate_qkv_params = separate_qkv_params
        self.mask_additive = mask_additive
        self.scaling = (embed_dim // num_heads) ** -0.5

    def init(self, generator: torch.Generator, device=None,
             dtype: torch.dtype = torch.float32) -> dict:
        """The parameter dict on ``device`` (the card unless given):
        Xavier-uniform weights (the packed ``[3h, h]`` in-projection with
        gain sqrt(2)), zero biases, LayerNorm ones and zeros."""
        dev = _device.resolve_device(device)
        h = self.embed_dim
        p = {}
        if self.separate_qkv_params:
            for name in ("q_weight", "k_weight", "v_weight"):
                p[name] = _xavier((h, h), generator, dev)
        else:
            p["in_proj_weight"] = _xavier((3 * h, h), generator, dev,
                                          math.sqrt(2))
        p["out_proj_weight"] = _xavier((h, h), generator, dev)
        if self.bias:
            if self.separate_qkv_params:
                for name in ("q_bias", "k_bias", "v_bias"):
                    p[name] = torch.zeros(h, device=dev)
            else:
                p["in_proj_bias"] = torch.zeros(3 * h, device=dev)
            p["out_proj_bias"] = torch.zeros(h, device=dev)
        if self.include_norm_add:
            p["lyr_nrm_gamma_weights"] = torch.ones(h, device=dev)
            p["lyr_nrm_beta_weights"] = torch.zeros(h, device=dev)
        return {k: t.to(dtype) for k, t in p.items()}

    def _in_proj(self, params):
        h = self.embed_dim
        n, d = self.num_heads, self.embed_dim // self.num_heads
        if self.separate_qkv_params:
            # interleaved per head: [n, 3, d, h] -> [3h, h]
            w = torch.cat([params[f"{c}_weight"].reshape(n, 1, d, h)
                           for c in "qkv"], dim=1).reshape(3 * h, h)
            b = None
            if self.bias:
                b = torch.cat([params[f"{c}_bias"].reshape(n, 1, d)
                               for c in "qkv"], dim=1).reshape(3 * h)
            return w, b
        return params["in_proj_weight"], params.get("in_proj_bias")

    def _pre_ln(self, params, query):
        if not self.include_norm_add:
            return query
        return layer_norm(query.float(),
                          params["lyr_nrm_gamma_weights"].float(),
                          params["lyr_nrm_beta_weights"].float()
                          ).to(query.dtype)

    def _epilogue(self, params, ctx, residual, drop_p, generator):
        out = _project(ctx, params["out_proj_weight"],
                       params.get("out_proj_bias") if self.bias else None)
        if self.include_norm_add:
            # the residual dropout-add (reference jit_dropout_add)
            if drop_p > 0.0:
                if generator is None:
                    raise ValueError(
                        "training dropout requires a generator")
                keep = _bernoulli_keep(out.shape, drop_p, generator,
                                       out.device)
                out = out * keep.to(out.dtype) / (1.0 - drop_p)
            out = residual + out
        return out

    @staticmethod
    def _check_masks(key_padding_mask, attn_mask):
        if key_padding_mask is not None and attn_mask is not None:
            raise ValueError(
                "attn_mask and key_padding_mask should not be both defined")

    def __call__(self, params, query, key=None, value=None,
                 key_padding_mask=None, need_weights=False, attn_mask=None,
                 is_training=True, dropout_seed=None, generator=None):
        """``query [s, b, h]`` -> ``(out [s, b, h], None)``; self-attention
        ignores ``key``/``value``. ``key_padding_mask [b, s]``: 1 = masked
        out, or additive values with ``mask_additive``; ``attn_mask``
        additive, broadcastable to ``[b, n, sq, sk]``. Masks carry no
        gradient on any path."""
        del key, value, need_weights
        self._check_masks(key_padding_mask, attn_mask)
        h = self.embed_dim
        residual = query
        x = self._pre_ln(params, query)
        w, b = self._in_proj(params)
        qkv = _project(x, w, b)
        n, d = self.num_heads, h // self.num_heads
        s_len, bsz = qkv.shape[:2]
        qkv = qkv.reshape(s_len, bsz, n, 3, d)
        q, k, v = (qkv[..., i, :].reshape(s_len, bsz, h) for i in range(3))
        drop_p = self.dropout if is_training else 0.0
        ctx = _attend(q, k, v, n, self.scaling, key_padding_mask, attn_mask,
                      self.mask_additive, drop_p, dropout_seed, generator)
        return self._epilogue(params, ctx, residual, drop_p, generator), None


class EncdecMultiheadAttn(SelfMultiheadAttn):
    """The reference's ``EncdecMultiheadAttn``: the query from the
    decoder, key and value from the encoder output — an ``[h, h]`` q
    projection and a packed ``[2h, h]`` kv projection."""

    def __init__(self, embed_dim, num_heads, dropout=0.0, bias=False,
                 include_norm_add=False, impl="fast"):
        super().__init__(embed_dim, num_heads, dropout=dropout, bias=bias,
                         include_norm_add=include_norm_add, impl=impl)

    def init(self, generator: torch.Generator, device=None,
             dtype: torch.dtype = torch.float32) -> dict:
        dev = _device.resolve_device(device)
        h = self.embed_dim
        p = {"q_weight": _xavier((h, h), generator, dev),
             "kv_weight": _xavier((2 * h, h), generator, dev,
                                  math.sqrt(1.5)),
             "out_proj_weight": _xavier((h, h), generator, dev)}
        if self.bias:
            p["q_bias"] = torch.zeros(h, device=dev)
            p["kv_bias"] = torch.zeros(2 * h, device=dev)
            p["out_proj_bias"] = torch.zeros(h, device=dev)
        if self.include_norm_add:
            p["lyr_nrm_gamma_weights"] = torch.ones(h, device=dev)
            p["lyr_nrm_beta_weights"] = torch.zeros(h, device=dev)
        return {k: t.to(dtype) for k, t in p.items()}

    def __call__(self, params, query, key, value=None, key_padding_mask=None,
                 need_weights=False, attn_mask=None, is_training=True,
                 dropout_seed=None, generator=None):
        del value, need_weights
        self._check_masks(key_padding_mask, attn_mask)
        h = self.embed_dim
        n, d = self.num_heads, h // self.num_heads
        residual = query
        x = self._pre_ln(params, query)
        q = _project(x, params["q_weight"],
                     params["q_bias"] if self.bias else None)
        kv = _project(key, params["kv_weight"],
                      params["kv_bias"] if self.bias else None)
        sk, bsz = kv.shape[:2]
        kv = kv.reshape(sk, bsz, n, 2, d)
        k = kv[..., 0, :].reshape(sk, bsz, h)
        v = kv[..., 1, :].reshape(sk, bsz, h)
        drop_p = self.dropout if is_training else 0.0
        ctx = _attend(q, k, v, n, self.scaling, key_padding_mask, attn_mask,
                      False, drop_p, dropout_seed, generator)
        return self._epilogue(params, ctx, residual, drop_p, generator), None
