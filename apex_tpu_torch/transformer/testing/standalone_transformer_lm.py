"""The GPT of ``apex_tpu/transformer/testing/standalone_transformer_lm.py``,
as far as serving and the single-device train step use it.

- :class:`GPTConfig`: the JAX config's field names and defaults for the
  model shape and the training fields of the unfused step.
- :func:`init_gpt_params`: the same init scheme and the same parameter
  tree (nested dict, layer weights stacked ``[L, ...]``, weights
  ``[out, in]``), drawn from an explicit ``torch.Generator``. The
  numbers differ from JAX's for the same seed; tests carry JAX weights
  across with ``apex_tpu_torch.convert.params_from_jax`` instead.
- :func:`gpt_forward`: a dense, inference-only forward in plain PyTorch
  (no KV cache, plain causal softmax attention) — the oracle that
  ``serving.decode_model.reference_decode`` recomputes per token.
  Numerics follow the training path: LayerNorm on an fp32 copy cast
  back, GEMMs in ``compute_dtype``, tanh GeLU, fp32 logits.
- the training path, in the Megatron ``[s, b, h]`` layout:
  :func:`parallel_attention` (flash attention, or the scores through
  ``transformer.functional.FusedScaleMaskSoftmax`` with
  ``use_flash_attention=False`` or where flash does not apply),
  :func:`parallel_mlp`,
  :func:`transformer_layer` (the unfused branch, and with
  ``GPTConfig.fused_block`` the fused block tails of
  ``ops/fused_block.py``), :func:`transformer_block` (a loop over the
  stacked layers, ``recompute_granularity`` None, ``"full"``,
  ``"selective"`` or ``"selective_elementwise"``), :func:`gpt_embed`,
  :func:`gpt_hidden` and :func:`gpt_loss` (the single-device branch:
  chunked LM-head cross entropy), and the BERT encoder
  :func:`bert_forward` (padding mask, tied MLM head, pooler and binary
  head). The kernels on it are the LayerNorm forward and backward, the
  flash-attention forward and backward or the fused scale-mask-softmax
  forward and backward, and, in the fused block, bias-GeLU,
  bias-dropout-residual and residual-add-LayerNorm forward and backward;
  GEMMs (the attention products included) are ``F.linear`` /
  ``torch.bmm`` / ``torch.mm``, as the JAX package left them to XLA.

Not ported yet (ROADMAP.md): tensor, sequence and context parallelism
and fp8. Hidden
dropout of the unfused branch draws from an explicit ``torch.Generator``
(JAX's ``bernoulli`` stream cannot be matched); attention dropout and
the fused tails' hidden dropout are the kernels' hash, seeded from the
same generator.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

from ...contrib.xentropy import lm_head_cross_entropy, lm_logits
from ...ops.flash_attention import (
    FLASH_ATTN_FWD,
    KERNEL_HEAD_DIMS,
    flash_attention_available,
    flash_attention_sbhd,
)
from ...ops.fused_block import (
    BIAS_DROPOUT_RESIDUAL_FWD,
    BIAS_GELU_FWD,
    RESIDUAL_LN_FWD,
    bias_dropout_residual,
    bias_gelu,
    residual_add_layer_norm,
)
from ...ops.layer_norm import LAYER_NORM_FWD, RMS_NORM_FWD, layer_norm
from ...telemetry.numerics import tap
from ..enums import AttnMaskType
from ..functional.fused_softmax import FusedScaleMaskSoftmax

Params = Dict[str, Any]


@dataclasses.dataclass
class GPTConfig:
    """Model config (the JAX ``GPTConfig``'s fields for one device, with
    its defaults)."""

    num_layers: int = 4
    hidden_size: int = 64
    num_attention_heads: int = 4
    vocab_size: int = 512
    max_position_embeddings: int = 128
    ffn_hidden_size: Optional[int] = None  # default 4h
    layernorm_epsilon: float = 1e-5
    hidden_dropout: float = 0.1
    attention_dropout: float = 0.1
    params_dtype: torch.dtype = torch.float32
    compute_dtype: torch.dtype = torch.float32  # bf16 for mixed precision
    apply_query_key_layer_scaling: bool = True
    attn_mask_type: AttnMaskType = AttnMaskType.causal
    # None | "full" | "selective" | "selective_elementwise" (see
    # transformer_block); "selective_elementwise" also keeps the fused
    # tails' outputs and pairs with fused_block=True
    recompute_granularity: Optional[str] = None
    # None = flash attention where it applies (no fp16 query-key layer
    # scaling, a causal or [b, 1, 1, sk] padding mask), else the scores
    # through FusedScaleMaskSoftmax; True forces flash (raises where it
    # does not apply); False forces the softmax path
    use_flash_attention: Optional[bool] = None
    # save each CE chunk's logits in compute_dtype instead of
    # recomputing the chunk GEMM in backward (changes the forward loss:
    # the CE of the rounded logits)
    ce_save_logits: bool = False
    # fused block tails (ops/fused_block.py): the projection GEMMs run
    # bias-free and each tail is one sweep (bias + GeLU after fc1; proj
    # bias + hash dropout + residual + the MLP's pre-LN after attention;
    # fc2 bias + hash dropout + residual after the MLP). Hidden dropout is
    # then the counter hash seeded per tail, not the generator's mask.
    fused_block: bool = False
    # BERT: the pooler and binary (sentence-order) head
    add_binary_head: bool = False

    @property
    def ffn_size(self) -> int:
        return self.ffn_hidden_size or 4 * self.hidden_size

    @property
    def kv_channels(self) -> int:
        return self.hidden_size // self.num_attention_heads


def init_gpt_params(cfg: GPTConfig, generator: torch.Generator,
                    device: Optional[torch.device] = None) -> Params:
    """Global parameter tree, Megatron init: normal(0, 0.02) weights,
    output projections scaled by ``1/sqrt(2 * num_layers)``, zero
    biases, unit LN weights; with ``cfg.add_binary_head`` the BERT
    pooler and binary head too. Draws happen on ``generator``'s device
    and land on ``device`` (default: the generator's)."""
    h, L, v = cfg.hidden_size, cfg.num_layers, cfg.vocab_size
    ffn = cfg.ffn_size
    std = 0.02
    out_std = std / (2.0 * L) ** 0.5
    dt = cfg.params_dtype
    gdev = generator.device
    dev = torch.device(device) if device is not None else gdev

    def n(shape, s=std):
        x = torch.randn(shape, generator=generator, device=gdev,
                        dtype=torch.float32) * s
        return x.to(device=dev, dtype=dt)

    def full(shape, val):
        return torch.full(shape, val, device=dev, dtype=dt)

    params = {
        "embedding": {
            "word": n((v, h)),
            "position": n((cfg.max_position_embeddings, h)),
        },
        "layers": {
            "input_ln_w": full((L, h), 1.0),
            "input_ln_b": full((L, h), 0.0),
            "qkv_w": n((L, 3 * h, h)),
            "qkv_b": full((L, 3 * h), 0.0),
            "proj_w": n((L, h, h), out_std),
            "proj_b": full((L, h), 0.0),
            "post_ln_w": full((L, h), 1.0),
            "post_ln_b": full((L, h), 0.0),
            "fc1_w": n((L, ffn, h)),
            "fc1_b": full((L, ffn), 0.0),
            "fc2_w": n((L, h, ffn), out_std),
            "fc2_b": full((L, h), 0.0),
        },
        "final_ln_w": full((h,), 1.0),
        "final_ln_b": full((h,), 0.0),
    }
    if cfg.add_binary_head:
        params["binary_head"] = {
            "pooler_w": n((h, h)),
            "pooler_b": full((h,), 0.0),
            "head_w": n((2, h)),
            "head_b": full((2,), 0.0),
        }
    return params


def ln_fp32(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
            eps: float) -> torch.Tensor:
    """LayerNorm on an fp32 copy (the training path normalises in fp32
    and the caller casts back)."""
    return layer_norm(x.float(), w.float(), b.float(), eps=eps)


def linear(x: torch.Tensor, w: torch.Tensor,
           b: Optional[torch.Tensor]) -> torch.Tensor:
    """``x @ w^T + b`` with the GEMM and the bias add rounded separately
    in ``x``'s dtype, as the JAX einsum-then-add does; ``b`` None is the
    bias-free GEMM of a fused tail."""
    out = F.linear(x, w.to(x.dtype))
    return out if b is None else out + b.to(x.dtype)


def lm_head(h: torch.Tensor, word: torch.Tensor) -> torch.Tensor:
    """Tied-embedding head with fp32 logits from fp32 accumulation
    (``contrib.xentropy.lm_logits``: on the card one bf16 GEMM that
    writes fp32, reading the bf16 embedding as it is; a plain bf16
    matmul would round the logits to bf16 and create argmax ties);
    differentiable."""
    lead = h.shape[:-1]
    out = lm_logits(h.reshape(-1, h.shape[-1]), word)
    return out.reshape(*lead, word.shape[0])


def gpt_forward(cfg: GPTConfig, params: Params,
                tokens: torch.Tensor) -> torch.Tensor:
    """Dense inference forward: ``tokens [b, s]`` -> fp32 logits
    ``[b, s, vocab]``. Deterministic (no dropout); causal attention
    with an fp32 softmax over all earlier positions."""
    b, s = tokens.shape
    if s > cfg.max_position_embeddings:
        raise ValueError(
            f"sequence {s} exceeds max_position_embeddings "
            f"{cfg.max_position_embeddings}")
    n, d = cfg.num_attention_heads, cfg.kv_channels
    dt = cfg.compute_dtype
    eps = cfg.layernorm_epsilon
    emb = params["embedding"]
    pos = torch.arange(s, device=tokens.device)
    h = (emb["word"][tokens.long()] + emb["position"][pos][None]).to(dt)
    causal = torch.ones(s, s, dtype=torch.bool,
                        device=tokens.device).tril()
    layers = params["layers"]
    for l in range(cfg.num_layers):
        lp = {k: v[l] for k, v in layers.items()}
        ln1 = ln_fp32(h, lp["input_ln_w"], lp["input_ln_b"], eps).to(dt)
        qkv = linear(ln1, lp["qkv_w"], lp["qkv_b"]).reshape(b, s, n, 3 * d)
        q, k, v = qkv.split(d, dim=-1)  # [b, s, n, d]
        scores = torch.einsum("bsnd,btnd->bnst", q.float(), k.float())
        scores = scores / (d ** 0.5)
        scores = scores.masked_fill(~causal, float("-inf"))
        probs = torch.softmax(scores, dim=-1)
        ctx = torch.einsum("bnst,btnd->bsnd", probs, v.float())
        ctx = ctx.to(dt).reshape(b, s, n * d)
        h = (h + linear(ctx, lp["proj_w"], lp["proj_b"])).to(dt)
        ln2 = ln_fp32(h, lp["post_ln_w"], lp["post_ln_b"], eps).to(dt)
        inter = F.gelu(linear(ln2, lp["fc1_w"], lp["fc1_b"]),
                       approximate="tanh")
        h = (h + linear(inter, lp["fc2_w"], lp["fc2_b"])).to(dt)
    h = ln_fp32(h, params["final_ln_w"], params["final_ln_b"], eps).to(dt)
    return lm_head(h, emb["word"])


# --------------------------------------------------------------------------
# training path ([s, b, h] layout, unfused block)
# --------------------------------------------------------------------------

def _draw_seed(generator: torch.Generator) -> int:
    """An int32 seed from ``generator`` (a CPU generator draws without
    touching the card; a CUDA one costs a host read)."""
    return int(torch.randint(-(2 ** 31), 2 ** 31 - 1, (),
                             generator=generator, device=generator.device))


def _dropout(x: torch.Tensor, rate: float, seed: Optional[int],
             deterministic: bool) -> torch.Tensor:
    """Hidden dropout from a generator seeded with ``seed`` (so a
    recomputed layer draws the same mask)."""
    if deterministic or rate == 0.0 or seed is None:
        return x
    g = torch.Generator(device=x.device).manual_seed(seed & 0xFFFFFFFF)
    keep = torch.rand(x.shape, generator=g, device=x.device) >= rate
    return torch.where(keep, x / (1.0 - rate), 0).to(x.dtype)


def parallel_attention(cfg: GPTConfig, lp: Dict[str, torch.Tensor],
                       hidden: torch.Tensor,
                       attention_mask: Optional[torch.Tensor],
                       dropout_seed: Optional[int], deterministic: bool,
                       layer_number: Optional[int] = None,
                       fuse_tail: bool = False) -> torch.Tensor:
    """Self-attention on one device (the JAX ``parallel_attention``):
    fused QKV GEMM, then flash attention or, with
    ``use_flash_attention=False`` or where flash does not apply (the
    configuration, or with ``None`` a head dim the device's flash kernels
    do not take: ``flash_attention_available``), the scores through
    :func:`_softmax_attention`; output projection. ``True`` where flash
    cannot run raises ``ValueError``.
    ``fuse_tail`` leaves ``proj_b`` to the caller's fused tail."""
    s, b, _ = hidden.shape
    n, hn = cfg.num_attention_heads, cfg.kv_channels
    qkv = linear(hidden, lp["qkv_w"], lp["qkv_b"]).reshape(s, b, n, 3 * hn)
    q, k, v = qkv.split(hn, dim=-1)  # [s, b, n, hn]
    qk_scaling = (cfg.apply_query_key_layer_scaling
                  and cfg.compute_dtype == torch.float16
                  and layer_number is not None)
    causal = cfg.attn_mask_type == AttnMaskType.causal
    kv_mask = None
    mask_ok = causal
    if (not causal and attention_mask is not None
            and attention_mask.dim() == 4 and attention_mask.shape[1] == 1
            and attention_mask.shape[2] == 1):
        kv_mask = attention_mask[:, 0, 0, :] == 0  # True = attend
        mask_ok = True
    flash_compatible = not qk_scaling and mask_ok
    # the JAX package's decision: flash where the configuration allows it
    # and the device's kernels take the shape, else the path without flash
    available = flash_attention_available(s, s, hn, hidden.device)
    if cfg.use_flash_attention is None:
        use_flash = flash_compatible and available
    else:
        use_flash = bool(cfg.use_flash_attention)
    if cfg.use_flash_attention and not flash_compatible:
        raise ValueError(
            "use_flash_attention=True but the configuration is not "
            "flash-compatible (fp16 qk layer scaling or a non-causal/"
            "non-padding mask)")
    if cfg.use_flash_attention and not available:
        raise ValueError(
            f"use_flash_attention=True but the flash kernels on "
            f"{hidden.device} do not take head dim {hn} (they take "
            f"{KERNEL_HEAD_DIMS})")
    if not use_flash:
        ctx = _softmax_attention(cfg, q, k, v, attention_mask, causal,
                                 layer_number if qk_scaling else None,
                                 dropout_seed, deterministic)
        return _attn_out_proj(cfg, lp, ctx.to(hidden.dtype), fuse_tail)
    p = 0.0 if deterministic or dropout_seed is None \
        else float(cfg.attention_dropout)
    flash_kw = dict(dropout_p=p, dropout_seed=dropout_seed) if p > 0.0 \
        else {}
    ctx = flash_attention_sbhd(q, k, v, causal=causal, kv_mask=kv_mask,
                               scale=1.0 / (hn ** 0.5), **flash_kw)
    ctx = ctx.to(hidden.dtype).reshape(s, b, n * hn)
    return _attn_out_proj(cfg, lp, ctx, fuse_tail)


def _softmax_attention(cfg: GPTConfig, q: torch.Tensor, k: torch.Tensor,
                       v: torch.Tensor,
                       attention_mask: Optional[torch.Tensor], causal: bool,
                       qk_layer: Optional[int], dropout_seed: Optional[int],
                       deterministic: bool) -> torch.Tensor:
    """Attention with materialised ``[b, n, s, s]`` scores (the JAX
    branch without flash): ``q k^T`` in the compute dtype divided by
    ``sqrt(hn)`` in that dtype, :class:`FusedScaleMaskSoftmax` (causal,
    or the ``attention_mask`` with nonzero = masked out), dropout on the
    probabilities from a generator seeded with ``dropout_seed`` (so a
    recomputed layer redraws the same mask), and ``probs @ v`` with fp32
    accumulation -> context ``[s, b, n * hn]``.

    ``qk_layer`` (fp16 with query-key layer scaling) is the 1-based layer
    number: the scores are taken in fp32, divided by ``sqrt(hn) * coeff``
    and multiplied back by ``coeff = max(qk_layer, 1)`` inside an inline
    fp32 softmax with the ``-10000`` fill, and no kernel runs (the JAX
    package's traced scale has no kernel either). The two products are
    ``torch.bmm`` over ``b * n`` contiguous batches, as the JAX package
    left its einsums to XLA."""
    s, b, n, hn = q.shape
    sk = k.shape[0]
    dt = cfg.compute_dtype
    qb = q.permute(1, 2, 0, 3).reshape(b * n, s, hn)
    kb = k.permute(1, 2, 3, 0).reshape(b * n, hn, sk)
    vb = v.permute(1, 2, 0, 3).reshape(b * n, sk, hn)
    norm_factor = hn ** 0.5
    if qk_layer is not None:
        coeff = float(max(qk_layer, 1))
        x = torch.bmm(qb.float(), kb.float()).view(b, n, s, sk) \
            / (norm_factor * coeff) * coeff
        if causal:
            x = torch.where(torch.ones(s, sk, dtype=torch.bool,
                                       device=x.device).triu(1),
                            -10000.0, x)
        elif attention_mask is not None:
            x = x.masked_fill(attention_mask != 0, -10000.0)
        probs = torch.softmax(x, dim=-1).to(dt)
    else:
        softmax = FusedScaleMaskSoftmax(
            input_in_fp16=dt == torch.float16,
            input_in_bf16=dt == torch.bfloat16,
            attn_mask_type=cfg.attn_mask_type, mask_func=None,
            softmax_in_fp32=True, scale=None)
        scores = torch.bmm(qb, kb).view(b, n, s, sk) / norm_factor
        probs = softmax(scores, None if causal else attention_mask)
    probs = _dropout(probs, cfg.attention_dropout, dropout_seed,
                     deterministic)
    ctx = torch.bmm(probs.reshape(b * n, s, sk).to(v.dtype), vb)
    return ctx.view(b, n, s, hn).permute(2, 0, 1, 3).reshape(s, b, n * hn)


def _attn_out_proj(cfg: GPTConfig, lp: Dict[str, torch.Tensor],
                   ctx: torch.Tensor, fuse_tail: bool = False
                   ) -> torch.Tensor:
    """Attention output projection (dense); ``fuse_tail`` omits
    ``proj_b``, which rides the caller's fused tail."""
    return linear(ctx, lp["proj_w"], None if fuse_tail else lp["proj_b"])


def parallel_mlp(cfg: GPTConfig, lp: Dict[str, torch.Tensor],
                 hidden: torch.Tensor, fuse_tail: bool = False
                 ) -> torch.Tensor:
    """h -> 4h GEMM + bias, tanh GeLU, 4h -> h GEMM + bias (the JAX
    ``parallel_mlp``). ``fuse_tail`` is the fused-block MLP: fc1 runs
    bias-free and :func:`bias_gelu` adds its bias, fc2 runs bias-free
    and the caller fuses ``fc2_b`` into its tail."""
    if fuse_tail:
        inter = linear(hidden, lp["fc1_w"], None)
        inter = bias_gelu(inter, lp["fc1_b"].to(inter.dtype))
        return linear(inter, lp["fc2_w"], None)
    inter = F.gelu(linear(hidden, lp["fc1_w"], lp["fc1_b"]),
                   approximate="tanh")
    return linear(inter, lp["fc2_w"], lp["fc2_b"])


def transformer_layer(cfg: GPTConfig, lp: Dict[str, torch.Tensor],
                      hidden: torch.Tensor,
                      attention_mask: Optional[torch.Tensor],
                      seeds: Optional[tuple], deterministic: bool,
                      layer_number: Optional[int] = None) -> torch.Tensor:
    """Pre-LN transformer layer: LayerNorm on an fp32 copy, attention,
    dropout + residual, LayerNorm, MLP, dropout + residual. ``seeds`` =
    (attention, attention-residual, MLP-residual) dropout seeds, or None.

    With ``cfg.fused_block`` the two tails are the single-sweep ops of
    ``ops/fused_block.py``: the attention tail is
    :func:`residual_add_layer_norm` (proj bias + hash dropout + residual
    + the MLP's pre-LN), the MLP tail :func:`bias_dropout_residual`; the
    tails' seeds come from ``seeds``, so a recomputed layer regenerates
    the same masks."""
    dt = hidden.dtype
    eps = cfg.layernorm_epsilon
    s_attn, s_res1, s_res2 = seeds if seeds is not None else (None,) * 3
    ln1 = ln_fp32(hidden, lp["input_ln_w"], lp["input_ln_b"], eps).to(dt)
    attn = parallel_attention(cfg, lp, ln1, attention_mask, s_attn,
                              deterministic, layer_number,
                              fuse_tail=cfg.fused_block)
    attn = tap("apex_tpu.transformer_layer/attn", attn, layer=layer_number)
    if cfg.fused_block:
        p = 0.0 if deterministic or s_res1 is None else cfg.hidden_dropout
        hidden, ln2 = residual_add_layer_norm(
            attn, lp["proj_b"].to(dt), hidden, lp["post_ln_w"],
            lp["post_ln_b"], eps=eps, dropout_p=p,
            seed=_hash_dropout_seed(s_res1, p))
        mlp_out = tap("apex_tpu.transformer_layer/mlp",
                      parallel_mlp(cfg, lp, ln2, fuse_tail=True),
                      layer=layer_number)
        p = 0.0 if deterministic or s_res2 is None else cfg.hidden_dropout
        return bias_dropout_residual(
            mlp_out, lp["fc2_b"].to(dt), hidden, dropout_p=p,
            seed=_hash_dropout_seed(s_res2, p))
    hidden = (hidden + _dropout(attn, cfg.hidden_dropout, s_res1,
                                deterministic)).to(dt)
    ln2 = ln_fp32(hidden, lp["post_ln_w"], lp["post_ln_b"], eps).to(dt)
    mlp_out = tap("apex_tpu.transformer_layer/mlp",
                  parallel_mlp(cfg, lp, ln2), layer=layer_number)
    return (hidden + _dropout(mlp_out, cfg.hidden_dropout, s_res2,
                              deterministic)).to(dt)


def _hash_dropout_seed(seed: Optional[int], p: float) -> Optional[int]:
    """The int32 seed of a fused tail's hash dropout (drawn per layer and
    tail from the step's generator by :func:`_draw_seed`, in
    :func:`gpt_hidden`), or None when dropout is off."""
    return None if p <= 0.0 or seed is None else seed


#: forward ops whose outputs "selective" recompute keeps, besides the
#: weight GEMMs: flash attention's (o, lse), from which its backward
#: recomputes the scores, and the norms' O(s)-size outputs (the JAX
#: policy's flash, LayerNorm and RMSNorm kernels). Not a blanket
#: match: replaying the cheap elementwise work is the point. The fused
#: softmax forwards (SOFTMAX_FWD, SOFTMAX_MASKED_FWD) are deliberately
#: absent, as in the JAX policy: they emit the [b, n, s, s] probabilities,
#: the activation selective recompute exists not to keep, so the backward
#: replays them.
_SELECTIVE_SAVEABLE_OPS = frozenset({FLASH_ATTN_FWD, LAYER_NORM_FWD,
                                     RMS_NORM_FWD})

#: "selective_elementwise" also keeps the fused tails' forward outputs, so
#: the backward replays only the unfused remainder (casts, copies)
_FUSED_BLOCK_SAVEABLE_OPS = frozenset({
    BIAS_GELU_FWD, BIAS_DROPOUT_RESIDUAL_FWD, RESIDUAL_LN_FWD,
})

#: the weight GEMMs: ``F.linear`` on an ``[s, b, h]`` activation reaches
#: ``aten::mm`` on the flattened rows, a product with no batch dims (JAX's
#: ``dots_with_no_batch_dims_saveable``); ``bmm`` has batch dims and is
#: replayed
_NO_BATCH_DIM_GEMMS = frozenset({"aten::mm", "aten::addmm"})


def _policy_with_saveable_ops(ops: frozenset, ctx, op, *args, **kwargs):
    """Selective-checkpoint policy: keep the outputs of the weight GEMMs
    and of the named forward ops in ``ops``; replay everything else.
    ``op`` is the dispatcher op (``torch.library`` custom ops carry the
    kernels' names)."""
    name = op.name()
    if name in _NO_BATCH_DIM_GEMMS or name in ops:
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


_selective_policy = functools.partial(_policy_with_saveable_ops,
                                      _SELECTIVE_SAVEABLE_OPS)
_selective_elementwise_policy = functools.partial(
    _policy_with_saveable_ops,
    _SELECTIVE_SAVEABLE_OPS | _FUSED_BLOCK_SAVEABLE_OPS)
_POLICIES = {"selective": _selective_policy,
             "selective_elementwise": _selective_elementwise_policy}


def transformer_block(cfg: GPTConfig, layer_params: Dict[str, torch.Tensor],
                      hidden: torch.Tensor,
                      attention_mask: Optional[torch.Tensor],
                      layer_seeds: Optional[list] = None,
                      deterministic: bool = True) -> torch.Tensor:
    """The stacked ``[L, ...]`` layers in a Python loop (the JAX
    ``lax.scan``). The stacks are unbound once, so the backward stacks
    the per-layer gradients in one copy. ``recompute_granularity="full"``
    recomputes each layer in the backward (``torch.utils.checkpoint``);
    ``"selective"`` keeps the weight-GEMM, flash-attention and LayerNorm
    outputs and replays the rest (a selective-checkpoint context whose
    policy matches dispatcher ops by name); ``"selective_elementwise"``
    also keeps the fused tails' outputs (pairs with ``fused_block``; the
    backward then launches no forward kernel again). Dropout seeds are
    fixed per layer beforehand, so a recomputed layer draws the same
    masks."""
    rg = cfg.recompute_granularity
    if rg not in (None, "full", "selective", "selective_elementwise"):
        raise ValueError(
            f"unknown recompute_granularity {rg!r}: use None, 'full', "
            "'selective' or 'selective_elementwise'")
    keys = sorted(layer_params)
    stacks = [layer_params[k].unbind(0) for k in keys]
    L = len(stacks[0])
    for l in range(L):
        seeds = None if layer_seeds is None else layer_seeds[l]

        def run(h, *vals, seeds=seeds, l=l):
            return transformer_layer(cfg, dict(zip(keys, vals)), h,
                                     attention_mask, seeds, deterministic,
                                     l + 1)

        vals = [st[l] for st in stacks]
        if rg is None:
            hidden = run(hidden, *vals)
        else:
            kw = {} if rg == "full" else dict(context_fn=functools.partial(
                create_selective_checkpoint_contexts, _POLICIES[rg]))
            hidden = checkpoint(run, hidden, *vals, use_reentrant=False,
                                preserve_rng_state=False, **kw)
    return hidden


def _local_position_ids(cfg: GPTConfig, s_loc: int,
                        device=None) -> torch.Tensor:
    """``[s_loc]`` position ids (no context parallelism in the port)."""
    if s_loc > cfg.max_position_embeddings:
        raise ValueError(
            f"sequence {s_loc} exceeds max_position_embeddings="
            f"{cfg.max_position_embeddings}")
    return torch.arange(s_loc, device=device)


def gpt_embed(cfg: GPTConfig, params: Params, tokens: torch.Tensor,
              position_ids: Optional[torch.Tensor] = None,
              dropout_seed: Optional[int] = None,
              deterministic: bool = True) -> torch.Tensor:
    """Word + position embeddings -> ``[s, b, h]`` in compute_dtype."""
    b, s = tokens.shape
    if position_ids is None:
        position_ids = _local_position_ids(
            cfg, s, tokens.device).expand(b, s)
    word = F.embedding(tokens.long(), params["embedding"]["word"])
    pos = F.embedding(position_ids.long(), params["embedding"]["position"])
    emb = (word + pos).to(cfg.compute_dtype).transpose(0, 1).contiguous()
    return _dropout(emb, cfg.hidden_dropout, dropout_seed, deterministic)


def gpt_hidden(cfg: GPTConfig, params: Params, tokens: torch.Tensor,
               generator: Optional[torch.Generator] = None,
               deterministic: bool = True) -> torch.Tensor:
    """GPT trunk -> pre-head hidden states ``[s, b, h]`` in
    compute_dtype: embeddings, the layer stack, the final LayerNorm.
    Dropout (when not ``deterministic``) draws its seeds from
    ``generator``."""
    return _trunk(cfg, params, tokens, None, generator, deterministic)


def _trunk(cfg: GPTConfig, params: Params, tokens: torch.Tensor,
           attention_mask: Optional[torch.Tensor],
           generator: Optional[torch.Generator],
           deterministic: bool) -> torch.Tensor:
    """Embeddings, the layer stack under ``attention_mask``, the final
    LayerNorm -> ``[s, b, h]`` in compute_dtype; dropout seeds (one for
    the embeddings, three per layer) drawn from ``generator``."""
    embed_seed = layer_seeds = None
    if generator is not None and not deterministic:
        embed_seed = _draw_seed(generator)
        layer_seeds = [tuple(_draw_seed(generator) for _ in range(3))
                       for _ in range(cfg.num_layers)]
    hidden = gpt_embed(cfg, params, tokens, None, embed_seed, deterministic)
    hidden = transformer_block(cfg, params["layers"], hidden,
                               attention_mask, layer_seeds, deterministic)
    return ln_fp32(hidden, params["final_ln_w"], params["final_ln_b"],
                   cfg.layernorm_epsilon).to(cfg.compute_dtype)


def gpt_loss(cfg: GPTConfig, params: Params, tokens: torch.Tensor,
             labels: torch.Tensor, loss_mask: Optional[torch.Tensor] = None,
             generator: Optional[torch.Generator] = None,
             deterministic: bool = True) -> torch.Tensor:
    """Masked mean LM loss, single device: the head GEMM and the cross
    entropy chunk-fused (``contrib.xentropy.lm_head_cross_entropy``),
    rows in ``[s, b]`` order, the chunk the largest divisor of ``s * b``
    that is at most 2048."""
    hidden = gpt_hidden(cfg, params, tokens, generator, deterministic)
    s, b, h = hidden.shape
    n = s * b
    chunk = next(c for c in range(min(2048, n), 0, -1) if n % c == 0)
    losses = lm_head_cross_entropy(
        hidden.reshape(n, h), params["embedding"]["word"],
        labels.transpose(0, 1).reshape(n), chunk_size=chunk,
        save_logits_dtype=cfg.compute_dtype if cfg.ce_save_logits
        else None).reshape(s, b).transpose(0, 1)  # [b, s]
    if loss_mask is None:
        return losses.mean()
    m = loss_mask.to(torch.float32)
    return (losses * m).sum() / m.sum().clamp_min(1.0)


# --------------------------------------------------------------------------
# BERT
# --------------------------------------------------------------------------

def bert_forward(cfg: GPTConfig, params: Params, tokens: torch.Tensor,
                 padding_mask: Optional[torch.Tensor] = None,
                 generator: Optional[torch.Generator] = None,
                 deterministic: bool = True):
    """BERT-style bidirectional encoder (the JAX ``bert_forward``):
    ``tokens [b, s]`` and ``padding_mask [b, s]`` (1 = real token,
    default all real) -> ``(lm_logits [b, s, vocab] fp32, binary_logits
    [b, 2] or None)``. The layers run with ``attn_mask_type=padding``
    under the int8 ``[b, 1, 1, s]`` mask (nonzero = masked out), which
    flash attention takes as its key mask and the softmax path as its
    mask; then the final LayerNorm, the tied head with fp32 logits and,
    with ``cfg.add_binary_head``, the tanh pooler over the first token
    and the binary head."""
    b, s = tokens.shape
    if padding_mask is None:
        padding_mask = torch.ones((b, s), dtype=torch.int32,
                                  device=tokens.device)
    attn_mask = (padding_mask[:, None, None, :] == 0).to(torch.int8)
    cfg_pad = dataclasses.replace(cfg, attn_mask_type=AttnMaskType.padding)
    hidden = _trunk(cfg_pad, params, tokens, attn_mask, generator,
                    deterministic)
    # the head reads [b, s, h] rows, so the logits come out [b, s, v]
    lm_logits = lm_head(hidden.transpose(0, 1), params["embedding"]["word"])
    binary_logits = None
    if cfg.add_binary_head and "binary_head" in params:
        bh = params["binary_head"]
        dt = hidden.dtype
        pooled = torch.tanh(hidden[0] @ bh["pooler_w"].to(dt)
                            + bh["pooler_b"].to(dt))
        binary_logits = pooled @ bh["head_w"].t().to(dt) + bh["head_b"].to(dt)
    return lm_logits, binary_logits
