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
  :func:`parallel_attention` (flash attention only), :func:`parallel_mlp`,
  :func:`transformer_layer` (the unfused branch), :func:`transformer_block`
  (a loop over the stacked layers, ``recompute_granularity`` None or
  ``"full"``), :func:`gpt_embed`, :func:`gpt_hidden` and
  :func:`gpt_loss` (the single-device branch: chunked LM-head cross
  entropy). The kernels on it are the LayerNorm forward and backward
  and the flash-attention forward and backward; GEMMs are
  ``F.linear`` / ``torch.mm``, as the JAX package left them to XLA.

Not ported yet (ROADMAP.md): tensor, sequence and context parallelism,
fp8, the fused block tails (``fused_block``), the ``selective``
recompute policies, the non-flash attention path (fused softmax
kernels) and fp16 query-key layer scaling; each raises
``NotImplementedError``. Hidden dropout draws from an explicit
``torch.Generator`` (JAX's ``bernoulli`` stream cannot be matched);
attention dropout is the kernels' hash, seeded from the same generator.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ...contrib.xentropy import lm_head_cross_entropy, logits_f32
from ...ops.flash_attention import flash_attention_sbhd
from ...ops.layer_norm import layer_norm
from ..enums import AttnMaskType

Params = Dict[str, Any]


@dataclasses.dataclass
class GPTConfig:
    """Model config (the JAX ``GPTConfig``'s fields for one device and
    the unfused step, with its defaults)."""

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
    # None | "full" ("selective*" come with the fused-block slice)
    recompute_granularity: Optional[str] = None
    # None = flash attention (the only attention path ported); False
    # raises (the non-flash path runs the fused-softmax kernels)
    use_flash_attention: Optional[bool] = None
    # save each CE chunk's logits in compute_dtype instead of
    # recomputing the chunk GEMM in backward (changes the forward loss:
    # the CE of the rounded logits)
    ce_save_logits: bool = False

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
    biases, unit LN weights. Draws happen on ``generator``'s device and
    land on ``device`` (default: the generator's)."""
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

    return {
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


def ln_fp32(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
            eps: float) -> torch.Tensor:
    """LayerNorm on an fp32 copy (the training path normalises in fp32
    and the caller casts back)."""
    return layer_norm(x.float(), w.float(), b.float(), eps=eps)


def linear(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``x @ w^T + b`` with the GEMM and the bias add rounded separately
    in ``x``'s dtype, as the JAX einsum-then-add does."""
    return F.linear(x, w.to(x.dtype)) + b.to(x.dtype)


def lm_head(h: torch.Tensor, word: torch.Tensor) -> torch.Tensor:
    """Tied-embedding head with fp32 logits from fp32 accumulation
    (``contrib.xentropy.logits_f32``: on the card one bf16 GEMM that
    writes fp32, reading the bf16 embedding as it is; a plain bf16
    matmul would round the logits to bf16 and create argmax ties)."""
    lead = h.shape[:-1]
    out = logits_f32(h.reshape(-1, h.shape[-1]), word)
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


def _not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported yet (ROADMAP.md)")


def parallel_attention(cfg: GPTConfig, lp: Dict[str, torch.Tensor],
                       hidden: torch.Tensor,
                       attention_mask: Optional[torch.Tensor],
                       dropout_seed: Optional[int], deterministic: bool,
                       layer_number: Optional[int] = None) -> torch.Tensor:
    """Self-attention on one device: fused QKV GEMM, flash attention,
    output projection (the JAX ``parallel_attention``'s flash path)."""
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
    if cfg.use_flash_attention and not flash_compatible:
        raise ValueError(
            "use_flash_attention=True but the configuration is not "
            "flash-compatible (fp16 qk layer scaling or a non-causal/"
            "non-padding mask)")
    if cfg.use_flash_attention is False or not flash_compatible:
        raise _not_ported(
            "attention without flash (the fused scale-mask-softmax "
            "kernels, TPU kernels #14-#16) and fp16 query-key layer "
            "scaling")
    p = 0.0 if deterministic or dropout_seed is None \
        else float(cfg.attention_dropout)
    flash_kw = dict(dropout_p=p, dropout_seed=dropout_seed) if p > 0.0 \
        else {}
    ctx = flash_attention_sbhd(q, k, v, causal=causal, kv_mask=kv_mask,
                               scale=1.0 / (hn ** 0.5), **flash_kw)
    ctx = ctx.to(hidden.dtype).reshape(s, b, n * hn)
    return _attn_out_proj(cfg, lp, ctx)


def _attn_out_proj(cfg: GPTConfig, lp: Dict[str, torch.Tensor],
                   ctx: torch.Tensor) -> torch.Tensor:
    """Attention output projection (dense, with its bias)."""
    return linear(ctx, lp["proj_w"], lp["proj_b"])


def parallel_mlp(cfg: GPTConfig, lp: Dict[str, torch.Tensor],
                 hidden: torch.Tensor) -> torch.Tensor:
    """h -> 4h GEMM + bias, tanh GeLU, 4h -> h GEMM + bias (the JAX
    ``parallel_mlp`` with ``fuse_tail=False``)."""
    inter = F.gelu(linear(hidden, lp["fc1_w"], lp["fc1_b"]),
                   approximate="tanh")
    return linear(inter, lp["fc2_w"], lp["fc2_b"])


def transformer_layer(cfg: GPTConfig, lp: Dict[str, torch.Tensor],
                      hidden: torch.Tensor,
                      attention_mask: Optional[torch.Tensor],
                      seeds: Optional[tuple], deterministic: bool,
                      layer_number: Optional[int] = None) -> torch.Tensor:
    """Pre-LN transformer layer, the unfused branch: LayerNorm on an fp32
    copy, attention, dropout + residual, LayerNorm, MLP, dropout +
    residual. ``seeds`` = (attention, attention-residual, MLP-residual)
    dropout seeds, or None."""
    dt = hidden.dtype
    eps = cfg.layernorm_epsilon
    s_attn, s_res1, s_res2 = seeds if seeds is not None else (None,) * 3
    ln1 = ln_fp32(hidden, lp["input_ln_w"], lp["input_ln_b"], eps).to(dt)
    attn = parallel_attention(cfg, lp, ln1, attention_mask, s_attn,
                              deterministic, layer_number)
    hidden = (hidden + _dropout(attn, cfg.hidden_dropout, s_res1,
                                deterministic)).to(dt)
    ln2 = ln_fp32(hidden, lp["post_ln_w"], lp["post_ln_b"], eps).to(dt)
    mlp_out = parallel_mlp(cfg, lp, ln2)
    return (hidden + _dropout(mlp_out, cfg.hidden_dropout, s_res2,
                              deterministic)).to(dt)


def transformer_block(cfg: GPTConfig, layer_params: Dict[str, torch.Tensor],
                      hidden: torch.Tensor,
                      attention_mask: Optional[torch.Tensor],
                      layer_seeds: Optional[list] = None,
                      deterministic: bool = True) -> torch.Tensor:
    """The stacked ``[L, ...]`` layers in a Python loop (the JAX
    ``lax.scan``). The stacks are unbound once, so the backward stacks
    the per-layer gradients in one copy. ``recompute_granularity="full"``
    recomputes each layer in the backward (``torch.utils.checkpoint``);
    dropout seeds are fixed per layer beforehand, so the recomputed
    layer draws the same masks."""
    rg = cfg.recompute_granularity
    if rg in ("selective", "selective_elementwise"):
        raise _not_ported(f"recompute_granularity={rg!r} (it comes with "
                          "the fused-block slice)")
    if rg not in (None, "full"):
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
        if rg == "full":
            hidden = checkpoint(run, hidden, *vals, use_reentrant=False,
                                preserve_rng_state=False)
        else:
            hidden = run(hidden, *vals)
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
    embed_seed = layer_seeds = None
    if generator is not None and not deterministic:
        embed_seed = _draw_seed(generator)
        layer_seeds = [tuple(_draw_seed(generator) for _ in range(3))
                       for _ in range(cfg.num_layers)]
    hidden = gpt_embed(cfg, params, tokens, None, embed_seed, deterministic)
    hidden = transformer_block(cfg, params["layers"], hidden, None,
                               layer_seeds, deterministic)
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
