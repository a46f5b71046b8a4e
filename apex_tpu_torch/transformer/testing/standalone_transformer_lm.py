"""The GPT of ``apex_tpu/transformer/testing/standalone_transformer_lm.py``
for serving and training, on one device or tensor-parallel.

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
- fp8 (``GPTConfig.fp8``): the four projection GEMMs of a layer (qkv,
  proj, fc1, fc2) on the e4m3 / e5m2 delayed-scaling recipe of
  ``fused_dense.fp8_fused_dense_qgrad`` (the library fp8 GEMM on the
  card), the states threaded through :func:`transformer_block` as
  ``[L, ...]`` stacks: :func:`init_gpt_fp8_states`,
  :func:`init_gpt_fp8_carriers`, ``gpt_loss(..., fp8_states=,
  fp8_carriers=)`` returning ``(loss, new_states)``, and
  :func:`record_gpt_grad_amaxes` over the carriers' gradients.
- tensor and sequence parallelism (``axis_name="tensor"`` on
  :func:`parallel_attention`, :func:`parallel_mlp`,
  :func:`transformer_layer`, :func:`transformer_block`,
  :func:`gpt_embed`, :func:`gpt_hidden`, :func:`gpt_forward`,
  :func:`gpt_loss` and :func:`bert_forward`): the params are this rank's
  shards (:func:`shard_gpt_params` cuts them by
  :func:`gpt_partition_specs`), the projections are the
  ``tensor_parallel`` column / row linears, the embedding and the tied
  head are vocab-parallel and the loss is ``vocab_parallel_cross_entropy``
  over the vocab-sharded logits that ``gpt_forward`` then returns. With
  ``GPTConfig.sequence_parallel`` the activations between the linears
  are split along the sequence: scattered after the embedding, gathered
  before the head, and the parameters that meet only this rank's rows
  (the LayerNorms, ``proj_b``, ``fc2_b``) enter through the copy into
  the tensor region, so their gradients are summed over the ranks in the
  backward, as the JAX package's autodiff sums them. The fused qkv
  weight is cut in contiguous ``3h / tp`` rows, which are whole heads
  with their own q, k and v in the per-head ``[q, k, v]`` layout of the
  split below. A rank is a process; the collectives run over the
  ``parallel_state`` group of the axis (``tensor_parallel.mappings``).

- context parallelism (``GPTConfig.context_parallel_axis``, a
  ``parallel_state`` axis, any name without model parallelism (the
  default group), or a ``ProcessGroup``): the sequence is sharded over
  the group end to end, contiguously by rank or, with
  ``context_parallel_zigzag``, in the layout of
  ``context_parallel.zigzag_indices``; attention is
  ``context_parallel.ring_attention`` (causal only, not with sequence
  parallelism, no qk layer scaling or attention dropout, flash
  required; zigzag needs a local sequence divisible by 16), the
  position ids are this rank's global ones, the hidden-dropout
  generator is forked by the rank, and the loss is the masked mean whose
  numerator and denominator are summed over the group (all-reduce
  forward, the same cotangent on every rank backward). The parameters
  are replicated over the group: ``gpt_loss`` passes them through the
  copy into the group's region (identity forward, all-reduce backward),
  so their gradients come back summed over the ranks, as the JAX
  package's autodiff sums them.
- pipeline stages: :func:`pipeline_stage_layers` cuts the stacked layer
  tree into a stage's ``vpp`` chunks in the reference layout (chunk
  ``c`` of stage ``s`` holds layer block ``c pp + s``); the pipelined
  model is composed by the caller around the schedules of
  ``pipeline_parallel``, as the JAX package's callers compose it.

``fp8_amax_reduction_axes`` names ``transformer.parallel_state`` axes:
each layer's x and w amaxes, and each projection's stacked gradient
amaxes, are MAX-reduced over that group, one all-reduce a site, where
the JAX package ``pmax``es (under tensor parallelism with model
parallelism initialised and no axes named, over the amax group). Hidden
dropout of the unfused branch draws from an explicit ``torch.Generator``
(JAX's ``bernoulli`` stream cannot be matched); attention dropout and
the fused tails' hidden dropout are the kernels' hash, seeded from the
same generator. Under tensor parallelism every rank draws the same seeds
(the activations are replicated); under sequence parallelism the
generator is forked by rank first
(``tensor_parallel.model_parallel_rng_key``), as the JAX package folds
the rank into its key.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

from ..._device import resolve_device
from ..._tree import tree_map
from ...contrib.xentropy import lm_head_cross_entropy, lm_logits
from ...fused_dense.fp8 import (
    FP8_GEMM,
    fp8_fused_dense_qgrad,
    init_fp8_dense_state,
    record_grad_amax,
)
from ...ops.flash_attention import (
    FLASH_ATTN_FWD,
    MAX_HEAD_DIM,
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
from ..tensor_parallel import (
    column_parallel_linear,
    mappings,
    model_parallel_rng_key,
    row_parallel_linear,
    vocab_parallel_cross_entropy,
    vocab_parallel_embedding,
)

Params = Dict[str, Any]


@dataclasses.dataclass
class GPTConfig:
    """Model config (the JAX ``GPTConfig``'s fields, with its
    defaults)."""

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
    # the tensor group's size (checked against the group of the axis_name
    # the functions are given) and Megatron's sequence parallelism
    tensor_model_parallel_size: int = 1
    sequence_parallel: bool = False
    # context parallelism: the axis (a parallel_state axis name, any name
    # without model parallelism, or a ProcessGroup) the sequence is
    # sharded over end to end; zigzag selects the load-balanced layout
    context_parallel_axis: Optional[Any] = None
    context_parallel_zigzag: bool = False
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
    # fp8 (e4m3 forward, e5m2 gradients, delayed scaling) on the four
    # projection GEMMs of a layer (qkv / proj / fc1 / fc2): pass
    # init_gpt_fp8_states(cfg) and init_gpt_fp8_carriers(cfg) to gpt_loss.
    # fp8_amax_reduction_axes: parallel_state axes the amaxes are
    # MAX-reduced over (the JAX package's pmax over mesh axes)
    fp8: bool = False
    fp8_margin: float = 0.0
    fp8_amax_history_len: int = 16
    fp8_amax_reduction_axes: Optional[Tuple[str, ...]] = None
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


def gpt_partition_specs(cfg: GPTConfig) -> Params:
    """Which dim of each parameter is split over the ``tensor`` axis, or
    None (replicated), in the tree of :func:`init_gpt_params`: the JAX
    package's ``PartitionSpec`` tree as dims (``P(None, t, None)`` is
    1). Column weights and biases are split along their output rows,
    row weights along their input columns, the word embedding along the
    vocab; the rest is replicated."""
    specs = {
        "embedding": {"word": 0, "position": None},
        "layers": {
            "input_ln_w": None, "input_ln_b": None,
            "qkv_w": 1, "qkv_b": 1,
            "proj_w": 2, "proj_b": None,
            "post_ln_w": None, "post_ln_b": None,
            "fc1_w": 1, "fc1_b": 1,
            "fc2_w": 2, "fc2_b": None,
        },
        "final_ln_w": None, "final_ln_b": None,
    }
    if cfg.add_binary_head:
        specs["binary_head"] = {"pooler_w": None, "pooler_b": None,
                                "head_w": None, "head_b": None}
    return specs


def shard_gpt_params(params: Params, cfg: GPTConfig, rank: int,
                     tp: int) -> Params:
    """Rank ``rank``'s shards of a full parameter tree over ``tp`` ranks,
    cut by :func:`gpt_partition_specs` (contiguous copies; replicated
    leaves are the caller's tensors)."""
    specs = gpt_partition_specs(cfg)

    def cut(t, dim):
        if dim is None:
            return t
        if t.shape[dim] % tp != 0:
            raise ValueError(f"dim {dim} of {tuple(t.shape)} is not "
                             f"divisible by tp={tp}")
        return t.chunk(tp, dim=dim)[rank].contiguous()

    def walk(p, s):
        if isinstance(p, dict):
            return {k: walk(v, s[k]) for k, v in p.items()}
        return cut(p, s)

    return walk(params, specs)


def pipeline_stage_layers(layers: Params, cfg: GPTConfig, stage: int,
                          pp: int, vpp: int = 1) -> Params:
    """Stage ``stage``'s layers of the stacked ``[L, ...]`` layer tree
    (``params["layers"]``, whole or a tensor-parallel shard) in the
    reference's interleaved layout: ``L / (pp vpp)`` layers a chunk,
    chunk ``c`` holding global layer block ``c pp + stage``; leaves
    ``[L / pp, ...]`` with ``vpp`` 1, else ``[vpp, L / (pp vpp), ...]``
    (the schedules' chunk axis). The counterpart of the JAX callers'
    ``P("pipeline", ...)`` in_specs."""
    L = cfg.num_layers
    if L % (pp * vpp) != 0:
        raise ValueError(f"num_layers {L} is not divisible by pp x vpp = "
                         f"{pp} x {vpp}")
    block = L // (pp * vpp)

    def cut(t):
        chunks = [t[(c * pp + stage) * block:(c * pp + stage + 1) * block]
                  for c in range(vpp)]
        return chunks[0].contiguous() if vpp == 1 else torch.stack(chunks)

    return {k: cut(v) for k, v in layers.items()}


def _tp_world(cfg: GPTConfig, axis_name) -> int:
    """The tensor group's size on ``axis_name`` (1 without one), checked
    against ``cfg.tensor_model_parallel_size``."""
    if axis_name is None:
        return 1
    world = mappings.axis_world(axis_name)[1]
    if world != cfg.tensor_model_parallel_size:
        raise ValueError(
            f"GPTConfig.tensor_model_parallel_size="
            f"{cfg.tensor_model_parallel_size} but the group of axis "
            f"{axis_name!r} has {world} ranks")
    return world


def _sp(cfg: GPTConfig, axis_name) -> bool:
    return axis_name is not None and cfg.sequence_parallel


def _replicated(cfg: GPTConfig, t: torch.Tensor, axis_name) -> torch.Tensor:
    """A replicated parameter that meets only this rank's sequence rows
    under sequence parallelism enters through the copy into the tensor
    region (identity forward, its gradient summed over the ranks
    backward); anywhere else it is used as it is."""
    if _sp(cfg, axis_name):
        return mappings.copy_to_tensor_model_parallel_region(t, axis_name)
    return t


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


def _lm_head(cfg: GPTConfig, params: Params, hidden: torch.Tensor,
             axis_name) -> torch.Tensor:
    """The tied head over ``[s, b, h]`` -> fp32 logits ``[s, b, vocab]``,
    under tensor parallelism over this rank's vocab rows: the replicated
    hidden enters through the copy into the region (its partial gradients
    all-reduced backward); under sequence parallelism the gather before
    the head already sums them (its reduce-scatter), so no copy."""
    if axis_name is not None and not cfg.sequence_parallel:
        hidden = mappings.copy_to_tensor_model_parallel_region(hidden,
                                                               axis_name)
    return lm_head(hidden, params["embedding"]["word"])


def gpt_forward(cfg: GPTConfig, params: Params, tokens: torch.Tensor,
                fp8_states=None, fp8_carriers=None, axis_name=None,
                generator: Optional[torch.Generator] = None,
                deterministic: bool = True):
    """Dense inference forward: ``tokens [b, s]`` -> fp32 logits
    ``[b, s, vocab]``. Deterministic (no dropout); causal attention
    with an fp32 softmax over all earlier positions.

    With ``axis_name`` (tensor parallelism), with ``cfg.fp8``
    (``fp8_states`` and ``fp8_carriers`` given, which :func:`gpt_hidden`
    checks) or with ``deterministic=False`` the logits come from the
    training path, as the JAX ``gpt_forward`` computes them
    (:func:`gpt_hidden`, then the tied head): under tensor parallelism
    they are this rank's vocab shard ``[b, s, vocab / tp]``; with fp8
    ``(logits, new_fp8_states)`` is returned."""
    if cfg.fp8 or fp8_states is not None or axis_name is not None \
            or not deterministic or cfg.context_parallel_axis is not None:
        hidden = gpt_hidden(cfg, params, tokens, generator, deterministic,
                            fp8_states, fp8_carriers, axis_name=axis_name)
        new_fp8 = None
        if fp8_states is not None:
            hidden, new_fp8 = hidden
        logits = _lm_head(cfg, params, hidden, axis_name).transpose(0, 1)
        return logits if fp8_states is None else (logits, new_fp8)
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


FP8_GEMM_NAMES = ("qkv", "proj", "fc1", "fc2")


def init_gpt_fp8_states(cfg: GPTConfig, device=None):
    """Per-layer delayed-scaling state of the four projection GEMMs:
    ``{name: Fp8DenseState with [L, ...] leaves}`` on ``device`` (None:
    the card), with gradient metas. Thread through ``gpt_loss(...,
    fp8_states=...)``; the returned states carry the rolled x and w
    histories, and the gradient amaxes come back as the gradients of
    the ``fp8_carriers`` (fold them in with
    :func:`record_gpt_grad_amaxes`)."""
    one = init_fp8_dense_state(cfg.fp8_amax_history_len,
                               with_grad_meta=True,
                               device=resolve_device(device))
    return {name: tree_map(lambda t: t.expand(cfg.num_layers, *t.shape)
                           .clone(), one)
            for name in FP8_GEMM_NAMES}


def init_gpt_fp8_carriers(cfg: GPTConfig, device=None):
    """Zero per-layer gradient-amax carriers ``{name: [L] fp32}``:
    differentiate with respect to them; their gradients are the
    per-layer ``max|dY|``."""
    device = resolve_device(device)
    return {name: torch.zeros(cfg.num_layers, dtype=torch.float32,
                              device=device)
            for name in FP8_GEMM_NAMES}


def record_gpt_grad_amaxes(cfg: GPTConfig, fp8_states, carrier_grads):
    """Fold the backward-observed gradient amaxes (the carriers'
    gradients) into each layer's g meta."""
    return {name: record_grad_amax(
                fp8_states[name], carrier_grads[name],
                margin=cfg.fp8_margin,
                amax_reduction_axes=cfg.fp8_amax_reduction_axes)
            for name in FP8_GEMM_NAMES}


def _fp8_dense(cfg: GPTConfig, fp8, name: str, x: torch.Tensor,
               w: torch.Tensor, b: Optional[torch.Tensor]):
    """One fp8 projection: the e4m3 GEMM with this layer's state and
    carrier, then the bias in ``x``'s dtype; returns ``(y,
    new_state)``."""
    state, carrier = fp8[name]
    y, new_state = fp8_fused_dense_qgrad(
        x, w, None, state, carrier, margin=cfg.fp8_margin,
        amax_reduction_axes=cfg.fp8_amax_reduction_axes)
    if b is not None:
        y = y + b.to(y.dtype)
    return y, new_state


def _proj(cfg: GPTConfig, fp8, name: str, x: torch.Tensor,
          w: torch.Tensor, b: Optional[torch.Tensor], axis_name,
          column: bool):
    """One projection of a layer -> ``(y, new fp8 state or None)``:
    dense (:func:`linear`, or :func:`_fp8_dense` with ``fp8``) without
    ``axis_name``; else the column-parallel (``column``) or row-parallel
    linear over this rank's shard, sequence-parallel with
    ``cfg.sequence_parallel``, fp8 with ``fp8``."""
    if axis_name is None:
        if fp8 is not None:
            return _fp8_dense(cfg, fp8, name, x, w.to(x.dtype), b)
        return linear(x, w, b), None
    st, car = fp8[name] if fp8 is not None else (None, None)
    fn = column_parallel_linear if column else row_parallel_linear
    kw = dict(gather_output=False) if column else \
        dict(input_is_parallel=True)
    y, _, new = fn(x, w.to(x.dtype), None if b is None else b.to(x.dtype),
                   axis_name=axis_name,
                   sequence_parallel_enabled=cfg.sequence_parallel,
                   fp8_state=st, fp8_grad_carrier=car,
                   fp8_amax_reduction_axes=cfg.fp8_amax_reduction_axes,
                   fp8_margin=cfg.fp8_margin, **kw)
    return y, new


def parallel_attention(cfg: GPTConfig, lp: Dict[str, torch.Tensor],
                       hidden: torch.Tensor,
                       attention_mask: Optional[torch.Tensor],
                       dropout_seed: Optional[int], deterministic: bool,
                       layer_number: Optional[int] = None,
                       fuse_tail: bool = False, fp8=None, axis_name=None):
    """Self-attention (the JAX ``parallel_attention``): fused QKV GEMM
    (column-parallel over this rank's heads with ``axis_name``, whose
    ``3h / tp`` rows are whole heads in the per-head ``[q, k, v]``
    layout), then flash attention or, with
    ``use_flash_attention=False`` or where flash does not apply (the
    configuration, or with ``None`` a head dim the device's flash kernels
    do not take: ``flash_attention_available``), the scores through
    :func:`_softmax_attention`; output projection. ``True`` where flash
    cannot run raises ``ValueError``.
    ``fuse_tail`` leaves ``proj_b`` to the caller's fused tail. With
    ``fp8`` (``{name: (Fp8DenseState, carrier)}`` for qkv and proj) the
    projections run the fp8 recipe and ``(out, new_fp8)`` is returned.
    The output projection is row-parallel with ``axis_name``."""
    b = hidden.shape[1]
    n = cfg.num_attention_heads // _tp_world(cfg, axis_name)
    hn = cfg.kv_channels
    qkv, state = _proj(cfg, fp8, "qkv", hidden, lp["qkv_w"], lp["qkv_b"],
                       axis_name, column=True)
    new_fp8 = None if fp8 is None else {"qkv": state}
    # under sequence parallelism the column-parallel QKV gathered the
    # [s/tp] rows back to the whole sequence
    s = qkv.shape[0]
    qkv = qkv.reshape(s, b, n, 3 * hn)
    q, k, v = qkv.split(hn, dim=-1)  # [s, b, n, hn]
    qk_scaling = (cfg.apply_query_key_layer_scaling
                  and cfg.compute_dtype == torch.float16
                  and layer_number is not None)
    if cfg.context_parallel_axis is not None:
        ctx = _context_parallel_attention(cfg, q, k, v, qk_scaling,
                                          dropout_seed, deterministic)
        return _attn_out_proj(cfg, lp, ctx.to(hidden.dtype), fuse_tail,
                              fp8, new_fp8, axis_name)
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
            f"head dims up to {MAX_HEAD_DIM})")
    if not use_flash:
        ctx = _softmax_attention(cfg, q, k, v, attention_mask, causal,
                                 layer_number if qk_scaling else None,
                                 dropout_seed, deterministic)
        return _attn_out_proj(cfg, lp, ctx.to(hidden.dtype), fuse_tail,
                              fp8, new_fp8, axis_name)
    p = 0.0 if deterministic or dropout_seed is None \
        else float(cfg.attention_dropout)
    flash_kw = dict(dropout_p=p, dropout_seed=dropout_seed) if p > 0.0 \
        else {}
    ctx = flash_attention_sbhd(q, k, v, causal=causal, kv_mask=kv_mask,
                               scale=1.0 / (hn ** 0.5), **flash_kw)
    ctx = ctx.to(hidden.dtype).reshape(s, b, n * hn)
    return _attn_out_proj(cfg, lp, ctx, fuse_tail, fp8, new_fp8, axis_name)


def _context_parallel_attention(cfg: GPTConfig, q, k, v, qk_scaling: bool,
                                dropout_seed, deterministic: bool):
    """Ring attention over ``cfg.context_parallel_axis`` on ``[s_loc, b,
    n, hn]`` -> context ``[s_loc, b, n * hn]``, after the JAX package's
    refusals."""
    from ..context_parallel import ring_attention

    s, b, n, hn = q.shape
    if cfg.attn_mask_type != AttnMaskType.causal:
        raise ValueError("context parallelism supports causal attention only")
    if cfg.sequence_parallel:
        raise ValueError(
            "context_parallel_axis and sequence_parallel are mutually "
            "exclusive (Megatron SP gathers the full sequence inside the "
            "block; CP keeps it sharded end-to-end)")
    if qk_scaling:
        raise ValueError(
            "context parallelism needs a static softmax scale; disable "
            "apply_query_key_layer_scaling (fp16 layer scaling)")
    if cfg.attention_dropout > 0.0 and not deterministic \
            and dropout_seed is not None:
        raise ValueError(
            "attention dropout is not supported on the ring-attention "
            "path; set attention_dropout=0 (hidden dropout still works)")
    if cfg.use_flash_attention is False:
        raise ValueError(
            "use_flash_attention=False cannot be honored under context "
            "parallelism: ring attention runs the flash chunk kernels")
    tile = s // 2 if cfg.context_parallel_zigzag else s
    if cfg.context_parallel_zigzag and s % 16 != 0:
        raise ValueError(
            f"zigzag context parallelism needs local seq {s} % 16 == 0 "
            "(the kernels run on tileable half-chunks)")
    if tile % 8 != 0 or hn > MAX_HEAD_DIM:
        raise ValueError(
            f"context parallelism needs kernel-tileable shapes (seq {tile} "
            f"% 8 == 0 and head dim {hn} <= {MAX_HEAD_DIM})")
    qb, kb, vb = (t.permute(1, 2, 0, 3) for t in (q, k, v))
    ctx = ring_attention(qb, kb, vb, axis_name=cfg.context_parallel_axis,
                         causal=True, zigzag=cfg.context_parallel_zigzag,
                         scale=1.0 / (hn ** 0.5))
    return ctx.permute(2, 0, 1, 3).reshape(s, b, n * hn)


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
                   ctx: torch.Tensor, fuse_tail: bool = False, fp8=None,
                   new_fp8=None, axis_name=None):
    """Attention output projection (dense, or row-parallel with
    ``axis_name``); ``fuse_tail`` omits ``proj_b``, which rides the
    caller's fused tail. With ``fp8`` the projection runs the fp8 recipe
    and ``(out, new_fp8)`` is returned, carrying the rolled qkv and proj
    states."""
    bias = None if fuse_tail else lp["proj_b"]
    out, state = _proj(cfg, fp8, "proj", ctx, lp["proj_w"], bias, axis_name,
                       column=False)
    if fp8 is not None:
        new_fp8["proj"] = state
        return out, new_fp8
    return out


def parallel_mlp(cfg: GPTConfig, lp: Dict[str, torch.Tensor],
                 hidden: torch.Tensor, fuse_tail: bool = False, fp8=None,
                 axis_name=None):
    """h -> 4h GEMM + bias, tanh GeLU, 4h -> h GEMM + bias (the JAX
    ``parallel_mlp``; with ``axis_name`` the column-parallel fc1 over
    this rank's ``4h / tp`` columns and the row-parallel fc2).
    ``fuse_tail`` is the fused-block MLP: fc1 runs bias-free and
    :func:`bias_gelu` adds its bias (the ``fused_dense`` GEMM + bias +
    GeLU shape), fc2 runs bias-free and the caller fuses ``fc2_b`` into
    its tail. With ``fp8`` (fc1 and fc2's states and carriers) both GEMMs
    run the fp8 recipe and ``(out, new_fp8)`` is returned."""
    inter, st1 = _proj(cfg, fp8, "fc1", hidden, lp["fc1_w"],
                       None if fuse_tail else lp["fc1_b"], axis_name,
                       column=True)
    inter = (bias_gelu(inter, lp["fc1_b"].to(inter.dtype)) if fuse_tail
             else F.gelu(inter, approximate="tanh"))
    out, st2 = _proj(cfg, fp8, "fc2", inter, lp["fc2_w"],
                     None if fuse_tail else lp["fc2_b"], axis_name,
                     column=False)
    return out if fp8 is None else (out, {"fc1": st1, "fc2": st2})


def transformer_layer(cfg: GPTConfig, lp: Dict[str, torch.Tensor],
                      hidden: torch.Tensor,
                      attention_mask: Optional[torch.Tensor],
                      seeds: Optional[tuple], deterministic: bool,
                      layer_number: Optional[int] = None, fp8_l=None,
                      axis_name=None):
    """Pre-LN transformer layer: LayerNorm on an fp32 copy, attention,
    dropout + residual, LayerNorm, MLP, dropout + residual. ``seeds`` =
    (attention, attention-residual, MLP-residual) dropout seeds, or None.
    With ``fp8_l`` (``{name: (Fp8DenseState, carrier)}``, this layer's
    slice) the four projections run the fp8 recipe and ``(hidden,
    new_fp8_l)`` is returned.

    With ``cfg.fused_block`` the two tails are the single-sweep ops of
    ``ops/fused_block.py``: the attention tail is
    :func:`residual_add_layer_norm` (proj bias + hash dropout + residual
    + the MLP's pre-LN), the MLP tail :func:`bias_dropout_residual`; the
    tails' seeds come from ``seeds``, so a recomputed layer regenerates
    the same masks.

    With ``axis_name`` the projections are tensor-parallel over this
    rank's shards of ``lp``; under sequence parallelism ``hidden`` is this
    rank's ``[s / tp, b, h]`` rows and the norms' parameters enter
    through the copy into the tensor region, and so do ``proj_b`` and
    ``fc2_b`` where the fused tails add them (the row-parallel linear
    does it for the biases it adds)."""
    dt = hidden.dtype
    eps = cfg.layernorm_epsilon
    s_attn, s_res1, s_res2 = seeds if seeds is not None else (None,) * 3
    if _sp(cfg, axis_name):
        lp = dict(lp)
        names = ("input_ln_w", "input_ln_b", "post_ln_w", "post_ln_b") + (
            ("proj_b", "fc2_b") if cfg.fused_block else ())
        for k in names:
            lp[k] = _replicated(cfg, lp[k], axis_name)
    ln1 = ln_fp32(hidden, lp["input_ln_w"], lp["input_ln_b"], eps).to(dt)
    attn = parallel_attention(cfg, lp, ln1, attention_mask, s_attn,
                              deterministic, layer_number,
                              fuse_tail=cfg.fused_block, fp8=fp8_l,
                              axis_name=axis_name)
    new_fp8 = {}
    if fp8_l is not None:
        attn, attn_fp8 = attn
        new_fp8.update(attn_fp8)
    attn = tap("apex_tpu.transformer_layer/attn", attn, layer=layer_number)
    if cfg.fused_block:
        p = 0.0 if deterministic or s_res1 is None else cfg.hidden_dropout
        hidden, ln2 = residual_add_layer_norm(
            attn, lp["proj_b"].to(dt), hidden, lp["post_ln_w"],
            lp["post_ln_b"], eps=eps, dropout_p=p,
            seed=_hash_dropout_seed(s_res1, p))
    else:
        hidden = (hidden + _dropout(attn, cfg.hidden_dropout, s_res1,
                                    deterministic)).to(dt)
        ln2 = ln_fp32(hidden, lp["post_ln_w"], lp["post_ln_b"], eps).to(dt)
    mlp_out = parallel_mlp(cfg, lp, ln2, fuse_tail=cfg.fused_block,
                           fp8=fp8_l, axis_name=axis_name)
    if fp8_l is not None:
        mlp_out, mlp_fp8 = mlp_out
        new_fp8.update(mlp_fp8)
    mlp_out = tap("apex_tpu.transformer_layer/mlp", mlp_out,
                  layer=layer_number)
    if cfg.fused_block:
        p = 0.0 if deterministic or s_res2 is None else cfg.hidden_dropout
        out = bias_dropout_residual(
            mlp_out, lp["fc2_b"].to(dt), hidden, dropout_p=p,
            seed=_hash_dropout_seed(s_res2, p))
    else:
        out = (hidden + _dropout(mlp_out, cfg.hidden_dropout, s_res2,
                                 deterministic)).to(dt)
    if fp8_l is not None:
        return out, new_fp8
    return out


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
#: ``dots_with_no_batch_dims_saveable``), and so does the fp8 projection's
#: GEMM (``fused_dense.fp8.FP8_GEMM``, the custom op around
#: ``aten::_scaled_mm`` on the card, which the policy sees whole); ``bmm``
#: has batch dims and is replayed
_NO_BATCH_DIM_GEMMS = frozenset({"aten::mm", "aten::addmm", FP8_GEMM})


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
                      deterministic: bool = True, fp8_states=None,
                      fp8_carriers=None, axis_name=None):
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
    masks.

    With ``fp8_states`` (``{name: Fp8DenseState [L, ...]}``) and
    ``fp8_carriers`` (``{name: [L]}``) each layer takes its row of both
    and ``(hidden, new_fp8_states)`` is returned, the rolled states
    stacked again. ``axis_name``: tensor parallelism over this rank's
    shards (:func:`transformer_layer`)."""
    rg = cfg.recompute_granularity
    if rg not in (None, "full", "selective", "selective_elementwise"):
        raise ValueError(
            f"unknown recompute_granularity {rg!r}: use None, 'full', "
            "'selective' or 'selective_elementwise'")
    keys = sorted(layer_params)
    stacks = [layer_params[k].unbind(0) for k in keys]
    L = len(stacks[0])
    with_fp8 = fp8_states is not None
    new_fp8 = []
    for l in range(L):
        seeds = None if layer_seeds is None else layer_seeds[l]
        fp8_l = None
        if with_fp8:
            fp8_l = {name: (tree_map(lambda t, l=l: t[l], fp8_states[name]),
                            fp8_carriers[name][l])
                     for name in FP8_GEMM_NAMES}

        def run(h, *vals, seeds=seeds, l=l, fp8_l=fp8_l):
            return transformer_layer(cfg, dict(zip(keys, vals)), h,
                                     attention_mask, seeds, deterministic,
                                     l + 1, fp8_l=fp8_l, axis_name=axis_name)

        vals = [st[l] for st in stacks]
        if rg is None:
            out = run(hidden, *vals)
        else:
            kw = {} if rg == "full" else dict(context_fn=functools.partial(
                create_selective_checkpoint_contexts, _POLICIES[rg]))
            out = checkpoint(run, hidden, *vals, use_reentrant=False,
                             preserve_rng_state=False, **kw)
        if with_fp8:
            hidden, state_l = out
            new_fp8.append(state_l)
        else:
            hidden = out
    if with_fp8:
        return hidden, {name: tree_map(lambda *ts: torch.stack(ts),
                                       *[st[name] for st in new_fp8])
                        for name in FP8_GEMM_NAMES}
    return hidden


def _local_position_ids(cfg: GPTConfig, s_loc: int,
                        device=None) -> torch.Tensor:
    """``[s_loc]`` GLOBAL position ids of this rank's tokens: ``arange``
    without context parallelism; under it the shard's offset (contiguous
    ``rank * s_loc``; zigzag the rank's chunks ``r`` and ``2 cp - 1 -
    r``)."""
    axis = cfg.context_parallel_axis
    cp, r = 1, 0
    if axis is not None:
        _, cp, r, _ = mappings.axis_world(axis)
    if cp * s_loc > cfg.max_position_embeddings:
        raise ValueError(
            f"global sequence {cp}*{s_loc}={cp * s_loc} exceeds "
            f"max_position_embeddings={cfg.max_position_embeddings}")
    if axis is None:
        return torch.arange(s_loc, device=device)
    if cfg.context_parallel_zigzag:
        if s_loc % 2 != 0:
            raise ValueError(
                "zigzag needs an even local sequence length, got "
                f"{s_loc} tokens per rank")
        h = s_loc // 2
        return torch.cat([r * h + torch.arange(h, device=device),
                          (2 * cp - 1 - r) * h
                          + torch.arange(h, device=device)])
    return r * s_loc + torch.arange(s_loc, device=device)


def gpt_embed(cfg: GPTConfig, params: Params, tokens: torch.Tensor,
              position_ids: Optional[torch.Tensor] = None,
              dropout_seed: Optional[int] = None,
              deterministic: bool = True, axis_name=None) -> torch.Tensor:
    """Word + position embeddings -> ``[s, b, h]`` in compute_dtype.
    With ``axis_name`` the word embedding is vocab-parallel over this
    rank's rows; under sequence parallelism the result is then cut to
    this rank's ``[s / tp]`` rows, which the dropout acts on."""
    b, s = tokens.shape
    if position_ids is None:
        position_ids = _local_position_ids(
            cfg, s, tokens.device).expand(b, s)
    if axis_name is not None:
        word = vocab_parallel_embedding(tokens, params["embedding"]["word"],
                                        axis_name=axis_name)
    else:
        word = F.embedding(tokens.long(), params["embedding"]["word"])
    pos = F.embedding(position_ids.long(), params["embedding"]["position"])
    emb = (word + pos).to(cfg.compute_dtype).transpose(0, 1).contiguous()
    if _sp(cfg, axis_name):
        emb = mappings.scatter_to_sequence_parallel_region(emb, axis_name)
    return _dropout(emb, cfg.hidden_dropout, dropout_seed, deterministic)


def gpt_hidden(cfg: GPTConfig, params: Params, tokens: torch.Tensor,
               generator: Optional[torch.Generator] = None,
               deterministic: bool = True, fp8_states=None,
               fp8_carriers=None, axis_name=None):
    """GPT trunk -> pre-head hidden states ``[s, b, h]`` in
    compute_dtype: embeddings, the layer stack, the final LayerNorm.
    Dropout (when not ``deterministic``) draws its seeds from
    ``generator``. With ``fp8_states`` and ``fp8_carriers`` the
    projection GEMMs run the e4m3 / e5m2 recipe and ``(hidden,
    new_fp8_states)`` is returned; ``cfg.fp8`` and the states must
    agree. With ``axis_name`` the trunk is tensor-parallel over this
    rank's shards and the hidden states come out whole on every rank
    (under sequence parallelism gathered along the sequence)."""
    if bool(cfg.fp8) != (fp8_states is not None):
        raise ValueError(
            "GPTConfig.fp8 and the fp8_states argument must agree: the "
            "flag declares the recipe, the state carries it — pass "
            "init_gpt_fp8_states(cfg) (+ carriers) when cfg.fp8, and "
            "don't pass states to a non-fp8 config. (The flag alone "
            "cannot run fp8: delayed scaling is stateful.)")
    return _trunk(cfg, params, tokens, None, generator, deterministic,
                  fp8_states, fp8_carriers, axis_name)


def _trunk(cfg: GPTConfig, params: Params, tokens: torch.Tensor,
           attention_mask: Optional[torch.Tensor],
           generator: Optional[torch.Generator],
           deterministic: bool, fp8_states=None, fp8_carriers=None,
           axis_name=None):
    """Embeddings, the layer stack under ``attention_mask``, the final
    LayerNorm -> ``[s, b, h]`` in compute_dtype (and the rolled fp8
    states with ``fp8_states``); dropout seeds (one for the embeddings,
    three per layer) drawn from ``generator``, forked by rank first under
    sequence parallelism. Under sequence parallelism the normalised rows
    are gathered along the sequence at the end (reduce-scatter
    backward)."""
    _tp_world(cfg, axis_name)
    sp = _sp(cfg, axis_name)
    embed_seed = layer_seeds = None
    if generator is not None and not deterministic:
        if sp:
            generator = model_parallel_rng_key(generator, axis_name)
        if cfg.context_parallel_axis is not None:
            # each context-parallel rank holds other tokens
            generator = model_parallel_rng_key(generator,
                                               cfg.context_parallel_axis)
        embed_seed = _draw_seed(generator)
        layer_seeds = [tuple(_draw_seed(generator) for _ in range(3))
                       for _ in range(cfg.num_layers)]
    hidden = gpt_embed(cfg, params, tokens, None, embed_seed, deterministic,
                       axis_name)
    hidden = transformer_block(cfg, params["layers"], hidden,
                               attention_mask, layer_seeds, deterministic,
                               fp8_states, fp8_carriers, axis_name)
    new_fp8 = None
    if fp8_states is not None:
        hidden, new_fp8 = hidden
    hidden = ln_fp32(hidden,
                     _replicated(cfg, params["final_ln_w"], axis_name),
                     _replicated(cfg, params["final_ln_b"], axis_name),
                     cfg.layernorm_epsilon).to(cfg.compute_dtype)
    if sp:
        hidden = mappings.gather_from_sequence_parallel_region(hidden,
                                                               axis_name)
    return hidden if fp8_states is None else (hidden, new_fp8)


def gpt_loss(cfg: GPTConfig, params: Params, tokens: torch.Tensor,
             labels: torch.Tensor, loss_mask: Optional[torch.Tensor] = None,
             generator: Optional[torch.Generator] = None,
             deterministic: bool = True, fp8_states=None, fp8_carriers=None,
             axis_name=None):
    """Masked mean LM loss. Single device: the head GEMM and the cross
    entropy chunk-fused (``contrib.xentropy.lm_head_cross_entropy``),
    rows in ``[s, b]`` order, the chunk the largest divisor of ``s * b``
    that is at most 2048. With ``axis_name`` (tensor parallelism): the
    vocab-sharded logits of :func:`gpt_forward` through
    ``vocab_parallel_cross_entropy``; the loss is the same on every rank.

    With ``fp8_states`` and ``fp8_carriers`` (:func:`init_gpt_fp8_states`,
    :func:`init_gpt_fp8_carriers`) the layer projections run the fp8
    recipe and ``(loss, new_fp8_states)`` is returned: differentiate
    with respect to the params and the carriers, then fold the carriers'
    gradients in with :func:`record_gpt_grad_amaxes`."""
    new_fp8 = None
    cp_axis = cfg.context_parallel_axis
    if cp_axis is not None:
        # replicated over the group: each rank's gradient is a partial
        # sum, which the copy's backward all-reduces
        params = tree_map(lambda p: mappings.copy_to_tensor_model_parallel_region(
            p, cp_axis), params)
    if axis_name is not None:
        logits = gpt_forward(cfg, params, tokens, fp8_states, fp8_carriers,
                             axis_name, generator, deterministic)
        if fp8_states is not None:
            logits, new_fp8 = logits
        losses = vocab_parallel_cross_entropy(logits, labels, 0.0,
                                              axis_name)
    else:
        hidden = gpt_hidden(cfg, params, tokens, generator, deterministic,
                            fp8_states, fp8_carriers)
        if fp8_states is not None:
            hidden, new_fp8 = hidden
        s, b, h = hidden.shape
        n = s * b
        chunk = next(c for c in range(min(2048, n), 0, -1) if n % c == 0)
        losses = lm_head_cross_entropy(
            hidden.reshape(n, h), params["embedding"]["word"],
            labels.transpose(0, 1).reshape(n), chunk_size=chunk,
            save_logits_dtype=cfg.compute_dtype if cfg.ce_save_logits
            else None).reshape(s, b).transpose(0, 1)  # [b, s]
    if cp_axis is not None:
        # the global masked mean: numerator and denominator summed over
        # the group (all-reduce forward, identity backward)
        m = torch.ones_like(losses) if loss_mask is None \
            else loss_mask.to(torch.float32)
        num = mappings.reduce_from_tensor_model_parallel_region(
            (losses * m).sum(), cp_axis)
        den = mappings.reduce_from_tensor_model_parallel_region(
            m.sum(), cp_axis)
        loss = num / den.clamp_min(1.0)
    elif loss_mask is None:
        loss = losses.mean()
    else:
        m = loss_mask.to(torch.float32)
        loss = (losses * m).sum() / m.sum().clamp_min(1.0)
    return loss if fp8_states is None else (loss, new_fp8)


# --------------------------------------------------------------------------
# BERT
# --------------------------------------------------------------------------

def bert_forward(cfg: GPTConfig, params: Params, tokens: torch.Tensor,
                 padding_mask: Optional[torch.Tensor] = None,
                 generator: Optional[torch.Generator] = None,
                 deterministic: bool = True, axis_name=None):
    """BERT-style bidirectional encoder (the JAX ``bert_forward``):
    ``tokens [b, s]`` and ``padding_mask [b, s]`` (1 = real token,
    default all real) -> ``(lm_logits [b, s, vocab] fp32, binary_logits
    [b, 2] or None)``. The layers run with ``attn_mask_type=padding``
    under the int8 ``[b, 1, 1, s]`` mask (nonzero = masked out), which
    flash attention takes as its key mask and the softmax path as its
    mask; then the final LayerNorm, the tied head with fp32 logits and,
    with ``cfg.add_binary_head``, the tanh pooler over the first token
    and the binary head. With ``axis_name`` the encoder is
    tensor-parallel and the MLM logits are this rank's vocab shard."""
    b, s = tokens.shape
    if padding_mask is None:
        padding_mask = torch.ones((b, s), dtype=torch.int32,
                                  device=tokens.device)
    attn_mask = (padding_mask[:, None, None, :] == 0).to(torch.int8)
    cfg_pad = dataclasses.replace(cfg, attn_mask_type=AttnMaskType.padding)
    hidden = _trunk(cfg_pad, params, tokens, attn_mask, generator,
                    deterministic, axis_name=axis_name)
    # the head reads [b, s, h] rows, so the logits come out [b, s, v]
    lm_logits = _lm_head(cfg, params, hidden.transpose(0, 1), axis_name)
    binary_logits = None
    if cfg.add_binary_head and "binary_head" in params:
        bh = params["binary_head"]
        dt = hidden.dtype
        pooled = torch.tanh(hidden[0] @ bh["pooler_w"].to(dt)
                            + bh["pooler_b"].to(dt))
        binary_logits = pooled @ bh["head_w"].t().to(dt) + bh["head_b"].to(dt)
    return lm_logits, binary_logits
