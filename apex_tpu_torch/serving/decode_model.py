"""Token-at-a-time and chunked-prefill GPT forward over the paged KV
cache (counterpart of ``apex_tpu/serving/decode_model.py``).

The inference twin of ``transformer.testing.standalone_transformer_lm``:
the same parameter tree and per-layer math (pre-LN, fused QKV laid out
per head as ``[n, 3d]`` then split into thirds, tanh GeLU, tied
embedding head), evaluated against K/V read from — and written into —
the paged pool, with attention by ``ops.flash_decode`` and every
LayerNorm by ``ops.layer_norm`` (both hand-written kernels on the
card).

- :func:`decode_tokens` — ONE token per slot per step;
- :func:`prefill_chunk_tokens` — up to ``chunk`` tokens per slot per
  step; each column's K/V is written into the pool BEFORE attention and
  column ``j`` attends with ``kv_len = pos + j + 1``, so the ``[B, C]``
  chunk flattens into a ``[B*C]`` single-query batch for the same
  flash-decode kernel (causal by construction).

Inactive slots and invalid chunk columns write the garbage page and
attend with ``kv_len == 0`` (zeros), so one code path serves any mix of
slots. The pool is updated in place (``kv_cache.write_*_kv``).

Dtypes follow training: LayerNorm in fp32 on a copy cast back, GEMMs in
``cfg.compute_dtype``, logits fp32 from fp32 accumulation
(``standalone_transformer_lm.lm_head``).

With ``tp_axis`` (a ``tp.TPComm``, a ``parallel_state`` axis name or a
``ProcessGroup``) each function is one rank's share of the tensor-
parallel engine's program: ``spec`` is the rank's head-sharded spec,
``params`` carry its column-parallel QKV / fc1 slices (whole heads) and
row-parallel proj / fc2 slices (``engine.tp_rank_params``), each layer
runs on ``n / tp`` heads and closes each sublayer with ONE ``all_reduce``
of the partial GEMM in the compute dtype, before the bias (the JAX
``_psum_tail``), and :func:`lm_logits` contracts the rank's ``vocab /
tp`` rows of the replicated word embedding, returning its slice of the
logits.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..ops.flash_decode import flash_decode
from ..transformer.testing.standalone_transformer_lm import (
    gpt_forward,
    linear,
    lm_head,
    ln_fp32,
)
from .kv_cache import (
    KVCacheState,
    PagedKVSpec,
    write_chunk_kv,
    write_token_kv,
)
from .tp import TPComm

Params = Dict[str, Any]

#: the collectives a layer issues under tensor parallelism, by site: one
#: ``all_reduce`` SUM a sublayer tail (a program's record counts the
#: layer loop's body once)
TP_SITES = {"attn_tail": "all_reduce_sum", "mlp_tail": "all_reduce_sum"}


def _row_linear(x, w, b, comm: Optional[TPComm], site: str):
    """A row-parallel sublayer tail: the partial GEMM all-reduced over
    the tensor group, then the (replicated) bias; the plain ``linear``
    without ``comm``."""
    if comm is None:
        return linear(x, w, b)
    return comm.psum(linear(x, w, None), site) + b.to(x.dtype)


def _layer(cfg, lp, h, pages, l, write, q_rows, page_tables, kv_lens,
           n, d, scale, comm: Optional[TPComm] = None):
    """One pre-LN layer over ``h [..., hidden]``: K/V written by
    ``write(k, v)`` before attention, single-query attention over the
    pool for the ``q_rows``-row flattening of the queries; ``n`` is the
    rank's head count under ``comm``."""
    dt = h.dtype
    eps = cfg.layernorm_epsilon
    lead = h.shape[:-1]
    ln1 = ln_fp32(h, lp["input_ln_w"], lp["input_ln_b"], eps).to(dt)
    qkv = linear(ln1, lp["qkv_w"], lp["qkv_b"]).reshape(*lead, n, 3 * d)
    q, k, v = qkv.split(d, dim=-1)  # [..., n, d]
    write(pages, l, k, v)
    ctx = flash_decode(q.reshape(q_rows, n, d), pages[l, 0], pages[l, 1],
                       page_tables, kv_lens, scale=scale)
    ctx = ctx.to(dt).reshape(*lead, n * d)
    h = (h + _row_linear(ctx, lp["proj_w"], lp["proj_b"], comm,
                         "attn_tail")).to(dt)
    ln2 = ln_fp32(h, lp["post_ln_w"], lp["post_ln_b"], eps).to(dt)
    inter = F.gelu(linear(ln2, lp["fc1_w"], lp["fc1_b"]), approximate="tanh")
    return (h + _row_linear(inter, lp["fc2_w"], lp["fc2_b"], comm,
                            "mlp_tail")).to(dt)


def decode_tokens(cfg, params: Params, spec: PagedKVSpec, kv: KVCacheState,
                  tokens: torch.Tensor, positions: torch.Tensor,
                  active: torch.Tensor, page_tables: torch.Tensor, *,
                  tp_axis=None) -> Tuple[torch.Tensor, KVCacheState]:
    """One decode step: embed each slot's token, run every layer against
    the paged cache (writing this token's K/V in place), return fp32
    logits ``[B, vocab]`` (``[B, vocab / tp]`` under ``tp_axis``) and the
    (same, updated) cache. Inactive slots are gated to token/position 0,
    the garbage page and zero attention; their logits are garbage and
    the caller masks them."""
    comm = TPComm.of(tp_axis)
    n, d, ps = spec.num_heads, spec.head_dim, spec.page_size
    B = tokens.shape[0]
    tok = torch.where(active, tokens, 0).long()
    pos = torch.where(active, positions, 0).long()
    emb = params["embedding"]
    h = (emb["word"][tok] + emb["position"][pos]).to(cfg.compute_dtype)
    page_idx = page_tables.long().gather(1, (pos // ps)[:, None])[:, 0]
    offsets = pos % ps
    kv_lens = torch.where(active, pos + 1, 0).to(torch.int32)
    pt = page_tables.to(torch.int32)

    def write(pages, l, k, v):
        write_token_kv(pages, l, k, v, page_idx, offsets)

    scale = 1.0 / (d ** 0.5)
    layers = params["layers"]
    for l in range(cfg.num_layers):
        lp = {name: w[l] for name, w in layers.items()}
        h = _layer(cfg, lp, h, kv.pages, l, write, B, pt, kv_lens, n, d,
                   scale, comm)
    return lm_logits(cfg, params, h, tp_axis=comm), kv


def chunk_hidden(cfg, params: Params, spec: PagedKVSpec, kv: KVCacheState,
                 tok: torch.Tensor, pclamp: torch.Tensor,
                 valid: torch.Tensor, page_tables: torch.Tensor, *,
                 tp_axis=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """The chunk-shaped transformer body: embed a ``[B, C]`` token grid,
    write each valid column's K/V before attention, attend with
    per-column ``kv_lens = pos + 1``. Returns the final hidden states
    ``[B, C, hidden]`` (before the final LN) and the pool."""
    comm = TPComm.of(tp_axis)
    n, d, ps = spec.num_heads, spec.head_dim, spec.page_size
    B, C = tok.shape
    mp = page_tables.shape[1]
    emb = params["embedding"]
    h = (emb["word"][tok.long()]
         + emb["position"][pclamp.long()]).to(cfg.compute_dtype)
    page_idx = page_tables.long().gather(
        1, (pclamp.long() // ps).clamp(max=mp - 1))
    page_idx = torch.where(valid, page_idx, 0)
    offsets = torch.where(valid, pclamp.long() % ps, 0)
    kv_lens = torch.where(valid, pclamp + 1, 0).to(torch.int32)
    flat_lens = kv_lens.reshape(B * C)
    pt_rep = page_tables.to(torch.int32).repeat_interleave(C, dim=0)

    def write(pages, l, k, v):
        write_chunk_kv(pages, l, k, v, page_idx, offsets)

    scale = 1.0 / (d ** 0.5)
    layers = params["layers"]
    for l in range(cfg.num_layers):
        lp = {name: w[l] for name, w in layers.items()}
        h = _layer(cfg, lp, h, kv.pages, l, write, B * C, pt_rep, flat_lens,
                   n, d, scale, comm)
    return h, kv.pages


def lm_logits(cfg, params: Params, h: torch.Tensor, *,
              tp_axis=None) -> torch.Tensor:
    """Final LN + tied-embedding head: fp32 logits ``[..., vocab]``.
    Under ``tp_axis`` the head is vocab-parallel: the rank contracts its
    ``vocab / tp`` rows of the replicated word embedding and returns
    ``[..., vocab / tp]`` (each logit an independent dot product, so the
    slice is the replicated head's; no collective here)."""
    comm = TPComm.of(tp_axis)
    h = ln_fp32(h, params["final_ln_w"], params["final_ln_b"],
                cfg.layernorm_epsilon).to(cfg.compute_dtype)
    word = params["embedding"]["word"]
    if comm is not None:
        vl = word.shape[0] // comm.size
        word = word[comm.rank * vl:(comm.rank + 1) * vl]
    return lm_head(h, word)


def prefill_chunk_tokens(cfg, params: Params, spec: PagedKVSpec,
                         kv: KVCacheState, tokens: torch.Tensor,
                         positions: torch.Tensor, active: torch.Tensor,
                         prompt_buf: torch.Tensor, prompt_lens: torch.Tensor,
                         page_tables: torch.Tensor, *, chunk: int,
                         tp_axis=None
                         ) -> Tuple[torch.Tensor, KVCacheState,
                                    torch.Tensor]:
    """One CHUNKED step: each prefilling slot consumes ``min(chunk,
    prompt_len - pos)`` prompt tokens, each decoding slot its one
    carried token. Returns ``(logits [B, vocab], kv, take [B] int32)``:
    fp32 logits at each slot's LAST consumed position (the emission
    point) and the per-slot token count consumed (0 when inactive)."""
    C = int(chunk)
    W = prompt_buf.shape[1]
    pos0 = torch.where(active, positions, 0).to(torch.int32)
    plen = prompt_lens.to(torch.int32)
    prefilling = pos0 < plen
    take = torch.where(
        active,
        torch.where(prefilling, torch.clamp(plen - pos0, max=C), 1),
        0).to(torch.int32)
    cols = torch.arange(C, dtype=torch.int32, device=tokens.device)
    p = pos0[:, None] + cols[None, :]                    # [B, C]
    valid = cols[None, :] < take[:, None]
    prompt_tok = prompt_buf.gather(1, p.clamp(max=W - 1).long())
    tok = torch.where(p < plen[:, None], prompt_tok, tokens[:, None])
    tok = torch.where(valid, tok, 0).to(torch.int32)
    pclamp = torch.where(valid, p, 0)
    comm = TPComm.of(tp_axis)
    h, _ = chunk_hidden(cfg, params, spec, kv, tok, pclamp, valid,
                        page_tables, tp_axis=comm)
    # only the LAST consumed column's logits matter: select it before
    # the vocab GEMM (one [B, vocab] head instead of C of them)
    last = (take - 1).clamp(min=0).long()
    h_last = h.gather(1, last[:, None, None].expand(-1, 1, h.shape[-1]))
    return lm_logits(cfg, params, h_last[:, 0], tp_axis=comm), kv, take


def reference_decode(cfg, params: Params, prompt, max_new_tokens: int,
                     eos_id: Optional[int] = None):
    """Per-request dense-attention greedy decode — the oracle: the full
    forward (``gpt_forward``, no KV cache) recomputed for every emitted
    token, then the argmax."""
    return reference_sample_decode(cfg, params, prompt, max_new_tokens,
                                   eos_id=eos_id)


def reference_sample_decode(cfg, params: Params, prompt,
                            max_new_tokens: int, *, sampling=None,
                            rid: int = 0, eos_id: Optional[int] = None):
    """Per-request dense-attention decode with carried sampling: the
    next token is drawn by the SAME ``sample_tokens`` the engine runs,
    keyed by ``(seed, rid, position)``. ``sampling=None`` is greedy."""
    from .sampling import i32_wrap, resolve, sample_tokens

    sp = resolve(sampling)
    rid = i32_wrap(rid)
    dev = params["embedding"]["word"].device
    toks = [int(t) for t in prompt]
    out = []
    with torch.no_grad():
        for _ in range(int(max_new_tokens)):
            logits = gpt_forward(
                cfg, params, torch.tensor([toks], dtype=torch.long,
                                          device=dev))
            row = logits[0, -1:].float()
            if sp.is_greedy:
                nxt = int(row.argmax(dim=-1)[0])
            else:
                def t(v, dtype):
                    return torch.tensor([v], dtype=dtype, device=dev)

                nxt = int(sample_tokens(
                    row, t(sp.temperature, torch.float32),
                    t(sp.top_k, torch.int32), t(sp.top_p, torch.float32),
                    t(i32_wrap(sp.seed), torch.int32),
                    t(rid, torch.int32),
                    # the sampled token OCCUPIES position len(toks)
                    t(len(toks), torch.int32))[0])
            out.append(nxt)
            if eos_id is not None and nxt == eos_id:
                break
            toks.append(nxt)
    return out
