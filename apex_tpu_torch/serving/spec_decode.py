"""Speculative decoding: self-drafted n-gram lookahead, verified in one
target pass (counterpart of ``apex_tpu/serving/spec_decode.py``).

The decode hot path pays one full target-model forward per emitted
token; this module spends ONE chunk-shaped pass (``prefill_chunk_tokens``'
shape, through ``decode_model.chunk_hidden``) to verify ``k + 1``
positions at once:

- **draft** — each decoding slot proposes up to ``spec_k`` tokens from
  an n-gram lookup over its OWN prompt + emitted history (prompt lookup
  / self-speculative decoding: no second model). The history is the
  on-device ``SlotState.hist`` buffer the step itself maintains, so
  drafting reads nothing back to the host, and a replayed request
  rebuilds the same table from the same history;
- **verify** — the drafted tokens ride the chunk pass as extra columns:
  column ``j`` consumes draft ``j`` at position ``pos + j``, its K/V is
  written before attention, and per-column ``kv_lens`` make in-chunk
  attention causal by construction — the ``[B, C]`` chunk flattens into
  a ``[B*C]`` single-query batch for the flash-decode kernel;
- **accept** — per slot, on the device: the sampled token at each
  position is a *deterministic* function of ``(logits, seed, rid,
  position)`` (``sampling.sample_tokens``), so draft ``j`` is accepted
  iff it equals the position's own carried draw. The emitted run is the
  accepted prefix plus the first correction token — identical to plain
  sequential decode (greedy: an argmax match; sampled: the position's
  carried draw);
- **rollback** — rejected columns wrote K/V the sequence never reads:
  every read at position ``p`` is masked to ``kv_len = p + 1`` entries,
  and the cursor rewinds to the first rejection, so stale entries are
  overwritten before the cursor passes them. The host returns the
  speculative tail pages (``Scheduler.rollback_kv``). Shared
  (prefix-cache) pages were COW-forked BEFORE the step's writes
  (``ensure_capacity`` sizes its fork scan to the speculative worst
  case, ``Scheduler.next_take_upper``), so a rejected draft never
  writes a page another reader holds.

Prefilling slots ride along unchanged (``min(prefill_chunk,
remaining)`` prompt tokens per step, no drafts), so one fixed-shape step
of width ``max(prefill_chunk, spec_k + 1)`` serves every boundary. All
``B*C`` rows are sampled in one call, so the step adds no host read to
what the plain step has. The tensor-parallel sampler and branch of the
JAX module come with tensor-parallel serving.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from .decode_model import chunk_hidden, lm_logits
from .kv_cache import KVCacheState, PagedKVSpec
from .sampling import sample_tokens

#: emitted-token sentinels (the JAX package's values): no token in this
#: column / the slot's logits were non-finite (column 0 only)
NO_TOKEN = -1
POISONED = -2


def ngram_propose(hist: torch.Tensor, lens: torch.Tensor, *, k: int,
                  n: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Prompt-lookup drafting on the device: for each row, match the LAST
    ``n`` known tokens against every earlier window of the history and
    propose the continuation of the most recent match.

    ``hist`` is ``[B, W + 1]`` int32 (column ``W`` is the scratch sink
    inactive writes target — never read); ``lens`` is how many head
    tokens of each row are known (0 disables the row). Returns
    ``(drafts [B, k] int32, n_draft [B] int32)`` with unused draft slots
    zeroed. A row drafts only when a match exists strictly before the
    tail n-gram itself, and never proposes past its known history —
    correctness never depends on it (every draft is verified), only the
    accept rate does.
    """
    B, W1 = hist.shape
    W = W1 - 1
    dev = hist.device
    if k < 1:
        return (torch.zeros((B, 0), dtype=torch.int32, device=dev),
                torch.zeros((B,), dtype=torch.int32, device=dev))
    lens = lens.to(torch.int32)
    # the tail n-gram to match: hist[b, lens-n : lens]
    tpos = lens[:, None] - n + torch.arange(n, dtype=torch.int32,
                                            device=dev)[None, :]
    tgt = hist.gather(1, tpos.clamp(0, W).long())
    # eq[b, s] = the window starting at s matches the tail n-gram
    S = W - n + 1
    eq = None
    for i in range(n):
        m = hist[:, i:i + S] == tgt[:, i:i + 1]
        eq = m if eq is None else (eq & m)
    s_iota = torch.arange(S, dtype=torch.int32, device=dev)[None, :]
    # a usable match starts strictly before the tail (s < lens - n) —
    # which also guarantees at least one continuation token exists
    ok = eq & (s_iota < (lens - n)[:, None]) & (lens[:, None] > n)
    best = torch.where(ok, s_iota, -1).amax(dim=1)        # most recent
    found = best >= 0
    cont = best + n                                       # continuation
    dpos = cont[:, None] + torch.arange(k, dtype=torch.int32,
                                        device=dev)[None, :]
    drafts = hist.gather(1, dpos.clamp(0, W).long())
    n_draft = torch.where(found, torch.clamp(lens - cont, max=k),
                          0).to(torch.int32)
    dvalid = (torch.arange(k, dtype=torch.int32, device=dev)[None, :]
              < n_draft[:, None])
    return torch.where(dvalid, drafts, 0).to(torch.int32), n_draft


def run_spec_step(cfg, params, spec: PagedKVSpec, kv: KVCacheState, slots,
                  page_tables: torch.Tensor, poison: torch.Tensor,
                  draft_caps: torch.Tensor, *, spec_k: int, ngram: int,
                  prefill_chunk: int, any_sampled: Optional[bool] = None):
    """One unified draft→verify→accept step over every slot.

    ``slots`` is the engine's ``SlotState`` (sampling rows and ``hist``
    carried); ``poison`` ``[B]`` bool turns a slot's logits non-finite
    (the chaos seam); ``draft_caps`` ``[B]`` int32 bounds each slot's
    draft length to what the host paged for it (``Scheduler.draft_cap``)
    — the device must never write K/V beyond the slot's page table,
    because an accepted token whose K/V landed on the garbage page would
    be silently lost. ``any_sampled`` as in ``sample_tokens``.

    Returns ``(kv, slots, emitted_ex)``: the pool and ``slots.hist`` are
    updated in place, the other slot fields are new tensors;
    ``emitted_ex`` is ``[B, C + 1]`` int32: columns ``0..C-1`` are this
    step's emitted tokens in order (``NO_TOKEN`` padding; ``POISONED``
    in column 0 quarantines the slot), and column ``C`` is the slot's
    drafted-token count — so the host's ONE fetched array carries
    tokens, fault verdicts AND the speculation accounting.
    """
    B = slots.tokens.shape[0]
    C = max(int(prefill_chunk), int(spec_k) + 1)
    hist = slots.hist
    W = hist.shape[1] - 1
    dev = hist.device
    rows = torch.arange(B, device=dev)

    active = slots.active
    pos0 = torch.where(active, slots.positions, 0).to(torch.int32)
    plen = slots.prompt_lens.to(torch.int32)
    prefilling = pos0 < plen
    decoding = active & ~prefilling

    # 1. complete the known history: the carried token is consumed at
    # pos0 this step (inactive rows write the scratch column W)
    dest0 = torch.where(active, pos0, W)
    hist.index_put_((rows, dest0.long()), slots.tokens.to(torch.int32))

    # 2. draft: n-gram lookup over each decoding slot's own history
    # (known tokens = everything consumed + the carried token)
    lens = torch.where(decoding, pos0 + 1, 0)
    if spec_k > 0:
        drafts, n_draft = ngram_propose(hist, lens, k=spec_k, n=ngram)
        n_draft = torch.minimum(n_draft, draft_caps.to(torch.int32)
                                .clamp(min=0))
        n_draft = torch.where(decoding, n_draft, 0).to(torch.int32)
    else:
        drafts = torch.zeros((B, 0), dtype=torch.int32, device=dev)
        n_draft = torch.zeros((B,), dtype=torch.int32, device=dev)

    # 3. per-slot consumption: prompt chunk while prefilling, the
    # carried token + capped drafts while decoding
    take = torch.where(
        active,
        torch.where(prefilling, torch.clamp(plen - pos0, max=prefill_chunk),
                    1 + n_draft),
        0).to(torch.int32)

    cols = torch.arange(C, dtype=torch.int32, device=dev)
    p = pos0[:, None] + cols[None, :]                    # [B, C]
    valid = cols[None, :] < take[:, None]
    draft_col = torch.cat(
        [slots.tokens[:, None].to(torch.int32),
         F.pad(drafts, (0, C - 1 - drafts.shape[1]))], dim=1)  # [B, C]
    prompt_tok = hist.gather(1, p.clamp(max=W).long())
    tok = torch.where(p < plen[:, None], prompt_tok, draft_col)
    tok = torch.where(valid, tok, 0).to(torch.int32)
    pclamp = torch.where(valid, p, 0)

    # 4. write every consumed token into the history (prompt columns
    # rewrite their own value; draft columns extend it — stale rejected
    # entries beyond the rewound cursor are overwritten before any later
    # lookup includes them, the same argument as the KV pool). Invalid
    # columns all write 0 into the scratch column.
    destc = torch.where(valid, p, W)
    hist.index_put_((rows[:, None].expand(B, C), destc.long()), tok)

    # 5. ONE chunk-shaped target pass verifies all C positions
    h, pages = chunk_hidden(cfg, params, spec, kv, tok, pclamp, valid,
                            page_tables)
    logits = lm_logits(cfg, params, h)                   # [B, C, V] f32
    logits = torch.where(poison[:, None, None], float("nan"), logits)

    # 6. the position-keyed deterministic draw at every column — the
    # token sequential decode WOULD emit from these logits
    V = logits.shape[-1]

    def rep(a):
        return a[:, None].expand(B, C).reshape(B * C)

    e = sample_tokens(
        logits.reshape(B * C, V), rep(slots.temps), rep(slots.top_ks),
        rep(slots.top_ps), rep(slots.seeds), rep(slots.rids),
        (pclamp + 1).reshape(B * C), any_sampled=any_sampled).reshape(B, C)
    nonfin = ~torch.isfinite(logits).all(dim=-1)         # [B, C]

    # 7. accept: draft j survives iff it equals position pos+j's own
    # carried draw AND every earlier draft survived
    match = (tok[:, 1:] == e[:, :-1]) & valid[:, 1:]
    m = torch.cumprod(match.to(torch.int32), dim=1).sum(dim=1).to(
        torch.int32)                                     # accepted drafts
    n_emit_dec = m + 1
    new_pos = pos0 + torch.where(prefilling, take, n_emit_dec)
    finished_prefill = prefilling & (new_pos >= plen)

    # fault isolation: non-finite logits in a column that feeds an
    # EMITTED token quarantine the slot (POISONED in column 0). For a
    # decode slot that is the accepted run only — a REJECTED draft
    # column's logits are computation plain sequential decode would
    # never have performed; quarantining on it would FAIL a request
    # plain decode completes.
    emit_cols = torch.where(prefilling[:, None], valid,
                            cols[None, :] < n_emit_dec[:, None])
    bad = active & (emit_cols & nonfin).any(dim=1)

    last_idx = (take - 1).clamp(0, C - 1).long()
    e_last = e.gather(1, last_idx[:, None])[:, 0]
    e_m = e.gather(1, m.clamp(0, C - 1).long()[:, None])[:, 0]

    j = cols[None, :]
    emitted = torch.full((B, C), NO_TOKEN, dtype=torch.int32, device=dev)
    emitted = torch.where(decoding[:, None] & (j < n_emit_dec[:, None]),
                          e, emitted)
    emitted = torch.where(finished_prefill[:, None] & (j == 0),
                          e_last[:, None], emitted)
    poisoned_row = torch.where(j == 0, POISONED, NO_TOKEN).to(torch.int32)
    emitted = torch.where(bad[:, None], poisoned_row, emitted)
    emitted = torch.where(active[:, None], emitted, NO_TOKEN)

    # 8. carry: the next token each slot consumes (prompt next while
    # prefilling, else the last emitted token), at its rewound cursor
    still_prefill = new_pos < plen
    prompt_next = hist.gather(1, new_pos.clamp(max=W).long()[:, None])[:, 0]
    next_tok = torch.where(still_prefill, prompt_next,
                           torch.where(prefilling, e_last, e_m))
    slots = dataclasses.replace(
        slots,
        tokens=torch.where(active, next_tok, slots.tokens).to(torch.int32),
        positions=torch.where(active, new_pos,
                              slots.positions).to(torch.int32))
    emitted_ex = torch.cat(
        [emitted, torch.where(decoding & ~bad, n_draft, 0)[:, None]],
        dim=1).to(torch.int32)
    return KVCacheState(pages=pages), slots, emitted_ex
