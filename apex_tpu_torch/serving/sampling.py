"""Carried sampling: temperature / top-k / top-p with a stateless PRNG
(counterpart of ``apex_tpu/serving/sampling.py``).

Every random draw is a pure function of ``(seed, rid, position)``
through the murmur3 hash counter (``ops.flash_attention._hash_keep_bits``,
bit-exact with the JAX package), so a replayed request regenerates the
same samples and the dense reference decode draws exactly what the
engine draws. Semantics (HuggingFace filter order): logits scaled by
``1/temperature``, top-k keeps the k highest, top-p then keeps the
smallest set of survivors whose mass reaches ``p`` (always at least
one); the draw is Gumbel-max over the filtered logits. ``temperature ==
0`` is greedy argmax.

The JAX ``lax.cond``s become:

- the greedy/sampling branch: a Python ``if``; the engine passes
  ``any_sampled`` from its host mirrors, so the greedy hot path never
  reads the device; a caller that passes None pays one ``.any()`` read;
- the deep-sort branch (some row's thresholds lie beyond the
  ``TOP_FILTER_WIDTH`` prefix): both sides on the device and a per-row
  select, no host read. A step that samples pays one full sort of its
  ``[R, vocab]`` scaled logits whether or not a row needs it.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ..ops.flash_attention import _hash_keep_bits, _shr_logical


@dataclasses.dataclass(frozen=True)
class SamplingParams:
    """Per-request sampling policy (attach as ``Request.sampling``):
    ``temperature`` 0 = greedy; ``top_k`` 0 = off; ``top_p`` 1.0 = off;
    draws are keyed ``(seed, rid, position)``."""

    temperature: float = 0.0
    top_k: int = 0
    top_p: float = 1.0
    seed: int = 0

    def __post_init__(self):
        if self.temperature < 0:
            raise ValueError(f"temperature must be >= 0, "
                             f"got {self.temperature}")
        if self.top_k < 0:
            raise ValueError(f"top_k must be >= 0, got {self.top_k}")
        if not 0.0 < self.top_p <= 1.0:
            raise ValueError(f"top_p must be in (0, 1], got {self.top_p}")

    @property
    def is_greedy(self) -> bool:
        return self.temperature == 0.0


#: the default policy: greedy argmax, no randomness consumed
GREEDY = SamplingParams()


def resolve(sampling: Optional[SamplingParams]) -> SamplingParams:
    """``None`` means greedy (the Request default)."""
    return GREEDY if sampling is None else sampling


def i32_wrap(v: int) -> int:
    """Wrap an arbitrary int into the int32 PRNG lane (two's
    complement) — seeds/rids are hash keys, only their 32 bits matter."""
    v = int(v) & 0xFFFFFFFF
    return v - (1 << 32) if v >= (1 << 31) else v


def uniform_from_hash(seeds, rids, positions, idx) -> torch.Tensor:
    """Uniform (0, 1) f32 draws keyed ``(seed, rid, position, idx)``:
    the top 24 hash bits become the mantissa, ``((bits >> 8) + 0.5) /
    2^24`` — exactly representable, never 0 and never 1."""
    bits = _hash_keep_bits(seeds, rids, positions, idx)
    return (_shr_logical(bits, 8).float() + 0.5) / float(1 << 24)


#: width of the top-k prefilter the filter thresholds resolve from
TOP_FILTER_WIDTH = 64

#: the collectives of :func:`sample_tokens_tp`, by site (the draw's two
#: only on a step where a row samples)
TP_SITES = {"sampler_candidates": "all_gather",
            "sampler_sum": "all_reduce_sum",
            "draw_max": "all_reduce_max", "draw_min": "all_reduce_min"}

_NEG_INF = float("-inf")


def _thresholds(vals_desc: torch.Tensor, scaled: torch.Tensor,
                top_ks: torch.Tensor, top_ps: torch.Tensor):
    """Per-row keep thresholds from a DESCENDING prefix ``vals_desc``
    ([R, W]) of each row of ``scaled`` ([R, V]): ``(kth, thresh,
    covered)`` — the top-k threshold, the top-p threshold, and whether
    the prefix was deep enough for the row's filters to be exact."""
    R, V = scaled.shape
    W = vals_desc.shape[1]
    k_idx = top_ks.clamp(1, W).long() - 1
    kth = vals_desc.gather(1, k_idx[:, None])[:, 0]
    k_all = (top_ks <= 0) | (top_ks >= V)
    kth = torch.where(k_all, _NEG_INF, kth)
    m = vals_desc[:, 0]
    denom = torch.where(scaled >= kth[:, None],
                        torch.exp(scaled - m[:, None]), 0.0).sum(dim=-1)
    ms = torch.where(vals_desc >= kth[:, None], vals_desc, _NEG_INF)
    probs = torch.exp(ms - m[:, None]) / denom[:, None]  # -inf -> 0
    cum = torch.cumsum(probs, dim=-1)
    n_keep = ((cum - probs) < top_ps[:, None]).sum(dim=-1)
    thresh = ms.gather(1, (n_keep - 1).clamp(min=0)[:, None])[:, 0]
    thresh = torch.where(top_ps >= 1.0, _NEG_INF, thresh)
    p_done = (top_ps >= 1.0) | (cum[:, -1] >= top_ps)
    covered = (k_all | (top_ks <= W)) & p_done
    return kth, thresh, covered


def _filtered_logits(logits: torch.Tensor, temps: torch.Tensor,
                     top_ks: torch.Tensor, top_ps: torch.Tensor,
                     width: int = TOP_FILTER_WIDTH) -> torch.Tensor:
    """Temperature-scaled logits with the top-k then top-p filters
    applied as ``-inf`` masks ([R, V] -> [R, V], row-independent)."""
    R, V = logits.shape
    scaled = logits / temps.clamp(min=1e-6)[:, None]
    W = min(int(width), V)
    kth, thresh, covered = _thresholds(
        torch.topk(scaled, W, dim=-1).values, scaled, top_ks, top_ps)
    # the JAX sampler takes the full sort under lax.cond when some row's
    # thresholds lie beyond the prefix; branching on covered.all() here
    # would read the device, so the sort runs on every sampled step and
    # each row selects on the device. Covered rows keep their prefix-path
    # values (the same bits as the JAX sampler's, whichever branch it took)
    srt = torch.sort(scaled, dim=-1, descending=True).values
    f_kth, f_thresh, _ = _thresholds(srt, scaled, top_ks, top_ps)
    kth = torch.where(covered, kth, f_kth)
    thresh = torch.where(covered, thresh, f_thresh)
    keep = (scaled >= kth[:, None]) & (scaled >= thresh[:, None])
    return torch.where(keep, scaled, _NEG_INF)


def sample_tokens(logits: torch.Tensor, temps: torch.Tensor,
                  top_ks: torch.Tensor, top_ps: torch.Tensor,
                  seeds: torch.Tensor, rids: torch.Tensor,
                  positions: torch.Tensor, *,
                  any_sampled: Optional[bool] = None) -> torch.Tensor:
    """One token per row: ``[R, vocab]`` fp32 logits + per-row policy
    tensors -> ``[R]`` int32 tokens. ``positions`` is the position the
    sampled token will OCCUPY (the PRNG counter). Rows with ``temps <=
    0`` take the greedy argmax (lowest index on ties, as ``jnp.argmax``).
    ``any_sampled`` tells whether any row samples (None: read it from
    ``temps``)."""
    logits = logits.float()
    R, V = logits.shape
    greedy_tok = logits.argmax(dim=-1).to(torch.int32)
    if any_sampled is None:
        any_sampled = bool((temps > 0.0).any())
    if not any_sampled:
        return greedy_tok
    allowed = _filtered_logits(logits, temps, top_ks, top_ps)
    vi = torch.arange(V, dtype=torch.int32, device=logits.device)[None, :]
    u = uniform_from_hash(seeds[:, None], rids[:, None],
                          positions[:, None], vi)
    gumbel = -torch.log(-torch.log(u))
    sampled = (allowed + gumbel).argmax(dim=-1).to(torch.int32)
    return torch.where(temps <= 0.0, greedy_tok, sampled)


_I32_MAX = 2 ** 31 - 1


def sample_tokens_tp(logits: torch.Tensor, temps: torch.Tensor,
                     top_ks: torch.Tensor, top_ps: torch.Tensor,
                     seeds: torch.Tensor, rids: torch.Tensor,
                     positions: torch.Tensor, *, axis_name, vocab_size: int,
                     any_sampled: Optional[bool] = None):
    """Vocab-parallel :func:`sample_tokens`: this rank holds the ``[R,
    V / tp]`` logits of global ids ``[rank * V / tp, (rank + 1) * V /
    tp)``, and the full vocab is on no rank. ``axis_name`` is the
    tensor group (a ``tp.TPComm``, an axis name or a ``ProcessGroup``).

    Returns ``(tokens [R] int32, nonfinite [R] bool)``; the tokens are
    the replicated sampler's, bit for bit:

    - candidates: the rank's top-``TOP_FILTER_WIDTH`` of its raw slice
      with their global ids, gathered shard-major in ONE
      ``all_gather_into_tensor`` (the values' bits beside the ids). The
      greedy token is the largest candidate, the lowest id among equals
      (``argmax``'s rule);
    - thresholds: the top-``W`` of the gathered candidates divided by
      the temperature (``x / t``, as the replicated sampler divides) is
      the replicated prefix, so :func:`_thresholds`' math runs on it; the
      one sum over the whole vocab, the softmax denominator, is the
      rank's partial in ONE fused ``all_reduce`` that also carries the
      row's count of non-finite logits;
    - the draw: Gumbel noise keyed by the global vocab id through
      :func:`uniform_from_hash`, the rank's best and its id, then an
      ``all_reduce`` MAX of the best and a MIN over the ids that hold it.

    A step where no row samples (``any_sampled`` False, from the
    engine's host mirrors) issues the gather and the fused reduction
    only. There is no deep-``top_k`` fallback: the engine refuses
    ``top_k > TOP_FILTER_WIDTH`` at submit."""
    from .tp import TPComm

    comm = TPComm.of(axis_name)
    logits = logits.float()
    R, Vl = logits.shape
    V = int(vocab_size)
    base = comm.rank * Vl
    dev = logits.device

    # the rank's candidates: raw top-W of the local slice, global ids
    Wl = min(TOP_FILTER_WIDTH, Vl)
    lvals, lidx = torch.topk(logits, Wl, dim=-1)
    gids = (lidx + base).to(torch.int32)
    # values moved as their int32 bits beside the ids: one exact gather
    both = comm.all_gather(torch.cat([lvals.view(torch.int32), gids], -1),
                           "sampler_candidates").view(R, comm.size, 2, Wl)
    gvals = both[:, :, 0].contiguous().view(torch.float32).reshape(
        R, comm.size * Wl)
    ggids = both[:, :, 1].reshape(R, comm.size * Wl)
    best = gvals.max(dim=-1, keepdim=True).values
    greedy_tok = torch.where(gvals == best, ggids, _I32_MAX).min(
        dim=-1).values.clamp(max=V - 1).to(torch.int32)

    if any_sampled is None:
        any_sampled = bool((temps > 0.0).any())
    nonfin_l = (~torch.isfinite(logits)).sum(dim=-1).float()
    if not any_sampled:
        tot = comm.psum(torch.stack([torch.zeros_like(nonfin_l), nonfin_l],
                                    dim=-1), "sampler_sum")
        return greedy_tok, tot[:, 1] > 0.0

    # thresholds from the whole gathered candidate prefix (tp * W deep),
    # the temperature DIVIDED as the replicated sampler divides
    t = temps.clamp(min=1e-6)
    scaled = logits / t[:, None]
    W = gvals.shape[1]
    vals_desc = torch.topk(gvals / t[:, None], W, dim=-1).values
    k_idx = top_ks.clamp(1, W).long() - 1
    kth = vals_desc.gather(1, k_idx[:, None])[:, 0]
    k_all = (top_ks <= 0) | (top_ks >= V)
    kth = torch.where(k_all, _NEG_INF, kth)
    m = vals_desc[:, 0]

    # the sampler's ONE sum: the softmax denominator's partials over the
    # sharded vocab, fused with the non-finite count (the poison flag)
    part = torch.where(scaled >= kth[:, None],
                       torch.exp(scaled - m[:, None]), 0.0).sum(dim=-1)
    tot = comm.psum(torch.stack([part, nonfin_l], dim=-1), "sampler_sum")
    denom, nonfin_ct = tot[:, 0], tot[:, 1]

    ms = torch.where(vals_desc >= kth[:, None], vals_desc, _NEG_INF)
    probs = torch.exp(ms - m[:, None]) / denom[:, None]
    cum = torch.cumsum(probs, dim=-1)
    n_keep = ((cum - probs) < top_ps[:, None]).sum(dim=-1)
    thresh = ms.gather(1, (n_keep - 1).clamp(min=0)[:, None])[:, 0]
    thresh = torch.where(top_ps >= 1.0, _NEG_INF, thresh)

    # the distributed Gumbel-max over the local slice, keyed by global id
    keep = (scaled >= kth[:, None]) & (scaled >= thresh[:, None])
    allowed = torch.where(keep, scaled, _NEG_INF)
    vi = torch.arange(Vl, dtype=torch.int32, device=dev)[None, :] + base
    u = uniform_from_hash(seeds[:, None], rids[:, None], positions[:, None],
                          vi)
    y = allowed + (-torch.log(-torch.log(u)))
    lbest, larg = y.max(dim=-1)
    larg = larg.to(torch.int32) + base
    wbest = comm.pmax(lbest, "draw_max")
    warg = comm.pmin(torch.where(lbest == wbest, larg, _I32_MAX), "draw_min")
    sampled = warg.clamp(max=V - 1)  # all-NaN rows are poisoned anyway
    tok = torch.where(temps <= 0.0, greedy_tok, sampled).to(torch.int32)
    return tok, nonfin_ct > 0.0
