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
