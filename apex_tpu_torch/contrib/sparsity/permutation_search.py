"""Channel-permutation search for 2:4 structured sparsity (counterpart
of ``apex_tpu/contrib/sparsity/permutation_search.py``).

- ``apply_2_to_4`` / ``sum_after_2_to_4``: zero the two smallest of every
  row-aligned group of 4, ranked by a double stable ``argsort`` (ties
  keep their order, as a magnitude threshold would not);
- ``channel_swap_search``: the greedy search of the reference's
  ``Channel_Swap``: score every cross-stripe column swap by the magnitude
  kept after 2:4 pruning, apply the best, repeat until no swap gains more
  than ``min_gain``, with optional random "escape" swaps;
- ``exhaustive_search``: every regrouping of the columns of a window of
  stripes, alternated with the swap polish, with escapes;
- ``apply_permutation_C`` / ``_K``: apply a found permutation to a
  consumer's input dim or a producer's output dim.

The score map of a swap iteration is batched over the stripes: for every
stripe ``s``, position ``p`` and candidate column ``b``, the kept
magnitude with ``b`` in ``p``'s place is a sum over rows of the top two of
the stripe's three other values and ``|b|``, ``max(x1, v) + max(x2,
min(x1, v))`` with ``x1 >= x2`` the larger two of the three: a
``[stripes, rows, columns]`` tensor a position, swept in chunks of
stripes so that neither the card runs a Python loop of ``stripes x 4``
launches nor the memory holds the ``[C, R, 4]`` tensor a stripe that the
JAX package maps over. It is the same quantity as the JAX package's
``sum - smallest two``, rounded differently: kept magnitudes agree to
fp32 summation order, and the chosen swaps agree unless two gains tie
within that.

Escapes draw from a ``torch.Generator`` (passed as ``key``, the JAX
package's PRNG key's place), so a search with escapes takes other random
swaps than the JAX package's: their results agree exactly only at
``escape_attempts=0``.
"""
from __future__ import annotations

import itertools
from typing import Optional, Tuple

import numpy as np
import torch

#: elements of the ``[stripes, rows, columns]`` score tensor swept at once
_CHUNK_ELEMS = 1 << 26


def apply_2_to_4(matrix: torch.Tensor) -> torch.Tensor:
    """Zero the two smallest-magnitude entries of every row-aligned group
    of 4."""
    r, c = matrix.shape
    if c % 4:
        raise ValueError(f"columns {c} must be a multiple of 4")
    g = matrix.reshape(r, c // 4, 4)
    a = g.abs()
    rank = torch.argsort(torch.argsort(a, dim=-1, stable=True), dim=-1,
                         stable=True)  # 0 = smallest
    keep = rank >= 2
    return (g * keep).reshape(r, c)


def sum_after_2_to_4(matrix: torch.Tensor) -> torch.Tensor:
    """Total |magnitude| kept by 2:4 pruning."""
    return apply_2_to_4(matrix).abs().sum()


def _top2_sum(a: torch.Tensor) -> torch.Tensor:
    """``[..., 4]`` -> the sum of the two largest along the last dim, as
    the JAX package computes it: the sum of all four less the sum of the
    two smallest."""
    small2 = torch.sort(a, dim=-1).values[..., :2].sum(dim=-1)
    return a.sum(dim=-1) - small2


def _stripe_kept(stripes: torch.Tensor) -> torch.Tensor:
    """``[S, R, 4]`` -> ``[S]`` magnitude kept a stripe."""
    return _top2_sum(stripes.abs()).sum(dim=-1)


def _kept_replace(stripes: torch.Tensor, cols: torch.Tensor) -> torch.Tensor:
    """``[S, 4, C]``: magnitude kept by stripe ``s`` with position ``p``
    replaced by column ``b`` (``cols`` is the ``[R, C]`` matrix)."""
    s, r, _ = stripes.shape
    c = cols.shape[1]
    a = stripes.abs()
    v = cols.abs()[None]  # [1, R, C]
    out = torch.empty(s, 4, c, dtype=torch.float32, device=stripes.device)
    chunk = max(1, _CHUNK_ELEMS // max(1, r * c))
    for p in range(4):
        others = a[..., [q for q in range(4) if q != p]]  # [S, R, 3]
        top = torch.topk(others, 2, dim=-1).values  # x1 >= x2
        x1, x2 = top[..., 0:1], top[..., 1:2]  # [S, R, 1]
        for lo in range(0, s, chunk):
            hi = min(s, lo + chunk)
            a1, a2 = x1[lo:hi], x2[lo:hi]
            kept = torch.maximum(a1, v) + torch.maximum(a2,
                                                        torch.minimum(a1, v))
            out[lo:hi, p] = kept.sum(dim=1)
    return out


def _best_swap(matrix: torch.Tensor):
    """``(gain, col_a, col_b)`` of the best cross-stripe column swap, as
    0-dim tensors."""
    r, c = matrix.shape
    s = c // 4
    stripes = matrix.t().reshape(s, 4, r).permute(0, 2, 1)  # [S, R, 4]
    kept = _stripe_kept(stripes)  # [S]
    krep_ab = _kept_replace(stripes, matrix).reshape(c, c)  # row (s_a, p_a)
    kept4 = kept.repeat_interleave(4)
    imp = krep_ab + krep_ab.t()
    imp = imp - kept4[:, None] - kept4[None, :]
    ids = torch.arange(c, device=matrix.device) // 4
    imp = imp.masked_fill(ids[:, None] == ids[None, :], -torch.inf)
    flat = torch.argmax(imp)
    a, b = flat // c, flat % c
    return imp[a, b], a, b


def _swap_cols(matrix: torch.Tensor, a: int, b: int) -> torch.Tensor:
    out = matrix.clone()
    out[:, [a, b]] = matrix[:, [b, a]]
    return out


def _check_escape(escape_attempts: int, key) -> None:
    if escape_attempts > 0 and key is None:
        raise ValueError("escape_attempts > 0 requires key")


def channel_swap_search(matrix, max_iters: int = 1000,
                        escape_attempts: int = 0,
                        key: Optional[torch.Generator] = None,
                        min_gain: float = 1e-6) -> Tuple[np.ndarray, float]:
    """Greedy channel-swap search: ``(permutation [C], kept_magnitude)``
    such that ``matrix[:, permutation]`` keeps the most magnitude under
    2:4 pruning. ``escape_attempts`` random swaps are taken when the
    search stalls (needs ``key``, a ``torch.Generator``); the best
    permutation seen is returned. The matrix stays on its device; each
    iteration reads its gain on the host."""
    m = torch.as_tensor(matrix).to(torch.float32)
    r, c = m.shape
    if c % 4:
        raise ValueError(f"columns {c} must be a multiple of 4")
    _check_escape(escape_attempts, key)
    perm = np.arange(c)
    escapes_left = escape_attempts
    best = (None, -np.inf)
    for _ in range(max_iters):
        gain, a, b = _best_swap(m)
        gain = float(gain)
        a, b = int(a), int(b)
        if gain > min_gain:
            m = _swap_cols(m, a, b)
            perm[[a, b]] = perm[[b, a]]
            continue
        kept = float(sum_after_2_to_4(m))
        if kept > best[1]:
            best = (perm.copy(), kept)
        if escapes_left <= 0:
            break
        escapes_left -= 1
        a, b = (int(x) for x in torch.randperm(
            c, generator=key, device=key.device)[:2])
        m = _swap_cols(m, a, b)
        perm[[a, b]] = perm[[b, a]]
    kept = float(sum_after_2_to_4(m))
    if kept > best[1]:
        best = (perm.copy(), kept)
    return best


# ---------------------------------------------------------------------------
# the windowed exhaustive search (reference Exhaustive_Search)
# ---------------------------------------------------------------------------

_CANONICAL_PERMS_CACHE: dict = {}


def _canonical_group_perms(n_cols: int, group_width: int = 4) -> np.ndarray:
    """Every unique assignment of ``n_cols`` columns to groups of
    ``group_width`` (sorted within groups, groups sorted by their first
    member): (8, 4) -> 35, (12, 4) -> 5775."""
    key_ = (n_cols, group_width)
    if key_ in _CANONICAL_PERMS_CACHE:
        return _CANONICAL_PERMS_CACHE[key_]
    out = []

    def build(perm, remaining):
        if not remaining:
            out.append(list(perm))
            return
        for i, col in enumerate(remaining):
            if len(perm) % group_width == 0:
                if any(v < col for v in remaining[:i]):
                    continue
                if perm and col <= perm[-group_width]:
                    continue
            elif col <= perm[-1]:
                continue
            build(perm + [col], remaining[:i] + remaining[i + 1:])

    build([], list(range(n_cols)))
    arr = np.asarray(out, np.int32)
    _CANONICAL_PERMS_CACHE[key_] = arr
    return arr


def _window_kept(matrix: torch.Tensor, window_cols: torch.Tensor,
                 perms: torch.Tensor) -> torch.Tensor:
    """``[P, M]`` kept magnitude of window ``p`` regrouped by candidate
    ``m``; swept in chunks of windows."""
    r = matrix.shape[0]
    n_p, w = window_cols.shape
    n_m = perms.shape[0]
    chunk = max(1, _CHUNK_ELEMS // max(1, n_m * r * w))
    outs = []
    for lo in range(0, n_p, chunk):
        cols = window_cols[lo:lo + chunk]  # [P', W]
        cand = matrix[:, cols[:, perms]]  # [R, P', M, W]
        g = cand.abs().permute(1, 2, 0, 3).reshape(
            cols.shape[0], n_m, r, w // 4, 4)
        outs.append(_top2_sum(g).sum(dim=(2, 3)))
    return torch.cat(outs)


def _best_window_move(matrix, window_cols, perms):
    kept = _window_kept(matrix, window_cols, perms)  # [P, M]
    gain = kept - kept[:, :1]  # candidate 0 is the identity
    flat = torch.argmax(gain)
    p, mi = flat // gain.shape[1], flat % gain.shape[1]
    return gain[p, mi], p, mi


def exhaustive_search(matrix, escape_attempts: int = 10,
                      window_size: int = 8,
                      key: Optional[torch.Generator] = None,
                      max_iters: int = 1000, min_gain: float = 1e-6,
                      initial_permutation=None) -> Tuple[np.ndarray, float]:
    """Windowed exhaustive permutation search with escape moves, the
    ``(permutation, kept_magnitude)`` contract of
    :func:`channel_swap_search`: each window move tries every regrouping
    of ``window_size`` columns, alternated with the cross-window swap
    polish; escapes regroup a random window (``key``, a
    ``torch.Generator``). ``initial_permutation`` warm-starts it."""
    m = torch.as_tensor(matrix).to(torch.float32)
    r, c = m.shape
    if c % 4:
        raise ValueError(f"columns {c} must be a multiple of 4")
    if window_size % 4 or window_size < 8:
        raise ValueError(f"window_size {window_size} must be a multiple "
                         "of 4 and >= 8")
    s = c // 4
    w_stripes = window_size // 4
    if escape_attempts > 0 and key is None and s >= w_stripes:
        raise ValueError("escape_attempts > 0 requires key")
    if s < w_stripes:
        perm = (np.arange(c) if initial_permutation is None
                else np.asarray(initial_permutation, np.int64).copy())
        idx = torch.as_tensor(perm, device=m.device)
        return perm, float(sum_after_2_to_4(m[:, idx]))

    stripe_groups = np.asarray(
        list(itertools.combinations(range(s), w_stripes)), np.int64)
    window_cols_np = (stripe_groups[:, :, None] * 4
                      + np.arange(4)[None, None, :]).reshape(
                          len(stripe_groups), -1)
    perms_np = _canonical_group_perms(window_size).astype(np.int64)
    window_cols = torch.as_tensor(window_cols_np, device=m.device)
    perms = torch.as_tensor(perms_np, device=m.device)

    perm = np.arange(c)
    if initial_permutation is not None:
        perm = np.asarray(initial_permutation, np.int64).copy()
        m = m[:, torch.as_tensor(perm, device=m.device)]
    best = (perm.copy(), float(sum_after_2_to_4(m)))
    escapes_left = escape_attempts

    def apply_window(m, perm, p, mi):
        cols = window_cols_np[int(p)]
        new_cols = cols[perms_np[int(mi)]]
        m = m.clone()
        m[:, torch.as_tensor(cols, device=m.device)] = m[
            :, torch.as_tensor(new_cols, device=m.device)]
        perm[cols] = perm[new_cols]
        return m, perm

    for _ in range(max_iters):
        gain, p, mi = _best_window_move(m, window_cols, perms)
        if float(gain) > min_gain:
            m, perm = apply_window(m, perm, p, mi)
            continue
        gain, a, b = _best_swap(m)
        if float(gain) > min_gain:
            a, b = int(a), int(b)
            m = _swap_cols(m, a, b)
            perm[[a, b]] = perm[[b, a]]
            continue
        kept = float(sum_after_2_to_4(m))
        if kept > best[1]:
            best = (perm.copy(), kept)
        if escapes_left <= 0:
            break
        escapes_left -= 1
        p = int(torch.randint(0, len(stripe_groups), (), generator=key,
                              device=key.device))
        mi = int(torch.randint(1, perms_np.shape[0], (), generator=key,
                               device=key.device))
        m, perm = apply_window(m, perm, p, mi)
    kept = float(sum_after_2_to_4(m))
    if kept > best[1]:
        best = (perm.copy(), kept)
    return best


def apply_permutation_C(weight: torch.Tensor, permutation) -> torch.Tensor:
    """Permute a consumer weight's input-channel dim (the last)."""
    return torch.index_select(weight, -1, torch.as_tensor(
        np.asarray(permutation), device=weight.device))


def apply_permutation_K(weight: torch.Tensor, permutation) -> torch.Tensor:
    """Permute a producer weight's output dim (the first)."""
    return torch.index_select(weight, 0, torch.as_tensor(
        np.asarray(permutation), device=weight.device))
