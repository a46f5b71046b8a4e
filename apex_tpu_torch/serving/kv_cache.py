"""Paged KV cache: the device pool and the host-side page accounting
(counterpart of ``apex_tpu/serving/kv_cache.py``).

The unit is the **page** (PagedAttention/vLLM): ``page_size`` tokens of
one layer's K or V, owned by a request (or shared read-only through the
prefix cache), addressed through a per-request page table. Pages are
**head-major** ``[page, head, token, head_dim]`` so the flash-decode
kernel reads one head's rows of a page contiguously. Each page is a
whole number of packed-buffer ``ROW``s, the JAX package's layout rule.

Page 0 is the **garbage page**: page-table entries past a request's
length, and the writes of inactive slots and invalid chunk columns,
point at it, so the fixed-shape step always touches valid memory.
Nothing reads it unmasked.

Where the JAX package updated the donated pool functionally
(``.at[].set``), the port writes the pool tensor in place with
``index_put_`` (:func:`write_token_kv`, :func:`write_chunk_kv`).
Several rows may write the garbage page at once; ``index_put_`` with
duplicate indices picks no particular winner, which is harmless for a
page nobody reads.

:class:`PageAllocator` (free list, reader refcounts, cache pins) and
:class:`PrefixCache` (chained-hash radix index over full prompt pages)
are host code, copied from the JAX package.
"""
from __future__ import annotations

import hashlib
from collections import OrderedDict
from typing import Dict, List, NamedTuple, Optional, Sequence, Set, Tuple

import numpy as np
import torch

from ..multi_tensor_apply.packing import ROW, is_row_aligned


class KVCacheState(NamedTuple):
    """Device KV pool: ``pages[layer, 0=k/1=v, page, head, token, dim]``."""

    pages: torch.Tensor  # [L, 2, num_pages, n_heads, page_size, head_dim]


class PagedKVSpec:
    """Static paged-KV layout: pool shape and page geometry.

    ``num_pages`` INCLUDES the reserved garbage page 0, so
    ``num_pages - 1`` pages are allocatable. ``pages_per_seq`` bounds one
    request's page-table width (max sequence =
    ``pages_per_seq * page_size`` tokens).
    """

    GARBAGE_PAGE = 0

    def __init__(self, num_layers: int, num_heads: int, head_dim: int,
                 *, page_size: int, num_pages: int, pages_per_seq: int,
                 dtype: torch.dtype = torch.bfloat16):
        if num_pages < 2:
            raise ValueError(
                f"num_pages must be >= 2 (page 0 is the reserved garbage "
                f"page), got {num_pages}")
        page_elems = num_heads * page_size * head_dim
        if not is_row_aligned(page_elems):
            raise ValueError(
                f"page ({num_heads} heads x {page_size} tokens x "
                f"{head_dim} dim = {page_elems} elems) is not ROW-aligned "
                f"({ROW}): pages would straddle packed-buffer rows — pick "
                "page_size so heads*page_size*head_dim is a multiple of "
                f"{ROW}")
        self.num_layers = int(num_layers)
        self.num_heads = int(num_heads)
        self.head_dim = int(head_dim)
        self.page_size = int(page_size)
        self.num_pages = int(num_pages)
        self.pages_per_seq = int(pages_per_seq)
        self.dtype = dtype
        self.page_elems = page_elems
        self.max_seq_len = self.pages_per_seq * self.page_size

    @property
    def pool_leaf_shape(self):
        """One layer's K (or V) pool: ``[num_pages, heads, page, dim]``."""
        return (self.num_pages, self.num_heads, self.page_size,
                self.head_dim)

    @property
    def n_usable_pages(self) -> int:
        return self.num_pages - 1  # minus the garbage page

    def pages_for(self, n_tokens: int) -> int:
        """Pages needed to hold ``n_tokens``."""
        return -(-int(n_tokens) // self.page_size)

    def init_cache(self, device) -> KVCacheState:
        return KVCacheState(pages=torch.zeros(
            (self.num_layers, 2) + self.pool_leaf_shape, dtype=self.dtype,
            device=device))

    def __repr__(self):
        return (f"PagedKVSpec(L={self.num_layers}, heads={self.num_heads},"
                f" d={self.head_dim}, page={self.page_size}, "
                f"pages={self.num_pages}, per_seq={self.pages_per_seq}, "
                f"{self.dtype})")


def _write_rows(pages: torch.Tensor, layer: int, which: int,
                rows: torch.Tensor, page_idx: torch.Tensor,
                offsets: torch.Tensor) -> None:
    # [P, n, ps, d] viewed as [P, ps, n, d]: (page, offset) picks one
    # token's [n, d] row; the view writes through to the pool
    view = pages[layer, which].permute(0, 2, 1, 3)
    view.index_put_((page_idx.long(), offsets.long()),
                    rows.to(pages.dtype))


def write_token_kv(pages: torch.Tensor, layer: int, k: torch.Tensor,
                   v: torch.Tensor, page_idx: torch.Tensor,
                   offsets: torch.Tensor) -> torch.Tensor:
    """Write one token's K/V per slot into the pool, in place.

    ``pages`` ``[L, 2, P, n, ps, d]``; ``k``/``v`` ``[B, n, d]``;
    ``page_idx``/``offsets`` ``[B]`` (inactive slots point at the garbage
    page). Returns ``pages`` (the same tensor)."""
    _write_rows(pages, layer, 0, k, page_idx, offsets)
    _write_rows(pages, layer, 1, v, page_idx, offsets)
    return pages


class PageAllocator:
    """Host-side free list over pages ``1..num_pages-1`` (0 reserved),
    with per-page **reader refcounts** and **cache pins**.

    LIFO allocation (hot pages stay hot); loud errors on exhaustion
    misuse, double-free, and foreign/reserved frees — the leak/double-
    free invariants the scheduler property tests exercise.

    A live page's lifetime is governed by two independent holds:

    - its *reader refcount* — one per slot holding the page
      (:meth:`alloc` starts it at 1, :meth:`share` adds a reader,
      :meth:`free` drops one);
    - an optional *cache pin* (:meth:`pin`/:meth:`unpin`) — the prefix
      index's hold, so a cached page outlives the request that
      prefilled it.

    The page returns to the free list only when BOTH are gone. A page
    with refcount > 1 or a pin is **shared**: writers must
    copy-on-write :meth:`fork` it first (the device copy is the
    engine's half; the allocator swaps the bookkeeping).
    """

    def __init__(self, num_pages: int):
        self.num_pages = int(num_pages)
        self._free: List[int] = list(range(self.num_pages - 1, 0, -1))
        self._ref: Dict[int, int] = {}   # live page -> reader refcount
        self._pinned: Set[int] = set()   # prefix-cache pins

    @property
    def free_count(self) -> int:
        return len(self._free)

    @property
    def used_count(self) -> int:
        """Pages with at least one READER (a cached page nobody reads
        is not 'used' — after a drained trace this must be 0 even with
        a warm prefix cache)."""
        return sum(1 for r in self._ref.values() if r > 0)

    def live_pages(self) -> Dict[int, int]:
        """``{page: reader refcount}`` for every live page."""
        return dict(self._ref)

    def refcount(self, p: int) -> int:
        return self._ref.get(int(p), 0)

    def is_pinned(self, p: int) -> bool:
        return int(p) in self._pinned

    def is_shared(self, p: int) -> bool:
        """True when writing into the page would be visible beyond its
        one owner: more than one reader, or a cache pin (the index
        promises the page's frozen content to future readers)."""
        p = int(p)
        return self._ref.get(p, 0) > 1 or p in self._pinned

    def alloc(self) -> Optional[int]:
        """One page id at refcount 1, or None when exhausted."""
        if not self._free:
            return None
        p = self._free.pop()
        self._ref[p] = 1
        return p

    def share(self, p: int) -> None:
        """Add a reader to a live page (a prefix-cache hit)."""
        p = int(p)
        if p not in self._ref:
            raise ValueError(f"sharing a page that is not live: {p}")
        self._ref[p] += 1

    def free(self, pages: Sequence[int]) -> None:
        """Drop one reader per page; release to the free list at zero
        readers (unless cache-pinned)."""
        for p in pages:
            p = int(p)
            if p == PagedKVSpec.GARBAGE_PAGE:
                raise ValueError("freeing the reserved garbage page 0")
            if self._ref.get(p, 0) < 1:
                raise ValueError(
                    f"double-free (or foreign free) of page {p}")
            self._ref[p] -= 1
            self._maybe_release(p)

    def release_tail(self, pages: Sequence[int],
                     keep: int) -> List[int]:
        """Drop this holder's reader refcount on ``pages[keep:]`` and
        return the kept head — the un-write primitive under
        ``Scheduler.rollback_kv`` (speculative-decode rejection and
        cache-pressure rollback both release a slot's TAIL hold; a
        released page another reader or the prefix index still holds
        stays live, exactly like any other ``free``)."""
        keep = int(keep)
        if keep < 0:
            raise ValueError(f"release_tail keep={keep} < 0")
        drop = list(pages[keep:])
        if drop:
            self.free(drop)
        return list(pages[:keep])

    def fork(self, src: int,
             dst: Optional[int] = None) -> Optional[int]:
        """Copy-on-write bookkeeping: move the caller's reader hold
        from shared ``src`` onto a fresh page (``src`` stays live for
        its other readers / its cache pin). With ``dst=None`` the
        destination is allocated here (None when the pool is dry — the
        caller falls back to its pressure machinery); the scheduler's
        pressure path passes the page it already obtained, so BOTH
        paths share this one hold-swap primitive. The caller owns the
        device-side page copy."""
        if dst is None:
            dst = self.alloc()
            if dst is None:
                return None
        elif self._ref.get(dst, 0) != 1:
            raise ValueError(
                f"fork destination {dst} must be a freshly allocated "
                "page (exactly one hold)")
        self.free([src])
        return dst

    def pin(self, p: int) -> None:
        """The prefix index's hold on a live page (at most one)."""
        p = int(p)
        if p not in self._ref:
            raise ValueError(f"pinning a page that is not live: {p}")
        if p in self._pinned:
            raise ValueError(f"page {p} is already pinned")
        self._pinned.add(p)

    def unpin(self, p: int) -> None:
        p = int(p)
        if p not in self._pinned:
            raise ValueError(f"unpinning a page that is not pinned: {p}")
        self._pinned.discard(p)
        self._maybe_release(p)

    def _maybe_release(self, p: int) -> None:
        if self._ref.get(p, 0) == 0 and p not in self._pinned:
            del self._ref[p]
            self._free.append(p)

    def check(self) -> None:
        """Invariants: every non-reserved page is exactly once in
        free-or-live; refcounts never negative; a zero-reader live page
        must be pinned (else it leaked out of both lists)."""
        free = set(self._free)
        if len(free) != len(self._free):
            raise AssertionError("free list contains duplicates")
        live = set(self._ref)
        if free & live:
            raise AssertionError(
                f"pages both free and live: {sorted(free & live)}")
        allp = free | live
        expect = set(range(1, self.num_pages))
        if allp != expect:
            raise AssertionError(
                f"page accounting leak: missing {sorted(expect - allp)}, "
                f"unknown {sorted(allp - expect)}")
        for p, r in self._ref.items():
            if r < 0:
                raise AssertionError(f"page {p} refcount {r} < 0")
            if r == 0 and p not in self._pinned:
                raise AssertionError(
                    f"page {p} has zero readers and no pin but was not "
                    "released")
        if not self._pinned <= live:
            raise AssertionError(
                f"pinned pages not live: {sorted(self._pinned - live)}")


def write_chunk_kv(pages: torch.Tensor, layer: int, k: torch.Tensor,
                   v: torch.Tensor, page_idx: torch.Tensor,
                   offsets: torch.Tensor) -> torch.Tensor:
    """Write a CHUNK of tokens' K/V per slot into the pool, in place —
    the chunked-prefill sibling of :func:`write_token_kv`.

    ``k``/``v`` ``[B, C, n, d]``; ``page_idx``/``offsets`` ``[B, C]``
    (invalid chunk columns point at the garbage page, offset 0 — their
    duplicate writes land on memory nothing reads unmasked)."""
    B, C = page_idx.shape
    pi = page_idx.reshape(B * C)
    off = offsets.reshape(B * C)
    _write_rows(pages, layer, 0, k.reshape((B * C,) + k.shape[2:]), pi, off)
    _write_rows(pages, layer, 1, v.reshape((B * C,) + v.shape[2:]), pi, off)
    return pages


class _CacheEntry:
    """One indexed page: the pool page id plus the token count of the
    prefix whose K/V it completes (``n_tokens % page_size`` of them
    live in this page — a partial tail when not page-aligned)."""

    __slots__ = ("page", "n_tokens")

    def __init__(self, page: int, n_tokens: int):
        self.page = int(page)
        self.n_tokens = int(n_tokens)


class PrefixCache:
    """Host-side radix/hash prefix index over the paged KV pool.

    Pages are keyed by ``(prefix length, chained blake2b digest)``
    where each page's digest hashes the previous page's digest plus
    its own tokens — so the key commits to every token up to and
    INCLUDING the page's last one (a page's K/V content depends on the
    whole prefix through it), while a full walk hashes each token
    exactly once (the vLLM block-hash chain; a radix tree stores the
    same relation as explicit edges). Full pages key
    ``(i+1)*page_size`` tokens; the partial tail of a completed
    prefill keys the exact prompt length, so only an identical full
    prompt matches it.

    - :meth:`acquire` walks the chain greedily and **pins a reader
      refcount** on every matched page (the caller's slot now holds
      them read-only; its first write into one COW-forks).
    - :meth:`insert_chained` registers a freshly prefilled page under
      the index's own :meth:`PageAllocator.pin` — the page outlives its
      request. Idempotent per key (first publisher wins).
    - :meth:`evict_one` releases the least-recently-used entry whose
      page has **zero readers** — under pool pressure the scheduler
      evicts cache before preempting live work, and eviction can never
      free a page a live reader holds (reader-held entries are
      skipped, not unpinned).
    - :meth:`flush` drops every entry — the weight hot-swap barrier: a
      cache entry computed under old weights must not survive a swap
      (``ServingEngine.swap_params`` calls it).

    Deterministic: LRU order is insertion/touch order, no wall clock.
    """

    def __init__(self, spec: PagedKVSpec, allocator: PageAllocator):
        self.spec = spec
        self.allocator = allocator
        self._entries: "OrderedDict[Tuple[int, bytes], _CacheEntry]" = \
            OrderedDict()
        # lifetime counters (engines snapshot them per run)
        self.hits = 0
        self.misses = 0
        self.hit_tokens = 0
        self.insertions = 0
        self.evictions = 0
        #: bumped on every index mutation (insert/evict/flush) — the
        #: invalidation token for ``match_len`` memoization (admission
        #: walks every queued request per submit; a memo keyed on this
        #: makes repeat walks O(1) between mutations)
        self.generation = 0

    def __len__(self) -> int:
        return len(self._entries)

    @staticmethod
    def page_digest(prev: bytes, page_tokens: Sequence[int]) -> bytes:
        """One chain step: the digest naming the prefix that ends with
        ``page_tokens``, given the previous page's digest (``b""``
        seeds the chain)."""
        h = hashlib.blake2b(prev, digest_size=16)
        h.update(np.asarray(page_tokens, np.int32).tobytes())
        return h.digest()

    def _chain_keys(self, tokens: Sequence[int]):
        """Yield ``(end, key)`` per page boundary of ``tokens``, where
        the key's digest CHAINS: ``digest_i = blake2b(digest_{i-1} ||
        tokens[i*ps : end_i])`` — the vLLM block-hash scheme. Each
        token is hashed exactly once, so a full walk is O(len), not
        O(len^2 / page_size); the chain still commits to the whole
        prefix."""
        ps = self.spec.page_size
        arr = np.asarray(tokens, np.int32)
        prev = b""
        for start in range(0, len(arr), ps):
            end = min(start + ps, len(arr))
            prev = self.page_digest(prev, arr[start:end])
            yield end, (int(end), prev)

    def _walk(self, tokens: Sequence[int], touch: bool):
        """Greedy longest-prefix match down the page chain. Returns
        ``(pages, matched_tokens)`` without refcounting."""
        pages: List[int] = []
        matched = 0
        for end, key in self._chain_keys(tokens):
            e = self._entries.get(key)
            if e is None:
                break
            if touch:
                self._entries.move_to_end(key)
            pages.append(e.page)
            matched = end
        return pages, matched

    def match_len(self, tokens: Sequence[int]) -> int:
        """Read-only: how many head tokens of ``tokens`` the cache
        covers right now (no pins, no LRU touch) — the admission
        estimate of prefill work actually owed."""
        _, matched = self._walk(tokens, touch=False)
        return matched

    def acquire(self, tokens: Sequence[int]):
        """Longest-prefix hit with reader pins: returns ``(pages,
        matched_tokens)``; every returned page has had one reader
        refcount added (:meth:`PageAllocator.share`) — release them
        through the normal slot-page ``free`` path."""
        pages, matched = self._walk(tokens, touch=True)
        if matched:
            for p in pages:
                self.allocator.share(p)
            self.hits += 1
            self.hit_tokens += matched
        else:
            self.misses += 1
        return pages, matched

    def insert_chained(self, end: int, digest: bytes,
                       page: int) -> bool:
        """Register ``page`` as holding the K/V that completes the
        prefix ending at token ``end``, whose chained digest is
        ``digest`` (:meth:`page_digest` of this page given its
        predecessor's). No-op (False) when the key is already indexed —
        the first publisher wins, and re-publishing a page a slot itself
        acquired from the cache must not double-pin."""
        return self._insert_key((int(end), digest), page)

    def _insert_key(self, key: Tuple[int, bytes], page: int) -> bool:
        if key in self._entries:
            return False
        self.allocator.pin(page)
        self._entries[key] = _CacheEntry(page, key[0])
        self.insertions += 1
        self.generation += 1
        return True

    def evict_one(self) -> Optional[int]:
        """Release the LRU entry with zero readers; returns the freed
        page id, or None when every entry is reader-held (nothing can
        be evicted without yanking a page out from under a live slot —
        which this method therefore never does)."""
        for key, e in self._entries.items():
            if self.allocator.refcount(e.page) == 0:
                del self._entries[key]
                self.allocator.unpin(e.page)
                self.evictions += 1
                self.generation += 1
                return e.page
        return None

    def flush(self) -> int:
        """Drop EVERY entry (pages with readers stay live until their
        readers release; zero-reader pages free immediately). The
        weight hot-swap barrier. Returns the number of entries
        dropped."""
        n = len(self._entries)
        for e in self._entries.values():
            self.allocator.unpin(e.page)
        self._entries.clear()
        if n:
            self.generation += 1
        return n

    def stats(self) -> Dict[str, int]:
        return {"hits": self.hits, "misses": self.misses,
                "hit_tokens": self.hit_tokens,
                "insertions": self.insertions,
                "evictions": self.evictions,
                "entries": len(self._entries)}

    def check(self) -> None:
        """Index/allocator coherence: every entry's page is live and
        pinned; no page is indexed twice; every allocator pin belongs
        to exactly one entry."""
        seen: Set[int] = set()
        for (n_tok, _), e in self._entries.items():
            if e.page in seen:
                raise AssertionError(
                    f"page {e.page} indexed under two keys")
            seen.add(e.page)
            if not self.allocator.is_pinned(e.page):
                raise AssertionError(
                    f"cache entry ({n_tok} tokens) page {e.page} lost "
                    "its pin")
        pinned = {p for p in range(1, self.allocator.num_pages)
                  if self.allocator.is_pinned(p)}
        if pinned != seen:
            raise AssertionError(
                f"allocator pins {sorted(pinned)} != indexed pages "
                f"{sorted(seen)}")


def page_table_row(spec: PagedKVSpec, pages: Sequence[int]) -> np.ndarray:
    """A fixed-width int32 page-table row: the request's pages, then
    garbage-page fill."""
    if len(pages) > spec.pages_per_seq:
        raise ValueError(
            f"{len(pages)} pages exceed pages_per_seq={spec.pages_per_seq}")
    row = np.full((spec.pages_per_seq,), PagedKVSpec.GARBAGE_PAGE,
                  np.int32)
    if pages:
        row[:len(pages)] = np.asarray(list(pages), np.int32)
    return row
