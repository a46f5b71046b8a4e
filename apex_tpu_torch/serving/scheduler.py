"""Iteration-level (continuous-batching) scheduler for the decode engine
(counterpart of ``apex_tpu/serving/scheduler.py``).

Orca-style scheduling: admission and eviction happen **between** decode
steps, at token granularity, against a fixed-shape slot batch — the
device program never changes shape, the host just decides which
requests occupy which slots and which pool pages back them.

Host-side only. The scheduler owns:

- the waiting queue (FIFO admission into free slots);
- the page accounting (:class:`~.kv_cache.PageAllocator`): pages are
  allocated **lazily**, enough per slot to cover the tokens it will
  consume this step (one for decode, up to the prefill chunk for
  prompt ingestion), and freed on eviction;
- the **prefix cache** (:class:`~.kv_cache.PrefixCache`, optional): at
  admission the request's replay prompt is matched against the index
  and the hit pages are attached read-only — the prefill cursor starts
  PAST them (capped at ``prompt_len - 1``: the final prompt token is
  always recomputed, its logits produce the first generated token).
  Freshly prefilled pages are published back as they fill. A write
  into a shared page **COW-forks** it first (the engine applies the
  device-side page copy); under pool pressure, zero-reader cache
  entries are evicted BEFORE any live request is preempted;
- **preemption**: when the pool is exhausted, the youngest running
  request is evicted and requeued — its prompt is extended with the
  tokens it already generated, so on re-admission the (deterministic)
  prefill replay rebuilds exactly the cache state it lost. vLLM's
  recompute-mode preemption (and the replay's head usually re-hits the
  pages it just published, so the replay itself is largely free);
- the per-slot host mirrors (position, prompt, pages, emitted count)
  from which the fixed-shape page-table array is rebuilt each step.

The scheduler never touches device tensors — the engine applies its
decisions through one masked slot-state update plus the pending COW
page copies (``serving.engine``).

Host code copied from ``apex_tpu/serving/scheduler.py``: the same
admissions, preemptions, forks and page tables on the same trace.
"""
from __future__ import annotations

import dataclasses
import itertools
from collections import Counter, deque
from typing import Deque, Dict, List, Optional, Sequence, Set, Tuple

import numpy as np

from .kv_cache import (
    PageAllocator,
    PagedKVSpec,
    PrefixCache,
    page_table_row,
)
from .robustness import (
    RejectionCode,
    RejectionError,
    RejectionReason,
    RequestStatus,
    SchedulerError,  # noqa: F401  (re-export: historical home)
)
from .sampling import SamplingParams

_rid_counter = itertools.count()


@dataclasses.dataclass
class Request:
    """One generation request.

    ``arrival_step`` lets traces stagger admissions deterministically
    (the continuous-batching tests and the smoke run submit a whole
    trace up front). ``ttft_budget_ms``/``latency_budget_ms`` are
    wall-clock deadlines against the engine's clock (None = no
    deadline); ``priority`` orders shed-victim selection under
    degradation (higher = keep longer). ``status`` walks the
    :class:`~.robustness.RequestStatus` lifecycle and lands in exactly
    one terminal state.
    """

    prompt: List[int]
    max_new_tokens: int
    eos_id: Optional[int] = None
    arrival_step: int = 0
    priority: int = 0
    ttft_budget_ms: Optional[float] = None
    latency_budget_ms: Optional[float] = None
    # non-greedy decoding policy (None = greedy argmax — the
    # token-identity default); draws are keyed (sampling.seed, rid,
    # position), so replay/recovery/migration regenerate them exactly
    sampling: Optional[SamplingParams] = None
    rid: int = dataclasses.field(
        default_factory=lambda: next(_rid_counter))
    # engine-filled results / timestamps
    out_tokens: List[int] = dataclasses.field(default_factory=list)
    t_arrival: Optional[float] = None
    t_first_token: Optional[float] = None
    t_done: Optional[float] = None
    preemptions: int = 0
    # lifecycle (serving.robustness): terminal state + why + provenance
    status: RequestStatus = RequestStatus.PENDING
    end_reason: Optional[str] = None
    failure: Optional[dict] = None
    retries: int = 0
    restarts: int = 0
    # prefix-cache accounting: prompt tokens skipped at the LAST
    # admission thanks to a cache hit (TTFT attribution + summary)
    cached_tokens: int = 0
    # fleet routing: the replica that last admitted this request (None
    # outside fleet serving / before dispatch) — summary attribution
    # and the migration trail both key on it
    replica_id: Optional[int] = None
    # seniority, assigned at FIRST admission and stable across
    # preemptions — the total order that makes preemption terminate
    # (younger never preempts older, so the most senior request always
    # progresses)
    admit_seq: Optional[int] = None
    # tracing (telemetry.spans): the TraceContext stamped at submit and
    # carried across engines/migrations, plus the latency-attribution
    # ledgers — running end-to-end terms and the TTFT-instant snapshot
    # (both partition measured wall time over spans.ATTR_TERMS)
    trace: Optional[object] = None
    attr: Optional[dict] = None
    attr_ttft: Optional[dict] = None
    # generic label dict for the fleet health plane's aggregation layer
    # (telemetry.timeseries — the multi-tenant hook): carried onto this
    # request's request_end record, where it merges with (and wins
    # over) any stream-level TaggedRecorder labels
    labels: Optional[dict] = None

    @property
    def done(self) -> bool:
        if len(self.out_tokens) >= self.max_new_tokens:
            return True
        return (self.eos_id is not None and bool(self.out_tokens)
                and self.out_tokens[-1] == self.eos_id)


@dataclasses.dataclass
class RunningSlot:
    """Host mirror of one occupied device slot."""

    req: Request
    prompt: List[int]      # prompt to replay (original + regenerated)
    pos: int = 0           # tokens already consumed (= tokens in cache)
    pages: List[int] = dataclasses.field(default_factory=list)
    admit_seq: int = 0     # admission order (victim selection)
    cached_tokens: int = 0  # prompt head covered by a prefix-cache hit
    published: int = 0     # pages already offered to the prefix index
    # memoized chain digests (digests[j] names prompt[:page-j end]) so
    # publication hashes each token once per slot, not once per page
    digests: List[bytes] = dataclasses.field(default_factory=list)
    # attribution: this admission re-prefills work a disruption already
    # paid for (preemption/restart replay) — prefill intervals bucket
    # to "replay" instead of "prefill_compute"
    replay: bool = False
    # the boundary timestamp at which the engine admitted this slot
    # (span t_start for the prefill span; None outside tracing)
    t_admit: Optional[float] = None
    # attribution: the first post-admission interval of a cache-hit
    # admission buckets to "cached_skip" exactly once
    hit_attributed: bool = False

    @property
    def prefilling(self) -> bool:
        """True while the NEXT consumed token comes from the prompt."""
        return self.pos < len(self.prompt)

    def total_len(self) -> int:
        """Upper bound on this request's cache length."""
        remaining = self.req.max_new_tokens - len(self.req.out_tokens)
        return len(self.prompt) + remaining


class Scheduler:
    """Continuous batching over ``n_slots`` fixed slots.

    Per step the engine calls, in order: :meth:`admit` (fill free slots
    from the queue), :meth:`ensure_capacity` (allocate this step's
    pages, preempting if the pool is dry), :meth:`page_table_array`,
    then — after the device step — :meth:`advance` and, for finished
    requests, :meth:`evict`.

    ``chaos`` (optional, duck-typed — ``resilience.ServingChaos``) lets
    the fault harness steal page allocations: a stolen ``alloc`` looks
    exactly like a dry pool, driving the preemption machinery under
    test without actually shrinking it.

    ``prefix_cache=True`` builds a :class:`~.kv_cache.PrefixCache`
    over the allocator (``self.cache``); ``prefill_chunk`` is how many
    prompt tokens a prefilling slot consumes per step (the engine's
    chunked-prefill knob — the scheduler sizes page allocation and the
    cursor advance to it).
    """

    def __init__(self, spec: PagedKVSpec, n_slots: int,
                 max_prompt_len: int, chaos=None, *,
                 prefix_cache: bool = False, prefill_chunk: int = 1,
                 spec_k: int = 0):
        self.spec = spec
        self.n_slots = int(n_slots)
        self.max_prompt_len = int(max_prompt_len)
        self.prefill_chunk = max(1, int(prefill_chunk))
        self.spec_k = max(0, int(spec_k))
        self.allocator = PageAllocator(spec.num_pages)
        self.cache: Optional[PrefixCache] = (
            PrefixCache(spec, self.allocator) if prefix_cache else None)
        self.slots: List[Optional[RunningSlot]] = [None] * self.n_slots
        self.waiting: Deque[Request] = deque()
        self._admit_seq = itertools.count()
        self.chaos = chaos
        # pending COW page copies (src, dst) + slots whose cursor moved
        # outside the admit/advance lockstep — both drained by the
        # engine each boundary (take_forks / take_dirty_slots)
        self._forks: List[Tuple[int, int]] = []
        self._dirty: Set[int] = set()
        # cache-hit tokens a pressure rollback un-saved (recomputed
        # after being counted as skipped) — the engine subtracts them
        # from its cached_prompt_tokens accounting
        self._rollback_tokens = 0

    # -- queue -------------------------------------------------------------
    def submit(self, req: Request) -> None:
        reason = self.validate(req)
        if reason is not None:
            raise RejectionError(reason)
        req.status = RequestStatus.QUEUED
        self.waiting.append(req)

    def remove_waiting(self, req: Request) -> bool:
        """Pull a queued request back out (timeout, shed, cancel). The
        caller finalizes its status; pages were never allocated for a
        waiting request, so there is nothing else to release."""
        try:
            self.waiting.remove(req)
            return True
        except ValueError:
            return False

    def validate(self, req: Request,
                 prompt_len: Optional[int] = None
                 ) -> Optional[RejectionReason]:
        """The submit-time refusals, returning a typed
        :class:`~.robustness.RejectionReason` (``None`` = admissible)
        so admission control and the legacy refusals share one
        taxonomy. :meth:`submit` raises :class:`RejectionError` —
        still a :class:`SchedulerError` — on any of them."""
        if prompt_len is None:
            prompt_len = len(req.prompt)
        if prompt_len < 1:
            return RejectionReason(
                RejectionCode.EMPTY_PROMPT,
                f"request {req.rid}: empty prompt")
        if prompt_len > self.max_prompt_len:
            return RejectionReason(
                RejectionCode.PROMPT_TOO_LONG,
                f"request {req.rid}: prompt {prompt_len} exceeds "
                f"max_prompt_len {self.max_prompt_len}",
                {"prompt_len": prompt_len,
                 "max_prompt_len": self.max_prompt_len})
        # recompute-mode preemption replays prompt + generated-so-far as
        # the new prompt, which can grow to total - 1 tokens; a request
        # whose replay could not be re-admitted must be refused HERE —
        # admit() pops before validating, so a late failure would drop
        # the request from the queue with no way to recover it
        worst_replay = prompt_len + req.max_new_tokens \
            - len(req.out_tokens) - 1
        if worst_replay > self.max_prompt_len:
            return RejectionReason(
                RejectionCode.REPLAY_OVERFLOW,
                f"request {req.rid}: preemption replay prompt can grow "
                f"to {worst_replay} (prompt + max_new_tokens - 1), "
                f"exceeding max_prompt_len {self.max_prompt_len}",
                {"worst_replay": worst_replay,
                 "max_prompt_len": self.max_prompt_len})
        total = prompt_len + req.max_new_tokens - len(req.out_tokens)
        if total > self.spec.max_seq_len:
            return RejectionReason(
                RejectionCode.EXCEEDS_MAX_SEQ,
                f"request {req.rid}: prompt+max_new = {total} exceeds "
                f"pages_per_seq*page_size = {self.spec.max_seq_len}",
                {"total": total, "max_seq_len": self.spec.max_seq_len})
        # a request the POOL can never hold must be refused at submit —
        # admitted, it would preempt every other runner one page at a
        # time and then sink the whole batch from ensure_capacity
        if self.spec.pages_for(total) > self.spec.n_usable_pages:
            return RejectionReason(
                RejectionCode.POOL_INFEASIBLE,
                f"request {req.rid}: needs {self.spec.pages_for(total)} "
                f"pages but the pool has {self.spec.n_usable_pages} "
                "usable — it can never be served (grow num_pages or "
                "shrink the request)",
                {"pages_needed": self.spec.pages_for(total),
                 "n_usable_pages": self.spec.n_usable_pages})
        return None

    @property
    def n_active(self) -> int:
        return sum(s is not None for s in self.slots)

    @property
    def idle(self) -> bool:
        return not self.waiting and self.n_active == 0

    def running(self) -> List[Tuple[int, RunningSlot]]:
        return [(i, s) for i, s in enumerate(self.slots) if s is not None]

    # -- admission ---------------------------------------------------------
    def admit(self) -> List[Tuple[int, RunningSlot]]:
        """Move queued requests into free slots (FIFO). Pages are not
        reserved here — :meth:`ensure_capacity` allocates lazily, and
        preemption handles a dry pool.

        With a prefix cache, the replay prompt's longest cached head is
        attached read-only (reader refcounts pinned) and the prefill
        cursor starts past it — capped at ``len(prompt) - 1`` so the
        final prompt token is always recomputed: its forward pass
        produces the first generated token's logits, which no cached
        page can supply."""
        admitted = []
        for i in range(self.n_slots):
            if self.slots[i] is not None or not self.waiting:
                continue
            req = self.waiting.popleft()
            if req.admit_seq is None:
                req.admit_seq = next(self._admit_seq)
            run = RunningSlot(req=req, prompt=list(req.prompt)
                              + list(req.out_tokens),
                              admit_seq=req.admit_seq,
                              replay=(req.preemptions + req.restarts) > 0)
            reason = self.validate(req, len(run.prompt))
            if reason is not None:
                # unreachable for submit()-validated requests (replay
                # growth is bounded at submit); defensive only
                raise RejectionError(reason)
            if self.cache is not None:
                pages, matched = self.cache.acquire(run.prompt)
                if matched:
                    run.pages = list(pages)
                    run.pos = min(matched, len(run.prompt) - 1)
                    run.cached_tokens = run.pos
                    run.published = len(pages)
                # reset on EVERY admission: the field means "skipped at
                # the LAST admission", and a cache-miss readmission
                # (e.g. after a hot-swap flush) must not report the
                # previous admission's savings
                req.cached_tokens = run.cached_tokens
            req.status = RequestStatus.RUNNING
            self.slots[i] = run
            admitted.append((i, run))
        return admitted

    # -- paging ------------------------------------------------------------
    def next_take(self, run: RunningSlot) -> int:
        """Tokens this slot consumes next step: up to ``prefill_chunk``
        prompt tokens while prefilling, exactly one while decoding.
        The engine's device step computes the same quantity —
        host mirrors and device state advance in lockstep. (Under
        speculative decoding a decode slot may consume MORE — see
        :meth:`next_take_upper`; its actual advance is read back from
        the step's emitted row, since acceptance is decided on device.)
        """
        if run.prefilling:
            return min(self.prefill_chunk, len(run.prompt) - run.pos)
        return 1

    def draft_cap(self, run: RunningSlot) -> int:
        """How many tokens this decode slot may DRAFT next step: at
        most ``spec_k``, and never past the last position the request
        can consume (``max_new - emitted - 1`` more emits will be fed
        back — the final emitted token never is), so the device never
        writes K/V beyond what :meth:`ensure_capacity` paged. 0 while
        prefilling (prompt ingestion needs no speculation) and when
        speculative decoding is off."""
        if self.spec_k <= 0 or run.prefilling:
            return 0
        remaining = run.req.max_new_tokens - len(run.req.out_tokens)
        return max(0, min(self.spec_k, remaining - 1))

    def next_take_upper(self, run: RunningSlot) -> int:
        """Worst-case tokens this slot may WRITE next step — the bound
        :meth:`ensure_capacity` pages and COW-fork-scans against: the
        prefill chunk while prefilling, the carried token plus every
        drafted position while decoding. Speculative writes past the
        accepted prefix are rolled back as bookkeeping
        (:meth:`rollback_kv`) after the step."""
        if run.prefilling:
            return self.next_take(run)
        return 1 + self.draft_cap(run)

    def _fork_index(self, run: RunningSlot, end: int) -> Optional[int]:
        """The first page index this step's writes touch that is
        SHARED (read-only: other readers and/or a cache pin) — it must
        be COW-forked before the device step scatters into it."""
        if self.cache is None:
            return None
        ps = self.spec.page_size
        first = run.pos // ps
        last = min((end - 1) // ps, len(run.pages) - 1)
        for j in range(first, last + 1):
            if self.allocator.is_shared(run.pages[j]):
                return j
        return None

    def rollback_kv(self, i: int, run: RunningSlot, new_pos: int, *,
                    keep_pages: Optional[int] = None) -> None:
        """Un-write a slot's last-n KV positions: ONE bookkeeping path
        for every consumer that wrote ahead of where the cursor ends up
        — speculative-decode rejection (drafted positions past the
        accepted prefix; ``new_pos`` = the already-advanced cursor,
        only the worst-case tail pages are returned) and the
        cache-pressure rollback (``_rollback_cached``: cursor rewinds
        to a page boundary and the shared head recomputes).

        Frees the slot's hold on pages ``keep_pages:`` (default: just
        enough to cover ``new_pos`` consumed tokens), cancels any
        pending COW fork whose destination dies with them, rewinds the
        cursor (marking the slot dirty so the engine re-pushes its
        device row), and trims the publication watermark + digest memo
        to the kept pages. Un-written positions inside a KEPT page are
        plain bookkeeping: every future read is masked to ``kv_len =
        pos + 1`` entries, so a stale entry is overwritten by the
        cursor before anything can attend to it — and a kept page is
        never shared (writes into shared pages COW-forked before the
        step; ``check_invariants`` cross-checks the refcounts).
        """
        if keep_pages is None:
            keep_pages = self.spec.pages_for(new_pos)
        keep_pages = min(int(keep_pages), len(run.pages))
        drop = run.pages[keep_pages:]
        if drop:
            # a pending COW copy whose destination is being released
            # must not fire (the freed dst may be re-allocated to
            # another slot this same boundary) — the _free_slot rule
            if self._forks:
                gone = set(drop)
                self._forks = [(s, d) for s, d in self._forks
                               if d not in gone]
            run.pages = self.allocator.release_tail(run.pages,
                                                    keep_pages)
        if new_pos != run.pos:
            run.pos = int(new_pos)
            self._dirty.add(i)
        run.published = min(run.published, keep_pages)
        del run.digests[keep_pages:]

    def _rollback_cached(self, i: int, run: RunningSlot,
                         from_j: int) -> None:
        """Pressure fallback when no page can be found for a COW fork:
        release this slot's hold on pages ``from_j:`` and rewind the
        prefill cursor to recompute them (:meth:`rollback_kv`). The
        released pages become zero-reader cache entries — exactly what
        :meth:`evict_one` can now free — so the retry always makes
        progress, and the deterministic replay keeps token identity."""
        new_pos = min(run.pos, from_j * self.spec.page_size)
        self.rollback_kv(i, run, new_pos, keep_pages=from_j)
        # tokens counted as cache-skipped that will now be recomputed:
        # give them back (prefill_tokens_saved must not overstate the
        # cache win when pressure rollback fires)
        unsaved = max(0, run.cached_tokens - new_pos)
        if unsaved:
            run.cached_tokens -= unsaved
            run.req.cached_tokens = run.cached_tokens
            self._rollback_tokens += unsaved

    def ensure_capacity(self) -> List[Request]:
        """Give each active slot the pages this step's token writes
        need — allocating fresh pages, COW-forking shared ones — and
        preempt when the pool runs dry. Returns the preempted,
        requeued requests.

        Pressure order: (1) allocate; (2) evict zero-reader prefix-
        cache entries (cached-but-unread capacity goes first — eviction
        never touches a page a live reader holds); (3) preempt. A COW
        fork that still cannot find a page falls back to releasing the
        shared pages and recomputing them (:meth:`_rollback_cached`)
        rather than deadlocking or displacing seniors.

        Termination contract: seniority (``Request.admit_seq``) is
        stable across preemptions, service is oldest-first, and a
        requester may only preempt strictly YOUNGER victims — when none
        exists it yields its own slot instead. The most senior request
        is therefore never displaced, advances every step, and finishes
        — no preemption ping-pong, however small the pool (requests the
        pool can never hold were already refused at submit)."""
        preempted: List[Request] = []
        for i, run in sorted(self.running(),
                             key=lambda ir: ir[1].admit_seq):
            if self.slots[i] is not run:
                continue  # preempted / yielded earlier in this loop
            while self.slots[i] is run:
                end = run.pos + self.next_take_upper(run)
                fork_j = self._fork_index(run, end)
                if (fork_j is None
                        and len(run.pages) >= self.spec.pages_for(end)):
                    break  # capacity + write-exclusivity satisfied
                page = self._grab_page(i, run, preempted, fork_j=fork_j)
                if page is None:
                    # run yielded its slot (preempted) or rolled its
                    # cached head back; the while-condition / fresh
                    # fork scan picks the new state up
                    continue
                if fork_j is not None:
                    src = run.pages[fork_j]
                    self._forks.append((src, page))
                    # the allocator's COW hold-swap, with the page the
                    # pressure machinery already obtained
                    run.pages[fork_j] = self.allocator.fork(src, page)
                else:
                    run.pages.append(page)
        return preempted

    def _grab_page(self, i: int, run: RunningSlot,
                   preempted: List[Request], *,
                   fork_j: Optional[int] = None) -> Optional[int]:
        """One page under pressure: alloc -> cache eviction ->
        (rollback | preemption). Returns None when the caller's state
        changed instead (it yielded its own slot, or rolled back its
        cached head) — the caller re-evaluates."""
        while True:
            stolen = (self.chaos is not None
                      and self.chaos.steal_alloc())
            page = None if stolen else self.allocator.alloc()
            if page is None and not stolen and self.cache is not None:
                # pool dry: cached-but-unread pages go before any live
                # request is preempted (evict_one never frees a page a
                # reader holds)
                while page is None:
                    if self.cache.evict_one() is None:
                        break
                    page = self.allocator.alloc()
            if page is not None:
                return page
            if fork_j is not None and not stolen and run.prefilling:
                # a fork target the pool cannot provide, for a slot
                # still inside its prompt: recompute the shared head
                # instead of displacing anyone (the rolled-back pages
                # become evictable, so retries progress). Safe ONLY
                # while prefilling — a slot that crossed its prompt has
                # emitted tokens, and rewinding it across the boundary
                # would re-emit them; decoding slots take the
                # recompute-preemption requeue below instead, which
                # folds generated tokens into the replay prompt.
                self._rollback_cached(i, run, fork_j)
                return None
            victim = self._pick_victim(exclude=i)
            if victim is None:
                if stolen or fork_j is not None:
                    # a chaos-injected transient allocation fault — or
                    # a decode-time COW fork the pool cannot serve —
                    # with no one to preempt: requeue ourselves and
                    # retry at the next boundary (the fault budget is
                    # finite; the replay prompt grows by at least one
                    # emitted token per fork-preemption cycle, so this
                    # terminates)
                    preempted.append(self._preempt(i))
                    return None
                # unreachable for validated requests (validate()
                # refuses pages_for(total) > n_usable_pages and the
                # cache-eviction pass above frees every unread cached
                # page), so a lone runner always fits; defensive for
                # invariant breakage only
                raise SchedulerError(
                    "KV pool too small: one request needs "
                    f"{self.spec.pages_for(run.total_len())} pages "
                    f"but the pool has {self.spec.n_usable_pages}")
            vrun = self.slots[victim]
            if vrun.admit_seq > run.admit_seq:
                preempted.append(self._preempt(victim))
                # loop: retry alloc (the victim's exclusive pages are
                # free now; its cached ones became evictable)
            else:
                # every other runner outranks us: yield our slot
                # rather than displace a senior request
                preempted.append(self._preempt(i))
                return None

    def take_forks(self) -> List[Tuple[int, int]]:
        """Drain the pending COW ``(src, dst)`` page copies — the
        engine applies them on device BEFORE the step's K/V writes."""
        out, self._forks = self._forks, []
        return out

    def take_dirty_slots(self) -> Set[int]:
        """Slots whose cursor moved outside the admit/advance lockstep
        (cache-rollback) — the engine must re-push their device rows."""
        out, self._dirty = self._dirty, set()
        return out

    def take_rollback_tokens(self) -> int:
        """Cache-skipped tokens un-saved by pressure rollbacks since
        the last call (engine accounting correction)."""
        out, self._rollback_tokens = self._rollback_tokens, 0
        return out

    def _pick_victim(self, exclude: int) -> Optional[int]:
        """The youngest-admitted running request (most recent work is
        the cheapest to redo), never the requester."""
        cands = [(s.admit_seq, i) for i, s in self.running()
                 if i != exclude]
        return max(cands)[1] if cands else None

    def _preempt(self, slot_idx: int) -> Request:
        run = self.slots[slot_idx]
        assert run is not None
        req = run.req
        req.preemptions += 1
        req.status = RequestStatus.QUEUED
        self._free_slot(slot_idx)
        # recompute-mode requeue: replay prompt + already-generated
        # tokens on readmission (deterministic prefill rebuilds the
        # exact cache). Requeue at the FRONT: the victim keeps its
        # priority over later arrivals.
        self.waiting.appendleft(req)
        return req

    def _free_slot(self, slot_idx: int) -> None:
        run = self.slots[slot_idx]
        if run is None:
            raise SchedulerError(f"freeing empty slot {slot_idx}")
        if run.pages:
            # a pending COW copy whose destination dies with this slot
            # must not fire: the freed dst page may be re-allocated to
            # another slot this same boundary
            if self._forks:
                gone = set(run.pages)
                self._forks = [(s, d) for s, d in self._forks
                               if d not in gone]
            self.allocator.free(run.pages)
            run.pages = []  # a stale RunningSlot must not look backed
        self._dirty.discard(slot_idx)
        self.slots[slot_idx] = None

    def evict(self, slot_idx: int) -> None:
        """Release a finished request's slot and pages."""
        self._free_slot(slot_idx)

    # -- device-facing views -----------------------------------------------
    def page_table_array(self) -> np.ndarray:
        """``[n_slots, pages_per_seq]`` int32; empty slots are all
        garbage-page rows."""
        rows = [
            page_table_row(self.spec, s.pages if s is not None else [])
            for s in self.slots
        ]
        return np.stack(rows)

    def advance(self, slot_indices: Sequence[int],
                consumed: Optional[Dict[int, int]] = None) -> None:
        """Consume this step's tokens on each given slot — one while
        decoding, up to ``prefill_chunk`` while prefilling (the same
        :meth:`next_take` the device step computes) — and
        publish freshly completed prompt pages to the prefix index.

        ``consumed`` overrides the advance per slot index: under
        speculative decoding a decode slot's cursor moves by its
        ACCEPTED token count, which the host learns from the step's
        emitted row rather than computing a priori."""
        for i in slot_indices:
            run = self.slots[i]
            if run is None:
                raise SchedulerError(f"advance on empty slot {i}")
            was_prefilling = run.prefilling
            take = (consumed or {}).get(i)
            run.pos += self.next_take(run) if take is None else int(take)
            if self.cache is not None and was_prefilling:
                self._publish(run)

    def _publish(self, run: RunningSlot) -> None:
        """Offer newly completed prompt pages to the prefix index:
        every full page wholly covered by consumed PROMPT tokens, plus
        — at prefill completion — the partial tail page, keyed by the
        exact prompt. Idempotent against pages this slot itself
        acquired from the cache (insertion skips existing keys). The
        chain digest is memoized per slot (``RunningSlot.digests``),
        so publishing a whole prompt hashes each token once."""
        ps = self.spec.page_size
        plen = len(run.prompt)
        covered = min(run.pos, plen)
        while ((run.published + 1) * ps <= covered
               and run.published < len(run.pages)):
            j = run.published
            end = (j + 1) * ps
            self.cache.insert_chained(
                end, self._digest_through(run, j, end), run.pages[j])
            run.published = j + 1
        if run.pos >= plen and plen % ps:
            j = plen // ps
            if run.published == j and j < len(run.pages):
                self.cache.insert_chained(
                    plen, self._digest_through(run, j, plen),
                    run.pages[j])
                run.published = j + 1

    def _digest_through(self, run: RunningSlot, j: int,
                        end: int) -> bytes:
        """The chained digest naming ``run.prompt[:end]`` (page ``j``'s
        key digest), filling the slot's memo up to ``j`` — O(page) per
        new page, O(prefix) at most once per admission (when the head
        was acquired from the cache and the memo starts empty)."""
        ps = self.spec.page_size
        while len(run.digests) <= j:
            k = len(run.digests)
            k_end = end if k == j else (k + 1) * ps
            prev = run.digests[k - 1] if k else b""
            run.digests.append(self.cache.page_digest(
                prev, run.prompt[k * ps:k_end]))
        return run.digests[j]

    def check_invariants(self) -> None:
        """Page accounting must balance exactly — now including the
        prefix-cache refcount cross-checks — and the lifecycle states
        must match occupancy (tests + chaos harness):

        - every live slot's pages carry refcount >= 1, and each page's
          reader refcount equals exactly the number of slots holding
          it (readers; the index pin is accounted separately);
        - a zero-reader live page must be cache-pinned, and every
          indexed page is live and pinned exactly once
          (``PrefixCache.check``);
        - free pages + live (refcounted) pages + the garbage page
          cover the pool exactly (``PageAllocator.check``).
        """
        self.allocator.check()
        holders = Counter(p for _, s in self.running() for p in s.pages)
        for _, s in self.running():
            if len(s.pages) != len(set(s.pages)):
                raise AssertionError(
                    f"slot holds a page twice: {s.pages}")
        live = self.allocator.live_pages()
        for p, cnt in holders.items():
            if live.get(p, 0) != cnt:
                raise AssertionError(
                    f"page {p}: refcount {live.get(p, 0)} != "
                    f"{cnt} slot holder(s)")
        for p, rc in live.items():
            if rc != holders.get(p, 0):
                raise AssertionError(
                    f"page {p} has {rc} readers but "
                    f"{holders.get(p, 0)} slot holder(s)")
        if (self.allocator.free_count + len(live) + 1
                != self.spec.num_pages):
            raise AssertionError(
                f"pool accounting: free {self.allocator.free_count} + "
                f"live {len(live)} + garbage 1 != {self.spec.num_pages}")
        if self.cache is not None:
            self.cache.check()
        # lifecycle / occupancy coherence: a terminal request must hold
        # no capacity; queue and slots must carry the matching states
        for req in self.waiting:
            if req.status is not RequestStatus.QUEUED:
                raise AssertionError(
                    f"waiting request {req.rid} has status "
                    f"{req.status.name}, expected QUEUED")
        for i, run in self.running():
            if run.req.status is not RequestStatus.RUNNING:
                raise AssertionError(
                    f"slot {i} request {run.req.rid} has status "
                    f"{run.req.status.name}, expected RUNNING")
