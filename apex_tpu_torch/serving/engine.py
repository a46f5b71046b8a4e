"""ServingEngine: the continuous-batching decode loop over a paged KV
pool, on one device (counterpart of ``apex_tpu/serving/engine.py``).

Each boundary the host scheduler (``serving.scheduler``) enforces
deadlines, applies admission pressure (degradation, shedding), admits
queued requests into free slots and pages them (allocating, copy-on-write
forking shared prefix-cache pages, preempting under pressure); then the
engine runs ONE eager device step over the fixed ``[n_slots]`` slot
batch:

- the 1-token step (``decode_model.decode_tokens``) when no slot is
  prefilling or ``prefill_chunk == 1``;
- the chunked step (``decode_model.prefill_chunk_tokens``) when some
  slot is prefilling: up to ``prefill_chunk`` prompt tokens per
  prefilling slot, decode slots riding along with their one token;
- with ``spec_k > 0``, the speculative draft→verify→accept step
  (``spec_decode.run_spec_step``) at every boundary: one chunk-shaped
  pass of width ``max(prefill_chunk, spec_k + 1)``.

Sync discipline: the per-slot state (:class:`SlotState`) and the KV
pool stay on the device, the sampled token feeds the next step on the
device, and the pool is written in place (``index_put_`` where the JAX
engine donated its buffers). Host arrays reach the device through
pinned, non-blocking copies. The one host read per step is the fetch of
that step's emitted tokens — the scheduler needs them for EOS and
finish decisions, and they are the output; a ``HangWatchdog``
(``watchdog=``) can arm it, so a wedged step surfaces as a ``HangError``
with all-thread stacks instead of a silent stall. The greedy/sampling
branch is decided from host mirrors, so greedy traffic adds no read, and
a step in which some slot samples adds none either: the filters' deep
sort is selected per row on the device (``sampling._filtered_logits``).
The in-step metrics (``telemetry_every``) drain without a sync
(``telemetry.drain``: a pinned copy and a CUDA event).

Robustness (``serving.robustness``): every request ends in exactly one
typed terminal state; TTFT / total-latency deadlines are enforced at
each boundary; admission control bounds the queue with watermark
backpressure and token-budget feasibility, and a ``DegradationPolicy``
caps and sheds under sustained pressure; a slot whose logits go
non-finite is quarantined alone (the ``POISONED`` sentinel rides the
fetched token array) and finalized ``FAILED``; a dead engine's in-flight
requests are recovered onto a fresh one through the recompute-preemption
replay path (:meth:`ServingEngine.recover_from`). ``chaos=`` takes a
``resilience.ServingChaos`` to inject those faults; ``trace=`` emits
request spans and the latency-attribution ledger (``telemetry.spans``)
through ``sink`` with no extra clock read.

Tensor parallelism (``tp > 1``): the JAX engine is one controller over
a ``(tensor,)`` submesh under ``shard_map``; here each of ``tp`` ranks
(processes of a ``torch.distributed`` world, ``parallel_state.
tp_submesh``'s ranks) builds the same engine and makes the same calls
(``generate``, ``submit``, ``cancel``, ...) with the same requests. A
rank holds ``heads / tp`` heads of every page of the pool
(``PagedKVSpec.shard``, the page size from the local head count), its
column-parallel QKV / fc1 and row-parallel proj / fc2 slices
(:func:`tp_rank_params`; everything else, the word embedding included,
replicated), runs the device step on them with one ``all_reduce`` a
sublayer tail and the vocab-parallel sampler (``sampling.
sample_tokens_tp``), so every rank computes the same emitted tokens.
Every rank also runs the host half (scheduler, admission, deadlines,
prefix cache): its inputs are the requests, the emitted tokens and the
clock, and the clock is the group's first rank's — each clock reading
is broadcast from it (``tp.TPComm.broadcast_host``), so a rank whose
clock runs apart still takes the first rank's admission, deadline and
degradation decisions and issues the same collectives. The chaos
injector acts by step number, alike on every rank. The watchdog arms
each rank's own fetch, and its verdict is the group's: after the fetch
every rank reduces its "tripped" flag with MAX (``tp.TPComm.any_host``),
so a hang on one rank raises ``HangError`` on every rank at the same
step and none is left waiting in the next step's collectives.
``program_comm_volume`` / ``program_psum_counts`` report each program's
collectives: the sites the serving modules declare (``TP_SITES``), with
the bytes of the live steps' record (``tp.TPComm.recording``).

Not here: the fleet and CUDA-graph capture of the steps.

Weights are cast once at construction
(``amp.cast_params_for_inference``): bf16 serving reuses the training
stack's mixed-precision rules with no master copies.
"""
from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import telemetry
from .._device import resolve_device
from ..amp import cast_params_for_inference
from ..multi_tensor_apply.packing import is_row_aligned, layout_findings
from ..ops.flash_decode import flash_decode_available
from ..resilience.watchdog import HangError
from . import decode_model, sampling
from .decode_model import decode_tokens, prefill_chunk_tokens
from .kv_cache import PagedKVSpec
from .robustness import (
    AdmissionConfig,
    AdmissionController,
    DegradationPolicy,
    RejectionCode,
    RejectionError,
    RejectionReason,
    RequestStatus,
    TransientRequestFailure,
    already_in_flight,
    is_terminal,
    recover_requests,
    request_expired,
)
from .sampling import (
    TOP_FILTER_WIDTH,
    i32_wrap,
    resolve,
    sample_tokens,
    sample_tokens_tp,
)
from .scheduler import Request, Scheduler, SchedulerError
from .spec_decode import NO_TOKEN, POISONED, run_spec_step
from .tp import TPComm

__all__ = ["NO_TOKEN", "POISONED", "ServingEngine", "SlotState",
           "default_page_size", "tp_rank_params"]


@dataclasses.dataclass
class SlotState:
    """Per-slot device state carried step to step. The sampling rows
    make non-greedy decode a pure function of the carried state: every
    draw is keyed ``(seed, rid, position)``. ``hist`` is the consumed-
    token history (prompt + generated, one scratch column at the end):
    the speculative decoder's n-gram table, maintained by the step."""

    tokens: torch.Tensor       # [B] i32 — token each slot consumes next
    positions: torch.Tensor    # [B] i32 — its position
    active: torch.Tensor       # [B] bool
    prompt_buf: torch.Tensor   # [B, W] i32 — prompt (replay) text
    prompt_lens: torch.Tensor  # [B] i32
    temps: torch.Tensor        # [B] f32 — 0 = greedy argmax
    top_ks: torch.Tensor       # [B] i32 — 0 = disabled
    top_ps: torch.Tensor       # [B] f32 — 1.0 = disabled
    seeds: torch.Tensor        # [B] i32
    rids: torch.Tensor         # [B] i32
    hist: torch.Tensor         # [B, W + 1] i32 — consumed tokens

    @classmethod
    def zeros(cls, n_slots: int, buf_len: int, device) -> "SlotState":
        def z(*shape, dtype=torch.int32):
            return torch.zeros(shape, dtype=dtype, device=device)

        return cls(
            tokens=z(n_slots), positions=z(n_slots),
            active=z(n_slots, dtype=torch.bool),
            prompt_buf=z(n_slots, buf_len), prompt_lens=z(n_slots),
            temps=z(n_slots, dtype=torch.float32), top_ks=z(n_slots),
            top_ps=torch.ones(n_slots, dtype=torch.float32, device=device),
            seeds=z(n_slots), rids=z(n_slots),
            hist=z(n_slots, buf_len + 1))


def default_page_size(num_heads: int, head_dim: int) -> int:
    """Smallest power-of-two page (>= 8 tokens) whose K/V page is
    ROW-aligned (``kv_cache.PagedKVSpec`` requirement)."""
    for ps in (8, 16, 32, 64, 128, 256):
        if is_row_aligned(num_heads * ps * head_dim):
            return ps
    raise ValueError(
        f"no power-of-two page size <= 256 aligns {num_heads} heads x "
        f"{head_dim} dim pages to whole packed rows")


#: the serving sharding map (the JAX engine's ``_tp_param_pspecs``): the
#: column-parallel leaves split along their output dim (whole heads for
#: QKV), the row-parallel ones along their input dim
_TP_SPLIT = {"qkv_w": 1, "qkv_b": 1, "fc1_w": 1, "fc1_b": 1,
             "proj_w": 2, "fc2_w": 2}


def tp_rank_params(params, tp: int, rank: int):
    """A GPT parameter tree cut for rank ``rank`` of a tensor-parallel
    serving engine of ``tp`` ranks: ``layers``' ``qkv_w`` / ``qkv_b`` /
    ``fc1_w`` / ``fc1_b`` split along their output dim (QKV's per-head
    ``[n, 3d]`` layout, so whole heads), ``proj_w`` / ``fc2_w`` along
    their input dim, everything else (norms, row-parallel biases, both
    embeddings) replicated. This is not the training map of
    ``shard_gpt_params``, whose word embedding is vocab-parallel. A tree
    already cut for ``tp`` is returned as it is."""
    if tp == 1:
        return params
    layers = params["layers"]
    hidden = params["embedding"]["word"].shape[1]
    qkv_rows = layers["qkv_w"].shape[1]
    if qkv_rows == 3 * hidden // tp:
        return params  # already this engine's cut
    if qkv_rows != 3 * hidden:
        raise ValueError(f"qkv_w has {qkv_rows} rows: neither the full "
                         f"3 x {hidden} nor a cut for tp={tp}")
    cut = dict(layers)
    for name, dim in _TP_SPLIT.items():
        w = layers[name]
        size = w.shape[dim] // tp
        cut[name] = w.narrow(dim, rank * size, size).contiguous()
    return {**params, "layers": cut}


#: the process groups of tensor-parallel engines, by their ranks
_TP_GROUPS: Dict[Tuple[int, ...], Any] = {}


def _tp_comm(tp: int, devices) -> TPComm:
    """The tensor group of a ``tp``-rank engine on this process. Its
    ranks: ``devices`` (global ranks) when given; else this rank's
    ``parallel_state`` tensor group when model parallelism is
    initialised with a tensor axis of ``tp``; else
    ``parallel_state.tp_submesh``'s (ranks ``0 .. tp - 1``). The group:
    the default one when the ranks are the whole world, the
    ``parallel_state`` tensor group when they are it, else a new group
    over them (created once, by its members alone)."""
    import torch.distributed as dist

    from ..transformer import parallel_state as ps

    if (devices is None and ps.model_parallel_is_initialized()
            and ps.get_tensor_model_parallel_world_size() == tp):
        ranks = tuple(ps.get_group_ranks(ps.TENSOR_AXIS))
    else:
        ranks = tuple(int(r) for r in ps.tp_submesh(
            tp, devices=devices).devices.reshape(-1))
    world = dist.get_world_size()
    me = dist.get_rank()
    if me not in ranks:
        raise ValueError(f"rank {me} is not one of the engine's tensor-"
                         f"parallel ranks {list(ranks)}")
    if ranks == tuple(range(world)):
        group = None
    elif (ps.model_parallel_is_initialized()
          and tuple(ps.get_group_ranks(ps.TENSOR_AXIS)) == ranks):
        group = ps.get_group(ps.TENSOR_AXIS)
    else:
        if ranks not in _TP_GROUPS:
            _TP_GROUPS[ranks] = dist.new_group(
                list(ranks), use_local_synchronization=True)
        group = _TP_GROUPS[ranks]
    return TPComm(group, tp, ranks.index(me), True)


class _LeaderClock:
    """The engine's clock under tensor parallelism: every rank reads its
    own clock (a ``VirtualClock`` counts the read) and takes the group's
    first rank's reading, broadcast, so every host decision taken from
    the clock is the first rank's on every rank."""

    def __init__(self, clock: Callable[[], float], comm: TPComm):
        self.clock = clock
        self.comm = comm

    def __call__(self) -> float:
        t = torch.tensor([self.clock()], dtype=torch.float64)
        self.comm.broadcast_host(t, 0)
        return float(t[0])


class _LeaderRandom:
    """A retry policy's jitter under tensor parallelism: every rank draws
    from its own generator and takes the group's first rank's draw,
    broadcast, so every rank sleeps, and decides against the deadline,
    with the same backoff."""

    def __init__(self, rng, comm: TPComm):
        self.rng = rng
        self.comm = comm

    def uniform(self, a: float, b: float) -> float:
        t = torch.tensor([self.rng.uniform(a, b)], dtype=torch.float64)
        self.comm.broadcast_host(t, 0)
        return float(t[0])


def _upload(host: np.ndarray, device: torch.device) -> torch.Tensor:
    """A host array on ``device``. To the card through pinned memory and
    a non-blocking copy: a pageable copy would synchronise the stream."""
    t = torch.from_numpy(np.ascontiguousarray(host))
    if device.type != "cuda":
        return t.to(device)
    return t.pin_memory().to(device, non_blocking=True)


class ServingEngine:
    """Single-device paged-KV decode engine over a
    ``standalone_transformer_lm`` GPT parameter tree.

    ``generate(requests)`` drives :class:`~.scheduler.Request` objects
    to completion under continuous batching and returns ``{rid:
    [token, ...]}``. ``device=None`` is the card (and raises when there
    is none); pass ``device="cpu"`` for the plain PyTorch path.
    ``tp > 1`` runs this rank's share of a tensor-parallel engine over
    ``tp`` ranks (``devices``: their global ranks; default
    ``parallel_state.tp_submesh``'s), given the full or the rank's cut
    parameter tree; see the module docstring.
    """

    def __init__(self, cfg, params, *, n_slots: int = 4,
                 page_size: Optional[int] = None,
                 num_pages: Optional[int] = None,
                 pages_per_seq: Optional[int] = None,
                 max_prompt_len: Optional[int] = None,
                 kv_dtype: Optional[torch.dtype] = None,
                 telemetry_every: int = 0, record_every: int = 16,
                 sink=None,
                 admission: Optional[AdmissionConfig] = None,
                 degradation: Optional[DegradationPolicy] = None,
                 watchdog=None, step_timeout_s: Optional[float] = None,
                 chaos=None,
                 clock: Optional[Callable[[], float]] = None,
                 prefill_chunk: int = 1, prefix_cache: bool = True,
                 spec_k: int = 0, spec_ngram: int = 3, trace: bool = True,
                 tp: int = 1, devices: Optional[Sequence[int]] = None,
                 device=None):
        self.device = resolve_device(device)
        # recovery (recover_from / rebuild_like) builds an engine with
        # the same geometry, policies and device: capture the kwargs
        self._ctor_kw = dict(
            n_slots=n_slots, page_size=page_size, num_pages=num_pages,
            pages_per_seq=pages_per_seq, max_prompt_len=max_prompt_len,
            kv_dtype=kv_dtype, telemetry_every=telemetry_every,
            record_every=record_every, sink=sink, admission=admission,
            degradation=degradation, watchdog=watchdog,
            step_timeout_s=step_timeout_s, chaos=chaos, clock=clock,
            prefill_chunk=prefill_chunk, prefix_cache=prefix_cache,
            spec_k=spec_k, spec_ngram=spec_ngram, trace=trace, tp=tp,
            devices=devices, device=self.device)
        self.cfg = cfg
        n, d = cfg.num_attention_heads, cfg.kv_channels
        #: tensor-parallel degree: tp > 1 head-shards the pool and
        #: column / row-shards the GEMMs over the ranks of ``self.comm``
        self.tp = int(tp)
        if self.tp < 1:
            raise ValueError(f"tp must be >= 1, got {tp}")
        if n % self.tp:
            raise ValueError(
                f"num_attention_heads {n} not divisible by tp={self.tp}")
        self._vocab = int(params["embedding"]["word"].shape[0])
        if self._vocab % self.tp:
            raise ValueError(
                f"vocab {self._vocab} not divisible by tp={self.tp} "
                "(lm_logits is vocab-parallel)")
        self.comm: Optional[TPComm] = (_tp_comm(self.tp, devices)
                                       if self.tp > 1 else None)
        # each rank's K/V page must be ROW-aligned for its n / tp heads
        ps = page_size or default_page_size(n // self.tp, d)
        max_seq = cfg.max_position_embeddings
        mp = pages_per_seq or -(-max_seq // ps)
        num_pages = num_pages or (n_slots * mp + 1)
        self.spec = PagedKVSpec(
            cfg.num_layers, n, d, page_size=ps, num_pages=num_pages,
            pages_per_seq=mp, dtype=kv_dtype or cfg.compute_dtype)
        #: the spec of this rank's share of the pool (``self.spec`` at
        #: tp=1); the host keeps the global spec's page geometry
        self.spec_local = self.spec.shard(self.tp)
        if self.tp > 1:
            findings = layout_findings(self.spec.pack_spec,
                                       shard_count=self.tp)
            if findings:
                raise ValueError("KV pool layout is not tp-shardable: "
                                 + "; ".join(f"{c}: {m}"
                                             for c, m in findings))
        #: each program's live record of its collective sites (tp > 1)
        self._sites: Dict[str, Dict[str, Any]] = {}
        if self.device.type == "cuda" and not flash_decode_available(ps, d):
            raise ValueError(
                f"flash_decode kernel cannot take page_size={ps}, "
                f"head_dim={d} (needs page_size % 8 == 0 and head_dim "
                "<= 256)")
        self.n_slots = int(n_slots)
        self.max_prompt_len = int(max_prompt_len or max_seq)
        # the device prompt buffer holds preemption-replay prompts
        # (original prompt + generated so far): cap = max sequence
        self._buf_len = min(self.spec.max_seq_len, max_seq)
        self.prefill_chunk = max(1, int(prefill_chunk))
        if self.prefill_chunk > self._buf_len:
            raise ValueError(
                f"prefill_chunk {prefill_chunk} exceeds the prompt "
                f"buffer ({self._buf_len} tokens)")
        #: speculative decoding: draft up to `spec_k` tokens per decode
        #: slot per step (0 = off) from an `spec_ngram`-gram lookup over
        #: the slot's own history, verified in one target pass
        self.spec_k = max(0, int(spec_k))
        self.spec_ngram = int(spec_ngram)
        if self.spec_k > 0 and not 1 <= self.spec_ngram < self._buf_len:
            raise ValueError(
                f"spec_ngram must be in [1, {self._buf_len}) "
                f"(the sequence buffer), got {spec_ngram}")
        if self.spec_k >= self._buf_len:
            raise ValueError(
                f"spec_k {spec_k} exceeds the sequence buffer "
                f"({self._buf_len} tokens)")
        self.params = self._rank_params(params)
        self.sink = sink if sink is not None else telemetry.NullRecorder()
        self.telemetry_every = int(telemetry_every)
        self.record_every = int(record_every)
        self._chaos = chaos
        self.scheduler = Scheduler(self.spec, self.n_slots,
                                   max_prompt_len=self._buf_len,
                                   chaos=chaos,
                                   prefix_cache=bool(prefix_cache),
                                   prefill_chunk=self.prefill_chunk,
                                   spec_k=self.spec_k)
        self.prefix_cache = self.scheduler.cache
        if degradation is not None and admission is None:
            raise ValueError(
                "degradation= requires admission= (the DegradationPolicy "
                "acts through the AdmissionController's pressure state)")
        self.admission = (
            AdmissionController(admission, self.n_slots,
                                degradation=degradation)
            if admission is not None else None)
        self.watchdog = watchdog
        self._step_timeout_s = step_timeout_s
        self._clock = clock if clock is not None else time.perf_counter
        if self.comm is not None:
            self._clock = _LeaderClock(self._clock, self.comm)
        #: end-to-end tracing (telemetry.spans): span records through
        #: this engine's sink + the bounded flight-recorder ring dumped
        #: as a black box on hangs and recovery. Span timestamps only
        #: reuse clock values the engine already read, so tracing adds
        #: ZERO clock reads (VirtualClock budgets are denominated in
        #: reads) and traced runs stay deterministic.
        self.tracer = (telemetry.Tracer(sink=self.sink, clock=self._clock)
                       if trace else None)
        self.kv = self.spec_local.init_cache(self.device)
        self.slots = SlotState.zeros(self.n_slots, self._buf_len,
                                     self.device)
        self.metrics = telemetry.init_metrics(self.device)
        self._no_poison = torch.zeros((self.n_slots,), dtype=torch.bool,
                                      device=self.device)
        self._occupants: List[Optional[int]] = [None] * self.n_slots
        self.steps_run = 0
        self.last_stats: Dict[str, Any] = {}
        self._accum = self._fresh_accum()

    def _rank_params(self, params):
        """On the device, cut for this rank (under tensor parallelism)
        BEFORE the one-shot inference cast, then cast."""
        params = _to_device(params, self.device)
        if self.comm is not None:
            params = tp_rank_params(params, self.tp, self.comm.rank)
        return cast_params_for_inference(params, self.cfg.compute_dtype)

    # -- tensor parallelism ------------------------------------------------
    #: the collective sites of every serving program: its layers' tails
    #: and the sampler's (the JAX walker's count of one program)
    _PROGRAM_SITES = {**decode_model.TP_SITES, **sampling.TP_SITES}

    def _programs(self) -> List[str]:
        """The enabled serving programs: ``decode``; ``chunk_prefill``
        with ``prefill_chunk > 1``; ``spec_verify`` with ``spec_k > 0``."""
        return (["decode"] + (["chunk_prefill"] if self.prefill_chunk > 1
                              else [])
                + (["spec_verify"] if self.spec_k > 0 else []))

    def _recording(self, program: str):
        """The live record of ``program``'s collective sites around one
        of its steps (a no-op context at tp=1)."""
        if self.comm is None:
            return contextlib.nullcontext()
        return self.comm.recording(self._sites.setdefault(program, {}))

    def program_comm_volume(self) -> Optional[Dict[str, Dict]]:
        """``{program: {collective: {count, bytes, axes}}}`` over every
        enabled serving program (:meth:`_programs`): each declared
        collective site of the program once (the layer loop's tails count
        once, as the JAX walker counts a loop body), its output bytes
        from the program's live steps (None for a site those steps have
        not issued yet: a program that has not run, or the draw's two
        before a sampled row). None at tp=1: there are no collectives."""
        if self.comm is None:
            return None
        return {name: self.comm.volume(self._PROGRAM_SITES,
                                       self._sites.get(name, {}))
                for name in self._programs()}

    def program_psum_counts(self) -> Optional[Dict[str, int]]:
        """The ``psum`` (``all_reduce`` SUM) sites of each enabled
        program: the two sublayer tails plus the sampler's one fused
        reduction, 3 (None at tp=1)."""
        vols = self.program_comm_volume()
        if vols is None:
            return None
        return {name: int(v.get("psum", {}).get("count", 0))
                for name, v in vols.items()}

    def begin_run(self) -> None:
        """Reset the per-run accounting (``generate`` calls it)."""
        self._accum = self._fresh_accum()

    def _fresh_accum(self) -> Dict[str, Any]:
        return {
            "steps": 0, "active_slot_steps": 0, "prefill_slot_steps": 0,
            "decode_slot_steps": 0, "step_time_s": 0.0,
            "prefill_step_time_s": 0.0, "decode_step_time_s": 0.0,
            "step_times_ms": [], "max_queue_depth": 0,
            "prefill_tokens": 0, "decode_tokens": 0,
            "cached_prompt_tokens": 0,
            # speculative decoding: drafts offered to verification vs
            # drafts accepted (decode_tokens - accepted = the one "free"
            # token per decode slot-step)
            "drafted_tokens": 0, "accepted_tokens": 0,
            "cache_base": (self.prefix_cache.stats()
                           if self.prefix_cache is not None else None),
        }

    # -- request intake ----------------------------------------------------
    def _engine_reject_reason(self, req: Request
                              ) -> Optional[RejectionReason]:
        if len(req.prompt) > self.max_prompt_len:
            return RejectionReason(
                RejectionCode.PROMPT_TOO_LONG,
                f"request {req.rid}: prompt {len(req.prompt)} exceeds "
                f"max_prompt_len {self.max_prompt_len}")
        total = len(req.prompt) + req.max_new_tokens
        if total > self.cfg.max_position_embeddings:
            return RejectionReason(
                RejectionCode.EXCEEDS_MAX_SEQ,
                f"request {req.rid}: prompt+max_new = {total} exceeds "
                f"max_position_embeddings "
                f"{self.cfg.max_position_embeddings}")
        if req.max_new_tokens < 1:
            return RejectionReason(
                RejectionCode.BAD_MAX_NEW,
                f"request {req.rid}: max_new_tokens < 1")
        if self.tp > 1:
            sp = resolve(req.sampling)
            # the TP sampler's thresholds come from the gathered top-64
            # candidates: a deeper top_k cannot be honoured exactly
            if sp.top_k > TOP_FILTER_WIDTH:
                return RejectionReason(
                    RejectionCode.UNSUPPORTED_SAMPLING,
                    f"request {req.rid}: top_k {sp.top_k} exceeds the "
                    f"tensor-parallel filter width {TOP_FILTER_WIDTH} "
                    f"(tp={self.tp} has no full-vocab sort fallback)")
        return None

    def probe(self, req: Request
              ) -> Tuple[Optional[RejectionReason], float]:
        """Read-only feasibility x cost for one request against this
        engine. Returns ``(reason, est_steps)``: the refusal
        :meth:`try_submit` would produce right now (or ``None``), and the
        estimated engine steps until this request's FIRST token — the
        token backlog (queued + in-flight remainders) shared over
        ``n_slots`` slots, plus its own uncached prefill. Nothing is
        mutated: no stamp, no status change, no admission latch."""
        queued_tokens = self._queued_tokens()
        backlog = queued_tokens + sum(
            max(0, run.total_len() - run.pos)
            for _, run in self.scheduler.running())
        prefill_steps = self._prefill_steps(req)
        est_steps = backlog / max(1, self.n_slots) + prefill_steps
        if req.status in (RequestStatus.QUEUED, RequestStatus.RUNNING):
            return already_in_flight(req), est_steps
        reason = self._engine_reject_reason(req)
        if reason is None:
            reason = self.scheduler.validate(req)
        if reason is None and self.admission is not None:
            reason = self.admission.probe(
                req, queue_depth=len(self.scheduler.waiting),
                queued_tokens=queued_tokens, prefill_steps=prefill_steps)
        return reason, est_steps

    def try_submit(self, req: Request) -> Optional[RejectionReason]:
        """Admit a request, or refuse it with a typed reason (finalized
        ``REJECTED`` + a ``reject`` record). Resubmitting a terminal
        request starts a fresh lifecycle attempt; ``t_arrival`` is
        stamped only once, so deadline budgets span resubmits and
        restarts."""
        if req.status in (RequestStatus.QUEUED, RequestStatus.RUNNING):
            # a duplicate submission of in-flight work: refuse WITHOUT
            # finalizing — the live submission keeps running
            reason = already_in_flight(req)
            self.sink.record({"event": "reject", "rid": req.rid,
                              **reason.as_record()})
            return reason
        if is_terminal(req.status):
            req.status = RequestStatus.PENDING
            req.end_reason = None
        now = self._clock()
        if req.t_arrival is None:
            req.t_arrival = now
        ctx = None
        if self.tracer is not None:
            # trace identity stamped once per lifecycle attempt; a
            # resubmit keeps its context and its attribution ledger
            ctx = self.tracer.begin_request_trace(req)
            if req.attr is None:
                telemetry.attr_init(req, now)
            else:
                telemetry.attr_account(
                    req, now,
                    "migration" if getattr(req, "_migrating", False)
                    else "queue_wait")
            req._migrating = False
        ctl = self.admission
        depth = len(self.scheduler.waiting)
        reason = self._engine_reject_reason(req)
        if reason is None:
            reason = self.scheduler.validate(req)
        if reason is None and ctl is not None:
            reason = ctl.check(req, queue_depth=depth,
                               queued_tokens=self._queued_tokens(),
                               prefill_steps=self._prefill_steps(req))
        if reason is not None:
            self.sink.record({"event": "reject", "rid": req.rid,
                              "queue_depth": depth, **reason.as_record()})
            if ctx is not None:
                self.tracer.emit("admission", ctx.trace_id, now, now,
                                 parent_id=ctx.span_id,
                                 outcome=reason.code.value,
                                 queue_depth=depth)
            self._finalize(req, RequestStatus.REJECTED, reason.code.value,
                           now=now)
            return reason
        if ctl is not None:
            # graceful degradation, applied only to work actually being
            # admitted: less work per request keeps the door open
            cap = ctl.cap_for(req, depth)
            if cap is not None:
                self.sink.record({
                    "event": "degrade", "rid": req.rid,
                    "max_new_tokens": cap,
                    "requested_max_new": req.max_new_tokens})
                req.max_new_tokens = cap
        if ctx is not None:
            self.tracer.emit("admission", ctx.trace_id, now, now,
                             parent_id=ctx.span_id, outcome="queued",
                             queue_depth=depth)
        req.status = RequestStatus.QUEUED
        self.scheduler.waiting.append(req)
        return None

    def submit(self, req: Request) -> None:
        """The raising intake: refusal raises :class:`RejectionError`."""
        reason = self.try_submit(req)
        if reason is not None:
            raise RejectionError(reason)

    def cancel(self, req: Request) -> bool:
        """Withdraw a request: removed from the queue or evicted from its
        slot (pages freed), finalized ``CANCELLED``. False when it is not
        in flight (already terminal / unknown)."""
        sched = self.scheduler
        now = self._clock()
        if sched.remove_waiting(req):
            self._finalize(req, RequestStatus.CANCELLED, "cancelled",
                           now=now)
            return True
        for i, run in sched.running():
            if run.req is req:
                sched.evict(i)
                self._finalize(req, RequestStatus.CANCELLED, "cancelled",
                               now=now)
                return True
        return False

    def _uncached_replay(self, req: Request) -> int:
        """Replay-prompt tokens this engine would actually PREFILL for
        ``req`` now: the replay length minus its cached head (capped so
        the final prompt token is always recomputed). Memoized per
        request against the cache's mutation generation."""
        replay = len(req.prompt) + len(req.out_tokens)
        cache = self.prefix_cache
        if cache is None or replay < 2:
            return replay
        memo = getattr(req, "_uncached_memo", None)
        probe_key = (id(cache), cache.generation, replay)
        if memo is not None and memo[0] == probe_key:
            return memo[1]
        cached = min(cache.match_len(list(req.prompt)
                                     + list(req.out_tokens)), replay - 1)
        uncached = replay - cached
        req._uncached_memo = (probe_key, uncached)
        return uncached

    def _prefill_steps(self, req: Request) -> int:
        """Engine steps until ``req``'s first token once scheduled:
        ceil(uncached replay / prefill_chunk)."""
        return -(-self._uncached_replay(req) // self.prefill_chunk)

    def _queued_tokens(self) -> int:
        """Tokens still owed by the waiting queue: uncached replay head
        + remaining generation per request."""
        return sum(self._uncached_replay(r) + r.max_new_tokens
                   - len(r.out_tokens) for r in self.scheduler.waiting)

    # -- lifecycle ---------------------------------------------------------
    def _finalize(self, req: Request, status: RequestStatus, reason: str,
                  *, now: float, failure: Optional[dict] = None,
                  term: str = "queue_wait") -> None:
        """One typed terminal state per request + a ``request_end``
        record — and, under tracing, the trace's single TERMINAL span,
        closing the attribution ledger with ``term`` for the final
        interval."""
        if is_terminal(req.status):  # explicit: must survive python -O
            raise AssertionError(
                f"request {req.rid} finalized twice "
                f"({req.status.name} -> {status.name})")
        req.status = status
        req.end_reason = reason
        if failure is not None:
            req.failure = dict(failure)
        if req.t_done is None and status is RequestStatus.COMPLETED:
            req.t_done = now
        rec = {
            "event": "request_end", "rid": req.rid,
            "status": status.value, "reason": reason,
            "generated": len(req.out_tokens),
            "preemptions": req.preemptions,
            "restarts": req.restarts,
        }
        # latencies from stamps the engine already took, the SLO verdict
        # from static budgets — no clock read here
        if req.t_arrival is not None:
            if req.t_first_token is not None:
                rec["ttft_ms"] = round(
                    1e3 * (req.t_first_token - req.t_arrival), 6)
            rec["latency_ms"] = round(
                1e3 * ((req.t_done if req.t_done is not None else now)
                       - req.t_arrival), 6)
        rec["slo_ok"] = self._within_budget(req)
        if req.labels:
            rec["labels"] = dict(req.labels)
        if failure is not None:
            rec["failure"] = dict(failure)
        self.sink.record(rec)
        if self.tracer is not None:
            telemetry.emit_terminal_span(
                self.tracer, req, status.value, reason, now=now, term=term,
                slo_ok=self._within_budget(req))

    def _enforce_deadlines(self, now: float) -> None:
        """Evict expired work at the boundary: a request past its total
        budget — or still owed its first token past its TTFT budget — is
        finalized ``TIMED_OUT``, its slot and pages freed."""
        sched = self.scheduler
        for req in list(sched.waiting):
            why = request_expired(req, now)
            if why is not None:
                sched.remove_waiting(req)
                self._finalize(req, RequestStatus.TIMED_OUT, why, now=now)
        for i, run in list(sched.running()):
            why = request_expired(run.req, now)
            if why is not None:
                sched.evict(i)
                self._finalize(run.req, RequestStatus.TIMED_OUT, why,
                               now=now,
                               term=("decode" if not run.prefilling else
                                     "replay" if run.replay else
                                     "prefill_compute"))

    def _boundary_degradation(self, now: float) -> None:
        """Pressure degrades queued work: while the queue sits at/above
        the high watermark (or backpressure is latched), waiting
        requests are capped to the policy's ``cap_max_new``; past
        ``shed_after`` pressured boundaries, shedding starts
        (deadline-infeasible first, then lowest-priority-youngest) until
        the queue drains to the low watermark."""
        ctl = self.admission
        sched = self.scheduler
        shed_now = ctl.note_boundary(len(sched.waiting))
        d = ctl.degradation
        if (d is not None and d.cap_max_new is not None
                and (ctl.backpressure
                     or len(sched.waiting) >= ctl.high_count)):
            for req in sched.waiting:
                if req.max_new_tokens > d.cap_max_new:
                    self.sink.record({
                        "event": "degrade", "rid": req.rid,
                        "max_new_tokens": int(d.cap_max_new),
                        "requested_max_new": req.max_new_tokens})
                    req.max_new_tokens = int(d.cap_max_new)
        if not shed_now:
            return
        while len(sched.waiting) > ctl.low_count:
            victim = ctl.pick_shed_victim(sched.waiting,
                                          self._queued_tokens())
            if victim is None:
                break
            sched.remove_waiting(victim)
            ctl.shed += 1
            self.sink.record({"event": "shed", "rid": victim.rid,
                              "priority": victim.priority,
                              "queue_depth": len(sched.waiting)})
            self._finalize(victim, RequestStatus.REJECTED, "shed", now=now)

    # -- the loop ----------------------------------------------------------
    def _sync_device_slots(self) -> None:
        """Push occupancy changes (admissions, evictions, preemptions)
        and cursor rewinds to the device slot state as one masked
        update. A prefix-cache hit starts at its cached cursor; the
        replay prompt IS the consumed history so far, so ``hist``
        resumes where the slot left off."""
        sched = self.scheduler
        B, W = self.n_slots, self._buf_len
        dirty = sched.take_dirty_slots()
        mask = np.zeros((B,), bool)
        rows = {
            "tokens": np.zeros((B,), np.int32),
            "positions": np.zeros((B,), np.int32),
            "active": np.zeros((B,), bool),
            "prompt_buf": np.zeros((B, W), np.int32),
            "prompt_lens": np.zeros((B,), np.int32),
            "temps": np.zeros((B,), np.float32),
            "top_ks": np.zeros((B,), np.int32),
            "top_ps": np.ones((B,), np.float32),
            "seeds": np.zeros((B,), np.int32),
            "rids": np.zeros((B,), np.int32),
            "hist": np.zeros((B, W + 1), np.int32),
        }
        for i in range(B):
            run = sched.slots[i]
            rid = None if run is None else run.req.rid
            if rid == self._occupants[i] and i not in dirty:
                continue  # unchanged occupancy: the device row is current
            mask[i] = True
            self._occupants[i] = rid
            if run is None:
                continue  # deactivate the row (zeros, active=False)
            plen = len(run.prompt)
            if run.pos >= plen:
                raise SchedulerError(
                    f"slot {i}: admission must start inside the prompt")
            rows["tokens"][i] = run.prompt[run.pos]
            rows["positions"][i] = run.pos
            rows["active"][i] = True
            rows["prompt_buf"][i, :plen] = run.prompt
            rows["prompt_lens"][i] = plen
            rows["hist"][i, :plen] = run.prompt
            sp = resolve(run.req.sampling)
            rows["temps"][i] = sp.temperature
            rows["top_ks"][i] = sp.top_k
            rows["top_ps"][i] = sp.top_p
            rows["seeds"][i] = i32_wrap(sp.seed)
            rows["rids"][i] = i32_wrap(run.req.rid)
        if not mask.any():
            return
        m = _upload(mask, self.device)
        for name, host in rows.items():
            old = getattr(self.slots, name)
            sel = m.reshape((B,) + (1,) * (old.dim() - 1))
            setattr(self.slots, name,
                    torch.where(sel, _upload(host, self.device), old))

    def _copy_pool_pages(self, forks) -> None:
        """COW device half: copy pool pages ``src -> dst`` across every
        layer's K and V, in place, before the step's writes land."""
        pairs = np.asarray(forks, np.int64).reshape(-1, 2)
        src = _upload(pairs[:, 0], self.device)
        dst = _upload(pairs[:, 1], self.device)
        pages = self.kv.pages
        pages.index_copy_(2, dst, pages.index_select(2, src))

    def _poison_mask(self, step_no: int) -> torch.Tensor:
        """The chaos poison-injection mask for this step ([B] bool on
        the device; the cached all-False tensor when nothing fires)."""
        if self._chaos is None:
            return self._no_poison
        occupants = [None if s is None else s.req.rid
                     for s in self.scheduler.slots]
        mask = self._chaos.poison_mask(occupants, step_no)
        if mask is None:
            return self._no_poison
        return _upload(np.asarray(mask, bool), self.device)

    @torch.no_grad()
    def _device_step(self, page_tables: torch.Tensor, poison: torch.Tensor,
                     chunked: bool, any_sampled: bool) -> torch.Tensor:
        """One eager plain step; returns the emitted ``[B]`` int32 tokens
        (``NO_TOKEN`` / ``POISONED`` sentinels) on the device."""
        with self._recording("chunk_prefill" if chunked else "decode"):
            return self._plain_step(page_tables, poison, chunked,
                                    any_sampled)

    def _plain_step(self, page_tables: torch.Tensor, poison: torch.Tensor,
                    chunked: bool, any_sampled: bool) -> torch.Tensor:
        s = self.slots
        if chunked:
            logits, self.kv, take = prefill_chunk_tokens(
                self.cfg, self.params, self.spec_local, self.kv, s.tokens,
                s.positions, s.active, s.prompt_buf, s.prompt_lens,
                page_tables, chunk=self.prefill_chunk, tp_axis=self.comm)
            next_pos = s.positions + take
        else:
            logits, self.kv = decode_tokens(
                self.cfg, self.params, self.spec_local, self.kv, s.tokens,
                s.positions, s.active, page_tables, tp_axis=self.comm)
            next_pos = s.positions + 1
        # chaos seam: the poison mask turns a slot's logits non-finite
        # in the step (the shape of a corrupted activation)
        logits = torch.where(poison[:, None], float("nan"), logits)
        # the emitted token OCCUPIES position next_pos: its PRNG key
        if self.comm is None:
            # fault isolation rides the same logits the sampler reads
            bad = s.active & ~torch.isfinite(logits).all(dim=-1)
            sampled = sample_tokens(logits, s.temps, s.top_ks, s.top_ps,
                                    s.seeds, s.rids, next_pos,
                                    any_sampled=any_sampled)
        else:
            # the poison flag rides the TP sampler's fused reduction
            sampled, nonfin = sample_tokens_tp(
                logits, s.temps, s.top_ks, s.top_ps, s.seeds, s.rids,
                next_pos, axis_name=self.comm, vocab_size=self._vocab,
                any_sampled=any_sampled)
            bad = s.active & nonfin
        still_prefill = next_pos < s.prompt_lens
        prompt_next = s.prompt_buf.gather(
            1, next_pos.clamp(max=self._buf_len - 1).long()[:, None])[:, 0]
        emitted = torch.where(s.active & ~still_prefill, sampled, NO_TOKEN)
        emitted = torch.where(bad, POISONED, emitted).to(torch.int32)
        next_tok = torch.where(still_prefill, prompt_next, sampled)
        s.tokens = torch.where(s.active, next_tok, s.tokens).to(torch.int32)
        s.positions = torch.where(s.active, next_pos,
                                  s.positions).to(torch.int32)
        return emitted

    @torch.no_grad()
    def _spec_device_step(self, page_tables: torch.Tensor,
                          poison: torch.Tensor, caps: torch.Tensor,
                          any_sampled: bool) -> torch.Tensor:
        """The speculative step; returns the ``[B, C + 1]`` emitted
        matrix on the device."""
        with self._recording("spec_verify"):
            self.kv, self.slots, emitted = run_spec_step(
                self.cfg, self.params, self.spec_local, self.kv, self.slots,
                page_tables, poison, caps, spec_k=self.spec_k,
                ngram=self.spec_ngram, prefill_chunk=self.prefill_chunk,
                any_sampled=any_sampled, tp_axis=self.comm)
        return emitted

    def _observe_metrics(self, emitted: torch.Tensor) -> None:
        """The in-step metrics: tokens emitted this step, drained every
        ``telemetry_every`` steps with no host sync."""
        if self.telemetry_every <= 0:
            return
        toks = emitted if emitted.dim() == 1 else emitted[:, :-1]
        self.metrics = telemetry.accumulate(
            self.metrics, tokens=(toks >= 0).sum().to(torch.float32))
        self.metrics = telemetry.drain(
            self.metrics, self.sink, every_n=self.telemetry_every,
            tag="serving")

    def _fetch_emitted(self, emitted: torch.Tensor,
                       step_no: int) -> np.ndarray:
        """The step's one host sync, optionally under an armed watchdog
        deadline (a wedged sync raises ``HangError`` with all-thread
        stacks + a ``hang`` event instead of stalling forever). The chaos
        wedge fires inside the armed window — that is the fault the
        watchdog exists to catch."""
        def fetch():
            if self._chaos is not None:
                self._chaos.maybe_wedge(step_no)
            return emitted.cpu().numpy()

        if self.watchdog is None:
            return fetch()
        hang = None
        try:
            with self.watchdog.armed("serving_step_host_sync",
                                     timeout_s=self._step_timeout_s,
                                     context={"step": step_no}):
                em = fetch()
        except HangError as e:
            hang = e
        # under tensor parallelism the verdict is the group's (outside
        # the armed window: a rank that did not trip waits here for the
        # one that did, no longer than its deadline)
        if self.comm is not None and self.comm.any_host(hang is not None) \
                and hang is None:
            timeout = (self.watchdog.timeout_s if self._step_timeout_s
                       is None else self._step_timeout_s)
            hang = HangError("serving_step_host_sync", timeout,
                             "(this rank's fetch completed; another rank "
                             "of the tensor-parallel group tripped its "
                             "watchdog at this step)")
        if hang is None:
            return em
        # the post-mortem black box: the flight ring merged with the
        # hang's all-thread stacks, through the same sink
        if self.tracer is not None:
            self.tracer.dump_blackbox(
                reason="hang", sink=self.sink, stacks=hang.stacks,
                what=hang.what, step=step_no)
        raise hang

    def run_step(self) -> np.ndarray:
        """One scheduling boundary + one device step; returns the fetched
        emitted-token array: ``[B]`` (-1 = no token, -2 = quarantined)
        for the plain steps, or — with ``spec_k > 0`` — the ``[B, C+1]``
        matrix (per-slot emitted tokens in order, ``NO_TOKEN`` padding,
        ``POISONED`` in column 0, the drafted-token count last)."""
        sched = self.scheduler
        step_no = self.steps_run
        if self._chaos is not None:
            self._chaos.maybe_kill(step_no)  # raises ChaosError
        boundary_t = now = self._clock()
        self._enforce_deadlines(now)
        if self.admission is not None:
            self._boundary_degradation(now)
        if self._chaos is not None and sched.cache is not None:
            # eviction-under-pressure chaos: forced cache evictions at
            # this boundary (evict_one still refuses reader-held pages)
            for _ in range(self._chaos.take_cache_evictions()):
                if sched.cache.evict_one() is None:
                    break
        admitted = sched.admit()
        self._accum["cached_prompt_tokens"] += sum(
            run.cached_tokens for _, run in admitted)
        if self.tracer is not None:
            for i, run in admitted:
                run.t_admit = boundary_t
                ctx = run.req.trace
                if ctx is not None:
                    self.tracer.emit(
                        "admit", ctx.trace_id, boundary_t, boundary_t,
                        parent_id=ctx.span_id, slot=i, pos=run.pos,
                        cached_tokens=run.cached_tokens, replay=run.replay)
        preempted = sched.ensure_capacity()
        if self.tracer is not None:
            for r in preempted:
                ctx = r.trace
                if ctx is not None:
                    self.tracer.emit(
                        "preempt", ctx.trace_id, boundary_t, boundary_t,
                        parent_id=ctx.span_id, preemptions=r.preemptions)
        # pressure rollbacks recompute tokens already counted as skipped
        self._accum["cached_prompt_tokens"] -= sched.take_rollback_tokens()
        forks = sched.take_forks()
        if self.tracer is not None and forks:
            self.tracer.emit("cow_fork", "engine-steps", boundary_t,
                             boundary_t, step=step_no,
                             n_copies=len(forks), ring_only=True)
        if forks:
            # the COW page copies land BEFORE this step's K/V writes
            self._copy_pool_pages(forks)
        self._sync_device_slots()
        page_tables = _upload(sched.page_table_array(), self.device)
        poison = self._poison_mask(step_no)
        # host classification BEFORE the step (deterministic mirrors)
        served = sched.running()
        prefill_slots = [i for i, r in served if r.prefilling]
        decode_slots = {i for i, r in served if not r.prefilling}
        prefill_tokens = sum(sched.next_take(r)
                             for _, r in served if r.prefilling)
        any_sampled = any(resolve(r.req.sampling).temperature > 0.0
                          for _, r in served)
        t0 = time.perf_counter()
        if self.spec_k > 0:
            # the host's per-slot draft cap bounds drafting to the pages
            # ensure_capacity just allocated
            caps = np.zeros((self.n_slots,), np.int32)
            for i, r in served:
                caps[i] = sched.draft_cap(r)
            emitted = self._spec_device_step(
                page_tables, poison, _upload(caps, self.device),
                any_sampled)
        else:
            emitted = self._device_step(
                page_tables, poison,
                self.prefill_chunk > 1 and bool(prefill_slots), any_sampled)
        self._observe_metrics(emitted)
        em = self._fetch_emitted(emitted, step_no)  # the one host sync
        dt = time.perf_counter() - t0
        now = self._clock()
        if self.admission is not None:
            # the EWMA in the SAME clock the deadline budgets use
            self.admission.observe_step(now - boundary_t)
        if self.tracer is not None:
            # latency attribution: partition [last accounting -> now]
            # for every request visible at this boundary, with the SAME
            # `now` that stamps t_first_token/t_done below
            for r in sched.waiting:
                telemetry.attr_account(r, now, "queue_wait")
            for i, run in served:
                telemetry.attr_account(
                    run.req, now, self._phase_term(run, i in decode_slots))
        if em.ndim == 1:
            tok_rows = em[:, None]
            drafted = np.zeros((self.n_slots,), np.int64)
        else:
            tok_rows = em[:, :-1]
            drafted = em[:, -1].astype(np.int64)
        # quarantined slots are excluded from advance BEFORE it runs:
        # advance publishes completed prompt pages to the prefix cache,
        # and a poisoned slot wrote non-finite K/V this step
        bad_slots = {i for i, _ in served if int(tok_rows[i, 0]) == POISONED}
        emitted_by_slot: Dict[int, List[int]] = {}
        consumed: Dict[int, int] = {}
        for i, run in served:
            if i in bad_slots:
                continue
            toks = []
            for t in tok_rows[i]:
                t = int(t)
                if t == NO_TOKEN:
                    break
                toks.append(t)
            emitted_by_slot[i] = toks
            if i in decode_slots:
                # the cursor moved by the ACCEPTED run, decided on the
                # device and read off the emitted row
                consumed[i] = len(toks)
        sched.advance([i for i, _ in served if i not in bad_slots],
                      consumed=consumed)
        n_decode_tokens = 0
        n_accepted = 0
        for i, run in served:
            req = run.req
            if i in bad_slots:
                # fault isolation: quarantine ONLY this slot; the other
                # rows never mixed with its math
                sched.evict(i)
                if self.tracer is not None and req.trace is not None:
                    self.tracer.emit(
                        "quarantine", req.trace.trace_id, now, now,
                        parent_id=req.trace.span_id, slot=i,
                        step=step_no, position=run.pos)
                self._finalize(
                    req, RequestStatus.FAILED, "nonfinite_logits", now=now,
                    failure={"kind": "nonfinite_logits", "slot": i,
                             "step": step_no, "rid": req.rid,
                             "position": run.pos, "transient": True})
                continue
            kept = 0
            for tok in emitted_by_slot.get(i) or []:
                if req.t_first_token is None:
                    req.t_first_token = now
                    if self.tracer is not None:
                        # freeze the TTFT attribution at the SAME now
                        telemetry.attr_snapshot_ttft(req)
                        ctx = req.trace
                        if ctx is not None:
                            self.tracer.emit(
                                "prefill", ctx.trace_id,
                                run.t_admit if run.t_admit is not None
                                else now, now,
                                parent_id=ctx.span_id, slot=i,
                                cached_tokens=run.cached_tokens,
                                replay=run.replay)
                req.out_tokens.append(tok)
                kept += 1
                if req.done:
                    # surplus accepted tokens past max_new/EOS are
                    # discarded with the slot
                    req.t_done = now
                    sched.evict(i)
                    self._finalize(req, RequestStatus.COMPLETED, "done",
                                   now=now)
                    break
            if i in decode_slots:
                # count only DELIVERED tokens
                n_decode_tokens += kept
                n_accepted += max(0, kept - 1)
        if self.spec_k > 0:
            # rejected drafts' bookkeeping rollback: return the
            # worst-case tail pages the accepted run did not reach
            for i, run in served:
                if (i in decode_slots and i not in bad_slots
                        and sched.slots[i] is run):
                    sched.rollback_kv(i, run, run.pos)
        if self.tracer is not None:
            # flight-recorder heartbeat: one ring-only span per step
            self.tracer.emit(
                "engine_step", "engine-steps", boundary_t, now,
                step=step_no, active=len(served), admitted=len(admitted),
                preempted=len(preempted), queue_depth=len(sched.waiting),
                ring_only=True)
        self.steps_run += 1
        self._acct(len(served), len(prefill_slots), len(decode_slots),
                   prefill_tokens, dt, n_decode_tokens=n_decode_tokens,
                   n_drafted=int(sum(drafted[i] for i in decode_slots
                                     if i not in bad_slots)),
                   n_accepted=n_accepted)
        return em

    @staticmethod
    def _phase_term(run, decoding: bool) -> str:
        """The attribution bucket for one slot's boundary interval; a
        cache-hit admission's first interval buckets to ``cached_skip``
        exactly once."""
        if decoding:
            return "decode"
        if run.replay:
            return "replay"
        if run.cached_tokens > 0 and not run.hit_attributed:
            run.hit_attributed = True
            return "cached_skip"
        return "prefill_compute"

    def _acct(self, n_active, n_prefill, n_decode, n_prefill_tokens, dt,
              *, n_decode_tokens, n_drafted=0, n_accepted=0):
        a = self._accum
        a["steps"] += 1
        a["active_slot_steps"] += n_active
        a["prefill_slot_steps"] += n_prefill
        a["decode_slot_steps"] += n_decode
        a["prefill_tokens"] += n_prefill_tokens
        a["decode_tokens"] += n_decode_tokens
        a["drafted_tokens"] += n_drafted
        a["accepted_tokens"] += n_accepted
        a["step_time_s"] += dt
        a["max_queue_depth"] = max(a["max_queue_depth"],
                                   len(self.scheduler.waiting))
        # mixed steps pro-rate wall time by slot counts
        if n_prefill or n_decode:
            frac = n_prefill / (n_prefill + n_decode)
            a["prefill_step_time_s"] += dt * frac
            a["decode_step_time_s"] += dt * (1.0 - frac)
        a["step_times_ms"].append(dt * 1e3)
        if self.record_every and a["steps"] % self.record_every == 0:
            self.sink.record({
                "event": "serving_step", "step": self.steps_run,
                "active": n_active,
                "occupancy": n_active / self.n_slots,
                "free_pages": self.scheduler.allocator.free_count,
                "queue_depth": len(self.scheduler.waiting),
            })

    def _drain(self, pending: List[Request], start_step: int,
               max_steps: Optional[int]) -> int:
        """Submit arrivals and run steps until the trace drains; the
        shared loop under ``generate()`` and its retry passes."""
        step_i = start_step
        while True:
            while pending and pending[0].arrival_step <= step_i:
                self.try_submit(pending.pop(0))
            if not pending and self.scheduler.idle:
                return step_i
            if max_steps is not None and step_i >= max_steps:
                raise SchedulerError(
                    f"generate exceeded max_steps={max_steps} with "
                    f"{len(pending)} pending and "
                    f"{self.scheduler.n_active} active")
            if not self.scheduler.idle:
                self.run_step()
            step_i += 1  # an idle boundary is a gap before an arrival

    def generate(self, requests: Sequence[Request],
                 max_steps: Optional[int] = None,
                 retry_failed=None) -> Dict[int, List[int]]:
        """Run a request trace to completion under continuous batching.

        Requests with ``arrival_step > 0`` are submitted at that step
        boundary; refused requests are finalized ``REJECTED`` and the
        trace continues. Returns ``{rid: tokens}``, fills
        :attr:`last_stats` and records it as a ``serving_summary``.

        ``retry_failed``: a :class:`~apex_tpu_torch.resilience.RetryPolicy`
        for request-level retry of transient ``FAILED`` requests (a
        quarantined non-finite burst): each pass resubmits them through
        the recompute replay path (generated tokens are kept), under the
        policy's attempts and wall-clock ``deadline``; its ``retry_on``
        is ignored (the trigger is the internal retry signal).
        """
        self.begin_run()
        pending = sorted(requests, key=lambda r: (r.arrival_step, r.rid))
        all_reqs = list(pending)
        t_start = time.perf_counter()
        step_i = self._drain(pending, 0, max_steps)
        if retry_failed is not None:
            self._retry_failed(all_reqs, step_i, max_steps, retry_failed)
        wall = time.perf_counter() - t_start
        # the metrics drains' records land before the summary
        telemetry.flush()
        self.last_stats = self._summarize(all_reqs, wall)
        self.sink.record({"event": "serving_summary", **self.last_stats})
        return {r.rid: list(r.out_tokens) for r in all_reqs}

    def _retry_failed(self, all_reqs, step_i, max_steps, policy) -> None:
        """Request-level retry of FAILED-transient requests under a
        ``RetryPolicy`` (its attempts, backoff and ``deadline``). A pass
        that blows the step budget is abandoned: the stranded requests
        are finalized ``FAILED`` instead of escaping ``generate()``."""
        from ..resilience.retry import retry_call

        def transient_failed():
            return [r for r in all_reqs
                    if r.status is RequestStatus.FAILED
                    and (r.failure or {}).get("transient")]

        if not transient_failed():
            return

        def attempt():
            retryable = transient_failed()
            for r in retryable:
                r.status = RequestStatus.PENDING
                r.end_reason = None
                r.retries += 1
                r.arrival_step = 0
            self._drain(list(retryable), step_i, max_steps)
            still = transient_failed()
            if still:
                raise TransientRequestFailure(still)

        eff = dataclasses.replace(policy,
                                  retry_on=(TransientRequestFailure,),
                                  message_filter=None)
        kw = {}
        if self.comm is not None:
            # every rank of a TP engine decides alike: the deadline reads
            # the first rank's clock and the backoff is its draw; at TP 1
            # the policy's own clock and jitter, as the JAX engine's
            eff = dataclasses.replace(
                eff, rng=_LeaderRandom(policy.rng, self.comm))
            kw["clock"] = self._clock
        try:
            retry_call(attempt, policy=eff, tag="serving request retry",
                       sink=self.sink, **kw)
        except TransientRequestFailure:
            pass  # policy exhausted: they stay FAILED, summary shows it
        except SchedulerError as e:
            now = self._clock()
            for r in all_reqs:
                if not is_terminal(r.status):
                    self._abort_in_flight(r, now)
            self.sink.record({"event": "retry_abandoned", "error": str(e)})

    def _abort_in_flight(self, req: Request, now: float,
                         reason: str = "retry_abandoned") -> None:
        """Pull a non-terminal request out of the queue/its slot (pages
        freed) and finalize it FAILED."""
        sched = self.scheduler
        if not sched.remove_waiting(req):
            for i, run in sched.running():
                if run.req is req:
                    sched.evict(i)
                    break
        self._finalize(req, RequestStatus.FAILED, reason, now=now)

    def _summarize(self, reqs, wall_s) -> Dict[str, Any]:
        a = self._accum
        # percentiles over COMPLETED requests only
        completed = [r for r in reqs
                     if r.status is RequestStatus.COMPLETED]
        by_status = {
            s.value: sum(r.status is s for r in reqs)
            for s in (RequestStatus.COMPLETED, RequestStatus.REJECTED,
                      RequestStatus.TIMED_OUT, RequestStatus.FAILED,
                      RequestStatus.CANCELLED)}
        total_tokens = sum(len(r.out_tokens) for r in reqs)
        lat_ms = [(r.t_done - r.t_arrival) * 1e3 for r in completed
                  if r.t_done is not None and r.t_arrival is not None]
        ttft_ms = [(r.t_first_token - r.t_arrival) * 1e3
                   for r in completed
                   if r.t_first_token is not None
                   and r.t_arrival is not None]
        slo = [r for r in completed if self._within_budget(r)]
        goodput_tokens = sum(len(r.out_tokens) for r in slo)
        return {
            "n_requests": len(reqs),
            "completed": len(completed),
            "by_status": by_status,
            "preemptions": sum(r.preemptions for r in reqs),
            "retries": sum(r.retries for r in reqs),
            "steps": a["steps"],
            "wall_s": wall_s,
            "generated_tokens": total_tokens,
            "tokens_per_sec": total_tokens / wall_s if wall_s > 0 else None,
            # SLO view: requests completed within their own budgets over
            # ALL submitted requests (rejected/shed/timed-out work counts
            # against attainment)
            "slo_attained": len(slo),
            "slo_attainment": len(slo) / len(reqs) if reqs else None,
            "goodput_tokens": goodput_tokens,
            "goodput_tokens_per_sec": goodput_tokens / wall_s
            if wall_s > 0 else None,
            # mean batch occupancy: idle slot-steps are the bubble
            "occupancy": (a["active_slot_steps"]
                          / (a["steps"] * self.n_slots))
            if a["steps"] else None,
            "max_queue_depth": a["max_queue_depth"],
            "latency_ms": telemetry.percentiles(lat_ms),
            "ttft_ms": telemetry.percentiles(ttft_ms),
            "step_ms": telemetry.percentiles(a["step_times_ms"]),
            "step_time_s": a["step_time_s"],
            "prefill_slot_steps": a["prefill_slot_steps"],
            "decode_slot_steps": a["decode_slot_steps"],
            "prefill_tokens": a["prefill_tokens"],
            "decode_tokens": a["decode_tokens"],
            "cached_prompt_tokens": a["cached_prompt_tokens"],
            # speculative decoding: drafts offered vs accepted, and the
            # decode tokens per slot-step (> 1 iff speculation accepts)
            "spec_k": self.spec_k,
            "drafted_tokens": a["drafted_tokens"],
            "accepted_tokens": a["accepted_tokens"],
            "accept_rate": a["accepted_tokens"] / a["drafted_tokens"]
            if a["drafted_tokens"] else None,
            "tokens_per_step": a["decode_tokens"] / a["decode_slot_steps"]
            if a["decode_slot_steps"] else None,
            "prefill_chunk": self.prefill_chunk,
            "prefix_cache": self.prefix_cache_run_stats(),
            "prefill_step_time_s": a["prefill_step_time_s"],
            "decode_step_time_s": a["decode_step_time_s"],
            # tensor parallelism: the pool bytes a rank holds (heads / tp
            # of every page) and each program's collectives (None at 1)
            "tp": self.tp,
            "kv_bytes_per_shard": self.spec_local.cache_bytes(),
            "psum_per_program": self.program_psum_counts(),
            "comm_volume": self.program_comm_volume(),
            # latency attribution (telemetry.spans); None with tracing off
            "attribution": telemetry.attribution_summary(
                reqs, violators=[r for r in reqs
                                 if not self._within_budget(r)]),
        }

    def prefix_cache_run_stats(self) -> Optional[Dict[str, Any]]:
        """This run's prefix-cache deltas (hits, misses, hit_tokens,
        insertions, evictions) + live entries and the hit rate; None
        when the cache is disabled."""
        cache = self.prefix_cache
        if cache is None:
            return None
        base = self._accum.get("cache_base") or {}
        cur = cache.stats()
        out = {k: cur[k] - base.get(k, 0)
               for k in ("hits", "misses", "hit_tokens", "insertions",
                         "evictions")}
        out["entries"] = cur["entries"]
        looked = out["hits"] + out["misses"]
        out["hit_rate"] = out["hits"] / looked if looked else None
        out["cached_prompt_tokens"] = self._accum["cached_prompt_tokens"]
        return out

    @staticmethod
    def _within_budget(req: Request) -> bool:
        if req.t_arrival is None:
            return True
        if (req.latency_budget_ms is not None and req.t_done is not None
                and (req.t_done - req.t_arrival) * 1e3
                > req.latency_budget_ms):
            return False
        if (req.ttft_budget_ms is not None
                and req.t_first_token is not None
                and (req.t_first_token - req.t_arrival) * 1e3
                > req.ttft_budget_ms):
            return False
        return True

    # -- weight swap -------------------------------------------------------
    def swap_params(self, params) -> None:
        """Replace the serving weights in place (cut for this rank under
        tensor parallelism, then the same one-shot inference cast the
        constructor runs) AND flush the prefix cache: cached K/V was
        computed under the OLD weights."""
        self.params = self._rank_params(params)
        if self.prefix_cache is not None:
            flushed = self.prefix_cache.flush()
            self.sink.record({"event": "prefix_cache_flush",
                              "entries": flushed})

    # -- recovery ----------------------------------------------------------
    @classmethod
    def rebuild_like(cls, old: "ServingEngine",
                     params=None) -> "ServingEngine":
        """A fresh engine with ``old``'s config, weights, geometry,
        policies and device (the captured constructor kwargs) and NO
        request recovery (see :meth:`recover_from`)."""
        return cls(old.cfg, params if params is not None else old.params,
                   **old._ctor_kw)

    @classmethod
    def recover_from(cls, dead: "ServingEngine", **overrides
                     ) -> Tuple["ServingEngine", List[Request]]:
        """Restart-with-replay: build a fresh engine (a fresh pool, on
        the same device) with the dead engine's config, weights and
        policies and pull its non-terminal requests out for
        re-submission — in-flight work rides the recompute-preemption
        replay path, so survivors complete token-identically to an
        uninterrupted run.

        Returns ``(engine, survivors)``; drive them with
        ``engine.generate(survivors)``. ``overrides`` patch constructor
        kwargs (e.g. ``chaos=None`` to disarm a fault injector)."""
        kw = dict(dead._ctor_kw)
        kw.update(overrides)
        survivors = recover_requests(dead)
        eng = cls(dead.cfg, dead.params, **kw)
        eng.sink.record({
            "event": "engine_recovery",
            "recovered": len(survivors),
            "rids": [r.rid for r in survivors],
            "dead_steps_run": dead.steps_run,
        })
        if dead.tracer is not None:
            # the dead engine's flight ring, replayed into the fresh
            # engine's sink: the crash's last-moments black box
            dead.tracer.dump_blackbox(
                reason="engine_recovery", sink=eng.sink,
                recovered=len(survivors), dead_steps_run=dead.steps_run)
        return eng, survivors


def _to_device(tree, device):
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    return tree.to(device)
