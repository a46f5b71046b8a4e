"""Serving robustness of apex_tpu_torch against apex_tpu on the CPU.

- ``AdmissionController`` (watermark hysteresis, EWMA step time,
  feasibility, ``cap_for``, ``note_boundary``, ``pick_shed_victim``),
  ``DegradationPolicy`` and ``request_expired`` driven through the same
  random scripts in both packages: every verdict exact;
- the engine under ``VirtualClock`` with admission, degradation and
  deadlines armed: each request's status, ``end_reason`` and tokens, and
  ``by_status``, exactly the JAX engine's (the clock is read at the same
  points, the same number of times);
- each fault path against the JAX engine's outcome on the same trace:
  poison quarantine, ``kill_engine_at`` + ``recover_from``, the wedge
  under ``HangWatchdog``, ``generate(retry_failed=...)``, ``cancel``,
  ``swap_params`` flushing the prefix cache, and a random chaos trace
  (stolen allocations, a poisoned request, budgets, a bounded queue).

The tiny config of ``tests/test_serving_robustness.py`` (2 layers, hidden
64, 4 heads, vocab 128, position table x40), the JAX weights carried
across with ``convert.params_from_jax``; fp32, so tokens are compared
exactly.
"""
import types

import jax
import numpy as np
import pytest
import torch

import apex_tpu.resilience as jres
import apex_tpu.serving as jserving
from apex_tpu import telemetry as jtel
from apex_tpu.serving import robustness as jrob
from apex_tpu.transformer.testing import GPTConfig as JGPTConfig
from apex_tpu.transformer.testing import init_gpt_params as jinit
import apex_tpu_torch.resilience as tres
import apex_tpu_torch.serving as tserving
from apex_tpu_torch import telemetry as ttel
from apex_tpu_torch.convert import params_from_jax
from apex_tpu_torch.serving import decode_model as tdm
from apex_tpu_torch.serving import robustness as trob
from apex_tpu_torch.transformer.testing import GPTConfig

CPU = torch.device("cpu")


@pytest.fixture(scope="module", autouse=True)
def _shed_compile_caches():
    """Each JAX engine here compiles its own step programs; drop them
    with the module (the CPU suite runs near its memory ceiling)."""
    yield
    jax.clear_caches()


@pytest.fixture(scope="module")
def twins():
    """One namespace per package: its serving and resilience modules,
    recorder, config, weights and the extra engine kwargs."""
    kw = dict(num_layers=2, hidden_size=64, num_attention_heads=4,
              vocab_size=128, max_position_embeddings=64)
    jcfg = JGPTConfig(hidden_dropout=0.0, attention_dropout=0.0, **kw)
    jparams = jinit(jcfg, jax.random.PRNGKey(0))
    jparams["embedding"]["position"] = jparams["embedding"]["position"] * 40
    tparams = params_from_jax(
        jax.tree_util.tree_map(np.asarray, jparams), CPU)
    j = types.SimpleNamespace(sv=jserving, res=jres, tel=jtel, cfg=jcfg,
                              params=jparams, extra={})
    t = types.SimpleNamespace(sv=tserving, res=tres, tel=ttel,
                              cfg=GPTConfig(**kw), params=tparams,
                              extra={"device": "cpu"})
    return j, t


def _toks(rng, n):
    return [int(x) for x in rng.integers(0, 128, size=n)]


def _outcome(reqs):
    return [(r.rid, r.status.value, r.end_reason, list(r.out_tokens),
             r.retries, r.restarts, r.preemptions) for r in reqs]


def _both(twins, scenario, **kw):
    """Run ``scenario(ns, **kw)`` for the JAX package then the port;
    returns both results."""
    return [scenario(ns, **kw) for ns in twins]


# ---------------------------------------------------------------------------
# the host policies, verdict for verdict
# ---------------------------------------------------------------------------

def _reason(r):
    return None if r is None else (r.code.value, r.message, r.detail)


def _admission_script(rob, sv, seed):
    """A random script over one controller: checks, probes, boundaries,
    observed step times, caps and shed-victim picks; returns every
    verdict and the controller's counters."""
    rng = np.random.default_rng(seed)
    ctl = rob.AdmissionController(
        rob.AdmissionConfig(max_queue=8, high_watermark=0.5,
                            low_watermark=0.25,
                            step_time_init_s=float(rng.choice([0.0, 0.01])),
                            ewma_alpha=0.3),
        n_slots=2, degradation=rob.DegradationPolicy(
            shed_after=2, cap_max_new=int(rng.integers(2, 6))))
    out = []
    for i in range(60):
        req = sv.Request(
            prompt=list(range(int(rng.integers(1, 12)))),
            max_new_tokens=int(rng.integers(1, 16)), rid=5000 + i,
            priority=int(rng.integers(0, 3)),
            latency_budget_ms=(float(rng.integers(20, 400))
                               if rng.random() < 0.5 else None),
            ttft_budget_ms=(float(rng.integers(10, 200))
                            if rng.random() < 0.4 else None))
        if rng.random() < 0.2:
            req.t_first_token = 1.0
        depth = int(rng.integers(0, 10))
        queued = int(rng.integers(0, 80))
        op = int(rng.integers(0, 5))
        if op == 0:
            out.append(("check", _reason(ctl.check(
                req, queue_depth=depth, queued_tokens=queued,
                prefill_steps=int(rng.integers(1, 6))))))
        elif op == 1:
            out.append(("probe", _reason(ctl.probe(
                req, queue_depth=depth, queued_tokens=queued))))
        elif op == 2:
            out.append(("boundary", ctl.note_boundary(depth)))
        elif op == 3:
            ctl.observe_step(float(rng.uniform(-0.001, 0.03)))
            out.append(("est", ctl.est_step_s))
        else:
            out.append(("cap", ctl.cap_for(req, depth)))
            waiting = [sv.Request(prompt=[1] * int(rng.integers(1, 9)),
                                  max_new_tokens=int(rng.integers(1, 9)),
                                  rid=9000 + 10 * i + w,
                                  priority=int(rng.integers(0, 3)),
                                  latency_budget_ms=float(
                                      rng.integers(10, 300)))
                       for w in range(int(rng.integers(0, 5)))]
            v = ctl.pick_shed_victim(waiting, queued)
            out.append(("shed", None if v is None else v.rid))
        out.append(("latch", ctl.backpressure, ctl.high_count,
                    ctl.low_count))
    out.append(("counters", ctl.rejected, ctl.shed, ctl.max_queue_seen))
    return out


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_admission_controller_matches_jax(seed):
    want = _admission_script(jrob, jserving, seed)
    got = _admission_script(trob, tserving, seed)
    assert got == want
    kinds = {v[0] for v in got}
    assert {"check", "probe", "boundary", "cap", "shed"} <= kinds


def test_admission_controller_scripted():
    """The JAX package's own scripted hysteresis and feasibility cases,
    on the port."""
    ctl = trob.AdmissionController(
        trob.AdmissionConfig(max_queue=8, high_watermark=0.5,
                             low_watermark=0.25), n_slots=1)
    req = tserving.Request(prompt=[1, 2], max_new_tokens=4)
    assert ctl.check(req, queue_depth=0, queued_tokens=0) is None
    assert ctl.check(req, queue_depth=8, queued_tokens=48).code is \
        trob.RejectionCode.QUEUE_FULL
    assert ctl.check(req, queue_depth=4, queued_tokens=24).code is \
        trob.RejectionCode.BACKPRESSURE
    assert ctl.check(req, queue_depth=3, queued_tokens=18).code is \
        trob.RejectionCode.BACKPRESSURE
    assert ctl.check(req, queue_depth=2, queued_tokens=12) is None
    assert ctl.rejected == 3
    ctl = trob.AdmissionController(
        trob.AdmissionConfig(max_queue=64, step_time_init_s=0.010),
        n_slots=2)
    tight = tserving.Request(prompt=list(range(8)), max_new_tokens=8,
                             latency_budget_ms=200.0)
    r = ctl.check(tight, queue_depth=2, queued_tokens=32)
    assert r.code is trob.RejectionCode.DEADLINE_INFEASIBLE
    assert r.detail["latency_lb_ms"] == pytest.approx(320.0)


def test_request_expired_matches_jax():
    rng = np.random.default_rng(3)
    for i in range(300):
        fields = dict(
            t_arrival=(float(rng.uniform(0, 5)) if rng.random() < 0.9
                       else None),
            t_first_token=(float(rng.uniform(0, 9)) if rng.random() < 0.4
                           else None),
            latency_budget_ms=(float(rng.uniform(0, 6000))
                               if rng.random() < 0.6 else None),
            ttft_budget_ms=(float(rng.uniform(0, 4000))
                            if rng.random() < 0.6 else None))
        now = float(rng.uniform(0, 10))
        verdicts = []
        for sv, rob in ((jserving, jrob), (tserving, trob)):
            r = sv.Request(prompt=[1], max_new_tokens=1, rid=i)
            for k, v in fields.items():
                setattr(r, k, v)
            verdicts.append(rob.request_expired(r, now))
        assert verdicts[0] == verdicts[1], (fields, now)


def test_virtual_clock_and_request_storm():
    clock = trob.VirtualClock(dt=0.5, start=1.0)
    assert [clock(), clock(), clock()] == [1.5, 2.0, 2.5]
    cfg = GPTConfig(num_layers=1, hidden_size=64, num_attention_heads=4,
                    vocab_size=64, max_position_embeddings=32)
    from apex_tpu_torch.transformer.testing import init_gpt_params

    eng = tserving.ServingEngine(
        cfg, init_gpt_params(cfg, torch.Generator().manual_seed(0)),
        device="cpu", n_slots=1, num_pages=2, max_prompt_len=16)
    storm = tres.request_storm(eng)
    assert {c for _, c in storm} >= {
        trob.RejectionCode.EMPTY_PROMPT, trob.RejectionCode.BAD_MAX_NEW,
        trob.RejectionCode.PROMPT_TOO_LONG,
        trob.RejectionCode.EXCEEDS_MAX_SEQ,
        trob.RejectionCode.POOL_INFEASIBLE}
    for req, code in storm:
        assert eng.try_submit(req).code is code
        assert req.status is tserving.RequestStatus.REJECTED
    assert eng.scheduler.idle and eng.scheduler.allocator.used_count == 0


# ---------------------------------------------------------------------------
# the engine under VirtualClock: admission, degradation, deadlines
# ---------------------------------------------------------------------------

def _overload(ns, prefill_chunk, spec_k):
    rng = np.random.default_rng(23)
    reqs = []
    for i in range(14):
        reqs.append(ns.sv.Request(
            prompt=_toks(rng, int(rng.integers(3, 11))),
            max_new_tokens=int(rng.integers(4, 10)),
            arrival_step=int(i * 2), rid=100 + i,
            priority=int(rng.integers(0, 3)),
            latency_budget_ms=(float(rng.integers(40, 140)) * 1e3
                               if rng.random() < 0.6 else None),
            ttft_budget_ms=(float(rng.integers(4, 12)) * 1e3
                            if rng.random() < 0.4 else None)))
    ring = ns.tel.RingBufferRecorder()
    eng = ns.sv.ServingEngine(
        ns.cfg, ns.params, n_slots=2, num_pages=9, max_prompt_len=32,
        clock=ns.sv.VirtualClock(dt=1.0), sink=ring,
        prefill_chunk=prefill_chunk, spec_k=spec_k,
        admission=ns.sv.AdmissionConfig(max_queue=5, high_watermark=0.6,
                                        low_watermark=0.2,
                                        step_time_init_s=1.0),
        degradation=ns.sv.DegradationPolicy(shed_after=2, cap_max_new=5),
        **ns.extra)
    eng.generate(reqs, max_steps=3000)
    eng.scheduler.check_invariants()
    st = eng.last_stats
    events = {k: [(e["rid"], e.get("code"), e.get("max_new_tokens"))
                  for e in ring.events(k)]
              for k in ("reject", "shed", "degrade")}
    return dict(outcome=_outcome(reqs), by_status=st["by_status"],
                keys={k: st[k] for k in ("steps", "slo_attained",
                                         "max_queue_depth", "goodput_tokens",
                                         "completed")},
                events=events, leaked=eng.scheduler.allocator.used_count,
                t=[(r.t_arrival, r.t_first_token, r.t_done) for r in reqs])


@pytest.mark.parametrize("prefill_chunk,spec_k", [(1, 0), (4, 0), (4, 2)],
                         ids=["chunk1", "chunk4", "chunk4-spec2"])
def test_overload_under_virtual_clock_matches_jax(twins, prefill_chunk,
                                                  spec_k):
    want, got = _both(twins, _overload, prefill_chunk=prefill_chunk,
                      spec_k=spec_k)
    assert got["outcome"] == want["outcome"]
    assert got["by_status"] == want["by_status"]
    assert got["keys"] == want["keys"]
    assert got["events"] == want["events"]
    # clock reads at the same points: every stamp equal
    assert got["t"] == want["t"]
    assert got["leaked"] == 0
    bs = got["by_status"]
    assert bs["completed"] and bs["rejected"] and bs["timed_out"], bs
    assert got["events"]["reject"]


# ---------------------------------------------------------------------------
# fault paths, outcome against outcome
# ---------------------------------------------------------------------------

def _poison(ns):
    r = np.random.default_rng(99)
    reqs = [ns.sv.Request(prompt=_toks(r, L), max_new_tokens=6,
                          arrival_step=2 * i, rid=200 + i)
            for i, L in enumerate((6, 9, 4, 7))]
    chaos = ns.res.ServingChaos().poison_request(201, at_step=9)
    ring = ns.tel.RingBufferRecorder()
    eng = ns.sv.ServingEngine(ns.cfg, ns.params, n_slots=2, num_pages=12,
                              max_prompt_len=16, chaos=chaos, sink=ring,
                              **ns.extra)
    eng.generate(reqs, max_steps=2000)
    eng.scheduler.check_invariants()
    failed = [e["failure"] for e in ring.events("request_end")
              if e["status"] == "failed"]
    return dict(outcome=_outcome(reqs), fired=chaos.faults_fired,
                failure=reqs[1].failure, failed=failed,
                leaked=eng.scheduler.allocator.used_count)


def test_poison_quarantine_matches_jax(twins):
    want, got = _both(twins, _poison)
    assert got == want
    assert got["fired"] == [("poison", 201, 9)]
    assert got["failure"]["kind"] == "nonfinite_logits"
    assert got["leaked"] == 0


def test_poison_isolation_is_bitwise(twins):
    """The non-victims' tokens equal a clean run's, and the port's dense
    reference."""
    _, t = twins
    r = np.random.default_rng(99)
    reqs = [t.sv.Request(prompt=_toks(r, L), max_new_tokens=6,
                         arrival_step=2 * i, rid=200 + i)
            for i, L in enumerate((6, 9, 4, 7))]
    out_clean = t.sv.ServingEngine(t.cfg, t.params, n_slots=2,
                                   num_pages=12, max_prompt_len=16,
                                   **t.extra).generate(reqs, max_steps=2000)
    poisoned = _poison(t)["outcome"]
    for rid, status, _, toks, *_ in poisoned:
        if rid == 201:
            assert status == "failed"
            continue
        assert status == "completed" and toks == out_clean[rid]
        req = next(q for q in reqs if q.rid == rid)
        assert toks == tdm.reference_decode(t.cfg, t.params, req.prompt, 6)


def _kill_recover(ns):
    rng = np.random.default_rng(31)
    reqs = [ns.sv.Request(prompt=_toks(rng, L), max_new_tokens=6,
                          arrival_step=i, rid=300 + i)
            for i, L in enumerate((8, 5, 11))]
    chaos = ns.res.ServingChaos().kill_engine_at(10)
    ring = ns.tel.RingBufferRecorder()
    eng = ns.sv.ServingEngine(ns.cfg, ns.params, n_slots=2, num_pages=12,
                              max_prompt_len=16, chaos=chaos, sink=ring,
                              **ns.extra)
    with pytest.raises(ns.res.ChaosError, match="injected engine kill"):
        eng.generate(list(reqs), max_steps=2000)
    stranded = [(r.rid, r.status.value, list(r.out_tokens)) for r in reqs]
    eng2, survivors = ns.sv.ServingEngine.recover_from(eng)
    assert eng2.sink is ring
    eng2.generate(survivors, max_steps=2000)
    eng2.scheduler.check_invariants()
    rec = ring.events("engine_recovery")
    return dict(stranded=stranded, survivors=[r.rid for r in survivors],
                outcome=_outcome(reqs),
                recovery=[(e["recovered"], e["rids"], e["dead_steps_run"])
                          for e in rec],
                blackbox=[e["reason"] for e in ring.events("blackbox")],
                leaked=eng2.scheduler.allocator.used_count)


def test_kill_and_recover_matches_jax(twins):
    want, got = _both(twins, _kill_recover)
    assert got == want
    assert got["survivors"] and got["leaked"] == 0
    assert got["blackbox"] == ["engine_recovery"]
    assert all(s == "completed" for _, s, *_ in got["outcome"])


def _wedge(ns):
    rng = np.random.default_rng(41)
    req = ns.sv.Request(prompt=_toks(rng, 4), max_new_tokens=6, rid=400)
    chaos = ns.res.ServingChaos().wedge_step_at(5, stall_s=1.0)
    ring = ns.tel.RingBufferRecorder()
    wd = ns.res.HangWatchdog(timeout_s=0.2, poll_s=0.02, sink=ring)
    eng = ns.sv.ServingEngine(ns.cfg, ns.params, n_slots=1, num_pages=8,
                              max_prompt_len=16, chaos=chaos, watchdog=wd,
                              sink=ring, **ns.extra)
    with pytest.raises(ns.res.HangError) as e:
        eng.generate([req], max_steps=100)
    wd.close()
    hangs = ring.events("hang")
    stranded = list(req.out_tokens)
    eng2, survivors = ns.sv.ServingEngine.recover_from(eng, watchdog=None)
    eng2.generate(survivors, max_steps=200)
    return dict(what=e.value.what, hang_steps=[h["step"] for h in hangs],
                main_in_stacks=all("MainThread" in h["stacks"]
                                   for h in hangs),
                fired=chaos.faults_fired, stranded=stranded,
                survivors=[r.rid for r in survivors],
                outcome=_outcome([req]),
                blackbox=[b["reason"] for b in ring.events("blackbox")])


def test_wedge_under_watchdog_matches_jax(twins):
    want, got = _both(twins, _wedge)
    assert got == want
    assert got["what"] == "serving_step_host_sync"
    assert got["hang_steps"] == [5] and got["main_in_stacks"]
    assert got["blackbox"] == ["hang", "engine_recovery"]
    assert got["outcome"][0][1] == "completed"


def _retry(ns):
    rng = np.random.default_rng(21)
    reqs = [ns.sv.Request(prompt=_toks(rng, L), max_new_tokens=6,
                          rid=500 + i) for i, L in enumerate((5, 8))]
    chaos = ns.res.ServingChaos().poison_request(500, at_step=6)
    eng = ns.sv.ServingEngine(ns.cfg, ns.params, n_slots=2, num_pages=12,
                              max_prompt_len=16, chaos=chaos, **ns.extra)
    eng.generate(list(reqs), max_steps=2000,
                 retry_failed=ns.res.RetryPolicy(attempts=3,
                                                 retry_on=(Exception,),
                                                 deadline=60.0))
    st = eng.last_stats
    return dict(outcome=_outcome(reqs), retries=st["retries"],
                by_status=st["by_status"], fired=chaos.faults_fired)


def test_retry_failed_matches_jax(twins):
    want, got = _both(twins, _retry)
    assert got == want
    assert got["retries"] == 1 and got["by_status"]["completed"] == 2


def _cancel(ns):
    rng = np.random.default_rng(2)
    eng = ns.sv.ServingEngine(ns.cfg, ns.params, n_slots=1, num_pages=8,
                              max_prompt_len=16, **ns.extra)
    running = ns.sv.Request(prompt=_toks(rng, 6), max_new_tokens=8, rid=600)
    queued = ns.sv.Request(prompt=_toks(rng, 6), max_new_tokens=8, rid=601)
    eng.submit(running)
    eng.submit(queued)
    for _ in range(7):
        eng.run_step()
    states = [running.status.value]
    states.append(eng.cancel(queued))
    states.append(eng.cancel(running))
    states.append(eng.cancel(running))
    eng.scheduler.check_invariants()
    return dict(states=states, outcome=_outcome([running, queued]),
                idle=eng.scheduler.idle,
                leaked=eng.scheduler.allocator.used_count)


def test_cancel_matches_jax(twins):
    want, got = _both(twins, _cancel)
    assert got == want
    assert got["states"] == ["running", True, True, False]
    assert got["idle"] and got["leaked"] == 0


def _swap(ns, new_params):
    rng = np.random.default_rng(8)
    head = _toks(rng, 20)
    ring = ns.tel.RingBufferRecorder()
    eng = ns.sv.ServingEngine(ns.cfg, ns.params, n_slots=2, num_pages=12,
                              max_prompt_len=32, sink=ring, **ns.extra)

    def trace(base):
        return [ns.sv.Request(prompt=head + _toks(rng, 3), max_new_tokens=5,
                              arrival_step=3 * i, rid=base + i)
                for i in range(2)]

    first = trace(700)
    eng.generate(first, max_steps=500)
    entries = len(eng.prefix_cache)
    eng.swap_params(new_params)
    flushes = [e["entries"] for e in ring.events("prefix_cache_flush")]
    second = trace(710)
    eng.generate(second, max_steps=500)
    eng.scheduler.check_invariants()
    return dict(entries=entries, flushes=flushes,
                after=len(eng.prefix_cache) > 0,
                outcome=_outcome(first + second),
                hits=eng.last_stats["prefix_cache"]["hits"],
                leaked=eng.scheduler.allocator.used_count)


def test_swap_params_flushes_prefix_cache_like_jax(twins):
    j, t = twins
    jnew = jax.tree_util.tree_map(lambda x: x * 1.5, j.params)
    tnew = params_from_jax(jax.tree_util.tree_map(np.asarray, jnew), CPU)
    want = _swap(j, jnew)
    got = _swap(t, tnew)
    assert got == want
    assert got["entries"] > 0 and got["flushes"] == [got["entries"]]
    # the second trace cannot hit the old weights' pages: its hits are
    # its own publications, made under the new weights
    assert got["after"] and got["hits"] == want["hits"]


def _chaos_trace(ns, seed):
    rng = np.random.default_rng(seed)
    reqs = []
    for i in range(6):
        reqs.append(ns.sv.Request(
            prompt=_toks(rng, int(rng.integers(3, 10))), max_new_tokens=6,
            arrival_step=int(rng.integers(0, 10)), rid=800 + i,
            priority=int(rng.integers(0, 3)),
            latency_budget_ms=(float(rng.integers(8, 80)) * 1e3
                               if rng.random() < 0.5 else None)))
    chaos = ns.res.ServingChaos().fail_allocs(int(rng.integers(1, 4)))
    chaos.poison_request(800 + int(rng.integers(0, 6)))
    eng = ns.sv.ServingEngine(
        ns.cfg, ns.params, n_slots=2, num_pages=5, max_prompt_len=16,
        chaos=chaos, clock=ns.sv.VirtualClock(dt=1.0),
        admission=ns.sv.AdmissionConfig(max_queue=6, high_watermark=0.84,
                                        low_watermark=0.5),
        degradation=ns.sv.DegradationPolicy(shed_after=3), **ns.extra)
    pending = sorted(reqs, key=lambda r: (r.arrival_step, r.rid))
    step_i = 0
    for _ in range(600):
        while pending and pending[0].arrival_step <= step_i:
            eng.try_submit(pending.pop(0))
        if not pending and eng.scheduler.idle:
            break
        if not eng.scheduler.idle:
            eng.run_step()
        step_i += 1
        eng.scheduler.check_invariants()
    return dict(outcome=_outcome(reqs), fired=chaos.faults_fired,
                leaked=eng.scheduler.allocator.used_count)


@pytest.mark.parametrize("seed", [1234, 77])
def test_chaos_trace_matches_jax(twins, seed):
    want, got = _both(twins, _chaos_trace, seed=seed)
    assert got == want
    assert got["leaked"] == 0
    assert all(s in ("completed", "failed", "rejected", "timed_out")
               for _, s, *_ in got["outcome"])
    for _, status, _, toks, *_ in got["outcome"]:
        if status == "completed":
            assert len(toks) == 6


def test_probe_mutates_nothing(twins):
    """``probe`` is read-only: no stamp, no status, no latch, and its
    verdict and estimate are the JAX engine's."""
    res = []
    for ns in twins:
        eng = ns.sv.ServingEngine(
            ns.cfg, ns.params, n_slots=1, num_pages=8, max_prompt_len=16,
            admission=ns.sv.AdmissionConfig(max_queue=2, high_watermark=0.5,
                                            low_watermark=0.0),
            **ns.extra)
        a = ns.sv.Request(prompt=[1, 2, 3], max_new_tokens=4, rid=1)
        b = ns.sv.Request(prompt=[4, 5], max_new_tokens=4, rid=2)
        eng.submit(a)
        reason, est = eng.probe(b)
        res.append((_reason(reason), est, b.status.value, b.t_arrival,
                    eng.admission.backpressure, eng.admission.rejected))
        assert eng.try_submit(b).code.value == "backpressure"
    assert res[1] == res[0]
    assert res[1][0][0] == "backpressure" and res[1][2] == "pending"


def _forced_eviction(ns):
    """A warm prefix cache, then forced evictions at the boundary a
    request holding the cached head is running: ``evict_one`` frees only
    zero-reader entries, and the tokens stay those of the JAX engine."""
    rng = np.random.default_rng(14)
    head = _toks(rng, 24)
    eng = ns.sv.ServingEngine(ns.cfg, ns.params, n_slots=2, num_pages=12,
                              max_prompt_len=40,
                              chaos=ns.res.ServingChaos(), **ns.extra)
    first = [ns.sv.Request(prompt=head + _toks(rng, 2), max_new_tokens=4,
                           rid=750)]
    eng.generate(first, max_steps=500)
    before = eng.prefix_cache.stats()
    second = [ns.sv.Request(prompt=head + _toks(rng, 3), max_new_tokens=6,
                            arrival_step=0, rid=751),
              ns.sv.Request(prompt=_toks(rng, 5), max_new_tokens=6,
                            arrival_step=2, rid=752)]
    eng.submit(second[0])
    eng.run_step()            # 751 admitted on the cached head
    eng._chaos.evict_prefix_cache(50)
    eng.generate(second[1:], max_steps=500)
    eng.scheduler.check_invariants()
    return dict(before=before, after=eng.prefix_cache.stats(),
                outcome=_outcome(first + second),
                fired=eng._chaos.faults_fired,
                leaked=eng.scheduler.allocator.used_count)


def test_forced_cache_eviction_matches_jax(twins):
    want, got = _both(twins, _forced_eviction)
    assert got == want
    assert got["before"]["entries"] > 0 and got["after"]["evictions"] > 0
    assert got["fired"] == [("cache_evict", 50)]
    assert got["leaked"] == 0
