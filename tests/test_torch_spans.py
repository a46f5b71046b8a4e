"""Request tracing of apex_tpu_torch against apex_tpu on the CPU.

A traced serving run (``trace=True``, ``telemetry_every=4``,
``record_every=4``) under ``VirtualClock`` with a poisoned request,
stolen allocations (preemption), a prefix hit and an engine kill with
recovery goes through both packages on the same trace; the records each
writes to its sink are compared:

- span records field for field, span ids mapped to their order of
  allocation (the id counter is process-global in each package), and the
  flight-recorder black box of the recovery;
- ``request_end``, ``serving_step`` and the ``serving`` metrics records
  exactly, apart from ``t_wall`` and the drain's host-clock rates;
- the structure on the port's own: one terminal span per offered
  request, every tree rooted, the TTFT attribution terms summing to the
  measured TTFT, ``steps // 4`` metrics records and one
  ``serving_summary``.

The ``telemetry.spans`` helpers (the attribution ledger, dominant cause,
the summary fold, the black-box dump) are also held against the JAX
package's on scripted inputs.
"""
import json
import types

import jax
import numpy as np
import pytest
import torch

import apex_tpu.resilience as jres
import apex_tpu.serving as jserving
from apex_tpu import telemetry as jtel
from apex_tpu.transformer.testing import GPTConfig as JGPTConfig
from apex_tpu.transformer.testing import init_gpt_params as jinit
import apex_tpu_torch.resilience as tres
import apex_tpu_torch.serving as tserving
from apex_tpu_torch import telemetry as ttel
from apex_tpu_torch.convert import params_from_jax
from apex_tpu_torch.transformer.testing import GPTConfig

CPU = torch.device("cpu")


@pytest.fixture(scope="module", autouse=True)
def _shed_compile_caches():
    """Each JAX engine here compiles its own step programs; drop them
    with the module (the CPU suite runs near its memory ceiling)."""
    yield
    jax.clear_caches()

#: host-clock fields of a metrics drain (wall time between drains)
_HOST_RATES = ("t_wall", "wall_dt_s", "steps_per_sec", "tokens_per_sec")


def _twins():
    kw = dict(num_layers=2, hidden_size=64, num_attention_heads=4,
              vocab_size=128, max_position_embeddings=64)
    jcfg = JGPTConfig(hidden_dropout=0.0, attention_dropout=0.0, **kw)
    jparams = jinit(jcfg, jax.random.PRNGKey(0))
    jparams["embedding"]["position"] = jparams["embedding"]["position"] * 40
    tparams = params_from_jax(
        jax.tree_util.tree_map(np.asarray, jparams), CPU)
    return (types.SimpleNamespace(sv=jserving, res=jres, tel=jtel, cfg=jcfg,
                                  params=jparams, extra={},
                                  barrier=jax.effects_barrier),
            types.SimpleNamespace(sv=tserving, res=tres, tel=ttel,
                                  cfg=GPTConfig(**kw), params=tparams,
                                  extra={"device": "cpu"},
                                  barrier=ttel.flush))


def _traced_run(ns):
    rng = np.random.default_rng(61)
    head = [int(t) for t in rng.integers(0, 128, size=16)]
    reqs = []
    for i in range(6):
        tail = [int(t) for t in rng.integers(0, 128, size=2 + i)]
        reqs.append(ns.sv.Request(
            prompt=(head + tail) if i % 2 == 0 else tail + head[:3],
            max_new_tokens=6, arrival_step=2 * i, rid=60 + i,
            latency_budget_ms=(30e3 if i == 4 else None),
            ttft_budget_ms=(8e3 if i == 5 else None)))
    # refused at the door: a reject record and a one-span trace
    reqs.append(ns.sv.Request(prompt=[], max_new_tokens=2, arrival_step=3,
                              rid=66))
    chaos = (ns.res.ServingChaos().poison_request(61, at_step=8)
             .fail_allocs(2).kill_engine_at(14))
    ring = ns.tel.RingBufferRecorder(capacity=100000)
    kw = dict(n_slots=2, num_pages=6, max_prompt_len=32,
              prefill_chunk=4, clock=ns.sv.VirtualClock(dt=1.0), sink=ring,
              chaos=chaos, telemetry_every=4, record_every=4, trace=True,
              **ns.extra)
    eng = ns.sv.ServingEngine(ns.cfg, ns.params, **kw)
    with pytest.raises(ns.res.ChaosError):
        eng.generate(reqs, max_steps=3000)
    ns.barrier()
    steps_dead = eng.steps_run
    eng2, survivors = ns.sv.ServingEngine.recover_from(eng)
    eng2.generate(survivors, max_steps=3000)
    ns.barrier()
    return dict(records=list(ring.records), reqs=reqs, eng=eng2,
                steps=(steps_dead, eng2.last_stats["steps"]),
                fired=chaos.faults_fired)


@pytest.fixture(scope="module")
def runs():
    return [_traced_run(ns) for ns in _twins()]


def _canon(records, kinds):
    """The records of ``kinds`` with ``t_wall`` and the drain's host
    rates dropped and span ids renamed by first appearance."""
    ids = {}

    def cid(v):
        if v is None:
            return None
        return ids.setdefault(v, len(ids))

    out = []
    for r in records:
        if r.get("event") not in kinds:
            continue
        r = {k: v for k, v in r.items() if k not in _HOST_RATES}
        for key in ("span_id", "parent_id"):
            if key in r:
                r[key] = cid(r[key])
        out.append(json.loads(json.dumps(r, sort_keys=True)))
    return out


def test_fault_schedule_fired_alike(runs):
    j, t = runs
    assert t["fired"] == j["fired"]
    kinds = {f[0] for f in t["fired"]}
    assert {"poison", "alloc", "kill"} <= kinds
    assert t["steps"] == j["steps"]


def test_span_records_match_jax(runs):
    want = _canon(runs[0]["records"], {"span"})
    got = _canon(runs[1]["records"], {"span"})
    assert len(got) == len(want)
    assert got == want
    names = {r["name"] for r in got}
    assert {"admission", "admit", "prefill", "decode", "request",
            "quarantine", "preempt"} <= names


def test_blackbox_matches_jax(runs):
    """The dead engine's flight ring replayed at recovery: the header
    and every ring span (``ring_only`` step spans included)."""
    want = _canon(runs[0]["records"], {"blackbox"})
    got = _canon(runs[1]["records"], {"blackbox"})
    assert got == want and len(got) == 1
    assert got[0]["reason"] == "engine_recovery"
    ring_spans = [r for r in runs[1]["records"]
                  if r.get("blackbox_replay")]
    assert len(ring_spans) == got[0]["n_spans"] > 0
    assert any(r["name"] == "engine_step" for r in ring_spans)


@pytest.mark.parametrize("kind", ["request_end", "serving_step", "reject",
                                  "engine_recovery", "metrics"])
def test_host_records_match_jax(runs, kind):
    want = _canon(runs[0]["records"], {kind})
    got = _canon(runs[1]["records"], {kind})
    assert got == want
    assert got, f"the run writes {kind} records"


def test_one_terminal_span_per_request_and_rooted_trees(runs):
    recs = [r for r in runs[1]["records"]
            if r.get("event") == "span" and not r.get("blackbox_replay")]
    reqs = runs[1]["reqs"]
    terminal = [r for r in recs if r["terminal"]]
    assert sorted(r["rid"] for r in terminal) == sorted(q.rid for q in reqs)
    roots = {r["span_id"]: r["trace_id"] for r in terminal}
    for r in recs:
        if r["terminal"] or r["trace_id"] == "engine-steps":
            continue
        assert roots.get(r["parent_id"]) == r["trace_id"], r
        assert r["t_start"] <= r["t_end"]


def test_ttft_terms_sum_to_measured_ttft(runs):
    reqs = [q for q in runs[1]["reqs"] if q.t_first_token is not None]
    assert reqs
    for q in reqs:
        measured = q.t_first_token - q.t_arrival
        assert sum(q.attr_ttft.values()) == pytest.approx(measured,
                                                          rel=1e-9)
    summ = runs[1]["eng"].last_stats["attribution"]
    assert summ["ttft_sum_rel_err_max"] <= 1e-9


def test_metrics_cadence_and_summary_record(runs):
    t = runs[1]
    recs = t["records"]
    metrics = [r for r in recs if r.get("event") == "metrics"]
    assert all(r["tag"] == "serving" for r in metrics)
    # the drain counts every step the engines ran (the dead one's too:
    # the recovered engine starts a fresh window)
    assert len(metrics) == t["steps"][0] // 4 + t["steps"][1] // 4
    summaries = [r for r in recs if r.get("event") == "serving_summary"]
    assert len(summaries) == 1
    assert summaries[0]["steps"] == t["steps"][1]
    jsum = [r for r in runs[0]["records"]
            if r.get("event") == "serving_summary"][0]
    for key in ("by_status", "steps", "generated_tokens", "preemptions",
                "slo_attained", "drafted_tokens", "max_queue_depth",
                "completed", "retries"):
        assert summaries[0][key] == jsum[key], key


# ---------------------------------------------------------------------------
# the spans helpers on scripted inputs
# ---------------------------------------------------------------------------

def _ledger(sv, tel):
    """A scripted ledger walk: init, accounts over every term, a TTFT
    snapshot, a no-op backwards account."""
    r = sv.Request(prompt=[1, 2], max_new_tokens=3, rid=1)
    tel.attr_init(r, 1.0)
    tel.attr_init(r, 5.0)            # idempotent
    for now, term in ((2.5, "queue_wait"), (4.0, "cached_skip"),
                      (4.0, "decode"), (7.25, "prefill_compute"),
                      (6.0, "replay"), (9.0, "migration")):
        tel.attr_account(r, now, term)
    tel.attr_snapshot_ttft(r)
    tel.attr_account(r, 12.0, "decode")
    tel.attr_snapshot_ttft(r)        # first snapshot wins
    fresh = sv.Request(prompt=[1], max_new_tokens=1, rid=2)
    tel.attr_account(fresh, 3.0, "decode")   # starts the ledger
    return r, fresh


def test_attribution_ledger_matches_jax():
    (jr, jf), (tr, tf) = _ledger(jserving, jtel), _ledger(tserving, ttel)
    assert tr.attr == jr.attr and tr.attr_ttft == jr.attr_ttft
    assert tf.attr == jf.attr and tf._t_attr == jf._t_attr
    assert ttel.dominant_cause(tr.attr) == jtel.dominant_cause(jr.attr)
    assert ttel.dominant_cause({t: 0.0 for t in ttel.ATTR_TERMS}) is None
    assert ttel.ATTR_TERMS == jtel.ATTR_TERMS


def test_attribution_summary_matches_jax():
    def fold(sv, tel):
        reqs = []
        rng = np.random.default_rng(4)
        for i in range(5):
            r = sv.Request(prompt=[1], max_new_tokens=1, rid=i)
            r.t_arrival = float(i)
            tel.attr_init(r, r.t_arrival)
            t = r.t_arrival
            for term in tel.ATTR_TERMS:
                t += float(rng.uniform(0, 2))
                tel.attr_account(r, t, term)
                if term == "prefill_compute":
                    r.t_first_token = t
                    tel.attr_snapshot_ttft(r)
            reqs.append(r)
        reqs.append(sv.Request(prompt=[1], max_new_tokens=1, rid=9))
        return tel.attribution_summary(reqs, violators=reqs[:3])

    got, want = fold(tserving, ttel), fold(jserving, jtel)
    assert json.dumps(got, sort_keys=True) == json.dumps(want,
                                                         sort_keys=True)
    assert ttel.attribution_summary([]) is None


def test_tracer_blackbox_dump_matches_jax(tmp_path):
    dumps = []
    for tel, name in ((jtel, "j"), (ttel, "t")):
        clock = iter([10.0, 20.0])
        ring = tel.RingBufferRecorder()
        tr = tel.Tracer(sink=ring, clock=lambda: next(clock),
                        ring_capacity=3, tags={"replica": 1})
        for i in range(5):
            tr.emit("step", "engine-steps", float(i), float(i) + 0.5,
                    ring_only=i % 2 == 0, step=i)
        path = tmp_path / f"{name}.jsonl"
        recs = tr.dump_blackbox(reason="hang", path=str(path),
                                stacks="--- thread MainThread ---")
        lines = [json.loads(x) for x in path.read_text().splitlines()]
        dumps.append((_canon(recs, {"span", "blackbox"}),
                      _canon(lines, {"span", "blackbox"}),
                      _canon(ring.records, {"span"})))
    assert dumps[1] == dumps[0]
    assert len(dumps[1][0]) == 4 and dumps[1][0][0]["n_spans"] == 3
