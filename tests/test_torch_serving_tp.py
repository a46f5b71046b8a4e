"""Tensor-parallel serving of the port in a gloo world of 4 against the
port's TP 1 engine and the JAX package's TP engine on 2 and 4 of the 8
CPU devices of ``tests/conftest.py`` (the mirror of
``tools/serving_check.check_tp_identity`` and the ``test_tp_*`` tests of
``tests/test_serving.py``).

One gloo world of 4 CPU processes is spawned once for the file
(``test_torch_tensor_parallel.spawn_world``). Every rank builds the same
engines from the same weights (the JAX tiny model's, through
``convert.params_from_jax``) and drives the same trace: first one TP 4
engine over the whole world, then, with ``parallel_state`` at tensor
groups of 2, a TP 2 engine on ranks 0-1 and another on ranks 2-3. The
trace is ``check_tp_identity``'s: five staggered requests (greedy rows,
a top-k + top-p row, a no-filter temperature-1.4 row, a top-p row),
chunked prefill of 3, ``spec_k=2`` and a pool of 6 pages, small enough
to force preemption. The same ranks then run: the deep-``top_k``
refusal; ``rebuild_like`` and ``swap_params`` at TP 2; the summary's
``tp`` / ``kv_bytes_per_shard`` / ``psum_per_program`` of a plain
engine; and the skewed-clock run: ranks 0-1 serve an overload trace
under admission, degradation and deadline budgets with rank 0's
``VirtualClock`` at 1 s a read and rank 1's at 7 s a read from 500 s.

Held: tokens equal, token for token, to the port's TP 1 engine's and
to the JAX TP engine's at the same TP (exact: the decisions are argmax
and Gumbel-max over logits that differ by summation order only); every
rank of a group emits the same tokens; no page leaks; each program's
``psum`` count is 3; a rank's pool is ``1 / tp`` of the whole; under
the skewed clocks rank 1's outcomes, events and request timestamps equal
rank 0's, which equal the TP 1 engine's on rank 0's clock.
"""
import jax
import numpy as np
import pytest

from apex_tpu.serving import (
    Request as JRequest,
    SamplingParams as JSamplingParams,
    ServingEngine as JServingEngine,
)
from test_torch_tensor_parallel import flat, spawn_world
from tools.serving_check import _tiny_cfg, _tiny_params

WORLD = 4
TRACE = dict(n_slots=2, num_pages=6, max_prompt_len=16, prefill_chunk=3,
             spec_k=2)
#: (prompt length, sampling) of check_tp_identity's five requests
ROWS = ((14, None), (11, (0.9, 12, 0.9, 17)), (13, (1.4, 0, 1.0, 23)),
        (9, None), (12, (0.8, 0, 0.8, 29)))
SKEW = {0: (1.0, 0.0), 1: (7.0, 500.0)}  # rank: (dt, start) a clock read
#: the retry run's clocks and deadline: a retry pass reads rank 0's clock
#: far fewer than 1000 times and rank 1's at least once, so the deadline
#: of 1 s falls between them
RETRY_SKEW = {0: (1e-3, 0.0), 1: (10.0, 500.0)}
RETRY_DEADLINE = 1.0


def _prompts(vocab):
    rng = np.random.default_rng(19)
    return [rng.integers(0, vocab, size=L).tolist() for L, _ in ROWS]


def _jax_trace(cfg, params, tp):
    reqs = [JRequest(prompt=p, max_new_tokens=8, arrival_step=2 * i,
                     sampling=None if sp is None else JSamplingParams(
                         temperature=sp[0], top_k=sp[1], top_p=sp[2],
                         seed=sp[3]),
                     rid=47_000 + i)
            for i, (p, (_, sp)) in enumerate(zip(_prompts(cfg.vocab_size),
                                                 ROWS))]
    eng = JServingEngine(cfg, params, tp=tp, **TRACE)
    out = eng.generate(reqs, max_steps=2000)
    return out, eng.last_stats


_WORKER = r"""
import json, sys
import numpy as np
import torch
import torch.distributed as dist

torch.set_num_threads(1)
rank, world, store, out, inputs = (int(sys.argv[1]), int(sys.argv[2]),
                                   sys.argv[3], sys.argv[4], sys.argv[5])
spec = json.loads(sys.argv[6])
dist.init_process_group("gloo", init_method="file://" + store,
                        world_size=world, rank=rank)
from apex_tpu_torch import serving as sv
from apex_tpu_torch import telemetry as tel
from apex_tpu_torch.transformer import parallel_state as ps
from apex_tpu_torch.transformer.testing import GPTConfig

arr = dict(np.load(inputs))
res = {}

def tree(prefix):
    t = {}
    for k, v in arr.items():
        if k.startswith(prefix + "/"):
            node = t
            *path, leaf = k[len(prefix) + 1:].split("/")
            for p in path:
                node = node.setdefault(p, {})
            node[leaf] = torch.from_numpy(v)
    return t

cfg = GPTConfig(**spec["cfg"])
params, params2 = tree("params"), tree("params2")
trace = spec["trace"]

def requests():
    out = []
    for i, (p, (_, sp)) in enumerate(zip(spec["prompts"], spec["rows"])):
        samp = None if sp is None else sv.SamplingParams(
            temperature=sp[0], top_k=sp[1], top_p=sp[2], seed=sp[3])
        out.append(sv.Request(prompt=p, max_new_tokens=8,
                              arrival_step=2 * i, sampling=samp,
                              rid=47_000 + i))
    return out

def run(label, **kw):
    eng = sv.ServingEngine(cfg, params, device="cpu", **trace, **kw)
    got = eng.generate(requests(), max_steps=2000)
    eng.scheduler.check_invariants()
    for rid, toks in got.items():
        res[f"{label}/{rid}"] = np.array(toks, np.int64)
    res[f"{label}/leaks"] = np.array(eng.scheduler.allocator.used_count)
    st = eng.last_stats
    res[f"{label}/stats"] = np.array(json.dumps(
        {k: st[k] for k in ("tp", "kv_bytes_per_shard", "psum_per_program",
                            "comm_volume", "preemptions")}))
    return eng

run("tp1")
run("tp4", tp=4)
ps.initialize_model_parallel(2)
eng = run("tp2", tp=2)
res["tp2/global_bytes"] = np.array(eng.spec.cache_bytes())
res["tp2/issued"] = np.array(json.dumps(dict(eng.comm.issued)))

# the deep top_k refusal
deep = sv.SamplingParams(temperature=0.9, top_k=65, seed=3)
reason = eng._engine_reject_reason(sv.Request(prompt=[1, 2],
                                              max_new_tokens=2,
                                              sampling=deep))
res["deep/code"] = np.array(reason.code.value)
try:
    eng.submit(sv.Request(prompt=[1, 2], max_new_tokens=2, sampling=deep))
    res["deep/raised"] = np.array("")
except sv.RejectionError as e:
    res["deep/raised"] = np.array(str(e))

# rebuild_like and swap_params keep the geometry
fresh = sv.ServingEngine.rebuild_like(eng)
res["rebuild/tp"] = np.array([fresh.tp, fresh.comm.size,
                              fresh.spec_local.num_heads])
r = sv.Request(prompt=[3, 4, 5, 6], max_new_tokens=5, rid=9)
res["rebuild/tokens"] = np.array(fresh.generate([r], max_steps=200)[9])
fresh.swap_params(params2)
res["swap/qkv_rows"] = np.array(fresh.params["layers"]["qkv_w"].shape[1])
res["swap/took"] = np.array(torch.equal(fresh.params["embedding"]["position"],
                                        params2["embedding"]["position"]))
r = sv.Request(prompt=[3, 4, 5, 6], max_new_tokens=5, rid=10)
res["swap/tokens"] = np.array(fresh.generate([r], max_steps=200)[10])
for label, p in (("rebuild/tp1", params), ("swap/tp1", params2)):
    base = sv.ServingEngine(cfg, p, device="cpu", n_slots=2)
    r = sv.Request(prompt=[3, 4, 5, 6], max_new_tokens=5, rid=9)
    res[label] = np.array(base.generate([r], max_steps=200)[9])

# a plain TP 2 engine's summary
plain = sv.ServingEngine(cfg, params, device="cpu", n_slots=2, tp=2)
plain.generate([sv.Request(prompt=[1, 2, 3], max_new_tokens=4)],
               max_steps=200)
st = plain.last_stats
res["plain/stats"] = np.array(json.dumps(
    {k: st[k] for k in ("tp", "kv_bytes_per_shard", "psum_per_program")}))
res["plain/volume"] = np.array(json.dumps(st["comm_volume"]))
res["plain/local_bytes"] = np.array(plain.spec_local.cache_bytes())

# the watchdog's verdict is the group's: the second rank of each TP 2
# group wedges its fetch at step 3; every rank raises at that step, and
# the recovered engines finish the request in step
from apex_tpu_torch import resilience as rs
ring = tel.RingBufferRecorder()
wd = rs.HangWatchdog(timeout_s=0.3, poll_s=0.02, sink=ring)
wedge = rs.ServingChaos().wedge_step_at(3, stall_s=5.0) if rank % 2 else None
weng = sv.ServingEngine(cfg, params, device="cpu", n_slots=2, tp=2,
                        watchdog=wd, chaos=wedge, sink=ring)
hreq = sv.Request(prompt=[5, 6, 7], max_new_tokens=8, rid=77)
try:
    weng.generate([hreq], max_steps=100)
    res["hang/raised"] = np.array("")
except rs.HangError as e:
    res["hang/raised"] = np.array(e.what)
wd.close()
res["hang/steps_run"] = np.array(weng.steps_run)
res["hang/tripped_here"] = np.array(len(ring.events("hang")))
res["hang/verdicts"] = np.array(weng.comm.issued["host_verdict"])
again, survivors = sv.ServingEngine.recover_from(weng, watchdog=None,
                                                 chaos=None)
again.generate(survivors, max_steps=200)
res["hang/tokens"] = np.array(list(hreq.out_tokens))
base = sv.ServingEngine(cfg, params, device="cpu", n_slots=2)
res["hang/tp1"] = np.array(base.generate(
    [sv.Request(prompt=[5, 6, 7], max_new_tokens=8, rid=77)],
    max_steps=200)[77])

# the skewed clocks: ranks 0-1 serve an overload trace
def overload(clock, tp):
    rng = np.random.default_rng(23)
    reqs = []
    for i in range(14):
        reqs.append(sv.Request(
            prompt=rng.integers(0, cfg.vocab_size,
                                size=int(rng.integers(3, 11))).tolist(),
            max_new_tokens=int(rng.integers(4, 10)),
            arrival_step=int(i * 2), rid=100 + i,
            priority=int(rng.integers(0, 3)),
            latency_budget_ms=(float(rng.integers(40, 140)) * 1e3
                               if rng.random() < 0.6 else None),
            ttft_budget_ms=(float(rng.integers(4, 12)) * 1e3
                            if rng.random() < 0.4 else None)))
    ring = tel.RingBufferRecorder()
    e = sv.ServingEngine(
        cfg, params, device="cpu", n_slots=2, num_pages=9, max_prompt_len=32,
        clock=clock, sink=ring, prefill_chunk=4, spec_k=2, tp=tp,
        admission=sv.AdmissionConfig(max_queue=5, high_watermark=0.6,
                                     low_watermark=0.2,
                                     step_time_init_s=1.0),
        degradation=sv.DegradationPolicy(shed_after=2, cap_max_new=5))
    e.generate(reqs, max_steps=3000)
    e.scheduler.check_invariants()
    events = {k: [(ev["rid"], ev.get("code"), ev.get("max_new_tokens"))
                  for ev in ring.events(k)]
              for k in ("reject", "shed", "degrade")}
    ends = [{k: v for k, v in ev.items() if k != "t_wall"}
            for ev in ring.events("request_end")]
    return json.dumps(dict(
        outcome=[(r.rid, r.status.value, list(r.out_tokens)) for r in reqs],
        events=events, ends=ends,
        t=[(r.t_arrival, r.t_first_token, r.t_done) for r in reqs],
        leaked=e.scheduler.allocator.used_count))

# request-level retry under a deadline that falls between the skewed
# clocks: rid 500 is poisoned at step 6 and again in the first retry pass
from apex_tpu_torch import resilience as res_mod

class PoisonTwice(res_mod.ServingChaos):
    def poison_mask(self, occupants, step):
        mask = super().poison_mask(occupants, step)
        if mask is not None and len(self.faults_fired) == 1:
            self.poison_request(500)
        return mask

def retry_run(clock, tp, seed):
    import random
    rng = np.random.default_rng(21)
    reqs = [sv.Request(prompt=rng.integers(0, cfg.vocab_size,
                                           size=L).tolist(),
                       max_new_tokens=6, rid=500 + i)
            for i, L in enumerate((5, 8))]
    ring = tel.RingBufferRecorder()
    chaos = PoisonTwice().poison_request(500, at_step=6)
    e = sv.ServingEngine(cfg, params, device="cpu", n_slots=2, num_pages=12,
                         max_prompt_len=16, clock=clock, sink=ring, tp=tp,
                         chaos=chaos)
    t0 = clock.t
    e.generate(list(reqs), max_steps=2000, retry_failed=res_mod.RetryPolicy(
        attempts=3, retry_on=(Exception,), base_delay=0.01, max_delay=0.01,
        deadline=spec["retry_deadline"], rng=random.Random(seed)))
    e.scheduler.check_invariants()
    span = clock.t - t0
    retries = [{k: v for k, v in ev.items() if k != "t_wall"}
               for ev in ring.records
               if ev.get("event") in ("retry", "retry_deadline")]
    return json.dumps(dict(
        outcome=[(r.rid, r.status.value, list(r.out_tokens), r.retries)
                 for r in reqs],
        by_status=e.last_stats["by_status"], retries=retries,
        fired=[list(f) for f in chaos.faults_fired],
        leaked=e.scheduler.allocator.used_count)), span

if rank < 2:
    dt, start = spec["skew"][str(rank)]
    res["skew/tp2"] = np.array(overload(sv.VirtualClock(dt=dt, start=start),
                                        2))
    res["skew/tp1"] = np.array(overload(sv.VirtualClock(dt=1.0), 1))
    dt, start = spec["retry_skew"][str(rank)]
    got, span = retry_run(sv.VirtualClock(dt=dt, start=start), 2, rank)
    res["retry/tp2"], res["retry/own_span"] = np.array(got), np.array(span)
    res["retry/tp1"] = np.array(retry_run(
        sv.VirtualClock(dt=spec["retry_skew"]["0"][0]), 1, 0)[0])
ps.destroy_model_parallel()
dist.destroy_process_group()
np.savez(f"{out}/rank{rank}.npz", **res)
"""


@pytest.fixture(scope="module")
def model():
    cfg = _tiny_cfg()
    return cfg, _tiny_params(cfg)


@pytest.fixture(scope="module")
def world(tmp_path_factory, model):
    cfg, params = model
    # the JAX swap test's second tree: the position table halved
    params2 = jax.tree_util.tree_map(lambda a: a, params)
    params2["embedding"]["position"] = params["embedding"]["position"] * 0.5
    inputs = {f"params/{k}": np.asarray(v)
              for k, v in flat(jax.tree_util.tree_map(np.asarray,
                                                      params)).items()}
    inputs.update({f"params2/{k}": np.asarray(v)
                   for k, v in flat(jax.tree_util.tree_map(
                       np.asarray, params2)).items()})
    spec = {"cfg": dict(num_layers=cfg.num_layers,
                        hidden_size=cfg.hidden_size,
                        num_attention_heads=cfg.num_attention_heads,
                        vocab_size=cfg.vocab_size,
                        max_position_embeddings=cfg.max_position_embeddings),
            "trace": TRACE, "prompts": _prompts(cfg.vocab_size),
            "rows": [list(r) for r in ROWS], "skew": SKEW,
            "retry_skew": RETRY_SKEW, "retry_deadline": RETRY_DEADLINE}
    return spawn_world(tmp_path_factory.mktemp("gloo_serving_tp"), _WORKER,
                       inputs, spec, world=WORLD)


def _tokens(rec, label):
    return {int(k.split("/")[1]): rec[k].tolist() for k in rec
            if k.startswith(label + "/") and k.split("/")[1].isdigit()}


@pytest.mark.parametrize("tp", [2, 4])
def test_tp_tokens_equal_tp1_and_the_jax_tp_engine(world, model, tp):
    cfg, params = model
    jax_out, jax_stats = _jax_trace(cfg, params, tp)
    tp1 = _tokens(world[0], "tp1")
    assert set(tp1) == set(jax_out)
    for r in range(WORLD):
        got = _tokens(world[r], f"tp{tp}")
        assert got == tp1, f"rank {r}: TP {tp} against the port's TP 1"
        assert got == {k: list(v) for k, v in jax_out.items()}, (
            f"rank {r}: TP {tp} against the JAX TP engine")
        assert int(world[r][f"tp{tp}/leaks"]) == 0
        st = __import__("json").loads(str(world[r][f"tp{tp}/stats"]))
        assert st["psum_per_program"] == jax_stats["psum_per_program"] == {
            "decode": 3, "chunk_prefill": 3, "spec_verify": 3}
        assert st["tp"] == tp


def test_psum_counts_pool_bytes_and_comm_volume(world):
    import json

    for r in range(WORLD):
        st = json.loads(str(world[r]["tp2/stats"]))
        assert st["kv_bytes_per_shard"] * 2 == int(world[r]["tp2/global_bytes"])
        vol = st["comm_volume"]
        assert set(vol) == {"decode", "chunk_prefill", "spec_verify"}
        for prog in vol.values():
            assert prog["psum"]["count"] == 3
            assert prog["all_gather"]["count"] == 1
            assert prog["pmax"]["count"] == prog["pmin"]["count"] == 1
            assert all(v["axes"] == ["tensor"] for v in prog.values())
        # the bytes are the live steps': a spec engine runs spec_verify
        # only, with sampled rows, so every site of it was issued
        assert all(v["bytes"] > 0 for v in vol["spec_verify"].values())
        assert all(v["bytes"] is None for p in ("decode", "chunk_prefill")
                   for v in vol[p].values())
        # a greedy plain engine: the tails and the sampler's gather and
        # sum issued (the tails [B, hidden] in fp32, 2 rows of 64 wide),
        # the draw's MAX and MIN not
        pv = json.loads(str(world[r]["plain/volume"]))
        assert set(pv) == {"decode"}
        assert pv["decode"]["psum"]["bytes"] == 2 * (2 * 64 * 4) + 2 * 2 * 4
        assert pv["decode"]["all_gather"]["bytes"] > 0
        assert pv["decode"]["pmax"]["bytes"] is None
        plain = json.loads(str(world[r]["plain/stats"]))
        assert plain == {"tp": 2,
                         "kv_bytes_per_shard": int(world[r][
                             "plain/local_bytes"]),
                         "psum_per_program": {"decode": 3}}
        issued = json.loads(str(world[r]["tp2/issued"]))
        # 2 tails a layer x 2 layers + the sampler's one fused sum, a step
        assert issued["all_reduce_sum"] % 5 == 0 and issued["broadcast"] > 0


def test_watchdog_verdict_is_the_groups(world):
    """One rank of each TP 2 group trips its watchdog at step 3: every
    rank raises ``HangError`` at that step (none waits in the next
    step's collectives), one verdict a step was reduced, and the engines
    recovered on every rank finish the request as the TP 1 engine
    does."""
    for r in range(WORLD):
        rec = world[r]
        assert str(rec["hang/raised"]) == "serving_step_host_sync"
        assert int(rec["hang/steps_run"]) == 3
        assert int(rec["hang/tripped_here"]) == (1 if r % 2 else 0)
        assert int(rec["hang/verdicts"]) == 4
        assert rec["hang/tokens"].tolist() == rec["hang/tp1"].tolist()


def test_tp1_engine_reports_no_collectives(model):
    from apex_tpu_torch import serving as sv
    from apex_tpu_torch.convert import params_from_jax
    from apex_tpu_torch.transformer.testing import GPTConfig

    cfg, params = model
    tcfg = GPTConfig(num_layers=2, hidden_size=64, num_attention_heads=4,
                     vocab_size=128, max_position_embeddings=64)
    eng = sv.ServingEngine(tcfg, params_from_jax(jax.tree_util.tree_map(
        np.asarray, params)), device="cpu", n_slots=2)
    eng.generate([sv.Request(prompt=[1, 2, 3], max_new_tokens=2)],
                 max_steps=100)
    assert eng.last_stats["tp"] == 1
    assert eng.last_stats["psum_per_program"] is None
    assert eng.last_stats["comm_volume"] is None
    assert eng.last_stats["kv_bytes_per_shard"] == eng.spec.cache_bytes()


def test_deep_top_k_refused_at_submit(world):
    for r in range(WORLD):
        assert str(world[r]["deep/code"]) == "unsupported_sampling"
        assert "filter width" in str(world[r]["deep/raised"])


def test_rebuild_like_and_swap_params_keep_the_topology(world):
    for r in range(WORLD):
        rec = world[r]
        assert rec["rebuild/tp"].tolist() == [2, 2, 2]
        assert rec["rebuild/tokens"].tolist() == rec["rebuild/tp1"].tolist()
        assert int(rec["swap/qkv_rows"]) == 3 * 64 // 2
        assert rec["swap/tokens"].tolist() == rec["swap/tp1"].tolist()
        assert bool(rec["swap/took"])
    assert (world[0]["rebuild/tokens"].tolist()
            == world[1]["rebuild/tokens"].tolist()
            == world[2]["rebuild/tokens"].tolist())


def test_skewed_clocks_take_the_first_ranks_decisions(world):
    import json

    a = json.loads(str(world[0]["skew/tp2"]))
    b = json.loads(str(world[1]["skew/tp2"]))
    assert a == b
    assert a["leaked"] == 0
    # the run is the TP 1 engine's on rank 0's clock, decision for decision
    one = json.loads(str(world[0]["skew/tp1"]))
    assert a["outcome"] == one["outcome"]
    assert a["events"] == one["events"]
    assert a["t"] == one["t"]
    # and the trace exercised the clock: deadlines and admission acted
    statuses = {s for _, s, _ in a["outcome"]}
    assert len(statuses) > 1, statuses


def test_skewed_clocks_retry_failed_decides_alike(world):
    """Request-level retry (``generate(retry_failed=)``) under a deadline
    that falls between the two ranks' clocks: the poisoned request fails
    again in the first retry pass, and both ranks of the TP 2 engine
    resubmit it (rank 0's clock is under the deadline, rank 1's far over
    it), with the first rank's backoff draws, and finish alike, as the
    TP 1 engine does on rank 0's clock. Over the run rank 1's own clock
    moved past the deadline and rank 0's did not: decided apart, rank 1
    would have given up while rank 0 resubmitted, and then waited in the
    next step's all-reduce for ever."""
    import json

    a = json.loads(str(world[0]["retry/tp2"]))
    b = json.loads(str(world[1]["retry/tp2"]))
    one = json.loads(str(world[0]["retry/tp1"]))
    assert a == b == one
    assert a["leaked"] == 0
    assert [r[3] for r in a["outcome"]] == [2, 0]
    assert a["by_status"]["completed"] == 2
    assert [e["event"] for e in a["retries"]] == ["retry"]
    assert (float(world[0]["retry/own_span"]) < RETRY_DEADLINE
            < float(world[1]["retry/own_span"]))


@pytest.mark.parametrize("tp", [2, 4])
def test_tp_serving_params_from_jax_cut_round_trip(model, tp):
    """``convert.tp_serving_params_from_jax`` for every rank, put back
    together along the serving map's dims, is the full tree; every other
    leaf is replicated; a cut tree is left as it is."""
    import torch

    from apex_tpu_torch.convert import (
        params_from_jax,
        tp_serving_params_from_jax,
    )
    from apex_tpu_torch.serving import tp_rank_params
    from apex_tpu_torch.serving.engine import _TP_SPLIT

    _, params = model
    full = params_from_jax(jax.tree_util.tree_map(np.asarray, params))
    cuts = [tp_serving_params_from_jax(
        jax.tree_util.tree_map(np.asarray, params), r, tp) for r in range(tp)]
    for name, w in full["layers"].items():
        if name in _TP_SPLIT:
            assert cuts[0]["layers"][name].shape[_TP_SPLIT[name]] * tp == \
                w.shape[_TP_SPLIT[name]]
            assert torch.equal(torch.cat([c["layers"][name] for c in cuts],
                                         _TP_SPLIT[name]), w)
        else:
            assert all(torch.equal(c["layers"][name], w) for c in cuts)
    for c in cuts:
        assert torch.equal(c["embedding"]["word"], full["embedding"]["word"])
        assert tp_rank_params(c, tp, 0) is c


@pytest.mark.parametrize("pages,count", [(6, 2), (6, 4), (6, 5), (6, 16),
                                         (7, 4)])
def test_pool_shard_gate_matches_jax(pages, count):
    """The TP engine's whole-pool gate (``layout_findings`` on the pool's
    ``PackSpec`` at ``shard_count``) finds what the JAX
    ``check_pack_spec`` finds, code for code."""
    import jax.numpy as jnp
    import torch

    from apex_tpu.analysis.rules import check_pack_spec
    from apex_tpu.serving.kv_cache import PagedKVSpec as JSpec
    from apex_tpu_torch.multi_tensor_apply.packing import layout_findings
    from apex_tpu_torch.serving import PagedKVSpec

    geo = dict(page_size=16, num_pages=pages, pages_per_seq=4)
    want = [f.code for f in check_pack_spec(
        JSpec(2, 4, 16, dtype=jnp.float32, **geo).pack_spec,
        shard_count=count)]
    got = [code for code, _ in layout_findings(
        PagedKVSpec(2, 4, 16, dtype=torch.float32, **geo).pack_spec,
        shard_count=count)]
    assert got == want
    assert (not got) == (count in (2, 4))
