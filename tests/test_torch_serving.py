"""apex_tpu_torch.serving against apex_tpu.serving on the CPU.

- the host scheduler: the port's ``Scheduler``/``PageAllocator`` make
  the same admissions, preemptions, COW forks, prefix hits and page
  tables as the JAX package's on a random trace (exact);
- the device step: ``decode_tokens`` and ``prefill_chunk_tokens`` on
  the tiny fp32 config of ``tests/test_serving.py`` with the JAX weights
  carried across (``convert.params_from_jax``) give the same logits
  (atol/rtol 1e-4: fp32, different summation order) and the same KV
  pages (atol/rtol 1e-5);
- the engine: ``ServingEngine.generate`` emits exactly the JAX engine's
  tokens, greedy and seeded-sampled, on a staggered trace with forced
  preemption and a prefix hit, at ``prefill_chunk`` 1 and 4.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import apex_tpu.serving as jserving
from apex_tpu.transformer.testing import GPTConfig as JGPTConfig
from apex_tpu.transformer.testing import init_gpt_params as jinit
from apex_tpu.transformer.testing.standalone_transformer_lm import (
    gpt_forward as jgpt_forward,
)
from apex_tpu.serving import decode_model as jdm
import apex_tpu_torch.serving as tserving
from apex_tpu_torch.convert import params_from_jax
from apex_tpu_torch.serving import decode_model as tdm
from apex_tpu_torch.transformer.testing import GPTConfig, gpt_forward

CPU = torch.device("cpu")


def _cfgs():
    kw = dict(num_layers=2, hidden_size=64, num_attention_heads=4,
              vocab_size=128, max_position_embeddings=64)
    return (JGPTConfig(hidden_dropout=0.0, attention_dropout=0.0, **kw),
            GPTConfig(**kw))


@pytest.fixture(scope="module")
def models():
    jcfg, tcfg = _cfgs()
    jparams = jinit(jcfg, jax.random.PRNGKey(0))
    # amplified position table (tests/test_serving.py): continuations
    # depend on position, so the growing cache is really exercised
    jparams["embedding"]["position"] = jparams["embedding"]["position"] * 40
    tparams = params_from_jax(
        jax.tree_util.tree_map(np.asarray, jparams), CPU)
    return jcfg, jparams, tcfg, tparams


# ---------------------------------------------------------------------------
# scheduler
# ---------------------------------------------------------------------------

def _twin_requests(pkg, specs):
    return [pkg.Request(prompt=list(p), max_new_tokens=m, rid=rid)
            for rid, (p, m) in specs]


def test_scheduler_decisions_match_jax():
    """Both schedulers driven in lockstep over a trace with shared
    prompt heads (prefix hits), a pool small enough to preempt, and
    random emitted tokens: identical page tables, cursors, queues,
    forks and cache counters at every boundary."""
    rng = np.random.default_rng(5)
    head = [int(t) for t in rng.integers(0, 50, size=16)]
    specs = []
    for rid in range(9):
        tail = [int(t) for t in rng.integers(0, 50,
                                             size=int(rng.integers(1, 12)))]
        prompt = (head + tail) if rid % 2 else tail + head[:5]
        specs.append((1000 + rid, (prompt, int(rng.integers(2, 12)))))
    scheds = []
    for pkg in (jserving, tserving):
        spec = pkg.PagedKVSpec(1, 4, 16, page_size=16, num_pages=6,
                               pages_per_seq=4)
        scheds.append(pkg.Scheduler(spec, n_slots=3,
                                    max_prompt_len=spec.max_seq_len,
                                    prefix_cache=True, prefill_chunk=4))
    reqs = [_twin_requests(jserving, specs), _twin_requests(tserving, specs)]
    pending = list(range(len(specs)))
    preempted = 0
    for step in range(2000):
        if pending and step % 3 == 0:
            i = pending.pop(0)
            for s, rs in zip(scheds, reqs):
                s.submit(rs[i])
        if not pending and scheds[0].idle:
            break
        out = []
        for s in scheds:
            s.admit()
            pre = s.ensure_capacity()
            out.append((
                [r.rid for r in pre], s.take_forks(),
                s.page_table_array().tolist(),
                [(i, r.req.rid, r.pos, list(r.pages))
                 for i, r in s.running()],
                [r.rid for r in s.waiting],
                s.allocator.free_count, s.cache.stats()))
            s.check_invariants()
        assert out[0] == out[1], f"step {step}: schedulers diverged"
        preempted += len(out[0][0])
        served = [scheds[k].running() for k in range(2)]
        for k, s in enumerate(scheds):
            s.advance([i for i, _ in served[k]])
        tok = int(rng.integers(0, 50))
        for k, s in enumerate(scheds):
            for i, run in served[k]:
                if not run.prefilling:
                    run.req.out_tokens.append(tok)
                if run.req.done:
                    s.evict(i)
    assert scheds[0].idle and scheds[1].idle
    assert preempted > 0, "trace was sized to force preemption"
    assert scheds[1].cache.stats()["hits"] > 0, "trace has prefix hits"
    assert scheds[1].allocator.used_count == 0


def test_page_allocator_matches_jax():
    a, b = jserving.PageAllocator(6), tserving.PageAllocator(6)
    got = [(a.alloc(), b.alloc()) for _ in range(4)]
    assert all(x == y for x, y in got)
    for al in (a, b):
        al.share(got[0][0])
        al.pin(got[1][0])
        al.free([got[1][0], got[2][0]])
        al.check()
    assert a.live_pages() == b.live_pages()
    assert a.free_count == b.free_count
    with pytest.raises(ValueError, match="garbage"):
        b.free([0])


def test_paged_kv_spec_alignment():
    with pytest.raises(ValueError, match="ROW-aligned"):
        tserving.PagedKVSpec(1, 3, 16, page_size=8, num_pages=4,
                             pages_per_seq=2)
    with pytest.raises(ValueError, match="garbage"):
        tserving.PagedKVSpec(1, 4, 16, page_size=16, num_pages=1,
                             pages_per_seq=2)
    assert tserving.default_page_size(16, 64) == 8  # the 345M page
    assert tserving.default_page_size(4, 16) == \
        jserving.default_page_size(4, 16)


# ---------------------------------------------------------------------------
# the device step
# ---------------------------------------------------------------------------

def _pools(seed, spec_args):
    rng = np.random.default_rng(seed)
    jspec = jserving.PagedKVSpec(*spec_args[:3], **spec_args[3])
    pages = rng.normal(size=(jspec.num_layers, 2) + jspec.pool_leaf_shape)
    pages = pages.astype(np.float32)
    tspec = tserving.PagedKVSpec(*spec_args[:3], **dict(
        spec_args[3], dtype=torch.float32))
    return (jspec, jserving.KVCacheState(pages=jnp.asarray(pages)),
            tspec, tserving.KVCacheState(pages=torch.from_numpy(pages.copy())))


SPEC = (2, 4, 16, dict(page_size=16, num_pages=8, pages_per_seq=4,
                       dtype=jnp.float32))


def test_decode_tokens_matches_jax(models):
    jcfg, jparams, tcfg, tparams = models
    jspec, jkv, tspec, tkv = _pools(0, SPEC)
    tokens = np.asarray([5, 17, 99, 3], np.int32)
    positions = np.asarray([0, 15, 16, 40], np.int32)
    active = np.asarray([True, True, False, True])
    pt = np.asarray([[1, 0, 0, 0], [2, 3, 0, 0], [0, 0, 0, 0],
                     [4, 5, 6, 7]], np.int32)
    jl, jkv2 = jdm.decode_tokens(
        jcfg, jparams, jspec, jkv, *map(jnp.asarray,
                                        (tokens, positions, active, pt)),
        use_kernel=False)
    tl, tkv2 = tdm.decode_tokens(
        tcfg, tparams, tspec, tkv, *map(torch.from_numpy,
                                        (tokens, positions, active, pt)))
    live = active
    np.testing.assert_allclose(tl.numpy()[live], np.asarray(jl)[live],
                               rtol=1e-4, atol=1e-4)
    # the garbage page takes the inactive slot's write: compare the rest
    np.testing.assert_allclose(tkv2.pages.numpy()[:, :, 1:],
                               np.asarray(jkv2.pages)[:, :, 1:],
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("chunk", [1, 4])
def test_prefill_chunk_tokens_matches_jax(models, chunk):
    jcfg, jparams, tcfg, tparams = models
    jspec, jkv, tspec, tkv = _pools(1, SPEC)
    rng = np.random.default_rng(2)
    W = 64
    prompt_buf = rng.integers(0, 128, size=(4, W)).astype(np.int32)
    prompt_lens = np.asarray([10, 3, 20, 0], np.int32)
    tokens = np.asarray([7, 8, 9, 10], np.int32)
    positions = np.asarray([2, 3, 18, 0], np.int32)   # slot 1 decodes
    active = np.asarray([True, True, True, False])
    pt = np.asarray([[1, 2, 0, 0], [3, 0, 0, 0], [4, 5, 0, 0],
                     [0, 0, 0, 0]], np.int32)
    args = (tokens, positions, active, prompt_buf, prompt_lens, pt)
    jl, jkv2, jtake = jdm.prefill_chunk_tokens(
        jcfg, jparams, jspec, jkv, *map(jnp.asarray, args), chunk=chunk,
        use_kernel=False)
    tl, tkv2, ttake = tdm.prefill_chunk_tokens(
        tcfg, tparams, tspec, tkv, *map(torch.from_numpy, args),
        chunk=chunk)
    np.testing.assert_array_equal(ttake.numpy(), np.asarray(jtake))
    np.testing.assert_allclose(tl.numpy()[active], np.asarray(jl)[active],
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(tkv2.pages.numpy()[:, :, 1:],
                               np.asarray(jkv2.pages)[:, :, 1:],
                               rtol=1e-5, atol=1e-5)


def test_gpt_forward_matches_jax(models):
    jcfg, jparams, tcfg, tparams = models
    toks = np.random.default_rng(3).integers(0, 128, size=(2, 13))
    want = np.asarray(jgpt_forward(jcfg, jparams, jnp.asarray(toks),
                                   deterministic=True))
    got = gpt_forward(tcfg, tparams, torch.from_numpy(toks)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------

def _trace(pkg):
    """Staggered arrivals, a shared prompt head (prefix hit), greedy and
    seeded-sampled requests, sized with the engine below to preempt."""
    rng = np.random.default_rng(11)
    head = [int(t) for t in rng.integers(0, 128, size=17)]
    sps = [None, pkg.SamplingParams(temperature=0.9, top_k=20, seed=11),
           None, pkg.SamplingParams(temperature=1.1, top_p=0.8, seed=42),
           pkg.SamplingParams(temperature=0.7, top_k=12, top_p=0.9, seed=7)]
    out = []
    for i, sp in enumerate(sps):
        tail = [int(t) for t in rng.integers(0, 128, size=3 + 2 * i)]
        prompt = head + tail if i in (0, 2, 3) else tail + head[:4]
        out.append(pkg.Request(prompt=prompt, max_new_tokens=8,
                               arrival_step=4 * i, sampling=sp,
                               rid=500 + i))
    return out


@pytest.fixture(scope="module", params=[1, 4], ids=["chunk1", "chunk4"])
def engine_runs(request, models):
    jcfg, jparams, tcfg, tparams = models
    chunk = request.param
    kw = dict(n_slots=2, num_pages=4, max_prompt_len=48,
              prefill_chunk=chunk)
    jeng = jserving.ServingEngine(jcfg, jparams, **kw)
    jreqs = _trace(jserving)
    jout = jeng.generate(jreqs, max_steps=2000)
    teng = tserving.ServingEngine(tcfg, tparams, device="cpu", **kw)
    treqs = _trace(tserving)
    tout = teng.generate(treqs, max_steps=2000)
    return jeng, jout, teng, tout, treqs


def test_engine_tokens_match_jax(engine_runs):
    jeng, jout, teng, tout, treqs = engine_runs
    assert tout == jout
    st, jst = teng.last_stats, jeng.last_stats
    assert st["preemptions"] > 0, "trace was sized to force preemption"
    assert st["prefix_cache"]["hits"] > 0, "trace has a prefix hit"
    for key in ("preemptions", "steps", "completed", "generated_tokens",
                "prefill_tokens", "decode_tokens", "cached_prompt_tokens"):
        assert st[key] == jst[key], key
    assert any(r.sampling is not None for r in treqs)


def test_engine_matches_own_reference(engine_runs, models):
    """Token identity with the port's dense oracle, greedy and sampled."""
    _, _, teng, tout, treqs = engine_runs
    _, _, tcfg, tparams = models
    teng.scheduler.check_invariants()
    assert teng.scheduler.allocator.used_count == 0
    for r in treqs:
        ref = tdm.reference_sample_decode(
            tcfg, tparams, r.prompt, r.max_new_tokens, sampling=r.sampling,
            rid=r.rid)
        assert tout[r.rid] == ref


def test_engine_summary_fields(engine_runs):
    st = engine_runs[2].last_stats
    assert st["completed"] == st["n_requests"] == 5
    assert 0 < st["occupancy"] <= 1.0
    assert set(st["step_ms"]) == {"p50", "p90", "p99"}
    assert st["tokens_per_sec"] > 0


def test_engine_refuses_left_out_features(models):
    """Every feature of the JAX engine is accepted; tensor parallelism
    needs a world of ``tp`` ranks (``test_torch_serving_tp.py`` runs it):
    outside one, ``tp=2`` names the world size, and a head count ``tp``
    does not divide is refused first."""
    _, _, tcfg, tparams = models
    tserving.ServingEngine(tcfg, tparams, device="cpu", spec_k=2,
                           admission=tserving.AdmissionConfig(),
                           degradation=tserving.DegradationPolicy(),
                           trace=True, telemetry_every=4)
    with pytest.raises(ValueError, match="world has 1"):
        tserving.ServingEngine(tcfg, tparams, device="cpu", tp=2)
    with pytest.raises(ValueError, match="not divisible"):
        tserving.ServingEngine(tcfg, tparams, device="cpu", tp=3)
    with pytest.raises(TypeError, match="bogus"):
        tserving.ServingEngine(tcfg, tparams, device="cpu", bogus=1)
    eng = tserving.ServingEngine(tcfg, tparams, device="cpu", tp=1)
    r = tserving.Request(prompt=[], max_new_tokens=2)
    assert eng.try_submit(r).code is tserving.RejectionCode.EMPTY_PROMPT
    assert r.status is tserving.RequestStatus.REJECTED
