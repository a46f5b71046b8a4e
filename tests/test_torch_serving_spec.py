"""Speculative decoding of apex_tpu_torch.serving against apex_tpu.serving
on the CPU.

- ``ngram_propose`` on scripted and random histories: drafts and counts
  exact;
- ``run_spec_step`` on one pool and slot state through both packages
  (weights carried across with ``convert.params_from_jax``): the emitted
  matrix, the carried slot state and the history exact, the KV pages
  within atol/rtol 1e-5 (fp32, different summation order);
- the scheduler's speculative paging (``draft_cap``, ``next_take_upper``,
  ``rollback_kv``) in lockstep with the JAX package's;
- ``ServingEngine.generate`` with ``spec_k`` 2 and 4, greedy and
  seeded-sampled, on a staggered trace with forced preemption and a
  prefix hit: tokens and the speculation counters exactly the JAX
  engine's, and tokens equal to the port's own dense reference.

The tiny config of ``tests/test_serving_spec.py``: 2 layers, hidden 64,
4 heads, vocab 128. "Cyclic" weights (position table zeroed) make greedy
decode repeat, so drafts are accepted.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import apex_tpu.serving as jserving
from apex_tpu.serving import spec_decode as jspec
from apex_tpu.transformer.testing import GPTConfig as JGPTConfig
from apex_tpu.transformer.testing import init_gpt_params as jinit
import apex_tpu_torch.serving as tserving
from apex_tpu_torch.convert import params_from_jax
from apex_tpu_torch.serving import decode_model as tdm
from apex_tpu_torch.serving import spec_decode as tspec
from apex_tpu_torch.transformer.testing import GPTConfig

CPU = torch.device("cpu")


@pytest.fixture(scope="module", autouse=True)
def _shed_compile_caches():
    """Each JAX engine here compiles its own step programs; drop them
    with the module (the CPU suite runs near its memory ceiling)."""
    yield
    jax.clear_caches()


def _models(position_scale, max_pos=64):
    kw = dict(num_layers=2, hidden_size=64, num_attention_heads=4,
              vocab_size=128, max_position_embeddings=max_pos)
    jcfg = JGPTConfig(hidden_dropout=0.0, attention_dropout=0.0, **kw)
    jparams = jinit(jcfg, jax.random.PRNGKey(0))
    jparams["embedding"]["position"] = (jparams["embedding"]["position"]
                                        * position_scale)
    tparams = params_from_jax(
        jax.tree_util.tree_map(np.asarray, jparams), CPU)
    return jcfg, jparams, GPTConfig(**kw), tparams


@pytest.fixture(scope="module")
def cyclic():
    """Position-independent weights: greedy decode falls into a cycle,
    so n-gram drafts are accepted."""
    return _models(0.0)


@pytest.fixture(scope="module")
def amplified():
    """Position table x40 (``tests/test_serving.py``): continuations
    depend on position, so a wrong cursor shows in the tokens."""
    return _models(40.0)


# ---------------------------------------------------------------------------
# n-gram drafting
# ---------------------------------------------------------------------------

NGRAM_CASES = {
    # name: (history rows, known lengths, k, n)
    "most recent match": ([[1, 2, 3, 4, 1, 2, 3, 9, 1, 2, 0, 0, 0]],
                          [10], 3, 2),
    "no match": ([[1, 2, 3, 4, 5, 0, 0]], [5], 3, 2),
    "history shorter than n": ([[1, 2, 3, 4, 5, 0, 0]], [2], 3, 3),
    "disabled row": ([[1, 2, 3, 4, 5, 0, 0]], [0], 3, 2),
    "capped at history end": ([[7, 8, 9, 7, 8, 0]], [5], 4, 2),
    "k caps the proposal": ([[7, 8, 9, 7, 8, 0]], [5], 2, 2),
    "unigram, several rows": ([[5, 6, 5, 7, 5, 0, 0], [1, 1, 1, 1, 0, 0, 0],
                               [2, 3, 4, 2, 3, 4, 2]], [5, 4, 7], 3, 1),
}


def _ngram_both(hist, lens, k, n):
    hist = np.asarray(hist, np.int32)
    lens = np.asarray(lens, np.int32)
    jd, jn = jspec.ngram_propose(jnp.asarray(hist), jnp.asarray(lens),
                                 k=k, n=n)
    td, tn = tspec.ngram_propose(torch.from_numpy(hist),
                                 torch.from_numpy(lens), k=k, n=n)
    assert td.dtype == tn.dtype == torch.int32
    return (np.asarray(jd), np.asarray(jn)), (td.numpy(), tn.numpy())


@pytest.mark.parametrize("case", list(NGRAM_CASES))
def test_ngram_propose_matches_jax_scripted(case):
    (jd, jn), (td, tn) = _ngram_both(*NGRAM_CASES[case])
    np.testing.assert_array_equal(td, jd)
    np.testing.assert_array_equal(tn, jn)


def test_ngram_propose_scripted_values():
    """The port's own expectations, as the JAX tests state them."""
    (_, _), (td, tn) = _ngram_both(*NGRAM_CASES["most recent match"])
    assert list(td[0]) == [3, 9, 1] and int(tn[0]) == 3
    (_, _), (td, tn) = _ngram_both(*NGRAM_CASES["capped at history end"])
    assert int(tn[0]) == 3 and list(td[0]) == [9, 7, 8, 0]


@pytest.mark.parametrize("seed,k,n", [(0, 4, 2), (1, 2, 3), (2, 5, 1),
                                      (3, 4, 4)])
def test_ngram_propose_matches_jax_random(seed, k, n):
    """Random histories over a small alphabet (matches are common),
    random known lengths including 0 and the full width."""
    rng = np.random.default_rng(seed)
    B, W = 6, 40
    hist = rng.integers(0, 4, size=(B, W + 1)).astype(np.int32)
    lens = rng.integers(0, W + 1, size=B).astype(np.int32)
    lens[0], lens[1] = 0, W
    (jd, jn), (td, tn) = _ngram_both(hist, lens, k, n)
    np.testing.assert_array_equal(td, jd)
    np.testing.assert_array_equal(tn, jn)
    assert (jn > 0).any(), "the alphabet was chosen so that rows draft"


# ---------------------------------------------------------------------------
# the speculative step
# ---------------------------------------------------------------------------

def _step_inputs(sampled):
    """One mixed boundary: slot 0 decodes a repetitive history (drafts),
    slot 1 prefills mid-prompt, slot 2 is empty, slot 3 decodes and is
    poisoned (quarantine)."""
    rng = np.random.default_rng(5)
    B, W = 4, 64
    cyc = [3, 9, 14, 3, 9, 14, 3, 9, 14, 3, 9]
    prompt_buf = np.zeros((B, W), np.int32)
    hist = np.zeros((B, W + 1), np.int32)
    prompt_buf[0, :len(cyc)] = cyc
    hist[0, :len(cyc)] = cyc
    p1 = rng.integers(0, 128, size=20).astype(np.int32)
    prompt_buf[1, :20] = p1
    hist[1, :20] = p1
    p3 = rng.integers(0, 128, size=7).astype(np.int32)
    prompt_buf[3, :7] = p3
    hist[3, :7] = p3
    hist[3, 7:12] = rng.integers(0, 128, size=5)
    slot = dict(
        tokens=np.asarray([14, p1[6], 0, 77], np.int32),
        positions=np.asarray([11, 6, 0, 12], np.int32),
        active=np.asarray([True, True, False, True]),
        prompt_buf=prompt_buf,
        prompt_lens=np.asarray([11, 20, 0, 7], np.int32),
        temps=np.asarray([0.8 if sampled else 0.0, 0.0, 0.0, 0.0],
                         np.float32),
        top_ks=np.asarray([20, 0, 0, 0], np.int32),
        top_ps=np.asarray([0.9, 1.0, 1.0, 1.0], np.float32),
        seeds=np.asarray([11, 0, 0, 0], np.int32),
        rids=np.asarray([300, 301, 0, 303], np.int32),
        hist=hist)
    pt = np.asarray([[1, 2, 3, 0], [4, 5, 6, 0], [0, 0, 0, 0],
                     [7, 8, 9, 0]], np.int32)
    poison = np.asarray([False, False, False, True])
    caps = np.asarray([4, 0, 0, 2], np.int32)
    pages = rng.normal(size=(2, 2, 12, 4, 16, 16)).astype(np.float32)
    return slot, pt, poison, caps, pages


@pytest.mark.parametrize("spec_k", [2, 4])
@pytest.mark.parametrize("sampled", [False, True], ids=["greedy", "sampled"])
def test_run_spec_step_matches_jax(cyclic, spec_k, sampled):
    jcfg, jparams, tcfg, tparams = cyclic
    slot, pt, poison, caps, pages = _step_inputs(sampled)
    jspec_kv = jserving.PagedKVSpec(2, 4, 16, page_size=16, num_pages=12,
                                    pages_per_seq=4, dtype=jnp.float32)
    tspec_kv = tserving.PagedKVSpec(2, 4, 16, page_size=16, num_pages=12,
                                    pages_per_seq=4, dtype=torch.float32)
    kw = dict(spec_k=spec_k, ngram=2, prefill_chunk=4)
    jkv, jslots, jem = jspec.run_spec_step(
        jcfg, jparams, jspec_kv, jserving.KVCacheState(jnp.asarray(pages)),
        jserving.SlotState(**{k: jnp.asarray(v) for k, v in slot.items()}),
        jnp.asarray(pt), jnp.asarray(poison), jnp.asarray(caps),
        use_kernel=False, **kw)
    tslots_in = tserving.SlotState(
        **{k: torch.from_numpy(v.copy()) for k, v in slot.items()})
    tkv, tslots, tem = tspec.run_spec_step(
        tcfg, tparams, tspec_kv,
        tserving.KVCacheState(torch.from_numpy(pages.copy())), tslots_in,
        torch.from_numpy(pt), torch.from_numpy(poison),
        torch.from_numpy(caps), **kw)
    jem = np.asarray(jem)
    np.testing.assert_array_equal(tem.numpy(), jem)
    assert jem.shape == (4, max(4, spec_k + 1) + 1)
    assert jem[3, 0] == tspec.POISONED and jem[2, 0] == tspec.NO_TOKEN
    assert jem[0, -1] > 0, "the repetitive slot drafts"
    for name in ("tokens", "positions", "hist"):
        np.testing.assert_array_equal(
            getattr(tslots, name).numpy(), np.asarray(getattr(jslots, name)),
            err_msg=name)
    # every page but the garbage page (which takes the invalid columns'
    # writes in no particular order)
    np.testing.assert_allclose(tkv.pages.numpy()[:, :, 1:],
                               np.asarray(jkv.pages)[:, :, 1:],
                               rtol=1e-5, atol=1e-5)


def test_spec_scheduler_paging_matches_jax():
    """Both schedulers with spec_k=3 driven in lockstep: identical draft
    caps, worst-case takes, page tables, forks and rollbacks, on a pool
    small enough to preempt and with shared prompt heads."""
    rng = np.random.default_rng(9)
    head = [int(t) for t in rng.integers(0, 40, size=12)]
    specs = [(700 + i, (head + [int(t) for t in
                                rng.integers(0, 40, size=1 + i)],
                        int(rng.integers(3, 14)))) for i in range(6)]
    scheds, reqs = [], []
    for pkg in (jserving, tserving):
        kv = pkg.PagedKVSpec(1, 4, 16, page_size=16, num_pages=6,
                             pages_per_seq=4)
        scheds.append(pkg.Scheduler(kv, n_slots=3, max_prompt_len=32,
                                    prefix_cache=True, prefill_chunk=4,
                                    spec_k=3))
        reqs.append([pkg.Request(prompt=list(p), max_new_tokens=m, rid=r)
                     for r, (p, m) in specs])
    pending = list(range(len(specs)))
    for step in range(3000):
        if pending and step % 2 == 0:
            i = pending.pop(0)
            for s, rs in zip(scheds, reqs):
                s.submit(rs[i])
        if not pending and scheds[0].idle:
            break
        out = []
        for s in scheds:
            s.admit()
            pre = s.ensure_capacity()
            out.append(([r.rid for r in pre], s.take_forks(),
                        s.page_table_array().tolist(),
                        [(i, s.draft_cap(r), s.next_take_upper(r))
                         for i, r in s.running()],
                        s.allocator.free_count))
            s.check_invariants()
        assert out[0] == out[1], f"step {step}"
        # a decode slot accepts a random number of its drafts
        acc = int(rng.integers(0, 4))
        tok = int(rng.integers(0, 40))
        for s in scheds:
            served = s.running()
            consumed = {i: 1 + min(acc, s.draft_cap(r))
                        for i, r in served if not r.prefilling}
            s.advance([i for i, _ in served], consumed=consumed)
            for i, r in served:
                if i in consumed:
                    for _ in range(consumed[i]):
                        if not r.req.done:
                            r.req.out_tokens.append(tok)
                if r.req.done:
                    s.evict(i)
                elif i in consumed:
                    s.rollback_kv(i, r, r.pos)
            s.check_invariants()
    assert scheds[0].idle and scheds[1].idle
    assert scheds[1].allocator.used_count == 0


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------

def _trace(pkg, sampled):
    """Staggered arrivals, a shared prompt head (prefix hit), greedy or
    seeded-sampled requests; sized with the engine below to preempt."""
    rng = np.random.default_rng(17)
    head = [int(t) for t in rng.integers(0, 128, size=13)]
    sps = ([pkg.SamplingParams(temperature=0.9, top_k=20, seed=3),
            None, pkg.SamplingParams(temperature=1.1, top_p=0.8, seed=5),
            pkg.SamplingParams(temperature=0.7, top_k=8, seed=9)]
           if sampled else [None] * 4)
    out = []
    for i, sp in enumerate(sps):
        tail = [int(t) for t in rng.integers(0, 128, size=2 + 3 * i)]
        prompt = head + tail if i != 1 else tail + head[:3]
        out.append(pkg.Request(prompt=prompt, max_new_tokens=14,
                               arrival_step=3 * i, sampling=sp,
                               rid=900 + i))
    return out


ENGINE_KW = dict(n_slots=2, num_pages=5, max_prompt_len=48,
                 prefill_chunk=4, spec_ngram=2)


@pytest.fixture(scope="module", params=[
    (2, False), (4, False), (2, True), (4, True)],
    ids=["k2-greedy", "k4-greedy", "k2-sampled", "k4-sampled"])
def spec_runs(request, cyclic):
    jcfg, jparams, tcfg, tparams = cyclic
    spec_k, sampled = request.param
    jeng = jserving.ServingEngine(jcfg, jparams, spec_k=spec_k,
                                  **ENGINE_KW)
    jout = jeng.generate(_trace(jserving, sampled), max_steps=3000)
    teng = tserving.ServingEngine(tcfg, tparams, device="cpu",
                                  spec_k=spec_k, **ENGINE_KW)
    treqs = _trace(tserving, sampled)
    tout = teng.generate(treqs, max_steps=3000)
    return jeng, jout, teng, tout, treqs


SPEC_COUNTERS = ("steps", "completed", "preemptions", "generated_tokens",
                 "prefill_tokens", "decode_tokens", "cached_prompt_tokens",
                 "drafted_tokens", "accepted_tokens", "decode_slot_steps",
                 "prefill_slot_steps", "spec_k")


def test_spec_engine_matches_jax(spec_runs):
    jeng, jout, teng, tout, treqs = spec_runs
    assert tout == jout
    st, jst = teng.last_stats, jeng.last_stats
    for key in SPEC_COUNTERS:
        assert st[key] == jst[key], key
    # the JAX summary rounds its ratios to 4 decimals, the port does not
    for key in ("accept_rate", "tokens_per_step"):
        assert round(st[key], 4) == jst[key], key
    assert st["preemptions"] > 0, "the trace was sized to preempt"
    assert st["prefix_cache"]["hits"] > 0, "the trace has a prefix hit"
    assert st["drafted_tokens"] > 0 and st["accepted_tokens"] > 0


def test_spec_engine_matches_own_reference(spec_runs, cyclic):
    """Speculation is lossless: the port's dense oracle, greedy and
    sampled, token for token; nothing leaks."""
    _, _, teng, tout, treqs = spec_runs
    _, _, tcfg, tparams = cyclic
    teng.scheduler.check_invariants()
    assert teng.scheduler.allocator.used_count == 0
    for r in treqs:
        assert r.status is tserving.RequestStatus.COMPLETED
        assert tout[r.rid] == tdm.reference_sample_decode(
            tcfg, tparams, r.prompt, r.max_new_tokens, sampling=r.sampling,
            rid=r.rid)


def test_spec_summary_fields_reconcile(spec_runs):
    st = spec_runs[2].last_stats
    assert st["tokens_per_step"] == pytest.approx(
        st["decode_tokens"] / st["decode_slot_steps"])
    assert st["accept_rate"] == pytest.approx(
        st["accepted_tokens"] / st["drafted_tokens"])
    assert st["tokens_per_step"] > 1.0


def test_spec_preemption_replay_matches_jax(amplified):
    """Stolen allocations force preemption mid-speculation on
    position-sensitive weights: the port replays exactly as the JAX
    engine does (and as plain greedy decode)."""
    from apex_tpu.resilience import ServingChaos as JChaos
    from apex_tpu_torch.resilience import ServingChaos as TChaos

    jcfg, jparams, tcfg, tparams = amplified
    kw = dict(n_slots=2, num_pages=5, max_prompt_len=16, spec_k=3)
    outs, engs = [], []
    for pkg, cfg, params, chaos, extra in (
            (jserving, jcfg, jparams, JChaos().fail_allocs(4), {}),
            (tserving, tcfg, tparams, TChaos().fail_allocs(4),
             {"device": "cpu"})):
        rng = np.random.default_rng(7)
        reqs = [pkg.Request(prompt=[int(t) for t in
                                    rng.integers(0, 128, size=L)],
                            max_new_tokens=8, arrival_step=2 * i,
                            rid=40 + i)
                for i, L in enumerate((14, 11, 13, 9))]
        eng = pkg.ServingEngine(cfg, params, chaos=chaos, **kw, **extra)
        outs.append(eng.generate(reqs, max_steps=2000))
        engs.append((eng, reqs))
    assert outs[0] == outs[1]
    teng, treqs = engs[1]
    assert sum(r.preemptions for r in treqs) > 0
    assert teng.last_stats["preemptions"] == \
        engs[0][0].last_stats["preemptions"]
    for r in treqs:
        assert outs[1][r.rid] == tdm.reference_decode(
            tcfg, tparams, r.prompt, r.max_new_tokens)


def test_spec_knob_validation(cyclic):
    _, _, tcfg, tparams = cyclic
    with pytest.raises(ValueError, match="spec_ngram"):
        tserving.ServingEngine(tcfg, tparams, device="cpu", spec_k=2,
                               spec_ngram=0)
    with pytest.raises(ValueError, match="spec_k"):
        tserving.ServingEngine(tcfg, tparams, device="cpu", spec_k=5000)
