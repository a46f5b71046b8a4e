"""The bucketed flat gradient lifecycle of the port against the JAX
package's, single process (``tests/test_grad_lifecycle.py``'s unit
contracts), and the flat path's ``chunk_size`` (fault C9).

- ``PackSpec(bucket_elems=...)`` / ``GradBuckets``: the layout equals the
  JAX one field for field (``offsets``, ``padded_sizes``,
  ``bucket_bounds``, ``bucket_leaf_ranges``, ``total``) on the GPT-2 345M
  tree at the 25 MB cap and on odd trees (a leaf larger than the cap, a
  cap smaller than one ROW, mixed dtypes, ``align`` above a row); the
  buckets concatenate into ``pack``; the auto-built fp32 cap; an oversized
  leaf's own bucket; corrupt bounds fail ``check()`` with the JAX
  auditor's codes; equality and hashing.
- The handoff: ``packed_init(spec=)`` adopts the layout and refuses a
  conflicting chunk; ``as_flat_grads`` takes ``BucketBuffers``, a buffer of
  ``spec.total`` and a tree, refuses any other length and keeps a bare
  single leaf a tree; ``step_flat`` equals ``step`` and freezes on a noop;
  ``FusedSGD(packed_spec=)`` takes the reduced buffer bit for bit.
- The scaler: ``found_inf_flat`` against ``unscale_flat`` (buffer and
  ``BucketBuffers``), the collapsed scale; per-leaf provenance;
  ``sweep_bytes``.
- C9: ``clip_grad_norm_flat``, ``LossScaler.unscale_flat`` and the six
  packed ops take ``chunk_size``, validated, and give the JAX functions'
  results (the Pallas kernels in interpret mode, gridded over that chunk)
  at two chunk sizes.

Tolerances: layouts, flags, counts and the handoff's equalities exactly;
fp32 results of the packed ops within rtol 1e-6 atol 1e-7 (one rounding a
step, XLA may contract a product), bf16 outputs one bf16 rounding (rtol
8e-3), row sums of squares rtol 1e-6 (summation order); the clip's norm
rtol 1e-6 and its buffer rtol 1e-6.
"""
import copy
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.amp import LossScaler as JLossScaler
from apex_tpu.contrib.clip_grad import clip_grad_norm_flat as j_clip_flat
from apex_tpu.multi_tensor_apply.packing import PackSpec as JPackSpec
from apex_tpu.parallel import GradBuckets as JGradBuckets
from apex_tpu_torch._tree import tree_leaves, tree_map
from apex_tpu_torch.amp import LossScaler
from apex_tpu_torch.contrib.clip_grad import clip_grad_norm_flat
from apex_tpu_torch.multi_tensor_apply import (
    ROW,
    BucketBuffers,
    PackSpec,
)
from apex_tpu_torch.multi_tensor_apply.packing import layout_findings
from apex_tpu_torch.ops import packed_optimizer as T
from apex_tpu_torch.optimizers import FusedAdam, FusedSGD
from apex_tpu_torch.parallel import (
    DistributedDataParallel,
    GradBuckets,
    sync_gradients_bucketed,
)

J = importlib.import_module("apex_tpu.ops.packed_optimizer")

CHUNK = 2 * ROW  # a small chunk, so multi-bucket layouts stay tiny
FIELDS = ("offsets", "padded_sizes", "bucket_bounds", "bucket_leaf_ranges",
          "total", "n_buckets", "chunk_size", "sizes")
STATE_TOL = dict(rtol=1e-6, atol=1e-7)
BF16_TOL = dict(rtol=8e-3, atol=1e-7)

_JDT = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16,
        torch.float16: jnp.float16}


def _gpt345m(dtype=torch.bfloat16):
    """GPT-2 345M's parameter tree (24 x 1024, vocab 50304), meta tensors."""
    h, L, v, f = 1024, 24, 50304, 4096

    def m(*shape):
        return torch.empty(shape, dtype=dtype, device="meta")
    return {"embedding": {"word": m(v, h), "position": m(1024, h)},
            "layers": {"input_ln_w": m(L, h), "input_ln_b": m(L, h),
                       "qkv_w": m(L, 3 * h, h), "qkv_b": m(L, 3 * h),
                       "proj_w": m(L, h, h), "proj_b": m(L, h),
                       "post_ln_w": m(L, h), "post_ln_b": m(L, h),
                       "fc1_w": m(L, f, h), "fc1_b": m(L, f),
                       "fc2_w": m(L, h, f), "fc2_b": m(L, h)},
            "final_ln_w": m(h), "final_ln_b": m(h)}


def _jax_template(tree):
    return jax.tree_util.tree_map(
        lambda t: jax.ShapeDtypeStruct(tuple(t.shape), _JDT[t.dtype]), tree,
        is_leaf=lambda t: isinstance(t, torch.Tensor))


def _meta(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


#: (tree, PackSpec keywords): the odd trees of the layout test
LAYOUTS = {
    "oversized_leaf": ({"big": _meta(8 * CHUNK), "small": _meta(8),
                        "mid": _meta(3 * ROW + 5)},
                       dict(chunk_size=CHUNK, bucket_elems=2 * CHUNK)),
    "cap_below_a_row": ({f"w{i}": _meta(37 * i + 1) for i in range(6)},
                        dict(chunk_size=CHUNK, bucket_elems=ROW // 3)),
    "mixed_dtypes": ({"a": _meta(1000, dtype=torch.bfloat16),
                      "b": _meta(70, 30), "c": _meta(5000,
                                                     dtype=torch.float16),
                      "d": [_meta(3), _meta(2 * ROW)]},
                     dict(chunk_size=3 * ROW, bucket_elems=3000)),
    "align_above_a_row": ({f"w{i}": _meta(1500 * i + 7) for i in range(5)},
                          dict(align=2 * ROW, chunk_size=5 * ROW,
                               bucket_elems=6 * ROW)),
    "one_bucket": ({"x": _meta(77), "y": _meta(3, 3)},
                   dict(chunk_size=CHUNK)),
}


def _same_layout(t, j):
    for f in FIELDS:
        assert getattr(t, f) == getattr(j, f), f


@pytest.mark.parametrize("case", sorted(LAYOUTS))
def test_bucket_layout_equals_jax(case):
    tree, kw = LAYOUTS[case]
    t = PackSpec(tree, **kw)
    _same_layout(t, JPackSpec(_jax_template(tree), **kw))
    assert layout_findings(t) == []


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_345m_grad_buckets_equal_jax(dtype):
    tree = _gpt345m(getattr(torch, dtype))
    for reduce_dtype in (None, torch.float32):
        t = GradBuckets(tree, bucket_cap_mb=25, reduce_dtype=reduce_dtype)
        j = JGradBuckets(_jax_template(tree), bucket_cap_mb=25,
                         reduce_dtype=None if reduce_dtype is None
                         else jnp.float32)
        _same_layout(t.spec, j.spec)
        assert t.n_buckets == j.n_buckets > 1
        assert t.sweep_bytes() == j.sweep_bytes()
        t.check()


def _params(dtype=torch.float32, seed=0):
    rng = np.random.default_rng(seed)
    return {"w1": torch.from_numpy(rng.normal(size=(12, 64)).astype(
                np.float32) * 0.1).to(dtype),
            "b1": torch.from_numpy(rng.normal(size=64).astype(
                np.float32) * 0.1).to(dtype),
            "w2": torch.from_numpy(rng.normal(size=(64, 4)).astype(
                np.float32) * 0.1).to(dtype),
            "b2": torch.from_numpy(rng.normal(size=4).astype(
                np.float32) * 0.1).to(dtype)}


def _buckets(dtype=torch.float32, **kw):
    return GradBuckets(_params(dtype), bucket_cap_mb=0.002, chunk_size=CHUNK,
                       **kw)


def test_bucket_layout_structure_and_invariants():
    params = _params()
    buckets = _buckets()
    spec = buckets.spec
    assert buckets.n_buckets >= 2
    buckets.check()
    assert spec.bucket_bounds[0] == 0 and spec.bucket_bounds[-1] == spec.total
    assert all(b % spec.chunk_size == 0 for b in spec.bucket_bounds)
    assert [r for lo, hi in spec.bucket_leaf_ranges
            for r in range(lo, hi)] == list(range(spec.n_leaves))
    glob = spec.pack(params, torch.float32)
    cat = buckets.concat(buckets.pack(params, torch.float32))
    assert torch.equal(glob, cat)
    for b in range(buckets.n_buckets):
        assert torch.equal(spec.bucket_slice(glob, b),
                           buckets.pack(params)[b])
    out = buckets.unpack(glob)
    for k in params:
        assert torch.equal(out[k], params[k])
    # the JAX package's pack of the same tree, element for element
    jb = JGradBuckets(jax.tree_util.tree_map(
        lambda t: jnp.asarray(t.numpy()), params), bucket_cap_mb=0.002,
        chunk_size=CHUNK)
    jcat = jb.concat(jb.pack(jax.tree_util.tree_map(
        lambda t: jnp.asarray(t.numpy()), params)))
    np.testing.assert_array_equal(cat.numpy(), np.asarray(jcat))


def test_spec_equality_hash_and_shard_bounds():
    a, b = PackSpec(_params(), chunk_size=CHUNK, bucket_elems=1000), \
        PackSpec(_params(seed=1), chunk_size=CHUNK, bucket_elems=1000)
    assert a == b and hash(a) == hash(b)
    assert a != PackSpec(_params(), chunk_size=CHUNK)
    assert a != PackSpec(_params(torch.bfloat16), chunk_size=CHUNK,
                         bucket_elems=1000)
    j = JPackSpec(jax.tree_util.tree_map(lambda t: jnp.asarray(t.numpy()),
                                         _params()), chunk_size=CHUNK)
    t = PackSpec(_params(), chunk_size=CHUNK)
    for n in (1, 2, 4):
        if t.total % n == 0 and (t.total // n) % ROW == 0:
            assert t.shard_bounds(n) == j.shard_bounds(n)
    with pytest.raises(ValueError, match="divisible"):
        t.shard_bounds(t.total // ROW + 1)
    with pytest.raises(ValueError, match="align"):
        PackSpec(_params(), align=ROW + 1)


def test_autobuilt_fp32_reduction_sizes_cap_at_fp32():
    """An fp32 reduction prices the cap in fp32: 4 one-chunk bf16 leaves
    and a cap of 2 fp32 chunks are one bucket in bf16, two in fp32, and
    the auto-built buckets of ``allreduce_always_fp32`` are the latter."""
    chunk = 65536
    tree = {f"w{i}": torch.zeros(chunk, dtype=torch.bfloat16)
            for i in range(4)}
    cap_mb = 2 * chunk * 4 / 2 ** 20
    assert GradBuckets(tree, bucket_cap_mb=cap_mb).n_buckets == 1
    assert GradBuckets(tree, bucket_cap_mb=cap_mb,
                       reduce_dtype=torch.float32).n_buckets == 2
    flat, b = sync_gradients_bucketed(tree, bucket_cap_mb=cap_mb,
                                      allreduce_always_fp32=True)
    assert b.n_buckets == 2 and flat.dtype == torch.float32


def test_oversized_leaf_gets_its_own_bucket():
    tree = {"big": torch.zeros(8 * CHUNK), "small": torch.zeros(8)}
    buckets = GradBuckets(tree, bucket_cap_mb=0.001, chunk_size=CHUNK)
    assert buckets.n_buckets == 2
    buckets.check()


def test_corrupt_bucket_bounds_fail_check():
    buckets = _buckets()
    spec = buckets.spec
    bad = copy.copy(spec)
    bad.bucket_bounds = tuple(list(spec.bucket_bounds[:-1])
                              + [spec.total + 1])
    codes = {c for c, _ in layout_findings(bad)}
    assert {"bucket_bounds_cover", "bucket_not_chunk_aligned"} <= codes
    worse = copy.copy(spec)
    worse.bucket_bounds = spec.bucket_bounds[:-1]
    assert "bucket_tables_mismatch" in {c for c, _ in layout_findings(worse)}
    broken = copy.copy(buckets)
    broken.spec = bad
    with pytest.raises(ValueError, match="bucket_bounds_cover"):
        broken.check()


def test_adopted_spec_rejects_conflicting_chunk_size():
    params = _params()
    buckets = _buckets()
    with pytest.raises(ValueError, match="chunk_size"):
        FusedAdam(lr=1e-3, packed=True, packed_chunk_size=4 * CHUNK,
                  packed_spec=buckets.spec).init(params)
    s = FusedAdam(lr=1e-3, packed=True, packed_chunk_size=CHUNK,
                  packed_spec=buckets.spec).init(params)
    assert s.spec is buckets.spec
    with pytest.raises(ValueError, match="tree does not match"):
        FusedAdam(lr=1e-3, packed=True, packed_spec=buckets.spec).init(
            {"w1": params["w1"]})


def test_flat_grads_reject_layout_mismatch():
    params = _params()
    opt = FusedAdam(lr=1e-3, packed=True)
    state = opt.init(params)
    wrong = torch.zeros(state.spec.total + ROW)
    with pytest.raises(ValueError, match="PackSpec"):
        opt.step(wrong, state, params)
    with pytest.raises(ValueError, match="packed_spec requires"):
        FusedAdam(packed_spec=state.spec)
    with pytest.raises(ValueError, match="packed_spec requires"):
        FusedSGD(lr=0.1, packed_spec=state.spec)
    with pytest.raises(ValueError, match="buckets"):
        DistributedDataParallel("data", bucket_cap_mb=1.0).wrap_grad_fn(
            lambda p: p, flat=True)
    with pytest.raises(ValueError, match="expected"):
        _buckets().concat([torch.zeros(CHUNK)])


def test_single_bare_leaf_pytree_still_packs():
    w = torch.ones(1000)
    opt = FusedAdam(lr=1e-3, packed=True, packed_chunk_size=CHUNK)
    state = opt.init(w)
    assert state.spec.total != w.shape[0]
    p1, _ = opt.step(torch.ones_like(w) * 1e-2, state, w)
    flat = state.spec.pack(torch.ones_like(w) * 1e-2, torch.float32)
    p2, _ = opt.step(flat, opt.init(w), w)
    assert torch.equal(p1, p2)


def test_step_flat_matches_step_and_noop_contract():
    params = _params()
    buckets = _buckets()
    grads = tree_map(lambda p: torch.ones_like(p) * 1e-2, params)
    flat = buckets.concat(buckets.pack(grads))
    opt = FusedAdam(lr=1e-2, master_weights=True, packed=True,
                    packed_spec=buckets.spec)
    no = torch.tensor(False)
    p_ref, s_ref = opt.step(flat, opt.init(params), params, found_inf=no)
    s_got = opt.step_flat(BucketBuffers(tuple(buckets.pack(grads))),
                          opt.init(params), found_inf=no)
    assert torch.equal(s_got.exp_avg, s_ref.exp_avg)
    assert torch.equal(s_got.master_params, s_ref.master_params)
    got = buckets.unpack(s_got.master_params)
    for k in params:
        assert torch.equal(got[k], p_ref[k])
    frozen = [t.clone() for t in (s_got.step, s_got.exp_avg,
                                  s_got.exp_avg_sq, s_got.master_params)]
    s_skip = opt.step_flat(flat, s_got, found_inf=torch.tensor(True),
                           grad_scale=2.0)
    for a, b in zip((s_skip.step, s_skip.exp_avg, s_skip.exp_avg_sq,
                     s_skip.master_params), frozen):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="master_weights"):
        FusedAdam(lr=1e-2, packed=True).step_flat(flat, opt.init(params))


def test_step_on_the_reduced_buffer_matches_jax():
    """``FusedAdam(packed_spec=buckets.spec)`` stepping on the bucketed
    buffer against the JAX optimizer over the JAX buckets' spec, 3 steps
    (the JAX kernel in interpret mode)."""
    from apex_tpu.optimizers import FusedAdam as JFusedAdam

    params = _params()
    jparams = jax.tree_util.tree_map(lambda t: jnp.asarray(t.numpy()),
                                     params)
    tb, jb = _buckets(), JGradBuckets(jparams, bucket_cap_mb=0.002,
                                      chunk_size=CHUNK)
    topt = FusedAdam(lr=1e-2, master_weights=True, packed=True,
                     packed_spec=tb.spec, capturable=True,
                     set_grad_none=True)
    jopt = JFusedAdam(lr=1e-2, master_weights=True, packed=True,
                      packed_spec=jb.spec, packed_interpret=True)
    ts, js = topt.init(params), jopt.init(jparams)
    tp, jp = params, jparams
    rng = np.random.default_rng(7)
    for _ in range(3):
        g = {k: rng.normal(size=v.shape).astype(np.float32) * 1e-2
             for k, v in params.items()}
        tflat = tb.concat(tb.pack({k: torch.from_numpy(v)
                                   for k, v in g.items()}))
        jflat = jb.concat(jb.pack({k: jnp.asarray(v) for k, v in g.items()}))
        tp, ts = topt.step(BucketBuffers(tuple(tb.pack(
            {k: torch.from_numpy(v) for k, v in g.items()}))), ts, tp)
        jp, js = jopt.step(jflat, js, jp)
        assert torch.equal(tflat, tb.concat(tb.pack(
            {k: torch.from_numpy(v) for k, v in g.items()})))
    np.testing.assert_allclose(ts.master_params.numpy(),
                               np.asarray(js.master_params), **STATE_TOL)
    for k in params:
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]),
                                   **STATE_TOL)


def test_found_inf_flat_matches_unscale_flat_verdict():
    params = _params()
    buckets = _buckets()
    scaler, jscaler = LossScaler(loss_scale=4.0), JLossScaler(loss_scale=4.0)
    for poison in (False, True):
        grads = tree_map(torch.ones_like, params)
        if poison:
            grads["w1"][0, 0] = float("inf")
        flat = buckets.concat(buckets.pack(grads))
        bufs = BucketBuffers(tuple(buckets.pack(grads)))
        _, ref = scaler.unscale_flat(scaler.init_state("cpu"), flat,
                                     out_dtype=torch.float32)
        _, ref_b = scaler.unscale_flat(scaler.init_state("cpu"), bufs,
                                       out_dtype=torch.float32)
        got_flat = scaler.found_inf_flat(scaler.init_state("cpu"), flat)
        got_bufs = scaler.found_inf_flat(scaler.init_state("cpu"), bufs)
        want = jscaler.found_inf_flat(jscaler.init_state(),
                                      jnp.asarray(flat.numpy()))
        assert bool(got_flat.found_inf) == bool(ref.found_inf) == \
            bool(ref_b.found_inf) == bool(got_bufs.found_inf) == \
            bool(want.found_inf) == poison


@pytest.mark.parametrize("scale", [2.0 ** -10, 1.0, 4.0])
def test_found_inf_flat_under_a_collapsed_scale_matches_jax(scale):
    """Below scale 1 a finite ``g`` whose deferred ``1 / scale`` would
    overflow counts; at or above 1 it does not: the JAX verdict."""
    big = np.full((8,), 1e36, np.float32)
    got = LossScaler(loss_scale=scale)
    want = JLossScaler(loss_scale=scale)
    g = bool(got.found_inf_flat(got.init_state("cpu"),
                                torch.from_numpy(big)).found_inf)
    w = bool(want.found_inf_flat(want.init_state(),
                                 jnp.asarray(big)).found_inf)
    assert g == w == (scale < 1.0)


def test_fused_sgd_accepts_reduced_flat_buffer():
    params = _params()
    grads = tree_map(lambda p: torch.ones_like(p) * 1e-2, params)
    buckets = _buckets()
    opt = FusedSGD(lr=0.1, momentum=0.9, packed=True,
                   packed_spec=buckets.spec)
    s1, s2, s3 = opt.init(params), opt.init(params), opt.init(params)
    flat = buckets.concat(buckets.pack(grads))
    p_flat, s_flat = opt.step(flat, s1, params)
    p_tree, s_tree = opt.step(grads, s2, params)
    p_bufs, s_bufs = opt.step(BucketBuffers(tuple(buckets.pack(grads))),
                              s3, params)
    for k in params:
        assert torch.equal(p_flat[k], p_tree[k])
        assert torch.equal(p_bufs[k], p_tree[k])
    assert torch.equal(s_flat.exp_avg, s_tree.exp_avg)
    assert s_flat.spec is buckets.spec


def test_unscale_flat_found_inf_and_provenance():
    from apex_tpu_torch.telemetry.numerics import NumericsMonitor

    params = _params()
    buckets = _buckets()
    grads = tree_map(torch.ones_like, params)
    grads["w2"][3, 1] = float("inf")
    scaler = LossScaler(loss_scale=2.0)
    monitor = NumericsMonitor(spec=buckets.spec)
    for handoff in (buckets.concat(buckets.pack(grads)),
                    BucketBuffers(tuple(buckets.pack(grads)))):
        out, sstate, nstate = scaler.unscale_flat(
            scaler.init_state("cpu"), handoff, out_dtype=torch.float32,
            numerics=(monitor, monitor.init(device="cpu")))
        assert bool(sstate.found_inf)
        names = buckets.spec.leaf_names()
        bad = [n for n, f in zip(names, nstate.grad_nonfinite.tolist())
               if f > 0]
        assert bad == ["['w2']"]
        assert float(out[0]) == 0.5


def test_sweep_bytes():
    params = _params(torch.bfloat16)
    buckets = GradBuckets(params, bucket_cap_mb=0.002, chunk_size=CHUNK)
    total = buckets.spec.total
    assert buckets.sweep_bytes() == 2 * total + 3 * 2 * total
    f32 = GradBuckets(params, bucket_cap_mb=0.002, chunk_size=CHUNK,
                      reduce_dtype=torch.float32)
    assert f32.sweep_bytes() == 2 * total + 3 * 4 * total
    jb = JGradBuckets(jax.tree_util.tree_map(
        lambda t: jnp.asarray(t.float().numpy(), jnp.bfloat16), params),
        bucket_cap_mb=0.002, chunk_size=CHUNK, reduce_dtype=jnp.float32)
    assert f32.sweep_bytes() == jb.sweep_bytes()


def test_ddp_wrappers_at_world_one():
    """Without a process group the world is 1: the bucketed path is the
    packed buffer, ``sync`` keeps every leaf bit for bit, ``wrap_grad_fn``
    takes ``has_value`` and ``flat``, and ``collective_budget`` counts one
    all-reduce a bucket."""
    params = _params()
    buckets = _buckets()
    ddp = DistributedDataParallel("data", bucket_cap_mb=0.002,
                                  message_size=1, delay_allreduce=True,
                                  num_allreduce_streams=2)
    flat, b = ddp.reduce_flat(params, buckets=buckets)
    assert b is buckets and torch.equal(flat, buckets.spec.pack(params))
    synced = ddp.sync(params)
    for k in params:
        assert torch.equal(synced[k], params[k])
    fn = ddp.wrap_grad_fn(lambda p: (torch.tensor(1.0), p), has_value=True)
    v, g = fn(params)
    assert float(v) == 1.0 and torch.equal(g["w1"], params["w1"])
    out = ddp.wrap_grad_fn(lambda p: p, flat=True, buckets=buckets)(params)
    assert torch.equal(out, flat)
    budget = ddp.collective_budget(buckets, extra_psums=2)
    assert budget.counts == {"all_reduce": buckets.n_buckets + 2}
    assert budget.axes == ("data",)


# ---------------------------------------------------------------------------
# C9: chunk_size on the rest of the flat path
# ---------------------------------------------------------------------------

C9_CHUNKS = (ROW, 4 * ROW)
N_ROWS = 8


def _arrays(seed, n=N_ROWS * ROW):
    rng = np.random.default_rng(seed)
    out = {k: rng.normal(size=n).astype(np.float32) * s for k, s in
           (("g", 1e-2), ("m", 1e-3), ("v", 1e-6), ("src", 0.1),
            ("u", 1e-2))}
    out["v"] = np.abs(out["v"])  # a second moment
    return out


def _ops(a, rows_vec):
    """``name -> (args, kwargs, bf16 output positions)`` of the six packed
    ops, the arrays as numpy."""
    hyper = dict(lr=1e-3, bc1=0.1, bc2=0.001, inv_scale=0.5)
    return {
        "packed_adam_apply": ((a["g"], a["m"], a["v"], a["src"]),
                              dict(param_dtype="bfloat16", **hyper,
                                   wd=0.01), (0,)),
        "packed_sgd_apply": ((a["g"], a["m"], a["src"]),
                             dict(param_dtype="float32", lr=0.1,
                                  first_run=0.0, inv_scale=0.5,
                                  momentum=0.9, wd=1e-4), ()),
        "packed_lamb_stage1": ((a["g"], a["m"], a["v"], a["src"]),
                               dict(clip=1.5, bc1=0.1, bc2=0.001,
                                    inv_scale=0.5), ()),
        "packed_scale_update": ((a["u"], a["src"], rows_vec),
                                dict(param_dtype="bfloat16", lr=1e-2),
                                (0,)),
        "packed_novograd_apply": ((a["g"], a["m"], a["src"], rows_vec),
                                  dict(param_dtype="float32", lr=1e-3,
                                       bc1=0.1, inv_scale=0.5, wd=1e-3),
                                  ()),
        "packed_row_reduce": ((a["g"],), dict(op="sqsum", inv_scale=0.5),
                              ()),
    }


def _as_torch(x):
    return torch.from_numpy(np.array(x)) if isinstance(x, np.ndarray) else x


@pytest.mark.parametrize("chunk", C9_CHUNKS)
@pytest.mark.parametrize("name", ["packed_adam_apply", "packed_sgd_apply",
                                  "packed_lamb_stage1", "packed_scale_update",
                                  "packed_novograd_apply",
                                  "packed_row_reduce"])
def test_packed_op_chunk_size_matches_jax(name, chunk):
    a = _arrays(chunk + len(name))
    rows_vec = np.abs(np.random.default_rng(3).normal(
        size=N_ROWS)).astype(np.float32) + 0.5
    args, kw, bf16_out = _ops(a, rows_vec)[name]
    jkw = {k: (jnp.dtype(v) if k == "param_dtype" else v)
           for k, v in kw.items()}
    want = getattr(J, name)(*(jnp.asarray(x) for x in args), **jkw,
                            chunk_size=chunk, use_kernel=True,
                            interpret=True)
    tkw = {k: (getattr(torch, v) if k == "param_dtype" else v)
           for k, v in kw.items()}
    got = getattr(T, name)(*(_as_torch(x) for x in args), **tkw,
                           chunk_size=chunk)
    want = want if isinstance(want, tuple) else (want,)
    got = got if isinstance(got, tuple) else (got,)
    assert len(got) >= len(want)
    for i, w in enumerate(want):
        if w is None:
            continue
        g = got[i].float().numpy()
        np.testing.assert_allclose(
            g, np.asarray(w, np.float32),
            **(BF16_TOL if i in bf16_out else STATE_TOL), err_msg=str(i))
    with pytest.raises(ValueError, match="chunk_size"):
        getattr(T, name)(*(_as_torch(x) for x in args), **tkw, chunk_size=0)


@pytest.mark.parametrize("chunk", C9_CHUNKS)
def test_clip_grad_norm_flat_chunk_size_matches_jax(chunk):
    assert clip_grad_norm_flat.accepts_chunk_size
    assert j_clip_flat.accepts_chunk_size
    g = np.random.default_rng(chunk).normal(size=5 * ROW + 37).astype(
        np.float32)
    jc, jn = j_clip_flat(jnp.asarray(g), 1.0, chunk_size=chunk,
                         use_kernel=True, interpret=True)
    tc, tn = clip_grad_norm_flat(torch.from_numpy(g), 1.0, chunk_size=chunk)
    np.testing.assert_allclose(float(tn), float(jn), rtol=1e-6)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=1e-6,
                               atol=1e-9)
    with pytest.raises(ValueError, match="chunk_size"):
        clip_grad_norm_flat(torch.from_numpy(g), 1.0, chunk_size=-ROW)


@pytest.mark.parametrize("chunk", C9_CHUNKS)
def test_unscale_flat_chunk_size_matches_jax(chunk):
    g = np.random.default_rng(chunk).normal(size=3 * ROW + 5).astype(
        np.float32)
    g[ROW + 2] = np.inf
    scaler, jscaler = LossScaler(loss_scale=8.0), JLossScaler(loss_scale=8.0)
    out, st = scaler.unscale_flat(scaler.init_state("cpu"),
                                  torch.from_numpy(g), chunk_size=chunk)
    jout, jst = jscaler.unscale_flat(jscaler.init_state(), jnp.asarray(g),
                                     chunk_size=chunk, use_kernel=True,
                                     interpret=True)
    np.testing.assert_array_equal(out.numpy(), np.asarray(jout))
    assert bool(st.found_inf) == bool(jst.found_inf) is True
    with pytest.raises(ValueError, match="chunk_size"):
        scaler.unscale_flat(scaler.init_state("cpu"), torch.from_numpy(g),
                            chunk_size=0)


def test_multi_tensor_applier_forwards_chunk_to_the_clip():
    from apex_tpu_torch.multi_tensor_apply import MultiTensorApply

    g = torch.from_numpy(np.random.default_rng(0).normal(
        size=4 * ROW).astype(np.float32))
    direct = clip_grad_norm_flat(g, 0.5, chunk_size=ROW)
    via = MultiTensorApply(ROW)(clip_grad_norm_flat, g, 0.5)
    for a, b in zip(direct, via):
        assert torch.equal(a, b)
    assert tree_leaves(via)


def test_numerics_monitor_over_a_bucketed_spec_matches_jax():
    """A monitor built from a bucketed spec: the padding rows where a
    bucket closes lie between leaves, and the per-leaf sums of squares,
    maxima and non-finite counts of a flat buffer still equal the JAX
    monitor's (``segment_sum`` over the row ids)."""
    from apex_tpu.telemetry.numerics import NumericsMonitor as JMonitor
    from apex_tpu_torch.telemetry.numerics import NumericsMonitor

    params = _params()
    grads = tree_map(lambda p: torch.randn(p.shape, generator=torch.Generator(
    ).manual_seed(p.numel())), params)
    grads["b1"][5] = float("nan")
    tb = _buckets()
    jparams = jax.tree_util.tree_map(lambda t: jnp.asarray(t.numpy()),
                                     params)
    jb = JGradBuckets(jparams, bucket_cap_mb=0.002, chunk_size=CHUNK)
    assert any(tb.spec.row_leaf_ids()[:-1] == tb.spec.n_leaves)
    flat = tb.concat(tb.pack(grads))
    tmon, jmon = NumericsMonitor(spec=tb.spec), JMonitor(spec=jb.spec)
    ts = tmon.observe(tmon.init(device="cpu"), flat_grads=flat,
                      inv_scale=0.5)
    js = jmon.observe(jmon.init(), flat_grads=jnp.asarray(flat.numpy()),
                      inv_scale=0.5)
    np.testing.assert_allclose(ts.grad_sq.numpy(), np.asarray(js.grad_sq),
                               rtol=1e-6, equal_nan=True)
    np.testing.assert_array_equal(ts.grad_maxabs.numpy(),
                                  np.asarray(js.grad_maxabs))
    np.testing.assert_array_equal(ts.grad_nonfinite.numpy(),
                                  np.asarray(js.grad_nonfinite))


def test_checkpoint_keeps_the_bucketed_layout(tmp_path):
    """A packed state over a ``GradBuckets`` layout round-trips through
    ``checkpoint`` without a target: the loaded spec is the bucketed one
    (``align``, chunk and bucket cap), its buffers bit for bit."""
    from apex_tpu_torch.checkpoint import load_checkpoint, save_checkpoint

    params = _params()
    buckets = _buckets()
    opt = FusedAdam(lr=1e-2, master_weights=True, packed=True,
                    packed_spec=buckets.spec)
    state = opt.init(params)
    save_checkpoint(str(tmp_path / "ck"), {"opt": state})
    back = load_checkpoint(str(tmp_path / "ck"))["opt"]
    assert back.spec == buckets.spec
    assert back.spec.bucket_bounds == buckets.spec.bucket_bounds
    assert torch.equal(back.master_params, state.master_params)
