"""The port's packed LAMB against the JAX package's, on the CPU: the
row reduce, the global norm over a flat buffer, LAMB's two stages,
``FusedLAMB(packed=True)`` under every option set, a state carried from
JAX, the overflow skip, and a 2-layer BERT trained 3 steps.

The same numpy-seeded buffers and trees go through the JAX package, with
its Pallas kernels in interpret mode (``use_kernel=True, interpret=True``
or ``packed_interpret=True``) and on its XLA route, and through the port
on the CPU (its plain versions). The CUDA kernels are held against the
plain versions on the card by ``tests/test_torch_cuda.py`` and
``chip_smoke.py``.

Tolerances: elementwise fp32 results (the update u, m, v, masters) atol
1e-7 rtol 1e-6 (each operation rounded once in fp32 on both sides, XLA
may contract or reorder a product: a few ulps); row sums rtol 1e-6
(summation order); max |x| exactly; bf16 outputs one bf16 rounding
(rtol 8e-3); 5 optimizer steps rtol 1e-5 atol 1e-6 (the trust ratios'
norms are summed in another order, as ``test_torch_bert.py`` holds the
pytree LAMB); the 2-layer BERT's losses rtol 1e-5 and its params after 3
steps rtol 1e-5 atol 1e-6; a set ``found_inf`` leaves params and state
bit for bit.
"""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.multi_tensor_apply.packing import PackSpec as JaxPackSpec
from apex_tpu.optimizers import FusedLAMB as JaxFusedLAMB
from apex_tpu.transformer.testing import GPTConfig as JaxGPTConfig
from apex_tpu.transformer.testing.standalone_bert import (
    bert_model_provider as jax_bert_provider,
)
from apex_tpu_torch._tree import tree_leaves, tree_map, value_and_grad
from apex_tpu_torch.convert import packed_state_from_jax, params_from_jax
from apex_tpu_torch.multi_tensor_apply.packing import ROW, PackSpec
from apex_tpu_torch.ops.packed_optimizer import (
    multi_tensor_l2norm_flat,
    packed_lamb_stage1,
    packed_row_reduce,
    packed_scale_update,
)
from apex_tpu_torch.optimizers import FusedLAMB, FusedMixedPrecisionLamb
from apex_tpu_torch.transformer.testing import GPTConfig, bert_model_provider
from test_torch_bert import LAMB_CASES, _lamb_tree
from test_torch_packed_adam import _jax_state_np

JP = importlib.import_module("apex_tpu.ops.packed_optimizer")

STATE_TOL = dict(rtol=1e-6, atol=1e-7)
SUM_TOL = dict(rtol=1e-6, atol=0)
BF16_TOL = dict(rtol=8e-3, atol=1e-7)
STEP_TOL = dict(rtol=1e-5, atol=1e-6)

#: the JAX side: the Pallas kernels in interpret mode, or the XLA route
ROUTES = {"interpret": dict(use_kernel=True, interpret=True),
          "xla": dict(use_kernel=False)}


def _t(a):
    return torch.from_numpy(np.array(a))


def _buf(rng, n, scale=1.0, positive=False):
    a = rng.normal(size=n) * scale
    return (np.abs(a) if positive else a).astype(np.float32)


def _close(got, want, **tol):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(jnp.asarray(want, jnp.float32)),
                               **tol)


@pytest.mark.parametrize("route", list(ROUTES))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("op", ["sqsum", "maxabs"])
def test_packed_row_reduce_matches_jax(op, dtype, route):
    rng = np.random.default_rng(0)
    x = _buf(rng, 6 * ROW)
    x[ROW + 5] = -40.0  # one row's max |x| is a negative entry
    jx = jnp.asarray(x).astype(dtype)
    want = JP.packed_row_reduce(jx, op=op, inv_scale=0.5, chunk_size=2048,
                                **ROUTES[route])
    got = packed_row_reduce(_t(np.asarray(jx.astype(jnp.float32))).to(
        getattr(torch, dtype)), op=op, inv_scale=0.5)
    assert got.shape == (6,) and got.dtype == torch.float32
    if op == "maxabs":
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        assert float(got[1]) == 20.0
    else:
        _close(got, want, **SUM_TOL)
    with pytest.raises(ValueError, match="unknown row reduction"):
        packed_row_reduce(got, op="mean")


def test_packed_row_reduce_maxabs_keeps_nan():
    x = torch.zeros(2 * ROW)
    x[ROW + 3] = float("nan")
    got = packed_row_reduce(x, op="maxabs")
    assert float(got[0]) == 0.0 and torch.isnan(got[1])


@pytest.mark.parametrize("route", list(ROUTES))
def test_multi_tensor_l2norm_flat_matches_jax(route):
    """An awkward length (not whole rows): zero padding to the next row,
    the row partials of the input's rows only."""
    rng = np.random.default_rng(1)
    x = _buf(rng, 5000)
    jn, jrows = JP.multi_tensor_l2norm_flat(jnp.asarray(x), inv_scale=2.0,
                                            chunk_size=2048, **ROUTES[route])
    tn, trows = multi_tensor_l2norm_flat(_t(x), inv_scale=2.0)
    assert trows.shape == jrows.shape == (5,)
    _close(tn, jn, **SUM_TOL)
    _close(trows, jrows, **SUM_TOL)
    np.testing.assert_allclose(float(tn), 2 * np.linalg.norm(
        x.astype(np.float64)), rtol=1e-6)


STAGE1_CASES = {
    "adamw": dict(),
    "adam_l2": dict(adam_w_mode=False),
    "no_weight_decay": dict(wd=0.0),
    "no_averaging": dict(beta3=1.0),
    "bf16_grads": dict(),
    "noop": dict(),
}


def _stage1_inputs(seed=2, n=4 * ROW):
    rng = np.random.default_rng(seed)
    return (_buf(rng, n, 1e-2), _buf(rng, n, 1e-3),
            _buf(rng, n, 1e-5, positive=True), _buf(rng, n, 0.05))


@pytest.mark.parametrize("route", list(ROUTES))
@pytest.mark.parametrize("case", list(STAGE1_CASES))
def test_packed_lamb_stage1_matches_jax(case, route):
    g, m, v, src = _stage1_inputs()
    jg = jnp.asarray(g, jnp.bfloat16 if case == "bf16_grads" else
                     jnp.float32)
    hyper = dict(clip=1.7, bc1=0.19, bc2=0.002, inv_scale=0.25,
                 beta1=0.9, beta2=0.999, beta3=0.1, eps=1e-6, wd=0.01)
    hyper.update(STAGE1_CASES[case])
    want = JP.packed_lamb_stage1(jg, jnp.asarray(m), jnp.asarray(v),
                                 jnp.asarray(src), chunk_size=2048,
                                 **hyper, **ROUTES[route])
    tg = _t(np.asarray(jg.astype(jnp.float32))).to(
        torch.bfloat16 if case == "bf16_grads" else torch.float32)
    tm, tv, ts = _t(m), _t(v), _t(src)
    noop = torch.tensor(True) if case == "noop" else None
    u, gm, gv, ru, rp = packed_lamb_stage1(tg, tm, tv, ts, noop=noop,
                                           **hyper)
    assert gm is tm and gv is tv  # in place
    _close(u, want[0], **STATE_TOL)
    if case == "noop":  # the state stays as it was, bit for bit
        np.testing.assert_array_equal(tm.numpy(), m)
        np.testing.assert_array_equal(tv.numpy(), v)
    else:
        _close(tm, want[1], **STATE_TOL)
        _close(tv, want[2], **STATE_TOL)
    assert ru.shape == rp.shape == (4,)
    _close(ru, want[3], **SUM_TOL)
    _close(rp, want[4], **SUM_TOL)
    np.testing.assert_array_equal(ts.numpy(), src)  # never written


@pytest.mark.parametrize("route", list(ROUTES))
@pytest.mark.parametrize("write_master", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_packed_scale_update_matches_jax(dtype, write_master, route):
    rng = np.random.default_rng(3)
    u, src = _buf(rng, 4 * ROW), _buf(rng, 4 * ROW, 0.05)
    coef = np.array([0.5, 1.0, 2.5, 0.0], np.float32)
    want_p, want_m = JP.packed_scale_update(
        jnp.asarray(u), jnp.asarray(src), jnp.asarray(coef),
        param_dtype=getattr(jnp, dtype), lr=1e-2, write_master=write_master,
        chunk_size=2048, **ROUTES[route])
    ts = _t(src)
    p_out, master = packed_scale_update(
        _t(u), ts, _t(coef), param_dtype=getattr(torch, dtype), lr=1e-2,
        write_master=write_master)
    assert p_out.dtype == getattr(torch, dtype)
    _close(p_out, want_p, **(BF16_TOL if dtype == "bfloat16"
                             else STATE_TOL))
    if write_master:
        assert master is ts
        _close(ts, want_m, **STATE_TOL)
    else:
        assert master is None and want_m is None
        np.testing.assert_array_equal(ts.numpy(), src)
    # the coefficient 0 row keeps its source exactly
    np.testing.assert_array_equal(p_out[3 * ROW:].float().numpy(),
                                  _t(src[3 * ROW:]).to(p_out.dtype).float())
    # noop: the parameter output is the recast source, the master stays
    ts2 = _t(src)
    p_skip, _ = packed_scale_update(_t(u), ts2, _t(coef),
                                    param_dtype=getattr(torch, dtype),
                                    lr=1e-2, noop=torch.tensor(True))
    assert torch.equal(p_skip, _t(src).to(p_skip.dtype))
    np.testing.assert_array_equal(ts2.numpy(), src)


def test_row_segments_follow_the_jax_layout():
    """Each leaf's rows are one contiguous range: the segment lengths
    rebuild ``row_leaf_ids`` (the JAX package's) exactly, the padding
    rows last; the device copies are made once per spec."""
    rng = np.random.default_rng(4)
    p0 = _lamb_tree(rng)
    spec = PackSpec(tree_map(_t, p0), chunk_size=8 * ROW)
    jspec = JaxPackSpec(jax.tree_util.tree_map(jnp.asarray, p0),
                        chunk_size=8 * ROW)
    lengths = spec.row_segment_lengths()
    assert lengths.shape == (spec.n_leaves + 1,)
    assert lengths.sum() == spec.n_rows == 8
    np.testing.assert_array_equal(
        np.repeat(np.arange(spec.n_leaves + 1), lengths),
        jspec.row_leaf_ids())
    tl, ti = spec.row_segments("cpu")
    assert spec.row_segments("cpu")[0] is tl  # cached
    np.testing.assert_array_equal(tl.numpy(), lengths)
    np.testing.assert_array_equal(ti.numpy(), jspec.row_leaf_ids())


def _run_lamb(kw, p0, grads, bf16=False, packed_interpret=True):
    jopt = JaxFusedLAMB(packed_interpret=packed_interpret, **kw)
    topt = FusedLAMB(**kw)
    jp = jax.tree_util.tree_map(
        lambda a: jnp.asarray(a, jnp.bfloat16 if bf16 else jnp.float32), p0)
    tp = tree_map(lambda a: _t(a).to(torch.bfloat16 if bf16
                                     else torch.float32), p0)
    js, ts = jopt.init(jp), topt.init(tp)
    for g in grads:
        jp, js = jopt.step(jax.tree_util.tree_map(jnp.asarray, g), js, jp)
        tp, ts = topt.step(tree_map(_t, g), ts, tp)
    return jp, js, tp, ts


@pytest.mark.parametrize("case", list(LAMB_CASES))
def test_five_packed_lamb_steps_match_jax(case):
    """5 steps of ``FusedLAMB(packed=True)`` under each option set of the
    pytree test, the JAX side running its Pallas kernels in interpret
    mode: moments, masters and params."""
    kw = dict(lr=1e-2, packed=True, **LAMB_CASES[case])
    rng = np.random.default_rng(5)
    p0 = _lamb_tree(rng)
    grads = [_lamb_tree(rng) for _ in range(5)]
    bf16 = case == "master_weights"
    jp, js, tp, ts = _run_lamb(kw, p0, grads, bf16=bf16)
    assert int(ts.step) == int(js.step) == 5
    _close(ts.exp_avg, js.exp_avg, **STEP_TOL)
    _close(ts.exp_avg_sq, js.exp_avg_sq, **STEP_TOL)
    if bf16:
        _close(ts.master_params, js.master_params, **STEP_TOL)
    else:
        assert ts.master_params is None
    for a, b in zip(jax.tree_util.tree_leaves(jp), tree_leaves(tp)):
        assert b.dtype == (torch.bfloat16 if bf16 else torch.float32)
        _close(b, a, **(dict(rtol=8e-3, atol=1e-6) if bf16 else STEP_TOL))


def test_packed_lamb_chunk_size_and_xla_route():
    """``packed_chunk_size`` lays out the same buffers as the JAX
    package's, and the port also tracks the JAX package's XLA route."""
    kw = dict(lr=1e-2, packed=True, packed_chunk_size=4 * ROW,
              use_nvlamb=True)
    rng = np.random.default_rng(6)
    p0 = _lamb_tree(rng)
    grads = [_lamb_tree(rng) for _ in range(3)]
    jp, js, tp, ts = _run_lamb(kw, p0, grads, packed_interpret=False)
    assert ts.spec.total == js.spec.total == 4 * ROW
    _close(ts.exp_avg, js.exp_avg, **STEP_TOL)
    for a, b in zip(jax.tree_util.tree_leaves(jp), tree_leaves(tp)):
        _close(b, a, **STEP_TOL)


def test_packed_lamb_steps_from_carried_state():
    """Two JAX steps make non-zero moments and masters; the state is
    carried into the port and both run 3 more steps."""
    kw = dict(lr=1e-2, packed=True, master_weights=True)
    rng = np.random.default_rng(7)
    p0 = _lamb_tree(rng)
    grads = [_lamb_tree(rng) for _ in range(5)]
    jopt, topt = JaxFusedLAMB(**kw), FusedLAMB(**kw)
    jp = jax.tree_util.tree_map(jnp.asarray, p0)
    js = jopt.init(jp)
    for g in grads[:2]:
        jp, js = jopt.step(jax.tree_util.tree_map(jnp.asarray, g), js, jp)
    tp = params_from_jax(jax.tree_util.tree_map(np.asarray, jp))
    ts = packed_state_from_jax(_jax_state_np(js), PackSpec(tp))
    assert int(ts.step) == 2 and ts.exp_avg_sq is not None
    for g in grads[2:]:
        jp, js = jopt.step(jax.tree_util.tree_map(jnp.asarray, g), js, jp)
        tp, ts = topt.step(tree_map(_t, g), ts, tp)
    assert int(ts.step) == 5
    _close(ts.master_params, js.master_params, **STEP_TOL)
    _close(ts.exp_avg_sq, js.exp_avg_sq, **STEP_TOL)
    for a, b in zip(jax.tree_util.tree_leaves(jp), tree_leaves(tp)):
        _close(b, a, **STEP_TOL)


def test_packed_lamb_found_inf_skips_and_grad_scale_unscales():
    """A set ``found_inf`` (gradients holding inf, as after an overflow)
    leaves params, m, v, masters and the step count bit for bit, as the
    JAX package's ``lax.cond`` does; an unset one with ``grad_scale``
    steps as the JAX package does."""
    rng = np.random.default_rng(8)
    p0, g = _lamb_tree(rng), _lamb_tree(rng)
    topt = FusedMixedPrecisionLamb(lr=1e-2, packed=True)
    tp = tree_map(_t, p0)
    ts = topt.init(tp)
    tp, ts = topt.step(tree_map(_t, g), ts, tp)  # non-zero moments
    before = [x.clone() for x in (ts.exp_avg, ts.exp_avg_sq,
                                  ts.master_params)]
    bad = tree_map(_t, g)
    bad["w"][0, 0] = float("inf")
    sp, ss = topt.step(bad, ts, tp, found_inf=torch.tensor(True),
                       grad_scale=8.0)
    assert int(ss.step) == 1
    for a, b in zip(tree_leaves(tp), tree_leaves(sp)):
        assert torch.equal(a, b)
    for a, b in zip(before, (ss.exp_avg, ss.exp_avg_sq, ss.master_params)):
        assert torch.equal(a, b)

    jopt = JaxFusedLAMB(lr=1e-2, master_weights=True, packed=True)
    jp = jax.tree_util.tree_map(jnp.asarray, p0)
    js = jopt.init(jp)
    jp, js = jopt.step(jax.tree_util.tree_map(jnp.asarray, g), js, jp)
    jp2, js2 = jopt.step(jax.tree_util.tree_map(jnp.asarray, g), js, jp,
                         found_inf=jnp.asarray(True))
    assert int(js2.step) == 1
    jp, js = jopt.step(jax.tree_util.tree_map(lambda a: jnp.asarray(a) * 4,
                                              g), js, jp,
                       found_inf=jnp.asarray(False), grad_scale=4.0)
    tp, ts = topt.step(tree_map(lambda a: _t(a) * 4, g), ss, sp,
                       found_inf=torch.tensor(False), grad_scale=4.0)
    assert int(ts.step) == int(js.step) == 2
    _close(ts.master_params, js.master_params, **STEP_TOL)
    for a, b in zip(jax.tree_util.tree_leaves(jp), tree_leaves(tp)):
        _close(b, a, **STEP_TOL)


BERT_SHAPE = dict(num_layers=2, hidden_size=64, num_attention_heads=4,
                  vocab_size=128, max_position_embeddings=16,
                  hidden_dropout=0.0, attention_dropout=0.0,
                  add_binary_head=True)


def test_bert_trained_three_steps_with_packed_lamb_matches_jax():
    """The slice as a whole: a 2-layer BERT under a padding mask, 3 steps
    of loss, gradients and ``FusedLAMB(lr=1e-3, packed=True)`` in each
    package (the JAX kernels in interpret mode)."""
    jcfg = JaxGPTConfig(**BERT_SHAPE, use_flash_attention=False)
    tcfg = GPTConfig(**BERT_SHAPE, use_flash_attention=False)
    jp, _, jloss = jax_bert_provider(jcfg, jax.random.PRNGKey(9))
    tp = params_from_jax(jax.tree_util.tree_map(np.asarray, jp))
    _, _, tloss = bert_model_provider(tcfg, torch.Generator().manual_seed(0))
    rng = np.random.default_rng(9)
    tokens, labels = (rng.integers(0, 128, size=(2, 16)).astype(np.int32)
                      for _ in range(2))
    padding = np.ones((2, 16), np.int32)
    padding[1, 9:] = 0
    binary = np.array([1, 0], np.int32)
    jargs = [jnp.asarray(a) for a in (tokens, labels, padding)]
    targs = [_t(a) for a in (tokens, labels, padding)]
    jopt = JaxFusedLAMB(lr=1e-3, packed=True, packed_interpret=True)
    topt = FusedLAMB(lr=1e-3, packed=True)
    js, ts = jopt.init(jp), topt.init(tp)
    jl, tl = [], []
    for _ in range(3):
        loss, grads = jax.value_and_grad(lambda p: jloss(
            p, *jargs, padding_mask=jargs[2],
            binary_labels=jnp.asarray(binary)))(jp)
        jp, js = jopt.step(grads, js, jp)
        jl.append(float(loss))
        loss, grads = value_and_grad(lambda p: tloss(
            p, *targs, padding_mask=targs[2], binary_labels=_t(binary)), tp)
        tp, ts = topt.step(grads, ts, tp)
        tl.append(float(loss))
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    assert tl[-1] < tl[0]
    for a, b in zip(jax.tree_util.tree_leaves(jp), tree_leaves(tp)):
        _close(b, a, **STEP_TOL)
