"""The port's FusedSGD and packed SGD sweep against the JAX package's, on
the CPU: the sweep under each option set, 5 steps pytree and packed, a
state carried from JAX, the overflow skip and the grad scale, and a
2-layer GPT trained 3 steps with packed SGD.

The same numpy-seeded buffers and trees go through the JAX package, with
its Pallas kernel in interpret mode (``use_kernel=True, interpret=True``
or ``packed_interpret=True``) and on its XLA route, and through the port
on the CPU (its plain version). The CUDA kernel is held against the plain
version on the card by ``tests/test_torch_cuda.py`` and
``chip_smoke.py``.

Tolerances: fp32 results (momentum buffer, masters, fp32 params) atol
1e-7 rtol 1e-6 (each operation rounded once in fp32 on both sides, XLA
may contract or reorder a product: a few ulps), also over 5 steps (SGD
sums nothing across elements); bf16 params one bf16 rounding (rtol
8e-3); the 2-layer GPT's losses rtol 1e-5 and its params after 3 steps
rtol 1e-5 atol 1e-6 (the gradients differ in summation order); a set
``found_inf`` leaves params and state bit for bit.
"""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.optimizers import FusedSGD as JaxFusedSGD
from apex_tpu.optimizers._packed import packed_init as jax_packed_init
from apex_tpu.transformer.testing import GPTConfig as JaxGPTConfig
from apex_tpu.transformer.testing import gpt_loss as jax_gpt_loss
from apex_tpu.transformer.testing import init_gpt_params as jax_init
from apex_tpu_torch._tree import tree_leaves, tree_map, value_and_grad
from apex_tpu_torch.convert import packed_state_from_jax, params_from_jax
from apex_tpu_torch.multi_tensor_apply.packing import ROW, PackSpec
from apex_tpu_torch.ops.packed_optimizer import packed_sgd_apply
from apex_tpu_torch.optimizers import FusedSGD, FusedSGDState
from apex_tpu_torch.optimizers._packed import packed_init
from apex_tpu_torch.transformer.testing import GPTConfig, gpt_loss
from test_torch_bert import _lamb_tree

JP = importlib.import_module("apex_tpu.ops.packed_optimizer")

STATE_TOL = dict(rtol=1e-6, atol=1e-7)
BF16_TOL = dict(rtol=8e-3, atol=1e-7)
MODEL_TOL = dict(rtol=1e-5, atol=1e-6)

ROUTES = {"interpret": dict(use_kernel=True, interpret=True),
          "xla": dict(use_kernel=False)}

#: the option sets of the sweep and of the optimizer
SGD_CASES = {
    "plain": dict(),
    "momentum": dict(momentum=0.9),
    "dampening": dict(momentum=0.9, dampening=0.3),
    "nesterov": dict(momentum=0.9, nesterov=True),
    "weight_decay": dict(momentum=0.9, wd=1e-2),
    "wd_after_momentum": dict(momentum=0.9, wd=1e-2,
                              wd_after_momentum=True),
    "wd_no_momentum": dict(wd=1e-2),
}


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, **tol):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(jnp.asarray(want, jnp.float32)),
                               **tol)


@pytest.mark.parametrize("route", list(ROUTES))
@pytest.mark.parametrize("first_run", [False, True])
@pytest.mark.parametrize("case", list(SGD_CASES))
def test_packed_sgd_apply_matches_jax(case, first_run, route):
    """bf16 gradients and parameter output, fp32 buffer and masters."""
    rng = np.random.default_rng(0)
    n = 4 * ROW
    g, buf, src = (rng.normal(size=n).astype(np.float32) * s
                   for s in (1e-2, 1e-2, 0.05))
    jg = jnp.asarray(g, jnp.bfloat16)
    kw = SGD_CASES[case]
    want = JP.packed_sgd_apply(jg, jnp.asarray(buf), jnp.asarray(src),
                               param_dtype=jnp.bfloat16, lr=0.1,
                               first_run=first_run, inv_scale=0.5,
                               chunk_size=2048, **kw, **ROUTES[route])
    tb, ts = _t(buf), _t(src)
    p_out, gb, gm = packed_sgd_apply(
        _t(np.asarray(jg.astype(jnp.float32))).to(torch.bfloat16), tb, ts,
        param_dtype=torch.bfloat16, lr=0.1, first_run=first_run,
        inv_scale=0.5, **kw)
    assert gb is tb and gm is ts  # in place
    assert p_out.dtype == torch.bfloat16
    _close(p_out, want[0], **BF16_TOL)
    _close(tb, want[1], **STATE_TOL)
    _close(ts, want[2], **STATE_TOL)
    if "momentum" not in kw:
        np.testing.assert_array_equal(tb.numpy(), buf)


def test_packed_sgd_apply_noop_and_no_master():
    """``noop`` writes nothing and returns the recast source; without
    ``write_master`` the source stays and no master is returned."""
    rng = np.random.default_rng(1)
    g, buf, src = (rng.normal(size=2 * ROW).astype(np.float32)
                   for _ in range(3))
    tb, ts = _t(buf), _t(src)
    p_out, _, master = packed_sgd_apply(
        _t(g), tb, ts, param_dtype=torch.bfloat16, lr=0.1,
        first_run=torch.tensor(False), momentum=0.9, wd=1e-2,
        noop=torch.tensor(True))
    assert torch.equal(p_out, _t(src).to(torch.bfloat16))
    np.testing.assert_array_equal(tb.numpy(), buf)
    np.testing.assert_array_equal(ts.numpy(), src)
    want = JP.packed_sgd_apply(jnp.asarray(g), jnp.asarray(buf),
                               jnp.asarray(src), param_dtype=jnp.float32,
                               lr=0.1, first_run=False, momentum=0.9,
                               write_master=False, use_kernel=False)
    p_out, _, master = packed_sgd_apply(
        _t(g), tb, ts, param_dtype=torch.float32, lr=0.1,
        first_run=torch.tensor(False), momentum=0.9, write_master=False)
    assert master is None and want[2] is None
    np.testing.assert_array_equal(ts.numpy(), src)
    _close(p_out, want[0], **STATE_TOL)
    _close(tb, want[1], **STATE_TOL)


def _opt_kw(case):
    kw = dict(SGD_CASES[case])
    if "wd" in kw:
        kw["weight_decay"] = kw.pop("wd")
    return kw


def _run_sgd(kw, p0, grads, bf16, packed_interpret=False):
    jopt = JaxFusedSGD(packed_interpret=packed_interpret, **kw)
    topt = FusedSGD(**kw)
    jp = jax.tree_util.tree_map(
        lambda a: jnp.asarray(a, jnp.bfloat16 if bf16 else jnp.float32), p0)
    tp = tree_map(lambda a: _t(a).to(torch.bfloat16 if bf16
                                     else torch.float32), p0)
    js, ts = jopt.init(jp), topt.init(tp)
    for g in grads:
        jp, js = jopt.step(jax.tree_util.tree_map(jnp.asarray, g), js, jp)
        tp, ts = topt.step(tree_map(_t, g), ts, tp)
    return jp, js, tp, ts


@pytest.mark.parametrize("masters", [False, True])
@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("case", list(SGD_CASES))
def test_five_sgd_steps_match_jax(case, packed, masters):
    """5 steps, pytree and packed (the JAX packed side running its Pallas
    kernel in interpret mode), fp32 params, or bf16 params over fp32
    masters: the momentum buffer, the masters and the params."""
    kw = dict(lr=0.1, packed=packed, master_weights=masters,
              **_opt_kw(case))
    rng = np.random.default_rng(2)
    p0 = _lamb_tree(rng)
    grads = [_lamb_tree(rng) for _ in range(5)]
    jp, js, tp, ts = _run_sgd(kw, p0, grads, bf16=masters,
                              packed_interpret=packed)
    assert int(ts.step) == int(js.step) == 5
    if packed:
        assert ts.exp_avg_sq is None and js.exp_avg_sq is None
        pairs = [(ts.momentum_buffer, js.momentum_buffer)]
        if masters:
            pairs.append((ts.master_params, js.master_params))
    else:
        assert isinstance(ts, FusedSGDState)
        pairs = list(zip(tree_leaves(ts.momentum_buffer),
                         jax.tree_util.tree_leaves(js.momentum_buffer)))
        if masters:
            pairs += list(zip(tree_leaves(ts.master_params),
                              jax.tree_util.tree_leaves(js.master_params)))
    for got, want in pairs:
        _close(got, want, **STATE_TOL)
    for a, b in zip(jax.tree_util.tree_leaves(jp), tree_leaves(tp)):
        assert b.dtype == (torch.bfloat16 if masters else torch.float32)
        _close(b, a, **(BF16_TOL if masters else STATE_TOL))


def _jax_state_np(state):
    spec = state.spec

    def arr(x):
        return None if x is None else np.asarray(x)
    return {"step": np.asarray(state.step), "exp_avg": arr(state.exp_avg),
            "exp_avg_sq": arr(state.exp_avg_sq),
            "master_params": arr(state.master_params),
            "offsets": spec.offsets, "shapes": spec.shapes,
            "total": spec.total}


def test_packed_sgd_steps_from_carried_state():
    """Two JAX steps materialise the momentum buffer; the SGD state (no
    second moment) is carried into the port and both run 3 more steps."""
    kw = dict(lr=0.1, momentum=0.9, weight_decay=1e-4, packed=True,
              master_weights=True)
    rng = np.random.default_rng(3)
    p0 = _lamb_tree(rng)
    grads = [_lamb_tree(rng) for _ in range(5)]
    jopt, topt = JaxFusedSGD(**kw), FusedSGD(**kw)
    jp = jax.tree_util.tree_map(jnp.asarray, p0)
    js = jopt.init(jp)
    for g in grads[:2]:
        jp, js = jopt.step(jax.tree_util.tree_map(jnp.asarray, g), js, jp)
    tp = params_from_jax(jax.tree_util.tree_map(np.asarray, jp))
    ts = packed_state_from_jax(_jax_state_np(js), PackSpec(tp))
    assert int(ts.step) == 2 and ts.exp_avg_sq is None
    assert ts.momentum_buffer.abs().max() > 0
    for g in grads[2:]:
        jp, js = jopt.step(jax.tree_util.tree_map(jnp.asarray, g), js, jp)
        tp, ts = topt.step(tree_map(_t, g), ts, tp)
    assert int(ts.step) == 5
    _close(ts.momentum_buffer, js.momentum_buffer, **STATE_TOL)
    _close(ts.master_params, js.master_params, **STATE_TOL)
    for a, b in zip(jax.tree_util.tree_leaves(jp), tree_leaves(tp)):
        _close(b, a, **STATE_TOL)


@pytest.mark.parametrize("packed", [False, True])
def test_sgd_found_inf_skips_and_grad_scale_unscales(packed):
    """A set ``found_inf`` (gradients holding inf) leaves params, the
    momentum buffer, the masters and the step count bit for bit; an unset
    one with ``grad_scale`` steps as the JAX package does."""
    kw = dict(lr=0.1, momentum=0.9, weight_decay=1e-4, packed=packed,
              master_weights=True)
    rng = np.random.default_rng(4)
    p0, g = _lamb_tree(rng), _lamb_tree(rng)
    topt = FusedSGD(**kw)
    tp = tree_map(_t, p0)
    ts = topt.init(tp)
    tp, ts = topt.step(tree_map(_t, g), ts, tp)
    before = [x.clone() for x in tree_leaves((ts.momentum_buffer,
                                              ts.master_params))]
    bad = tree_map(_t, g)
    bad["w"][1, 2] = float("inf")
    sp, ss = topt.step(bad, ts, tp, found_inf=torch.tensor(True),
                       grad_scale=8.0)
    assert int(ss.step) == 1
    for a, b in zip(tree_leaves(tp), tree_leaves(sp)):
        assert torch.equal(a, b)
    for a, b in zip(before, tree_leaves((ss.momentum_buffer,
                                         ss.master_params))):
        assert torch.equal(a, b)
    jopt = JaxFusedSGD(**kw)
    jp = jax.tree_util.tree_map(jnp.asarray, p0)
    js = jopt.init(jp)
    jp, js = jopt.step(jax.tree_util.tree_map(jnp.asarray, g), js, jp)
    jp, js = jopt.step(jax.tree_util.tree_map(lambda a: jnp.asarray(a) * 4,
                                              g), js, jp,
                       found_inf=jnp.asarray(False), grad_scale=4.0)
    tp, ts = topt.step(tree_map(lambda a: _t(a) * 4, g), ss, sp,
                       found_inf=torch.tensor(False), grad_scale=4.0)
    assert int(ts.step) == int(js.step) == 2
    for a, b in zip(jax.tree_util.tree_leaves(jp), tree_leaves(tp)):
        _close(b, a, **STATE_TOL)


@pytest.mark.parametrize("masters", [False, True])
@pytest.mark.parametrize("second_moment", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_sweep_bytes_matches_jax_and_a_hand_count(dtype, second_moment,
                                                  masters):
    """``PackedState.sweep_bytes``: the gradient read and the params
    written in the packed dtype, each fp32 state buffer read and written,
    over the padded buffer, as the JAX package counts it."""
    p0 = _lamb_tree(np.random.default_rng(5))
    kw = dict(with_exp_avg_sq=second_moment, master_weights=masters)
    tp = tree_map(lambda a: _t(a).to(getattr(torch, dtype)), p0)
    jp = jax.tree_util.tree_map(
        lambda a: jnp.asarray(a, getattr(jnp, dtype)), p0)
    ts = packed_init(tp, **kw)
    n, item = ts.spec.total, 2 if dtype == "bfloat16" else 4
    want = n * (2 * item + 8 + 8 * second_moment + 8 * masters)
    assert ts.sweep_bytes() == want
    assert jax_packed_init(jp, **kw).sweep_bytes() == want


def test_sgd_refuses_what_it_does_not_take():
    with pytest.raises(ValueError, match="Nesterov"):
        FusedSGD(lr=0.1, nesterov=True)
    # a GradBuckets layout is adopted since A6.2, but only by the packed
    # state (the JAX package's refusal)
    with pytest.raises(ValueError, match="packed_spec requires packed"):
        FusedSGD(lr=0.1, packed_spec=object())


def test_gpt_trained_three_steps_with_packed_sgd_matches_jax():
    """The slice as a whole: a 2-layer GPT, 3 steps of loss, gradients
    and ``FusedSGD(packed=True, master_weights=True, momentum=0.9,
    weight_decay=1e-4)`` in each package (the JAX kernel in interpret
    mode), bf16 params over fp32 masters."""
    shape = dict(num_layers=2, hidden_size=64, num_attention_heads=4,
                 vocab_size=128, max_position_embeddings=32,
                 hidden_dropout=0.0, attention_dropout=0.0)
    jcfg, tcfg = JaxGPTConfig(**shape), GPTConfig(**shape)
    jp = jax_init(jcfg, jax.random.PRNGKey(5))
    tp = params_from_jax(jax.tree_util.tree_map(np.asarray, jp))
    rng = np.random.default_rng(5)
    tokens = rng.integers(0, 128, size=(2, 32)).astype(np.int32)
    labels = np.roll(tokens, -1, axis=1)
    kw = dict(lr=0.1, momentum=0.9, weight_decay=1e-4, packed=True,
              master_weights=True)
    jopt = JaxFusedSGD(packed_interpret=True, **kw)
    topt = FusedSGD(**kw)
    js, ts = jopt.init(jp), topt.init(tp)
    jl, tl = [], []
    for _ in range(3):
        loss, grads = jax.value_and_grad(lambda p: jax_gpt_loss(
            jcfg, p, jnp.asarray(tokens), jnp.asarray(labels)))(jp)
        jp, js = jopt.step(grads, js, jp)
        jl.append(float(loss))
        loss, grads = value_and_grad(lambda p: gpt_loss(
            tcfg, p, _t(tokens), _t(labels)), tp)
        tp, ts = topt.step(grads, ts, tp)
        tl.append(float(loss))
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    assert tl[-1] < tl[0]
    _close(ts.master_params, js.master_params, **MODEL_TOL)
    for a, b in zip(jax.tree_util.tree_leaves(jp), tree_leaves(tp)):
        _close(b, a, **MODEL_TOL)
