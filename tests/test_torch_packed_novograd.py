"""The port's FusedNovoGrad and packed NovoGrad sweep against the JAX
package's, and FusedAdagrad, on the CPU: the sweep under each option
set, 5 steps pytree and packed under each option set of the optimizer
(L2 and inf norm, ``init_zero``, ``grad_averaging`` off,
``reg_inside_moment``, weight decay, a grad scale, no bias correction),
a state carried from JAX mid-run, the overflow skip (bit for bit, the
layer-wise second moment included), the layer-wise moment itself, and
determinism.

The same numpy-seeded trees go through the JAX package, with its Pallas
kernel in interpret mode (``packed_interpret=True`` or ``use_kernel=True,
interpret=True``) and on its XLA route, and through the port on the CPU
(its plain versions). The CUDA kernel is held against the plain version
on the card by ``tests/test_torch_cuda.py`` and ``chip_smoke.py``.

Tolerances: the sweep rounds every operation once in fp32 on both sides
(XLA may contract a product into a fused multiply-add: a few ulps), fp32
results rtol 1e-6 atol 1e-9, bf16 params one bf16 rounding (rtol 8e-3);
over 5 optimizer steps params and moments rtol 1e-5 atol 1e-7 (the
layer-wise norms are sums in another order, ~1e-7 relative, and enter
every element through the denominator; the absolute term is a few fp32
ulps of moments of order 0.1, where ``beta1 * m + beta3 * mi``
cancels); the second moment rtol 1e-5;
Adagrad (elementwise only) rtol 1e-6 atol 1e-9; a set ``found_inf``
leaves params and state bit for bit.
"""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.optimizers import FusedAdagrad as JaxFusedAdagrad
from apex_tpu.optimizers import FusedNovoGrad as JaxFusedNovoGrad
from apex_tpu_torch._tree import tree_leaves, tree_map
from apex_tpu_torch.convert import (
    novograd_state_from_jax,
    packed_state_from_jax,
)
from apex_tpu_torch.multi_tensor_apply.packing import ROW, PackSpec
from apex_tpu_torch.ops.packed_optimizer import packed_novograd_apply
from apex_tpu_torch.optimizers import (
    FusedAdagrad,
    FusedNovoGrad,
    FusedNovoGradState,
    PackedState,
)

JP = importlib.import_module("apex_tpu.ops.packed_optimizer")

SWEEP_TOL = dict(rtol=1e-6, atol=1e-9)
BF16_TOL = dict(rtol=8e-3, atol=1e-7)
STEP_TOL = dict(rtol=1e-5, atol=1e-7)

ROUTES = {"interpret": dict(use_kernel=True, interpret=True),
          "xla": dict(use_kernel=False)}

#: the option sets of the sweep
SWEEP_CASES = {
    "plain": dict(),
    "wd_outside": dict(wd=1e-2),
    "wd_inside": dict(wd=1e-2, reg_inside_moment=True),
    "no_averaging": dict(beta3=1.0),
}

#: the option sets of the optimizer, and the grad scale each step gets
NOVO_CASES = {
    "l2": dict(),
    "inf_norm": dict(norm_type=0),
    "init_zero": dict(init_zero=True),
    "no_grad_averaging": dict(grad_averaging=False),
    "reg_inside_moment": dict(weight_decay=1e-2, reg_inside_moment=True),
    "weight_decay": dict(weight_decay=1e-2),
    "no_bias_correction": dict(bias_correction=False, norm_type=0,
                               init_zero=True),
    "grad_scale": dict(weight_decay=1e-3),
}


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _trees(seed: int, scale: float):
    """A 3-leaf tree (leaf sizes that are not whole rows) as numpy."""
    rng = np.random.default_rng(seed)
    return {"w": (rng.normal(size=(96, 64)) * scale).astype(np.float32),
            "b": (rng.normal(size=70) * scale).astype(np.float32),
            "layers": {"k": (rng.normal(size=(3, 40, 33))
                             * scale).astype(np.float32)}}


def _both(tree, jdt=jnp.float32, tdt=torch.float32):
    j = jax.tree_util.tree_map(lambda a: jnp.asarray(a).astype(jdt), tree)
    t = tree_map(lambda a: torch.from_numpy(np.array(a)).to(tdt), tree)
    return j, t


def _close_trees(jt, tt, **tol):
    for a, b in zip(jax.tree_util.tree_leaves(jt), tree_leaves(tt)):
        np.testing.assert_allclose(_np(b), _np(a), **tol)


def _state_leaves(state):
    if isinstance(state, PackedState):
        return [state.step, state.exp_avg, state.exp_avg_sq]
    return [state.step, *tree_leaves(state.exp_avg),
            *tree_leaves(state.exp_avg_sq)]


def _jax_state_leaves(state):
    if hasattr(state, "spec"):
        return [state.step, state.exp_avg, state.exp_avg_sq]
    return [state.step, *jax.tree_util.tree_leaves(state.exp_avg),
            *jax.tree_util.tree_leaves(state.exp_avg_sq)]


# ---------------------------------------------------------------------------
# the sweep
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("route", list(ROUTES))
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("case", list(SWEEP_CASES))
def test_packed_novograd_apply_matches_jax(case, dtype, route):
    rows = 37
    n = rows * ROW
    rng = np.random.default_rng(0)
    g = (rng.normal(size=n) * 1e-3).astype(np.float32)
    m = (rng.normal(size=n) * 1e-4).astype(np.float32)
    src = (rng.normal(size=n) * 0.02).astype(np.float32)
    denom = (rng.random(rows) + 0.5).astype(np.float32)
    jdt, tdt = ((jnp.bfloat16, torch.bfloat16) if dtype == "bf16"
                else (jnp.float32, torch.float32))
    kw = dict(beta1=0.95, beta3=0.05)
    kw.update(SWEEP_CASES[case])
    jp, jm = JP.packed_novograd_apply(
        jnp.asarray(g).astype(jdt), jnp.asarray(m), jnp.asarray(src),
        jnp.asarray(denom), param_dtype=jdt, lr=1e-3, bc1=0.05,
        inv_scale=0.5, **kw, **ROUTES[route])
    tm = torch.from_numpy(m.copy())
    tp, tm_out = packed_novograd_apply(
        torch.from_numpy(g).to(tdt), tm, torch.from_numpy(src),
        torch.from_numpy(denom), param_dtype=tdt, lr=torch.tensor(1e-3),
        bc1=torch.tensor(0.05), inv_scale=0.5, **kw)
    assert tm_out is tm and tp.dtype == tdt
    np.testing.assert_allclose(tm.numpy(), _np(jm), **SWEEP_TOL)
    np.testing.assert_allclose(_np(tp), _np(jp), **(
        BF16_TOL if dtype == "bf16" else SWEEP_TOL))


def test_packed_novograd_apply_noop_keeps_everything():
    rows = 3
    rng = np.random.default_rng(1)
    g, m, src = (torch.from_numpy(rng.normal(size=rows * ROW).astype(
        np.float32)) for _ in range(3))
    m0 = m.clone()
    p, _ = packed_novograd_apply(g, m, src, torch.ones(rows),
                                 param_dtype=torch.bfloat16, lr=1e-3,
                                 bc1=0.1, noop=torch.tensor(True))
    assert torch.equal(m, m0)
    assert torch.equal(p, src.to(torch.bfloat16))


# ---------------------------------------------------------------------------
# the optimizer, pytree and packed, 5 steps
# ---------------------------------------------------------------------------

def _run_novograd(case: str, packed: bool, route: str, steps: int = 5):
    kw = NOVO_CASES[case]
    scale = 8.0 if case == "grad_scale" else None
    jparams, tparams = _both(_trees(10, 0.05))
    jopt = JaxFusedNovoGrad(lr=1e-2, packed=packed,
                            packed_interpret=packed and route == "interpret",
                            **kw)
    topt = FusedNovoGrad(lr=1e-2, packed=packed, **kw)
    js, ts = jopt.init(jparams), topt.init(tparams)
    for i in range(steps):
        g = _trees(20 + i, 1e-2 * (scale or 1.0))
        jg, tg = _both(g)
        jparams, js = jopt.step(jg, js, jparams, grad_scale=scale)
        tparams, ts = topt.step(tg, ts, tparams, grad_scale=scale)
    return jparams, js, tparams, ts


#: (packed, route): the pytree step has no kernel, so one route
STEP_ROUTES = {"pytree": (False, "xla"), "packed-interpret":
               (True, "interpret"), "packed-xla": (True, "xla")}


@pytest.mark.parametrize("path", list(STEP_ROUTES))
@pytest.mark.parametrize("case", list(NOVO_CASES))
def test_five_novograd_steps_match_jax(case, path):
    packed, route = STEP_ROUTES[path]
    jparams, js, tparams, ts = _run_novograd(case, packed, route)
    _close_trees(jparams, tparams, **STEP_TOL)
    jl, tl = _jax_state_leaves(js), _state_leaves(ts)
    assert int(tl[0]) == int(jl[0]) == 5
    for a, b in zip(jl[1:], tl[1:]):
        np.testing.assert_allclose(_np(b), _np(a), **STEP_TOL)
    if packed:
        assert ts.exp_avg_sq.shape == (3,)


def test_packed_novograd_matches_the_pytree_step():
    _, _, pt_params, pt_state = _run_novograd("weight_decay", False, "xla")
    _, _, pk_params, pk_state = _run_novograd("weight_decay", True, "xla")
    for a, b in zip(tree_leaves(pt_params), tree_leaves(pk_params)):
        torch.testing.assert_close(b, a, **STEP_TOL)
    torch.testing.assert_close(pk_state.exp_avg_sq,
                               torch.stack(tree_leaves(pt_state.exp_avg_sq)),
                               **STEP_TOL)


@pytest.mark.parametrize("dtype", ["bf16"])
def test_packed_novograd_bf16_params_match_jax(dtype):
    """bf16 gradients and params (the packed buffer and the sweep's
    output in bf16, fp32 moments): 3 steps."""
    jparams, tparams = _both(_trees(11, 0.05), jnp.bfloat16, torch.bfloat16)
    jopt = JaxFusedNovoGrad(lr=1e-2, weight_decay=1e-2, packed=True,
                            packed_interpret=True)
    topt = FusedNovoGrad(lr=1e-2, weight_decay=1e-2, packed=True)
    js, ts = jopt.init(jparams), topt.init(tparams)
    for i in range(3):
        jg, tg = _both(_trees(30 + i, 1e-2), jnp.bfloat16, torch.bfloat16)
        jparams, js = jopt.step(jg, js, jparams)
        tparams, ts = topt.step(tg, ts, tparams)
    assert all(p.dtype == torch.bfloat16 for p in tree_leaves(tparams))
    _close_trees(jparams, tparams, **BF16_TOL)
    np.testing.assert_allclose(ts.exp_avg_sq.numpy(), _np(js.exp_avg_sq),
                               rtol=1e-5)


def test_layer_wise_second_moment():
    """After the first step (not ``init_zero``) each leaf's ``v`` is its
    gradient's squared L2 norm, one value per leaf in flatten order, in
    both the packed vector and the pytree's scalars; the padding of the
    flat buffer does not enter it."""
    g = _trees(40, 1e-2)
    _, tparams = _both(_trees(41, 0.05))
    _, tg = _both(g)
    want = torch.stack([(x.double() ** 2).sum().float()
                        for x in tree_leaves(tg)])
    for packed in (False, True):
        opt = FusedNovoGrad(lr=1e-2, packed=packed)
        _, state = opt.step(tg, opt.init(tparams), tparams)
        v = (state.exp_avg_sq if packed
             else torch.stack(tree_leaves(state.exp_avg_sq)))
        torch.testing.assert_close(v, want, rtol=1e-6, atol=0)
    spec = PackSpec(tparams)
    assert spec.total > sum(spec.sizes)  # the buffer has padding


@pytest.mark.parametrize("packed", [False, True], ids=["pytree", "packed"])
def test_novograd_found_inf_skips_bit_for_bit(packed):
    """A step with ``found_inf`` set after two real steps: params, both
    moments (the per-leaf ``v`` included) and the step count unchanged
    bit for bit, while the same step without the flag moves them."""
    _, tparams = _both(_trees(50, 0.05))
    opt = FusedNovoGrad(lr=1e-2, weight_decay=1e-2, packed=packed)
    state = opt.init(tparams)
    for i in range(2):
        _, tg = _both(_trees(51 + i, 1e-2))
        tparams, state = opt.step(tg, state, tparams)
    before = ([x.clone() for x in tree_leaves(tparams)],
              [x.clone() for x in _state_leaves(state)])
    _, tg = _both(_trees(60, 1e-2))
    skipped, sstate = opt.step(tg, state, tparams,
                               found_inf=torch.tensor(True))
    for a, b in zip(before[0], tree_leaves(skipped)):
        assert torch.equal(a, b)
    for a, b in zip(before[1], _state_leaves(sstate)):
        assert torch.equal(a, b)
    moved, mstate = opt.step(tg, sstate, skipped,
                             found_inf=torch.tensor(False))
    assert int(mstate.step) == 3
    assert not torch.equal(tree_leaves(moved)[0], before[0][0])


def test_packed_novograd_is_deterministic():
    runs = []
    for _ in range(2):
        _, _, tparams, ts = _run_novograd("inf_norm", True, "xla", steps=3)
        runs.append(tree_leaves(tparams) + _state_leaves(ts))
    for a, b in zip(*runs):
        assert torch.equal(a, b)


@pytest.mark.parametrize("packed", [False, True], ids=["pytree", "packed"])
def test_novograd_continues_from_a_jax_state(packed):
    """Two JAX steps, the state carried into the port (``convert``), then
    two more steps in each package from the same params and state."""
    jparams, _ = _both(_trees(70, 0.05))
    jopt = JaxFusedNovoGrad(lr=1e-2, weight_decay=1e-3, packed=packed)
    topt = FusedNovoGrad(lr=1e-2, weight_decay=1e-3, packed=packed)
    js = jopt.init(jparams)
    for i in range(2):
        jg, _ = _both(_trees(71 + i, 1e-2))
        jparams, js = jopt.step(jg, js, jparams)
    tparams = tree_map(lambda a: torch.from_numpy(np.array(a)),
                       jax.tree_util.tree_map(np.asarray, jparams))
    if packed:
        ts = packed_state_from_jax(
            {"step": np.asarray(js.step), "exp_avg": np.asarray(js.exp_avg),
             "exp_avg_sq": np.asarray(js.exp_avg_sq),
             "offsets": js.spec.offsets, "shapes": js.spec.shapes,
             "total": js.spec.total}, PackSpec(tparams))
        assert ts.exp_avg_sq.shape == (3,)
    else:
        ts = novograd_state_from_jax(jax.tree_util.tree_map(
            np.asarray, js._asdict()))
        assert isinstance(ts, FusedNovoGradState)
    for i in range(2):
        jg, tg = _both(_trees(80 + i, 1e-2))
        jparams, js = jopt.step(jg, js, jparams)
        tparams, ts = topt.step(tg, ts, tparams)
    _close_trees(jparams, tparams, **STEP_TOL)
    assert int(ts.step) == 4


def test_novograd_refuses_what_the_reference_refuses():
    with pytest.raises(RuntimeError, match="AMSGrad"):
        FusedNovoGrad(amsgrad=True)
    with pytest.raises(RuntimeError, match="l2/inf"):
        FusedNovoGrad(norm_type=1)


# ---------------------------------------------------------------------------
# FusedAdagrad (pytree only, no kernel in either package)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", [dict(), dict(weight_decay=1e-2),
                                  dict(weight_decay=1e-2,
                                       adagrad_w_mode=True)],
                         ids=["plain", "l2", "w_mode"])
def test_five_adagrad_steps_match_jax(case):
    jparams, tparams = _both(_trees(90, 0.05))
    jopt, topt = JaxFusedAdagrad(lr=1e-2, **case), FusedAdagrad(lr=1e-2,
                                                                 **case)
    js, ts = jopt.init(jparams), topt.init(tparams)
    for i in range(5):
        jg, tg = _both(_trees(91 + i, 1e-2 * 4))
        jparams, js = jopt.step(jg, js, jparams, grad_scale=4.0)
        tparams, ts = topt.step(tg, ts, tparams, grad_scale=4.0)
    _close_trees(jparams, tparams, rtol=1e-6, atol=1e-9)
    _close_trees(js.sum, ts.sum, rtol=1e-6, atol=1e-12)
    assert int(ts.step) == 5
    skipped, sstate = topt.step(tg, ts, tparams,
                                found_inf=torch.tensor(True))
    for a, b in zip(tree_leaves(tparams) + tree_leaves(ts.sum),
                    tree_leaves(skipped) + tree_leaves(sstate.sum)):
        assert torch.equal(a, b)
    assert int(sstate.step) == 5


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_packed_novograd_state_and_sweep_bytes_match_jax(dtype):
    """``packed_init(per_leaf_exp_avg_sq=True)``: a ``(n_leaves,)`` fp32
    second moment, counted by ``sweep_bytes`` as its 8 bytes a leaf (read
    and written) beside the gradient, the params and the first moment,
    as the JAX package counts it."""
    from apex_tpu.optimizers._packed import packed_init as jax_packed_init
    from apex_tpu_torch.optimizers._packed import packed_init

    jparams, tparams = _both(_trees(100, 0.05), getattr(jnp, dtype),
                             getattr(torch, dtype))
    ts = packed_init(tparams, per_leaf_exp_avg_sq=True)
    js = jax_packed_init(jparams, per_leaf_exp_avg_sq=True)
    assert ts.exp_avg_sq.shape == (3,) and ts.exp_avg_sq.dtype == \
        torch.float32
    assert ts.exp_avg.shape == (ts.spec.total,)
    item = 2 if dtype == "bfloat16" else 4
    want = ts.spec.total * (2 * item + 8) + 8 * 3
    assert ts.sweep_bytes() == js.sweep_bytes() == want
