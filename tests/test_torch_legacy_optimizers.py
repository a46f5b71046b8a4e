"""``contrib.optimizers`` of the port against the JAX package's, on the
CPU.

The legacy ``FusedAdam`` (both ``eps_inside_sqrt`` modes, with and
without bias correction and weight decay, a loss scale of 1024, the
combined-scale clip from ``grad_norms`` of the scaled gradients against
``max_grad_norm``, bf16 ``output_params``) and the legacy ``FusedSGD``
(momentum 0.9, nesterov, a scale) 3 steps on numpy-seeded scaled
gradients over a small tree, from the same params; a mid-run Adam state
carried across with ``convert.fused_adam_state_from_jax``; the exports
(``FusedLAMB``, ``FP16_Optimizer``) and the ``DistributedFused*``
refusals naming A6.6.

Tolerances: the params, moments and output copies within 1e-5 of each
leaf's largest entry over the 3-step trajectory (the same fp32
operations in the same order; ``pow`` and ``sqrt`` may round an ulp
apart between the two frameworks, and ``1 - beta2**t`` cancels); the
bf16 output copy within one bf16 rounding (2^-8) of its largest entry;
the step counts exactly.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.contrib import optimizers as jco
from apex_tpu_torch.contrib import optimizers as tco
from apex_tpu_torch.convert import fused_adam_state_from_jax, params_from_jax

SHAPES = {"w": (6, 8), "b": (8,), "blk": {"k": (3, 4, 2)}}
SCALE = 1024.0


def _tree(rng, shapes, scale=1.0):
    if isinstance(shapes, dict):
        return {k: _tree(rng, v, scale) for k, v in shapes.items()}
    return (rng.standard_normal(shapes) * scale).astype(np.float32)


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    return [tree]


def _close(got, want, tol=1e-5):
    for g, w in zip(_leaves(got), _leaves(want)):
        w = np.asarray(jnp.asarray(w).astype(jnp.float32))
        g = g.float().numpy()
        assert g.shape == w.shape
        assert np.abs(g - w).max() <= tol * np.abs(w).max(), (
            np.abs(g - w).max(), np.abs(w).max())


def _grads(rng, scale=SCALE):
    # unscaled norm ~5: the clip to max_grad_norm 1.0 is active
    g = _tree(rng, SHAPES, 0.5 * scale)
    norm = float(np.sqrt(sum(float((a.astype(np.float64) ** 2).sum())
                             for a in _leaves(g))))
    assert norm / scale > 2.0
    return g, norm


@pytest.mark.parametrize("bias_correction,wd", [(True, 0.0), (True, 0.01),
                                                (False, 0.01)])
@pytest.mark.parametrize("clip", [0.0, 1.0])
@pytest.mark.parametrize("eps_inside_sqrt", [False, True])
def test_legacy_adam_three_steps_match(eps_inside_sqrt, clip,
                                       bias_correction, wd):
    kw = dict(lr=1e-2, eps=1e-6, eps_inside_sqrt=eps_inside_sqrt,
              max_grad_norm=clip, bias_correction=bias_correction,
              weight_decay=wd)
    jopt, topt = jco.FusedAdam(**kw), tco.FusedAdam(**kw)
    p = _tree(np.random.default_rng(0), SHAPES)
    jp, tp = jax.tree_util.tree_map(jnp.asarray, p), params_from_jax(p)
    js, ts = jopt.init(jp), topt.init(tp)
    rng = np.random.default_rng(1)
    for _ in range(3):
        g, norm = _grads(rng)
        jp, js, jout = jopt.step(jax.tree_util.tree_map(jnp.asarray, g), js,
                                 jp, scale=SCALE, grad_norms=norm,
                                 output_params_dtype=jnp.bfloat16)
        tp, ts, tout = topt.step(params_from_jax(g), ts, tp, scale=SCALE,
                                 grad_norms=norm,
                                 output_params_dtype=torch.bfloat16)
    _close(tp, jp)
    _close(ts.exp_avg, js.exp_avg)
    _close(ts.exp_avg_sq, js.exp_avg_sq)
    _close(tout, jout, 2.0 ** -8)
    assert all(t.dtype == torch.bfloat16 for t in _leaves(tout))
    assert int(ts.step) == int(js.step) == 3


def test_legacy_adam_from_a_carried_state():
    jopt = jco.FusedAdam(lr=1e-2, max_grad_norm=1.0, weight_decay=0.01)
    topt = tco.FusedAdam(lr=1e-2, max_grad_norm=1.0, weight_decay=0.01)
    p = _tree(np.random.default_rng(2), SHAPES)
    jp = jax.tree_util.tree_map(jnp.asarray, p)
    js = jopt.init(jp)
    rng = np.random.default_rng(3)
    for _ in range(2):
        g, norm = _grads(rng)
        jp, js = jopt.step(jax.tree_util.tree_map(jnp.asarray, g), js, jp,
                           scale=SCALE, grad_norms=norm)
    tp = params_from_jax(jax.tree_util.tree_map(np.asarray, jp))
    ts = fused_adam_state_from_jax(js)
    g, norm = _grads(rng)
    jp, js = jopt.step(jax.tree_util.tree_map(jnp.asarray, g), js, jp,
                       scale=SCALE, grad_norms=norm)
    tp, ts = topt.step(params_from_jax(g), ts, tp, scale=SCALE,
                       grad_norms=norm)
    _close(tp, jp)
    _close(ts.exp_avg_sq, js.exp_avg_sq)


def test_combined_scale_clips_as_the_reference():
    from apex_tpu.contrib.optimizers import legacy as jl
    from apex_tpu_torch.contrib.optimizers import legacy as tl

    for norm in (10.0, 1e4, 3e6):
        want = float(jl._combined_scale(SCALE, norm, 1.0))
        got = float(tl._combined_scale(torch.tensor(SCALE), norm, 1.0))
        assert got == want
    assert tl._combined_scale(SCALE, None, 1.0) == SCALE


@pytest.mark.parametrize("nesterov", [False, True])
def test_legacy_sgd_three_steps_match(nesterov):
    kw = dict(lr=0.05, momentum=0.9, weight_decay=1e-3, nesterov=nesterov)
    jopt, topt = jco.FusedSGD(**kw), tco.FusedSGD(**kw)
    p = _tree(np.random.default_rng(4), SHAPES)
    jp, tp = jax.tree_util.tree_map(jnp.asarray, p), params_from_jax(p)
    js, ts = jopt.init(jp), topt.init(tp)
    rng = np.random.default_rng(5)
    for _ in range(3):
        g, norm = _grads(rng, 128.0)
        jp, js = jopt.step(jax.tree_util.tree_map(jnp.asarray, g), js, jp,
                           scale=128.0, grad_norms=norm)
        tp, ts = topt.step(params_from_jax(g), ts, tp, scale=128.0,
                           grad_norms=norm)
    _close(tp, jp)
    _close(ts.momentum_buffer, js.momentum_buffer)
    out = topt.step(params_from_jax(g), ts, tp, scale=128.0,
                    output_params_dtype=torch.float16)
    assert len(out) == 3 and out[2]["w"].dtype == torch.float16


def test_exports_and_distributed_refusals():
    from apex_tpu_torch.fp16_utils import FP16_Optimizer
    from apex_tpu_torch.optimizers import FusedLAMB

    assert tco.FusedLAMB is FusedLAMB and tco.FP16_Optimizer is FP16_Optimizer
    assert set(tco.__all__) >= {"FusedAdam", "FusedSGD", "FusedLAMB",
                                "FP16_Optimizer", "DistributedFusedAdam",
                                "DistributedFusedLAMB"}
    for cls in (tco.DistributedFusedAdam, tco.DistributedFusedLAMB):
        with pytest.raises(NotImplementedError, match="A6.6"):
            cls(lr=1e-3)
