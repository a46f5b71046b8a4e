"""openfold's ``FusedAdamSWA`` of the port against the JAX package's, on
the CPU.

Three Adam math modes, with and without bias correction and weight
decay, 5 steps over a small parameter tree of fp32 masters, bf16
compute copies and fp32 SWA averages, on numpy-seeded gradients (bf16,
as the compute copies'); the first step's SWA copy; a mid-run state
carried across with ``convert.fused_adam_swa_state_from_jax``.

Tolerances: the fp32 masters, moments and SWA averages rtol 1e-6 (the
same operations in the same order, rounded once each in fp32; only
``pow`` and ``sqrt`` may differ by an ulp between the two frameworks'
CPU libraries); the bf16 compute copies within one bf16 rounding of
the masters' (rtol 2^-7); the counts exactly.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.contrib.openfold import fused_adam_swa as jswa
from apex_tpu_torch.contrib import openfold as tof
from apex_tpu_torch.convert import fused_adam_swa_state_from_jax
from apex_tpu_torch.convert import params_from_jax

SHAPES = {"w": (6, 5), "b": (5,), "blk": {"k": (3, 4, 2)}}


def _tree(rng, shapes, scale=1.0):
    if isinstance(shapes, dict):
        return {k: _tree(rng, v, scale) for k, v in shapes.items()}
    return (rng.standard_normal(shapes) * scale).astype(np.float32)


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    return [tree]


def _close(got_tree, want_tree, rtol):
    for g, w in zip(_leaves(got_tree), _leaves(want_tree)):
        np.testing.assert_allclose(
            g.float().numpy(), np.asarray(jnp.asarray(w, jnp.float32)),
            rtol=rtol, atol=1e-30)


def _opts(mode, bias_correction, wd):
    kw = dict(swa_decay_rate=0.9, lr=1e-2, bias_correction=bias_correction,
              weight_decay=wd, eps=1e-6)
    return (jswa.FusedAdamSWA(adam_math_mode=getattr(jswa.AdamMathType,
                                                     mode), **kw),
            tof.FusedAdamSWA(adam_math_mode=getattr(tof.AdamMathType,
                                                    mode), **kw))


def _banks(seed):
    rng = np.random.default_rng(seed)
    p = _tree(rng, SHAPES)
    jp = jax.tree_util.tree_map(jnp.asarray, p)
    tp = params_from_jax(p)
    return (jp, jax.tree_util.tree_map(lambda a: a.astype(jnp.bfloat16), jp),
            jax.tree_util.tree_map(lambda a: a * 0, jp),
            tp, params_from_jax(p, dtype=torch.bfloat16),
            params_from_jax(jax.tree_util.tree_map(lambda a: a * 0, p)))


@pytest.mark.parametrize("wd", [0.0, 0.05])
@pytest.mark.parametrize("bias_correction", [True, False])
@pytest.mark.parametrize("mode", ["ApexAdam", "ApexAdamW", "PyTorchAdam"])
def test_five_steps_match_jax(mode, bias_correction, wd):
    jopt, topt = _opts(mode, bias_correction, wd)
    jp, jcp, jsp, tp, tcp, tsp = _banks(0)
    jst, tst = jopt.init(jp), topt.init(tp)
    rng = np.random.default_rng(1)
    for step in range(5):
        g = _tree(rng, SHAPES, 0.1)
        jg = jax.tree_util.tree_map(
            lambda a: jnp.asarray(a).astype(jnp.bfloat16), g)
        tg = params_from_jax(g, dtype=torch.bfloat16)
        jp, jcp, jsp, jst = jopt.step(jg, jst, jp, jcp, jsp)
        tp, tcp, tsp, tst = topt.step(tg, tst, tp, tcp, tsp)
        _close(tp, jp, 1e-6)
        _close(tsp, jsp, 1e-6)
        _close(tst.exp_avg, jst.exp_avg, 1e-6)
        _close(tst.exp_avg_sq, jst.exp_avg_sq, 1e-6)
        _close(tcp, jcp, 2.0 ** -7)
        assert all(c.dtype == torch.bfloat16 for c in _leaves(tcp))
        assert int(tst.step) == int(jst.step) == step + 1
        assert int(tst.n_averaged) == int(jst.n_averaged) == step + 1
        if step == 0:  # the first averaged step copies the masters
            for s, p in zip(_leaves(tsp), _leaves(tp)):
                assert torch.equal(s, p)


def test_state_carries_over_from_jax_and_lr_override():
    jopt, topt = _opts("PyTorchAdam", True, 0.01)
    jp, jcp, jsp, _, _, _ = _banks(2)
    jst = jopt.init(jp)
    rng = np.random.default_rng(3)
    for _ in range(2):
        g = jax.tree_util.tree_map(jnp.asarray, _tree(rng, SHAPES, 0.1))
        jp, jcp, jsp, jst = jopt.step(g, jst, jp, jcp, jsp)
    to_np = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    tst = fused_adam_swa_state_from_jax(to_np(jst))
    tp, tsp = params_from_jax(to_np(jp)), params_from_jax(to_np(jsp))
    tcp = params_from_jax(to_np(jcp), dtype=torch.bfloat16)
    assert int(tst.step) == 2 and tst.step.dtype == torch.int32
    g = _tree(rng, SHAPES, 0.1)
    jp, jcp, jsp, jst = jopt.step(jax.tree_util.tree_map(jnp.asarray, g),
                                  jst, jp, jcp, jsp, lr=3e-3)
    tp, tcp, tsp, tst = topt.step(params_from_jax(g), tst, tp, tcp, tsp,
                                  lr=3e-3)
    _close(tp, jp, 1e-6)
    _close(tsp, jsp, 1e-6)
    _close(tst.exp_avg_sq, jst.exp_avg_sq, 1e-6)


def test_unknown_math_mode_raises():
    with pytest.raises(ValueError, match="Unknown Adam math mode"):
        tof.FusedAdamSWA(0.9, adam_math_mode="adam")
