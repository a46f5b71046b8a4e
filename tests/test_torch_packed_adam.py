"""The port's PackSpec, packed Adam sweep and FusedAdam against the JAX
package's.

The same numpy-seeded buffers and trees go through the JAX package (the
packed Adam kernel in Pallas interpret mode, ``use_kernel=True``) and
through the port on the CPU (its plain version). The CUDA kernel is held
against the plain version on the card by ``tests/test_torch_cuda.py``
and ``chip_smoke.py``.

Tolerances: the PackSpec layout is compared exactly; fp32 optimizer
state (m, v, masters) atol 1e-7 rtol 1e-6 (the two compute each
operation in fp32, XLA may contract or reorder a product: a few fp32
ulps); bf16 params one bf16 rounding (rtol 8e-3); ``noop`` and
``write_mv=False`` leave their inputs bitwise as they were.
"""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.multi_tensor_apply.packing import PackSpec as JaxPackSpec
from apex_tpu.optimizers import FusedAdam as JaxFusedAdam
from apex_tpu.transformer.testing import GPTConfig as JaxGPTConfig
from apex_tpu.transformer.testing import init_gpt_params as jax_init
from apex_tpu_torch._tree import tree_leaves, tree_map
from apex_tpu_torch.convert import packed_state_from_jax, params_from_jax
from apex_tpu_torch.multi_tensor_apply.packing import PackSpec
from apex_tpu_torch.ops.packed_optimizer import packed_adam_apply
from apex_tpu_torch.optimizers import FusedAdam

JP = importlib.import_module("apex_tpu.ops.packed_optimizer")

STATE_TOL = dict(rtol=1e-6, atol=1e-7)
BF16_TOL = dict(rtol=8e-3, atol=1e-7)


def _gpt_tree(num_layers=2, hidden=64):
    cfg = JaxGPTConfig(num_layers=num_layers, hidden_size=hidden,
                       num_attention_heads=4, vocab_size=128,
                       max_position_embeddings=32)
    jp = jax_init(cfg, jax.random.PRNGKey(0))
    return jp, params_from_jax(jax.tree_util.tree_map(np.asarray, jp))


def test_pack_spec_layout_equals_jax():
    """Leaf order, names, offsets, sizes and total of the GPT tree are
    the JAX package's exactly, and so are packed buffers."""
    jp, tp = _gpt_tree()
    js, ts = JaxPackSpec(jp), PackSpec(tp)
    assert ts.leaf_names() == js.leaf_names()
    assert ts.offsets == js.offsets
    assert ts.sizes == js.sizes and ts.shapes == js.shapes
    assert ts.padded_sizes == js.padded_sizes
    assert (ts.total, ts.n_rows, ts.chunk_size) == (js.total, js.n_rows,
                                                    js.chunk_size)
    np.testing.assert_array_equal(ts.row_leaf_ids(), js.row_leaf_ids())
    np.testing.assert_array_equal(ts.valid_mask(), js.valid_mask())
    np.testing.assert_array_equal(ts.pack(tp).numpy(),
                                  np.asarray(js.pack(jp)))
    assert ts.common_dtype() == torch.float32


def test_pack_unpack_round_trip_and_views():
    _, tp = _gpt_tree()
    spec = PackSpec(tp, chunk_size=4096)
    flat = spec.pack(tp)
    assert flat.shape == (spec.total,) and spec.total % 4096 == 0
    back = spec.unpack(flat)
    for a, b in zip(tree_leaves(tp), tree_leaves(back)):
        assert torch.equal(a, b)
        assert b.untyped_storage().data_ptr() == \
            flat.untyped_storage().data_ptr()  # a view, no copy
    assert not flat[torch.from_numpy(~spec.valid_mask())].any()
    bf = spec.unpack(flat.to(torch.bfloat16), cast=False)
    assert tree_leaves(bf)[0].dtype == torch.bfloat16
    with pytest.raises(ValueError, match="does not match"):
        spec.pack({"a": torch.zeros(3)})


def _buffers(n=4096, seed=0):
    rng = np.random.default_rng(seed)
    g, m, src = (rng.normal(size=n).astype(np.float32) for _ in range(3))
    v = np.abs(rng.normal(size=n)).astype(np.float32)
    return g, m, v, src


@pytest.mark.parametrize("mode", ["adam", "write_mv_false", "noop",
                                  "adamw_wd", "adam_l2_wd"])
def test_packed_adam_apply_matches_jax_kernel(mode):
    g, m, v, src = _buffers()
    kw = {"write_mv_false": dict(write_mv=False, write_master=False),
          "adamw_wd": dict(wd=0.1), "adam_l2_wd": dict(wd=0.1,
                                                       adam_w_mode=False),
          }.get(mode, {})
    noop = True if mode == "noop" else None
    hyper = dict(lr=1e-3, bc1=0.1, bc2=0.001, inv_scale=0.5)
    want = JP.packed_adam_apply(
        *(jnp.asarray(a) for a in (g, m, v, src)),
        param_dtype=jnp.bfloat16, noop=None if noop is None
        else jnp.asarray(noop), use_kernel=True, interpret=True,
        chunk_size=2048, **hyper, **kw)
    tm, tv, ts = (torch.from_numpy(a.copy()) for a in (m, v, src))
    got = packed_adam_apply(torch.from_numpy(g), tm, tv, ts,
                            param_dtype=torch.bfloat16, noop=noop, **hyper,
                            **kw)
    assert got[0].dtype == torch.bfloat16
    np.testing.assert_allclose(got[0].float().numpy(),
                               np.asarray(want[0].astype(jnp.float32)),
                               **BF16_TOL)
    for w, t in zip(want[1:], got[1:]):
        assert (w is None) == (t is None)
        if w is not None:
            np.testing.assert_allclose(t.numpy(), np.asarray(w),
                                       **STATE_TOL)
    # in place: the returned buffers are the ones given
    if mode != "write_mv_false":
        assert got[1] is tm and got[2] is tv and got[3] is ts
    if mode in ("noop", "write_mv_false"):
        for t, a in ((tm, m), (tv, v), (ts, src)):
            np.testing.assert_array_equal(t.numpy(), a)
    if mode == "noop":
        assert torch.equal(got[0], torch.from_numpy(src).to(torch.bfloat16))


def _jax_state_np(state):
    spec = state.spec
    return {"step": np.asarray(state.step),
            "exp_avg": np.asarray(state.exp_avg),
            "exp_avg_sq": np.asarray(state.exp_avg_sq),
            "master_params": None if state.master_params is None
            else np.asarray(state.master_params),
            "offsets": spec.offsets, "shapes": spec.shapes,
            "total": spec.total}


def _grads(tree, seed):
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda x: (rng.normal(size=x.shape) * 1e-2).astype(np.float32), tree)


def test_fused_adam_packed_steps_from_carried_state():
    """Two JAX steps make non-zero moments; the state is carried into
    the port with packed_state_from_jax and both run 5 more steps on
    the same gradients: masters and params within rtol 1e-6."""
    jp, tp = _gpt_tree()
    jopt = JaxFusedAdam(lr=1e-3, weight_decay=0.01, master_weights=True,
                        packed=True)
    js = jopt.init(jp)
    for s in range(2):
        jp, js = jopt.step(jax.tree_util.tree_map(jnp.asarray,
                                                  _grads(jp, s)), js, jp)
    tp = params_from_jax(jax.tree_util.tree_map(np.asarray, jp))
    topt = FusedAdam(lr=1e-3, weight_decay=0.01, master_weights=True,
                     packed=True)
    ts = packed_state_from_jax(_jax_state_np(js), PackSpec(tp))
    assert int(ts.step) == 2
    for s in range(2, 7):
        g = _grads(jp, s)
        jp, js = jopt.step(jax.tree_util.tree_map(jnp.asarray, g), js, jp)
        tp, ts = topt.step(tree_map(torch.from_numpy, g), ts, tp)
    assert int(ts.step) == 7
    np.testing.assert_allclose(ts.master_params.numpy(),
                               np.asarray(js.master_params), rtol=1e-6,
                               atol=1e-7)
    for a, b in zip(jax.tree_util.tree_leaves(jp), tree_leaves(tp)):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-6,
                                   atol=1e-7)


def test_packed_state_from_jax_refuses_another_layout():
    jp, tp = _gpt_tree()
    js = JaxFusedAdam(master_weights=True, packed=True).init(jp)
    state = _jax_state_np(js)
    state["offsets"] = tuple(reversed(state["offsets"]))
    with pytest.raises(ValueError, match="layout"):
        packed_state_from_jax(state, PackSpec(tp))


@pytest.mark.parametrize("packed", [False, True])
def test_fused_adam_found_inf_and_no_update_mv(packed):
    """The overflow flag (a tensor, never read on the host) skips the
    step and leaves the step count; no_update_mv_step moves the params
    and keeps m, v and the count, as in the JAX package."""
    jp, tp = _gpt_tree(num_layers=1)
    kw = dict(lr=1e-3, master_weights=True, packed=packed)
    jopt, topt = JaxFusedAdam(**kw), FusedAdam(**kw)
    js, ts = jopt.init(jp), topt.init(tp)
    g = _grads(jp, 0)
    jg, tg = (jax.tree_util.tree_map(jnp.asarray, g),
              tree_map(torch.from_numpy, g))
    jp, js = jopt.step(jg, js, jp, found_inf=jnp.asarray(True))
    tp2, ts = topt.step(tg, ts, tp, found_inf=torch.tensor(True))
    assert int(ts.step) == int(js.step) == 0
    for a, b in zip(tree_leaves(tp), tree_leaves(tp2)):
        assert torch.equal(a, b)
    jp, js = jopt.step(jg, js, jp, grad_scale=2.0)
    tp, ts = topt.step(tg, ts, tp2, grad_scale=2.0)
    assert int(ts.step) == 1
    jp, js = jopt.no_update_mv_step(jg, js, jp)
    tp, ts = topt.no_update_mv_step(tg, ts, tp)
    assert int(ts.step) == 1
    for a, b in zip(jax.tree_util.tree_leaves(jp), tree_leaves(tp)):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-6,
                                   atol=1e-7)
    jm = js.exp_avg if packed else jax.tree_util.tree_leaves(js.exp_avg)
    tm = ts.exp_avg if packed else tree_leaves(ts.exp_avg)
    if packed:
        np.testing.assert_allclose(tm.numpy(), np.asarray(jm), **STATE_TOL)
    else:
        for a, b in zip(jm, tm):
            np.testing.assert_allclose(b.numpy(), np.asarray(a),
                                       **STATE_TOL)


def test_step_flat_matches_jax():
    jp, tp = _gpt_tree(num_layers=1)
    kw = dict(lr=1e-3, master_weights=True, packed=True)
    jopt, topt = JaxFusedAdam(**kw), FusedAdam(**kw)
    js, ts = jopt.init(jp), topt.init(tp)
    flat = js.spec.pack(jax.tree_util.tree_map(jnp.asarray,
                                               _grads(jp, 1)))
    js = jopt.step_flat(flat, js, found_inf=jnp.asarray(False))
    ts = topt.step_flat(torch.from_numpy(np.array(flat)), ts,
                        found_inf=torch.tensor(False))
    assert int(ts.step) == 1
    np.testing.assert_allclose(ts.master_params.numpy(),
                               np.asarray(js.master_params), **STATE_TOL)
    with pytest.raises(ValueError, match="PackSpec lays out"):
        topt.step_flat(torch.zeros(8), ts)
