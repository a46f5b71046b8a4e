"""The port's legacy mixed-precision utilities (``apex_tpu_torch.fp16_utils``)
against the JAX package's, on the CPU.

``tofp16`` / ``network_to_half`` / ``convert_network`` (batchnorm-like
paths kept fp32, a custom predicate) per-leaf dtypes and values;
``FP16Model``; ``prep_param_lists`` (fp32 copies, never aliases),
``master_params_to_model_params``, ``model_grads_to_master_grads``,
``to_python_float``; ``nonfinite_leaves`` naming the same paths; the
legacy ``DynamicLossScaler`` over 6 steps with an overflow (scale,
iteration counters, the provenance record) and the static one;
``FP16_Optimizer`` over FusedSGD and FusedAdam for 4 steps with an
overflow, a clipped step and a ``state_dict`` round trip. The exports are
the JAX package's.

Tolerances: dtypes, scales, flags and names exactly; casts bit for bit
(each is one rounding); optimizer steps within 1e-6 relative of each
leaf's largest entry (fp32 arithmetic in another order).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import apex_tpu.fp16_utils as jfp
from apex_tpu.optimizers import FusedAdam as JaxFusedAdam
from apex_tpu.optimizers import FusedSGD as JaxFusedSGD
from apex_tpu_torch import fp16_utils as tfp
from apex_tpu_torch._tree import leaf_paths, tree_flatten, tree_leaves
from apex_tpu_torch.optimizers import FusedAdam, FusedSGD


def _tree(seed=0, lib="t"):
    rng = np.random.default_rng(seed)

    def arr(*shape):
        a = rng.standard_normal(shape).astype(np.float32)
        return torch.from_numpy(a) if lib == "t" else jnp.asarray(a)

    steps = (torch.tensor([3], dtype=torch.int32) if lib == "t"
             else jnp.asarray([3], jnp.int32))
    return {"dense": {"kernel": arr(4, 3), "bias": arr(3)},
            "bn": {"scale": arr(3), "bias": arr(3)},
            "block": [{"norm": {"scale": arr(3)}}, arr(2, 2)],
            "steps": steps}


def _same(ttree, jtree):
    """Paths, dtypes and values equal (values compared in fp32)."""
    leaves, treedef = tree_flatten(ttree)
    jl = jax.tree_util.tree_flatten_with_path(jtree)[0]
    assert leaf_paths(treedef) == [jax.tree_util.keystr(p) for p, _ in jl]
    for t, (_, j) in zip(leaves, jl):
        assert str(t.dtype)[6:] == str(j.dtype)
        np.testing.assert_array_equal(
            t.float().numpy() if t.is_floating_point() else t.numpy(),
            np.asarray(jnp.asarray(j).astype(jnp.float32))
            if jnp.issubdtype(j.dtype, jnp.floating) else np.asarray(j))


@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
def test_casts_match_jax(dtype):
    td, jd = getattr(torch, dtype), getattr(jnp, dtype)
    _same(tfp.tofp16(_tree(), td), jfp.tofp16(_tree(lib="j"), jd))
    _same(tfp.network_to_half(_tree(), td),
          jfp.network_to_half(_tree(lib="j"), jd))
    out = tfp.convert_network(_tree(), td)
    _same(out, jfp.convert_network(_tree(lib="j"), jd))
    assert out["bn"]["scale"].dtype == torch.float32
    assert out["block"][0]["norm"]["scale"].dtype == torch.float32
    assert out["dense"]["kernel"].dtype == td

    def keep(path):
        return "kernel" in path

    _same(tfp.convert_network(_tree(), td, keep_fp32=keep),
          jfp.convert_network(_tree(lib="j"), jd, keep_fp32=keep))


def test_fp16_model_runs_in_half():
    def apply(params, x):
        return x @ params["dense"]["kernel"] + params["dense"]["bias"]

    x = np.random.default_rng(1).standard_normal((2, 4)).astype(np.float32)
    t = tfp.FP16Model(apply, torch.bfloat16)(_tree(), torch.from_numpy(x))
    j = jfp.FP16Model(apply, jnp.bfloat16)(_tree(lib="j"), jnp.asarray(x))
    assert t.dtype == torch.bfloat16 and str(j.dtype) == "bfloat16"
    np.testing.assert_allclose(t.float().numpy(),
                               np.asarray(j.astype(jnp.float32)),
                               rtol=1e-2, atol=1e-2)


def test_master_bookkeeping_matches_jax():
    half_t = tfp.tofp16(_tree())
    half_j = jfp.tofp16(_tree(lib="j"))
    tm, tmaster = tfp.prep_param_lists(half_t)
    jm, jmaster = jfp.prep_param_lists(half_j)
    assert tm is half_t
    _same(tmaster, jmaster)
    for a, b in zip(tree_leaves(half_t), tree_leaves(tmaster)):
        if b.is_floating_point():
            assert b.data_ptr() != a.data_ptr()
    # an fp32 tree's masters are copies too, not aliases
    f32 = _tree()
    _, m32 = tfp.prep_param_lists(f32)
    assert m32["dense"]["kernel"] is not f32["dense"]["kernel"]
    assert m32["dense"]["kernel"].data_ptr() != \
        f32["dense"]["kernel"].data_ptr()
    _same(tfp.master_params_to_model_params(half_t, tmaster),
          jfp.master_params_to_model_params(half_j, jmaster))
    _same(tfp.model_grads_to_master_grads(half_t),
          jfp.model_grads_to_master_grads(half_j))
    assert tfp.to_python_float(torch.tensor(2.5)) == \
        jfp.to_python_float(jnp.float32(2.5)) == 2.5
    assert tfp.to_python_float(3) == 3.0


def test_nonfinite_leaves_name_the_same_paths():
    t, j = _tree(), _tree(lib="j")
    t["dense"]["bias"][1] = float("inf")
    t["block"][1][0, 0] = float("nan")
    j = jax.tree_util.tree_map(lambda a: a, j)
    j["dense"]["bias"] = j["dense"]["bias"].at[1].set(jnp.inf)
    j["block"][1] = j["block"][1].at[0, 0].set(jnp.nan)
    assert tfp.nonfinite_leaves(t) == jfp.nonfinite_leaves(j) == [
        "['block'][1]", "['dense']['bias']"]
    assert tfp.nonfinite_leaves(_tree()) == []


class _Sink:
    def __init__(self):
        self.records = []

    def record(self, rec):
        self.records.append(rec)


def test_dynamic_loss_scaler_matches_jax_over_six_steps():
    """6 iterations with an overflow at the third: the scale halves,
    grows back after the window, and the provenance record names the
    leaf, as JAX's does."""
    ts, tsink = tfp.DynamicLossScaler(init_scale=2 ** 8, scale_window=2,
                                      sink=_Sink()), None
    js = jfp.DynamicLossScaler(init_scale=2 ** 8, scale_window=2,
                               sink=_Sink())
    tsink, jsink = ts.sink, js.sink
    for i in range(6):
        tg, jg = _tree(i), _tree(i, lib="j")
        if i == 2:
            tg["dense"]["kernel"][0, 0] = float("inf")
            jg["dense"]["kernel"] = jg["dense"]["kernel"].at[0, 0].set(
                jnp.inf)
        tover, jover = ts.has_overflow(tg), js.has_overflow(jg)
        assert tover == jover == (i == 2)
        ts.update_scale(tover)
        js.update_scale(jover)
        assert (ts.loss_scale, ts.cur_iter, ts.last_overflow_iter) == \
            (js.loss_scale, js.cur_iter, js.last_overflow_iter), i
        assert ts.last_overflow_leaves == js.last_overflow_leaves
    assert tsink.records == jsink.records
    assert tsink.records[0]["leaves"] == [{"name": "['dense']['kernel']"}]
    # backward / scale_gradient / unscale_gradient
    tl, tgrads = ts.backward(lambda: (torch.tensor(1.0), _tree(9)))
    jl, jgrads = js.backward(lambda: (jnp.float32(1.0), _tree(9, lib="j")))
    _same(tgrads, jgrads)
    _same(ts.unscale_gradient(tgrads), js.unscale_gradient(jgrads))


def test_static_loss_scaler_matches_jax():
    ts, js = tfp.LossScaler(4.0), jfp.LossScaler(4.0)
    assert ts.has_overflow(_tree()) is False and ts.loss_scale == 4.0
    assert ts._has_inf_or_nan(None) is js._has_inf_or_nan(None) is False
    ts.update_scale(True)
    assert ts.loss_scale == js.loss_scale == 4.0
    grads_t = {k: v for k, v in _tree().items() if k != "steps"}
    grads_j = {k: v for k, v in _tree(lib="j").items() if k != "steps"}
    _same(ts.scale_gradient(grads_t), js.scale_gradient(grads_j))


def _opt_pair(kind):
    if kind == "sgd":
        return (FusedSGD(lr=0.1, momentum=0.9, weight_decay=1e-4),
                JaxFusedSGD(lr=0.1, momentum=0.9, weight_decay=1e-4))
    return (FusedAdam(lr=1e-2, weight_decay=1e-2),
            JaxFusedAdam(lr=1e-2, weight_decay=1e-2))


def _close(ttree, jtree, rtol=1e-6):
    for a, b in zip(tree_leaves(ttree), jax.tree_util.tree_leaves(jtree)):
        b = np.asarray(jnp.asarray(b).astype(jnp.float32))
        a = a.float().numpy()
        np.testing.assert_allclose(a, b, rtol=0,
                                   atol=rtol * max(np.abs(b).max(), 1e-30))


@pytest.mark.parametrize("kind", ["sgd", "adam"])
@pytest.mark.parametrize("dynamic", [False, True], ids=["static", "dynamic"])
def test_fp16_optimizer_steps_match_jax(kind, dynamic):
    """4 steps over bf16 params: a clean step, an overflow (skipped, the
    scale halved when dynamic), a clipped step and a clean step; then the
    state_dict round trip."""
    topt, jopt = _opt_pair(kind)
    kw = ({"dynamic_loss_scale": True,
           "dynamic_loss_args": {"init_scale": 2.0 ** 8}} if dynamic
          else {"static_loss_scale": 8.0})
    tw, jw = tfp.FP16_Optimizer(topt, **kw), jfp.FP16_Optimizer(jopt, **kw)
    params_t = {k: v for k, v in tfp.tofp16(_tree()).items() if k != "steps"}
    params_j = {k: v for k, v in jfp.tofp16(_tree(lib="j")).items()
                if k != "steps"}
    ts, js = tw.init(params_t), jw.init(params_j)
    for i in range(4):
        gt = {k: v for k, v in _tree(10 + i).items() if k != "steps"}
        gj = {k: v for k, v in _tree(10 + i, lib="j").items()
              if k != "steps"}
        scale = float(ts.scaler.loss_scale)
        gt = jax.tree_util.tree_map(lambda g: g * scale, gt)
        gj = jax.tree_util.tree_map(lambda g: g * scale, gj)
        if i == 1:
            gt["dense"]["bias"][0] = float("inf")
            gj["dense"]["bias"] = gj["dense"]["bias"].at[0].set(jnp.inf)
        clip = 0.5 if i == 2 else None
        before = [m.clone() for m in tree_leaves(ts.masters)]
        params_t, ts = tw.step(gt, ts, params_t, max_grad_norm=clip)
        params_j, js = jw.step(gj, js, params_j, max_grad_norm=clip)
        _close(ts.masters, js.masters)
        _close(params_t, params_j)
        for field in ts.scaler._fields:
            assert getattr(ts.scaler, field).item() == np.asarray(
                getattr(js.scaler, field)).item(), (i, field)
        if i == 1:
            assert all(torch.equal(a, b) for a, b in zip(
                before, tree_leaves(ts.masters)))
        assert all(p.dtype == torch.bfloat16 for p in tree_leaves(params_t))
    assert float(tw.get_loss_scale(ts)) == float(jw.get_loss_scale(js))
    sd, jsd = tw.state_dict(ts), jw.state_dict(js)
    assert sd["loss_scaler"] == jsd["loss_scaler"]
    back = tw.load_state_dict(sd, tw.init(params_t))
    for a, b in zip(tree_leaves(back.masters), tree_leaves(ts.masters)):
        assert torch.equal(a, b)
    for a, b in zip(tree_leaves(back.inner), tree_leaves(ts.inner)):
        assert torch.equal(a, b)
    assert back.scaler.loss_scale.item() == ts.scaler.loss_scale.item()
    with pytest.raises(RuntimeError, match="functional"):
        tw.loss_scale
    assert float(tw.scale_loss(ts, torch.tensor(2.0))) == \
        float(jw.scale_loss(js, jnp.float32(2.0)))


def test_exports_match_the_jax_package():
    names = {n for n in dir(jfp) if not n.startswith("_")
             and not isinstance(getattr(jfp, n), type(jfp))}
    missing = {n for n in names if not hasattr(tfp, n)}
    assert not missing, missing
