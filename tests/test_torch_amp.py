"""The port's amp frontend against the JAX package's, on the CPU.

``Properties`` of O0-O3 field by field, with each override; the per-leaf
dtypes ``initialize`` gives a ResNet-18 tree (flax key paths, 4 filters
wide) at O0-O3
with ``keep_batchnorm_fp32`` unset, True and False; the masters flip,
``num_losses`` scalers and the ``state_dict`` round trip; the scaler
states on the params' device; ``scaled_value_and_grad`` (loss, aux,
gradients, ``found_inf``, the updated scale; ``argnums`` and
``has_aux``) clean and overflowing; ``apply_updates_skip_on_overflow``;
``cast_params_for_inference`` on a tree of dicts, lists and tuples with
and without ``keep_batchnorm_fp32``; the O1 context of ``AmpState``; the
exports.

Tolerances: dtypes, flags, scales and counters exactly; the loss and
gradients of the small fp32 model within 1e-6 relative (one product and
a sum in another order).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import apex_tpu.amp as jamp
from apex_tpu.optimizers import FusedAdam as JaxFusedAdam
from apex_tpu.optimizers import FusedSGD as JaxFusedSGD
from apex_tpu_torch import amp
from apex_tpu_torch._tree import leaf_paths, tree_flatten, tree_leaves
from apex_tpu_torch.convert import resnet_params_to_jax
from apex_tpu_torch.examples.imagenet import resnet
from apex_tpu_torch.optimizers import FusedAdam, FusedSGD

LEVELS = ["O0", "O1", "O2", "O3"]
OVERRIDES = [
    {},
    {"cast_model_type": "float16"},
    {"patch_functions": True},
    {"keep_batchnorm_fp32": False},
    {"keep_batchnorm_fp32": True},
    {"master_weights": False},
    {"loss_scale": 512.0},
    {"loss_scale": "dynamic"},
]


def _dtype_name(d):
    if d is None:
        return None
    return str(d)[6:] if isinstance(d, torch.dtype) else str(jnp.dtype(d))


def _kw(over, torch_side):
    out = dict(over)
    if "cast_model_type" in out:
        out["cast_model_type"] = (getattr(torch, out["cast_model_type"])
                                  if torch_side
                                  else getattr(jnp, out["cast_model_type"]))
    return out


@functools.lru_cache(maxsize=None)
def _resnet18_host():
    """A ResNet-18 parameter tree (its key paths and leaf kinds; 4 filters
    wide, so the casts are cheap): the port's tensors and the flax-layout
    numpy arrays."""
    model = resnet.ResNet(stage_sizes=(2, 2, 2, 2), block="BasicBlock",
                          num_classes=10, num_filters=4)
    tp, _ = model.init(torch.Generator().manual_seed(0))
    return tp, resnet_params_to_jax(tp)


def _resnet18_trees():
    """The port's tree (``initialize`` returns new leaves; it never writes
    into these) and the same tree as fresh JAX arrays."""
    tp, host = _resnet18_host()
    return tp, jax.tree_util.tree_map(jnp.asarray, host)


def _leaf_dtypes_torch(tree):
    leaves, treedef = tree_flatten(tree)
    return {p: _dtype_name(l.dtype) for p, l in zip(leaf_paths(treedef),
                                                    leaves)}


def _leaf_dtypes_jax(tree):
    return {jax.tree_util.keystr(p): str(l.dtype)
            for p, l in jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.mark.parametrize("over", OVERRIDES,
                         ids=[",".join(f"{k}={v}" for k, v in o.items())
                              or "preset" for o in OVERRIDES])
@pytest.mark.parametrize("level", LEVELS)
def test_properties_match_jax(level, over):
    tp, jp = _resnet18_trees()
    _, _, tst = amp.initialize(tp, None, opt_level=level, **_kw(over, True))
    _, _, jst = jamp.initialize(jp, None, opt_level=level,
                                **_kw(over, False))
    tprops, jprops = tst.opt_properties, jst.opt_properties
    for field in ("enabled", "opt_level", "patch_functions",
                  "keep_batchnorm_fp32", "master_weights", "loss_scale"):
        assert getattr(tprops, field) == getattr(jprops, field), field
    assert _dtype_name(tprops.cast_model_type) == _dtype_name(
        jprops.cast_model_type)
    assert set(amp.opt_levels) == set(jamp.opt_levels)


@pytest.mark.parametrize("kbn", [None, True, False])
@pytest.mark.parametrize("level", LEVELS)
def test_initialize_leaf_dtypes_match_jax(level, kbn):
    """Per-leaf dtypes on a ResNet-18 tree: the key-path batchnorm
    heuristic keeps ``BatchNorm_*``, ``bn_init`` and ``downsample_bn``
    fp32 where JAX's does."""
    tp, jp = _resnet18_trees()
    kw = {} if kbn is None else {"keep_batchnorm_fp32": kbn}
    tout, _, _ = amp.initialize(tp, None, opt_level=level, **kw)
    jout, _, _ = jamp.initialize(jp, None, opt_level=level, **kw)
    got, want = _leaf_dtypes_torch(tout), _leaf_dtypes_jax(jout)
    assert got == want
    if level == "O2" and kbn is not False:
        assert got["['bn_init']['scale']"] == "float32"
        assert got["['BasicBlock_2']['downsample_bn']['bias']"] == "float32"
        assert got["['BasicBlock_2']['Conv_0']['kernel']"] == "bfloat16"


def test_initialize_keeps_memory_format_and_identity():
    tp, _ = _resnet18_trees()
    out, _, _ = amp.initialize(tp, None, opt_level="O2")
    k = out["conv_init"]["kernel"]
    assert k.dtype == torch.bfloat16
    assert k.is_contiguous(memory_format=torch.channels_last)
    # fp32 batchnorm leaves are kept as the same objects (no copy)
    assert out["bn_init"]["scale"] is tp["bn_init"]["scale"]


@pytest.mark.parametrize("level", LEVELS)
def test_masters_flip_and_scalers_match_jax(level):
    tp, jp = _resnet18_trees()
    topts = [FusedSGD(lr=0.1), FusedAdam()]
    jopts = [JaxFusedSGD(lr=0.1), JaxFusedAdam()]
    _, topts_out, tst = amp.initialize(tp, topts, opt_level=level,
                                       num_losses=3)
    _, jopts_out, jst = jamp.initialize(jp, jopts, opt_level=level,
                                        num_losses=3)
    assert topts_out is topts
    assert [o.master_weights for o in topts] == \
        [o.master_weights for o in jopts]
    for i in range(3):
        ts, js = tst.scaler_state(i), jst.scaler_state(i)
        assert ts.loss_scale.device.type == "cpu"
        for field in amp.LossScaleState._fields:
            assert getattr(ts, field).item() == np.asarray(
                getattr(js, field)).item(), (i, field)
        assert tst.scaler(i).dynamic == jst.scaler(i).dynamic
    # one optimizer, not in a list, comes back alone
    _, one, _ = amp.initialize(tp, FusedSGD(lr=0.1), opt_level=level)
    assert isinstance(one, FusedSGD)
    # a list of models comes back as a list
    models, _, _ = amp.initialize([tp, tp], None, opt_level=level)
    assert isinstance(models, list) and len(models) == 2


def test_state_dict_roundtrip_matches_jax():
    tp, jp = _resnet18_trees()
    _, _, tst = amp.initialize(tp, None, opt_level="O2", num_losses=2)
    _, _, jst = jamp.initialize(jp, None, opt_level="O2", num_losses=2)
    # one overflow on loss 1 in both
    tsc, jsc = tst.scaler(1), jst.scaler(1)
    tst = tst.with_scaler_state(1, tsc.update_scale(
        tst.scaler_state(1)._replace(found_inf=torch.tensor(True))))
    jst = jst.with_scaler_state(1, jsc.update_scale(
        jst.scaler_state(1)._replace(found_inf=jnp.asarray(True))))
    tsd, jsd = amp.state_dict(tst), jamp.state_dict(jst)
    assert tsd == jsd
    back = amp.load_state_dict(tst, tsd)
    for i in range(2):
        for field in amp.LossScaleState._fields:
            assert getattr(back.scaler_state(i), field).item() == \
                getattr(tst.scaler_state(i), field).item()
    assert back.scaler_state(1).loss_scale.item() == 2.0 ** 15


def test_initialize_without_tensors_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        amp.initialize({}, None, opt_level="O2")


def test_unknown_level_raises():
    with pytest.raises(RuntimeError, match="Unexpected optimization level"):
        amp.initialize({"w": torch.ones(2)}, None, opt_level="O4")


def test_o1_context_patches_functions():
    _, _, st = amp.initialize({"w": torch.ones(2)}, None, opt_level="O1")
    a = torch.ones(4, 4)
    with st.autocast():
        assert torch.matmul(a, a).dtype == torch.bfloat16
    assert torch.matmul(a, a).dtype == torch.float32
    _, _, st2 = amp.initialize({"w": torch.ones(2)}, None, opt_level="O2")
    with st2.autocast():
        assert torch.matmul(a, a).dtype == torch.float32


# ---------------------------------------------------------------------------
# scaled_value_and_grad and the skip
# ---------------------------------------------------------------------------

def _small_problem(blow_up):
    rng = np.random.default_rng(0)
    w = rng.standard_normal((4, 3)).astype(np.float32)
    b = rng.standard_normal((3,)).astype(np.float32)
    x = rng.standard_normal((5, 4)).astype(np.float32)
    factor = 1e36 if blow_up else 1.0
    return {"w": w, "b": b}, x, factor


@pytest.mark.parametrize("blow_up", [False, True], ids=["clean", "overflow"])
@pytest.mark.parametrize("has_aux", [False, True])
def test_scaled_value_and_grad_matches_jax(blow_up, has_aux):
    params, x, factor = _small_problem(blow_up)

    def jloss(p, x):
        y = x @ p["w"] + p["b"]
        loss = jnp.sum(y * y) * factor
        return (loss, {"y": y}) if has_aux else loss

    def tloss(p, x):
        y = x @ p["w"] + p["b"]
        loss = torch.sum(y * y) * factor
        return (loss, {"y": y}) if has_aux else loss

    jsc = jamp.LossScaler("dynamic", init_scale=2.0 ** 10)
    tsc = amp.LossScaler("dynamic", init_scale=2.0 ** 10)
    jfn = jamp.scaled_value_and_grad(jloss, jsc, has_aux=has_aux)
    tfn = amp.scaled_value_and_grad(tloss, tsc, has_aux=has_aux)
    jout, jg, js = jfn(jsc.init_state(), jax.tree_util.tree_map(
        jnp.asarray, params), jnp.asarray(x))
    tp = {k: torch.from_numpy(v) for k, v in params.items()}
    tout, tg, ts = tfn(tsc.init_state("cpu"), tp, torch.from_numpy(x))
    if has_aux:
        (jl, jaux), (tl, taux) = jout, tout
        assert not taux["y"].requires_grad
        np.testing.assert_allclose(taux["y"].numpy(), np.asarray(jaux["y"]),
                                   rtol=1e-6)
    else:
        jl, tl = jout, tout
    assert not tl.requires_grad and tp["w"].grad is None
    assert bool(ts.found_inf) == bool(js.found_inf) == blow_up
    if not blow_up:
        np.testing.assert_allclose(float(tl), float(jl), rtol=1e-6)
        for k in params:
            np.testing.assert_allclose(tg[k].numpy(), np.asarray(jg[k]),
                                       rtol=1e-6, atol=1e-6)
    ts2, js2 = tsc.update_scale(ts), jsc.update_scale(js)
    for field in amp.LossScaleState._fields:
        assert getattr(ts2, field).item() == np.asarray(
            getattr(js2, field)).item(), field


def test_scaled_value_and_grad_argnums_tuple():
    params, x, _ = _small_problem(False)
    tp = {k: torch.from_numpy(v) for k, v in params.items()}
    tx = torch.from_numpy(x)

    def tloss(p, x):
        return torch.sum((x @ p["w"] + p["b"]) ** 2)

    def jloss(p, x):
        return jnp.sum((x @ p["w"] + p["b"]) ** 2)

    tsc, jsc = amp.LossScaler(8.0), jamp.LossScaler(8.0)
    _, (tgp, tgx), _ = amp.scaled_value_and_grad(tloss, tsc, argnums=(0, 1))(
        tsc.init_state("cpu"), tp, tx)
    _, (jgp, jgx), _ = jamp.scaled_value_and_grad(jloss, jsc, argnums=(0, 1))(
        jsc.init_state(), jax.tree_util.tree_map(jnp.asarray, params),
        jnp.asarray(x))
    np.testing.assert_allclose(tgx.numpy(), np.asarray(jgx), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(tgp["w"].numpy(), np.asarray(jgp["w"]),
                               rtol=1e-6, atol=1e-6)


def test_scale_loss_matches_jax():
    tsc, jsc = amp.LossScaler(64.0), jamp.LossScaler(64.0)
    t = amp.scale_loss(torch.tensor(1.5), tsc.init_state("cpu"))
    j = jamp.scale_loss(jnp.float32(1.5), jsc.init_state())
    assert float(t) == float(j) == 96.0


@pytest.mark.parametrize("found", [False, True])
def test_apply_updates_skip_on_overflow(found):
    old = {"a": torch.tensor([1.0, 2.0]), "b": [torch.tensor(3.0)]}
    new = {"a": torch.tensor([5.0, 6.0]), "b": [torch.tensor(7.0)]}
    out = amp.apply_updates_skip_on_overflow(old, new, torch.tensor(found))
    jout = jamp.apply_updates_skip_on_overflow(
        jax.tree_util.tree_map(lambda t: jnp.asarray(t.numpy()), old),
        jax.tree_util.tree_map(lambda t: jnp.asarray(t.numpy()), new),
        jnp.asarray(found))
    for a, b in zip(tree_leaves(out), jax.tree_util.tree_leaves(jout)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    want = old if found else new
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(out),
                                                 tree_leaves(want)))


# ---------------------------------------------------------------------------
# the inference cast (the repaired fault)
# ---------------------------------------------------------------------------

def _mixed_tree(lib):
    def arr(v, dtype="float32"):
        a = np.full((2,), v, np.float32)
        return (torch.from_numpy(a).to(getattr(torch, dtype)) if lib == "t"
                else jnp.asarray(a).astype(getattr(jnp, dtype)))
    steps = (torch.tensor([1, 2], dtype=torch.int32) if lib == "t"
             else jnp.asarray([1, 2], jnp.int32))
    return {"a": [arr(1.0), arr(2.0, "float16")],
            "b": (arr(3.0),),
            "BatchNorm_0": {"scale": arr(4.0, "bfloat16"), "mean": [arr(5.0)]},
            "nested": {"bn": (arr(6.0), {"w": arr(7.0)})},
            "steps": steps, "none": None}


@pytest.mark.parametrize("kbn", [False, True])
@pytest.mark.parametrize("dtype", ["bfloat16", "float16", "float32"])
def test_cast_params_for_inference_walks_lists_and_tuples(dtype, kbn):
    """The JAX function casts every float leaf of any tree (dicts, lists,
    tuples); with ``keep_batchnorm_fp32`` batchnorm-path leaves go to
    fp32. The port's walked dicts only and took no
    ``keep_batchnorm_fp32``."""
    tout = amp.cast_params_for_inference(_mixed_tree("t"),
                                         getattr(torch, dtype),
                                         keep_batchnorm_fp32=kbn)
    jout = jamp.cast_params_for_inference(_mixed_tree("j"),
                                          getattr(jnp, dtype),
                                          keep_batchnorm_fp32=kbn)
    assert _leaf_dtypes_torch(tout) == _leaf_dtypes_jax(jout)
    assert isinstance(tout["a"], list) and isinstance(tout["b"], tuple)
    assert tout["none"] is None
    for a, b in zip(tree_leaves(tout), jax.tree_util.tree_leaves(jout)):
        np.testing.assert_array_equal(
            a.float().numpy(), np.asarray(jnp.asarray(b).astype(jnp.float32)))


def test_cast_params_for_inference_keeps_cast_leaves():
    """A leaf already in the target dtype comes back as the same object
    (re-casting an already-cast tree costs nothing)."""
    tree = {"w": torch.ones(3, dtype=torch.bfloat16),
            "l": [torch.ones(2)]}
    out = amp.cast_params_for_inference(tree, torch.bfloat16)
    assert out["w"] is tree["w"]
    again = amp.cast_params_for_inference(out, torch.bfloat16)
    assert again["l"][0] is out["l"][0]


def test_exports_match_the_jax_package():
    import apex_tpu.amp as japi
    import apex_tpu_torch.amp as tapi

    names = {n for n in dir(japi) if not n.startswith("_")
             and not isinstance(getattr(japi, n), type(japi))}
    missing = {n for n in names if not hasattr(tapi, n)}
    assert not missing, missing
