"""The port's imagenet example (``apex_tpu_torch.examples.imagenet``)
against the JAX package's (``examples/imagenet``), on the CPU: training.

- three ``make_train_step`` steps of ResNet-18 at 32 px, batch 8, at O0
  (fp32) and O2 (bf16 over fp32 masters) against the JAX step on a
  one-device mesh, the first step's dtypes spied (the convs in the half
  dtype over half kernels at O2, every BatchNorm's output fp32) (not at 16 px: there a stride-2 3x3 conv meets a 1x1
  input, and torch's CPU bf16 weight gradient for that shape returns
  garbage in every memory format, torch 2.13; the card's is not
  affected): params (and their dtypes), running statistics, the FusedSGD
  state, the scaler state, loss and prec@1/5; then one more step on a
  JAX state carried across mid-run (``convert.fused_sgd_state_from_jax``);
- the overflow step (an input of 1e30): params, statistics and optimizer
  state unchanged bit for bit, the scale halved, as in JAX;
- the CLI at O0-O3, with ``--optimizer adam`` and ``--resume`` through
  ``tests/test_examples.py``'s harness, the checkpoint's layout against the JAX file's, and the
  refusals of SyncBatchNorm and of a world size above 1.

Tolerances: the fp32 train steps within 1e-4 of each leaf's largest
entry; the bf16 train steps' loss within 3e-2 relative and their trees
within 3e-2 of each leaf's largest entry plus a multiple of bf16's own
displacement (``_close_with_floor``); dtypes, ``found_inf``, the skips
and the scale exactly.
"""
import contextlib
import functools
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from apex_tpu import amp as jamp
from apex_tpu.optimizers import FusedSGD as JaxFusedSGD
from apex_tpu_torch import amp
from apex_tpu_torch._tree import tree_leaves, tree_map
from apex_tpu_torch.convert import (
    fused_sgd_state_from_jax,
    loss_scale_state_from_jax,
    resnet_params_from_jax,
    resnet_params_to_jax,
)
from apex_tpu_torch.examples.imagenet import main_amp, resnet
from apex_tpu_torch.optimizers import FusedSGD
from test_torch_resnet import (  # noqa: F401  (the fixture is autouse)
    CLASSES,
    _close_per_leaf,
    _jax_init,
    _np_tree,
    _two_torch_threads,
    jmain,
)

# ---------------------------------------------------------------------------
# the train step at O0 and O2
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _jax_step(opt_level, size):
    """The JAX example's jitted train step (compiled once per level)."""
    jm, params, _ = _jax_init("resnet18", size)
    jopt = JaxFusedSGD(lr=0.1, momentum=0.9, weight_decay=1e-4)
    _, jopt, jamp_state = jamp.initialize(params, jopt, opt_level=opt_level)
    mesh = Mesh(np.array(jax.devices()[:1]), ("data",))
    cast = jamp_state.opt_properties.cast_model_type not in (None,
                                                             jnp.float32)
    return jmain.make_train_step(jm, jopt, jamp_state.scaler(0), mesh,
                                 jnp.bfloat16, cast), jopt, mesh


def _jax_step_setup(opt_level, size=32):
    jstep, jopt, mesh = _jax_step(opt_level, size)
    _, params, bstats = _jax_init("resnet18", size)
    jparams, _, jamp_state = jamp.initialize(params, None,
                                             opt_level=opt_level)
    state = jax.device_put((jparams, bstats, jopt.init(jparams),
                            jamp_state.scaler_state(0)),
                           NamedSharding(mesh, P()))
    return jstep, state, _jax_init("resnet18", size)[1:]


def _port_step_setup(opt_level, params, bstats):
    tp, ts = resnet_params_from_jax(_np_tree(params), _np_tree(bstats))
    opt = FusedSGD(lr=0.1, momentum=0.9, weight_decay=1e-4)
    tp, opt, st = amp.initialize(tp, opt, opt_level=opt_level)
    cast = st.opt_properties.cast_model_type not in (None, torch.float32)
    tm = resnet.build_model("resnet18", num_classes=CLASSES)
    step = main_amp.make_train_step(tm, opt, st.scaler(0), torch.bfloat16,
                                    cast)
    return step, (tp, ts, opt.init(tp), st.scaler_state(0))


def _batches(n, b=8, size=32, seed=5):
    return list(main_amp.synthetic_batches(np.random.default_rng(seed), n,
                                           b, size, CLASSES))


def _flat(tree):
    return np.concatenate([np.ravel(np.asarray(x, np.float32))
                           for x in jax.tree_util.tree_leaves(tree)])


def _close_with_floor(jtree, ttree, rtree, tol, label):
    """Each leaf of ``ttree`` within ``tol`` of the JAX leaf's largest
    entry; with a reference ``rtree`` (the same steps in fp32), the bf16
    comparison: a bf16 step's rounding moves a leaf summed from cancelling
    terms (a bias, a zero-initialised scale) by up to 3/4 of its value in
    either package (measured against fp32), so the port is held to JAX
    relative to that floor, the distance of JAX's leaf from the fp32 one:
    each leaf within ``tol`` of its largest entry plus 5 floors (the worst
    leaf measured: 3.2), and the whole tree within twice the tree's floor
    in L2 (measured: 1.3)."""
    if rtree is None:
        return _close_per_leaf(jtree, ttree, tol, label)
    jl = jax.tree_util.tree_flatten_with_path(jtree)[0]
    for (path, a), b, r in zip(jl, jax.tree_util.tree_leaves(ttree),
                               jax.tree_util.tree_leaves(rtree)):
        a, b, r = (np.asarray(v, np.float32) for v in (a, b, r))
        err = float(np.abs(a - b).max())
        limit = tol * float(np.abs(a).max()) + 5 * float(np.abs(a - r).max())
        assert err <= limit, (label, jax.tree_util.keystr(path), err, limit)
    a, b, r = _flat(jtree), _flat(ttree), _flat(rtree)
    assert np.linalg.norm(a - b) <= 2 * np.linalg.norm(a - r), label


def _port_host(tstate):
    tparams, tbst, topt, _ = tstate
    return {"params": resnet_params_to_jax(tparams),
            "stats": resnet_params_to_jax(tbst),
            "momentum": resnet_params_to_jax(topt.momentum_buffer)}


def _compare_states(jstate, tstate, outs, tol, label, ref=None):
    """The JAX and port states after a step: dtypes, the scaler state and
    the step count exactly; params, running statistics, momentum and
    masters per leaf (:func:`_close_with_floor` against ``ref``, the
    port's fp32 state after the same steps); loss within ``tol``; prec@1/5
    exactly in fp32, within one image's share in bf16."""
    jparams, jbst, jopt, jss = jstate
    tparams, tbst, topt, tss = tstate
    for (path, a), b in zip(
            jax.tree_util.tree_flatten_with_path(jparams)[0],
            tree_leaves(tparams)):
        assert str(a.dtype) == str(b.dtype)[6:], (
            label, jax.tree_util.keystr(path), a.dtype, b.dtype)
    host = _port_host(tstate)
    rhost = None if ref is None else _port_host(ref)
    for key, jtree in (("params", jparams), ("stats", jbst),
                       ("momentum", jopt.momentum_buffer)):
        _close_with_floor(_np_tree(jtree), host[key],
                          None if rhost is None else rhost[key], tol,
                          f"{label} {key}")
    assert int(jopt.step) == int(topt.step)
    assert (jopt.master_params is None) == (topt.master_params is None)
    if jopt.master_params is not None:
        _close_with_floor(
            _np_tree(jopt.master_params),
            resnet_params_to_jax(topt.master_params),
            None if ref is None else resnet_params_to_jax(ref[0]), tol,
            f"{label} masters")
    for name in amp.LossScaleState._fields:
        assert getattr(tss, name).item() == np.asarray(
            getattr(jss, name)).item(), (label, name)
    (jl, j1, j5), (tl, t1, t5) = outs
    assert abs(float(jl) - float(tl)) <= tol * abs(float(jl)), (label, jl, tl)
    share = 0.0 if ref is None else 100.0 / 8
    assert abs(float(j1) - float(t1)) <= share, label
    assert abs(float(j5) - float(t5)) <= share, label


@contextlib.contextmanager
def _dtype_spies(seen):
    """Record the dtypes of the input and the kernel of every F.conv2d,
    the input of F.linear and F.log_softmax and the output of every
    BatchNorm of the port's ResNet."""
    saved = {(F, n): getattr(F, n) for n in ("conv2d", "linear",
                                             "log_softmax")}
    saved[(resnet, "_batch_norm")] = resnet._batch_norm

    def spy(mod, name):
        orig = saved[(mod, name)]

        def fn(t, *a, **k):
            out = orig(t, *a, **k)
            if mod is resnet:
                seen.setdefault("batch_norm", set()).add(out.dtype)
            else:
                seen.setdefault(name, set()).add(t.dtype)
            if name == "conv2d":
                seen.setdefault("conv2d.weight", set()).add(a[0].dtype)
            return out
        return fn

    for mod, n in saved:
        setattr(mod, n, spy(mod, n))
    try:
        yield
    finally:
        for (mod, n), f in saved.items():
            setattr(mod, n, f)


def _expected_dtypes(opt_level, half=torch.bfloat16):
    """flax's dtype flow: the convs compute in the half dtype over half
    kernels (O0: fp32), every BatchNorm outputs fp32, the classifier and
    log_softmax take fp32."""
    conv = torch.float32 if opt_level == "O0" else half
    return {"conv2d": {conv}, "conv2d.weight": {conv},
            "batch_norm": {torch.float32}, "linear": {torch.float32},
            "log_softmax": {torch.float32}}


@pytest.mark.parametrize("opt_level,tol", [("O0", 1e-4), ("O2", 3e-2)])
def test_train_steps_match_jax(opt_level, tol):
    jstep, jstate, (params, bstats) = _jax_step_setup(opt_level)
    step, tstate = _port_step_setup(opt_level, params, bstats)
    # the same steps in fp32 (the port's O0): the bf16 rounding floor
    ref_step, ref = (_port_step_setup("O0", params, bstats)
                     if opt_level == "O2" else (None, None))
    for i, (x, y) in enumerate(_batches(3)):
        lr = main_amp.adjust_learning_rate(0.1, 0, i, 3)
        args = (torch.from_numpy(x), torch.from_numpy(y), lr)
        jout = jstep(*jstate, jnp.asarray(x), jnp.asarray(y),
                     jnp.float32(lr))
        seen = {}
        with _dtype_spies(seen) if i == 0 else contextlib.nullcontext():
            tout = step(*tstate, *args)
        if i == 0:
            assert seen == _expected_dtypes(opt_level), seen
        if ref is not None:
            ref = ref_step(*ref, *args)[:4]
        jstate, tstate = jout[:4], tout[:4]
        _compare_states(jstate, tstate, (jout[4:], tout[4:]), tol,
                        f"{opt_level} step {i}", ref)
    # a JAX state carried across mid-run: one more step on both
    jparams, jbst, jopt, jss = _np_tree(jstate[0]), jstate[1], jstate[2], \
        jstate[3]
    carried_params = resnet_params_from_jax(jparams)[0]
    carried = (
        tree_map(lambda n, o: n.to(o.dtype), carried_params, tstate[0]),
        resnet_params_from_jax({}, _np_tree(jbst))[1],
        fused_sgd_state_from_jax(
            {"step": np.asarray(jopt.step),
             "momentum_buffer": _np_tree(jopt.momentum_buffer),
             "master_params": None if jopt.master_params is None
             else _np_tree(jopt.master_params)},
            tree_from_jax=lambda t, d: resnet_params_from_jax(t, device=d)[0]),
        loss_scale_state_from_jax(
            {k: np.asarray(getattr(jss, k)) for k in jss._fields}))
    x, y = _batches(1, seed=9)[0]
    jout = jstep(*jstate, jnp.asarray(x), jnp.asarray(y), jnp.float32(0.05))
    tout = step(*carried, torch.from_numpy(x), torch.from_numpy(y), 0.05)
    # from one state, one step: both round the same gradients once
    _compare_states(jout[:4], tout[:4], (jout[4:], tout[4:]), tol,
                    f"{opt_level} carried", None if ref is None else
                    ref_step(*ref, torch.from_numpy(x), torch.from_numpy(y),
                             0.05)[:4])


def test_overflow_step_skips_bit_for_bit():
    """An input of 1e30 overflows the gradients: params, running
    statistics and optimizer state stay bit for bit, the step count
    stays, the scale halves; the JAX step does the same."""
    jstep, jstate, (params, bstats) = _jax_step_setup("O2")
    step, tstate = _port_step_setup("O2", params, bstats)
    # one clean step first, so the optimizer state is not all zeros
    x, y = _batches(1)[0]
    tstate = step(*tstate, torch.from_numpy(x), torch.from_numpy(y), 0.1)[:4]
    jstate = jstep(*jstate, jnp.asarray(x), jnp.asarray(y),
                   jnp.float32(0.1))[:4]
    before = [t.clone() for t in tree_leaves(tstate[:3])]
    scale = float(tstate[3].loss_scale)
    xbig = np.full((8, 32, 32, 3), 1e30, np.float32)
    yz = np.zeros((8,), np.int32)
    # the step normalises uint8; feed the float image as JAX's test does
    out = step(*tstate, torch.from_numpy(xbig), torch.from_numpy(yz), 0.1)
    after = tree_leaves(out[:3])
    assert len(before) == len(after)
    for a, b in zip(before, after):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert float(out[3].loss_scale) == scale / 2
    assert int(out[3].consecutive_skips) == 1
    assert not bool(out[3].found_inf)  # consumed by update_scale
    jscale = float(jstate[3].loss_scale)
    jout = jstep(*jstate, jnp.asarray(xbig), jnp.asarray(yz),
                 jnp.float32(0.1))
    assert float(jout[3].loss_scale) == jscale / 2 == scale / 2


# ---------------------------------------------------------------------------
# the CLI (tests/test_examples.py's harness) and the checkpoint
# ---------------------------------------------------------------------------

def _run_main(monkeypatch, tmp_path, extra):
    argv = ["--synthetic", "--arch", "resnet18", "--epochs", "1",
            "--steps-per-epoch", "3", "-b", "16", "--image-size", "32",
            "--num-classes", "10", "--deterministic", "--print-freq", "1",
            "--device", "cpu"] + extra
    monkeypatch.chdir(tmp_path)  # checkpoint.pkl lands in tmp
    return main_amp.main(main_amp.parse(argv))


@pytest.mark.parametrize("opt_level", ["O0", "O1", "O2", "O3"])
def test_cli_opt_levels(monkeypatch, tmp_path, capsys, opt_level):
    prec1 = _run_main(monkeypatch, tmp_path, ["--opt-level", opt_level])
    out = capsys.readouterr().out
    assert "Epoch: [0][2/3]" in out and "Speed" in out
    assert np.isfinite(prec1)
    assert (tmp_path / "checkpoint.pkl").exists()


def test_cli_fused_adam(monkeypatch, tmp_path, capsys):
    """``--optimizer adam`` trains with the port's FusedAdam (the JAX
    example's config #2 optimizer; its SyncBatchNorm waits for A6.3)."""
    prec1 = _run_main(monkeypatch, tmp_path,
                      ["--opt-level", "O2", "--optimizer", "adam",
                       "--lr", "0.256"])
    assert "Epoch: [0][2/3]" in capsys.readouterr().out
    assert np.isfinite(prec1)
    with open(tmp_path / "checkpoint.pkl", "rb") as f:
        assert type(pickle.load(f)["opt_state"]).__name__ == "FusedAdamState"


def test_cli_resume_roundtrip(monkeypatch, tmp_path, capsys):
    _run_main(monkeypatch, tmp_path, ["--opt-level", "O2"])
    _run_main(monkeypatch, tmp_path,
              ["--opt-level", "O2", "--resume", "checkpoint.pkl"])
    out = capsys.readouterr().out
    assert "=> loaded checkpoint 'checkpoint.pkl' (epoch 1)" in out
    # resumed into a second epoch: the checkpoint reloads onto the live
    # dtypes and trains on
    _run_main(monkeypatch, tmp_path, ["--opt-level", "O2", "--epochs", "2",
                                      "--resume", "checkpoint.pkl"])
    assert "Epoch: [1][2/3]" in capsys.readouterr().out


def test_checkpoint_layout_matches_jax(monkeypatch, tmp_path, capsys):
    """The port's checkpoint holds the JAX file's keys, and its trees the
    JAX package's paths and shapes (flax layouts)."""
    _run_main(monkeypatch, tmp_path, ["--opt-level", "O2"])
    with open(tmp_path / "checkpoint.pkl", "rb") as f:
        ck = pickle.load(f)
    _, params, bstats = _jax_init("resnet18", 32)
    jopt = JaxFusedSGD(lr=0.1, momentum=0.9, weight_decay=1e-4)
    jparams, jopt, jst = jamp.initialize(params, jopt, opt_level="O2")
    jck = {"epoch": 1, "arch": "resnet18", "params": jparams,
           "batch_stats": bstats, "opt_state": jopt.init(jparams),
           "amp": jst.state_dict(), "best_prec1": 0.0}
    assert set(ck) == set(jck)
    for key in ("params", "batch_stats"):
        jl = jax.tree_util.tree_flatten_with_path(jck[key])[0]
        tl = jax.tree_util.tree_flatten_with_path(ck[key])[0]
        assert [jax.tree_util.keystr(p) for p, _ in jl] == \
            [jax.tree_util.keystr(p) for p, _ in tl]
        assert [a.shape for _, a in jl] == [np.shape(b) for _, b in tl]
    assert ck["opt_state"]._fields == jck["opt_state"]._fields
    for field in ("momentum_buffer", "master_params"):
        assert [a.shape for a in jax.tree_util.tree_leaves(
            getattr(jck["opt_state"], field))] == [
            np.shape(b) for b in jax.tree_util.tree_leaves(
                getattr(ck["opt_state"], field))]
    assert set(ck["amp"]["loss_scaler0"]) == set(jck["amp"]["loss_scaler0"])


def test_refuses_sync_bn_and_a_world_size(monkeypatch, tmp_path):
    with pytest.raises(NotImplementedError, match="A6.3"):
        _run_main(monkeypatch, tmp_path, ["--sync_bn"])
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(NotImplementedError, match="A6"):
        _run_main(monkeypatch, tmp_path, [])


