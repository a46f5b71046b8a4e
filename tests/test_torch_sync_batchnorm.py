"""SyncBatchNorm, ``groupbn``'s group sync, ``convert_syncbn_model``,
LARC, the imagenet example's data-parallel step (BASELINE config #2's
path) and the simple DDP example, against the JAX package on the CPU.

- One gloo world of 2 CPU processes, spawned once for the file over a
  ``FileStore`` (join timeout 180 s), against a 2-device JAX mesh under
  ``shard_map`` (``check_vma=False``, each device's gradient its own, as
  a rank's is): ``sync_batch_norm``'s output, running statistics and
  gradients of ``sum(y * dy)`` for x, weight and bias, NHWC and NCHW,
  with and without ``fuse_relu``, and in evaluation; ``groupbn``'s
  ``BatchNorm2d_NHWC(bn_group=2)`` with the add + ReLU epilogue and
  ``cudnn_gbn``'s ``GroupBatchNorm2d(group_size=2)``; and
  ``convert_syncbn_model`` of a torch ``Conv2d -> BatchNorm2d -> ReLU``,
  whose ranks together must give what the unconverted model gives on the
  whole batch (outputs, running statistics, summed weight gradients).
- LARC against ``tests/test_parallel.py``'s cases and the JAX wrapper's
  steps.
- ``main_amp --cpu 2 --sync_bn`` (ResNet-18 at 32 px, global batch 8, O0,
  FusedSGD, 2 steps, resumed from the JAX example's initial state) against
  the JAX ``make_train_step`` on 2 devices: the printed losses and the
  checkpointed params.
- The simple DDP example's loss lines against the JAX script's on the
  same data, at world 1 and in a world of 2.

The JAX examples build their steps with ``jax.shard_map(check_vma=True)``,
under which JAX's autodiff already sums a replicated parameter's
gradient over the devices before ``sync_gradients`` averages it: their
update is world times the averaged gradient's. The port (like the
reference and the JAX package's own ``tests/test_grad_lifecycle.py``)
averages. So at world 2 the JAX examples run here with ``check_vma``
off, where they average too; at world 1 the two agree as they stand.

Tolerances: fp32 outputs and statistics within 1e-5 of the largest entry
(the statistics sum in other orders; gloo sums two ranks exactly), input
gradients within 1e-4 of the largest entry (the closed form against
autodiff through the merge), bf16 outputs one bf16 rounding; LARC rtol
1e-5; the example's fp32 steps within phase 9's 1e-4 of each leaf's
largest entry, losses rtol 1e-5; the simple example's printed losses
within 2e-6 (the 6 printed decimals).
"""
import json
import os
import pickle
import subprocess
import sys
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

from apex_tpu import amp as jamp
from apex_tpu.contrib.groupbn import BatchNorm2d_NHWC as JBN
from apex_tpu.optimizers import FusedSGD as JFusedSGD
from apex_tpu.parallel import LARC as JLARC
from apex_tpu.parallel import larc_adjust_gradients as jlarc
from apex_tpu.parallel.sync_batchnorm import sync_batch_norm as jsbn
from apex_tpu_torch.optimizers import FusedSGD
from apex_tpu_torch.parallel import LARC, larc_adjust_gradients, larc_transform
from test_torch_resnet import (  # noqa: F401  (the fixture is autouse)
    CLASSES,
    _close_per_leaf,
    _two_torch_threads,
    jmain,
    jresnet,
)

REPO = Path(__file__).resolve().parents[1]
WORLD = 2
JOIN_TIMEOUT_S = 180
C = 6
#: (name, channel_last, fuse_relu, training, dtype)
BN_CASES = (("nhwc", True, False, True, "float32"),
            ("nchw", False, False, True, "float32"),
            ("nhwc_relu", True, True, True, "float32"),
            ("nchw_relu", False, True, True, "float32"),
            ("nhwc_eval", True, False, False, "float32"),
            ("nhwc_bf16", True, False, True, "bfloat16"))


def _inputs():
    rng = np.random.default_rng(77)
    out = {"x_nhwc": (rng.normal(size=(WORLD, 3, 5, 4, C)) * 2.0 + 0.5
                      ).astype(np.float32),
           "dy_nhwc": rng.normal(size=(WORLD, 3, 5, 4, C)).astype(
               np.float32),
           "w": (rng.random(C) + 0.5).astype(np.float32),
           "b": rng.normal(size=C).astype(np.float32),
           "rm": rng.normal(size=C).astype(np.float32) * 0.1,
           "rv": (rng.random(C) + 0.5).astype(np.float32),
           "z": rng.normal(size=(WORLD, 3, 5, 4, C)).astype(np.float32),
           "img": rng.normal(size=(WORLD, 2, 3, 6, 6)).astype(np.float32),
           "dimg": rng.normal(size=(WORLD, 2, 8, 6, 6)).astype(np.float32)}
    out["x_nchw"] = np.moveaxis(out["x_nhwc"], -1, 2).copy()
    out["dy_nchw"] = np.moveaxis(out["dy_nhwc"], -1, 2).copy()
    return out


_WORKER = r"""
import json, sys
import numpy as np
import torch
import torch.distributed as dist

torch.set_num_threads(1)
rank, world, store, out, inputs = (int(sys.argv[1]), int(sys.argv[2]),
                                   sys.argv[3], sys.argv[4], sys.argv[5])
cases = json.loads(sys.argv[6])
C = int(sys.argv[7])
dist.init_process_group("gloo", init_method="file://" + store,
                        world_size=world, rank=rank)
from apex_tpu_torch.contrib.cudnn_gbn import GroupBatchNorm2d
from apex_tpu_torch.contrib.groupbn import BatchNorm2d_NHWC
from apex_tpu_torch.parallel import convert_syncbn_model, sync_batch_norm

a = dict(np.load(inputs))
res = {}
def t(name, dtype=torch.float32):
    return torch.from_numpy(a[name][rank]).to(dtype)
for name, cl, relu, training, dt in cases:
    layout = "nhwc" if cl else "nchw"
    dtype = getattr(torch, dt)
    x = t("x_" + layout, dtype).requires_grad_()
    w = torch.from_numpy(a["w"]).requires_grad_()
    b = torch.from_numpy(a["b"]).requires_grad_()
    y, rm, rv = sync_batch_norm(x, w, b, torch.from_numpy(a["rm"]),
                                torch.from_numpy(a["rv"]),
                                training=training, axis_name="data",
                                channel_last=cl, fuse_relu=relu)
    res[name + "/y"] = y.detach().float().numpy()
    res[name + "/rm"] = rm.numpy()
    res[name + "/rv"] = rv.numpy()
    if dt == "float32":
        gx, gw, gb = torch.autograd.grad((y * t("dy_" + layout)).sum(),
                                         (x, w, b))
        res[name + "/gx"] = gx.numpy()
        res[name + "/gw"] = gw.numpy()
        res[name + "/gb"] = gb.numpy()

# groupbn over a group of 2 ranks, the add + ReLU epilogue
for key, bn in (("groupbn", BatchNorm2d_NHWC(C, fuse_relu=True, bn_group=2)),
                ("cudnn_gbn", GroupBatchNorm2d(C, group_size=2))):
    params, state = bn.init(device="cpu")
    params = {"weight": torch.from_numpy(a["w"]).requires_grad_(),
              "bias": torch.from_numpy(a["b"]).requires_grad_()}
    x = t("x_nhwc").requires_grad_()
    z = t("z").requires_grad_()
    y, new = bn.apply(params, state, x, z if key == "groupbn" else None)
    gx, gz = torch.autograd.grad((y * t("dy_nhwc")).sum(), (x, z),
                                 allow_unused=True)
    res[key + "/y"] = y.detach().numpy()
    res[key + "/rm"] = new["running_mean"].numpy()
    res[key + "/rv"] = new["running_var"].numpy()
    res[key + "/gx"] = gx.numpy()
    if key == "groupbn":
        res[key + "/gz"] = gz.numpy()

# convert_syncbn_model: each rank its half of the batch
torch.manual_seed(5)
model = torch.nn.Sequential(torch.nn.Conv2d(3, 8, 3, padding=1),
                            torch.nn.BatchNorm2d(8), torch.nn.ReLU())
model = convert_syncbn_model(model)
out_img = model(t("img"))
(out_img * t("dimg")).sum().backward()
res["convert/y"] = out_img.detach().numpy()
res["convert/rm"] = model[1].running_mean.numpy()
res["convert/rv"] = model[1].running_var.numpy()
res["convert/gw"] = model[0].weight.grad.numpy()
res["convert/type"] = np.array(type(model[1]).__name__)
dist.destroy_process_group()
np.savez(f"{out}/rank{rank}.npz", **res)
"""


ARR = _inputs()


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("gloo_sbn")
    inputs = tmp / "inputs.npz"
    np.savez(inputs, **ARR)
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    env.pop("XLA_FLAGS", None)
    procs = [subprocess.Popen(
        [sys.executable, "-c", _WORKER, str(r), str(WORLD),
         str(tmp / "store"), str(tmp), str(inputs),
         json.dumps([list(c) for c in BN_CASES]), str(C)],
        env=env, cwd=str(tmp), stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for r in range(WORLD)]
    deadline = time.monotonic() + JOIN_TIMEOUT_S
    errors = []
    try:
        for r, p in enumerate(procs):
            try:
                _, err = p.communicate(
                    timeout=max(1.0, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                errors.append(f"rank {r}: no exit within {JOIN_TIMEOUT_S} s")
                continue
            if p.returncode:
                errors.append(f"rank {r} exited {p.returncode}:\n"
                              f"{err[-3000:]}")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert not errors, "\n".join(errors)
    return [dict(np.load(tmp / f"rank{r}.npz")) for r in range(WORLD)]


def _per_device(fn, *stacked, axis="data"):
    mesh = Mesh(np.array(jax.devices()[:WORLD]), (axis,))

    def body(*xs):
        out = fn(*(x[0] for x in xs))
        return jax.tree_util.tree_map(lambda o: o[None], out)
    spec = P(axis)
    out = jax.jit(jax.shard_map(body, mesh=mesh, in_specs=spec,
                                out_specs=spec, check_vma=False))(
        *(jnp.asarray(x) for x in stacked))
    return jax.tree_util.tree_map(np.asarray, out)


def _close(got, want, tol):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, (err / scale, tol)


def _stack(name):
    return np.stack([ARR[name]] * WORLD)


@pytest.mark.parametrize("case", [c[0] for c in BN_CASES])
def test_sync_batch_norm_equals_jax_across_ranks(world, case):
    _, cl, relu, training, dt = dict((c[0], c) for c in BN_CASES)[case]
    layout = "nhwc" if cl else "nchw"
    dtype = jnp.dtype(dt)

    def fn(x, dy, w, b):
        def f(x, w, b):
            y, rm, rv = jsbn(x.astype(dtype), w, b, jnp.asarray(ARR["rm"]),
                             jnp.asarray(ARR["rv"]), training=training,
                             axis_name="data" if training else None,
                             channel_last=cl, fuse_relu=relu)
            return jnp.sum(y.astype(jnp.float32) * dy), (y, rm, rv)
        (_, (y, rm, rv)), grads = jax.value_and_grad(
            f, argnums=(0, 1, 2), has_aux=True)(x, w, b)
        return y.astype(jnp.float32), rm, rv, grads

    y, rm, rv, (gx, gw, gb) = _per_device(
        fn, ARR["x_" + layout], ARR["dy_" + layout], _stack("w"),
        _stack("b"))
    out_tol = 2.0 ** -7 if dt == "bfloat16" else 1e-5
    for r in range(WORLD):
        res = world[r]
        _close(res[case + "/y"], y[r], out_tol)
        _close(res[case + "/rm"], rm[r], 1e-5)
        _close(res[case + "/rv"], rv[r], 1e-5)
        if dt == "float32":
            _close(res[case + "/gx"], gx[r], 1e-4)
            _close(res[case + "/gw"], gw[r], 1e-4)
            _close(res[case + "/gb"], gb[r], 1e-5)
    if training:  # the statistics are the whole batch's on both ranks
        np.testing.assert_array_equal(world[0][case + "/rm"],
                                      world[1][case + "/rm"])


def test_sync_batch_norm_gradient_is_reduced_across_ranks(world):
    """Without the backward's all-reduce each rank's input gradient would
    be that of its own loss through the shared statistics: the ranks'
    gradients must differ from the local-only BatchNorm's, and match
    autograd of the sum of both ranks' losses through one BatchNorm over
    the whole batch."""
    x = torch.from_numpy(ARR["x_nhwc"].reshape(-1, C)).double()
    x.requires_grad_()
    dy = torch.from_numpy(ARR["dy_nhwc"].reshape(-1, C)).double()
    w = torch.from_numpy(ARR["w"]).double()
    b = torch.from_numpy(ARR["b"]).double()
    mean = x.mean(0)
    var = ((x - mean) ** 2).mean(0)
    y = (x - mean) / torch.sqrt(var + 1e-5) * w + b
    (gx,) = torch.autograd.grad((y * dy).sum(), (x,))
    gx = gx.reshape(ARR["x_nhwc"].shape).numpy()
    for r in range(WORLD):
        _close(world[r]["nhwc/gx"], gx[r], 1e-4)


@pytest.mark.parametrize("key", ["groupbn", "cudnn_gbn"])
def test_group_batch_norm_over_two_ranks_equals_jax(world, key):
    jbn = JBN(C, fuse_relu=True, bn_group=2) if key == "groupbn" else \
        JBN(C, fuse_relu=False, bn_group=2)
    _, state = jbn.init()

    def fn(x, z, dy):
        def f(x, z):
            y, new = jbn.apply({"weight": jnp.asarray(ARR["w"]),
                                "bias": jnp.asarray(ARR["b"])}, state, x,
                               z if key == "groupbn" else None)
            return jnp.sum(y * dy), (y, new)
        (_, (y, new)), (gx, gz) = jax.value_and_grad(
            f, argnums=(0, 1), has_aux=True)(x, z)
        return y, new["running_mean"], new["running_var"], gx, gz

    y, rm, rv, gx, gz = _per_device(fn, ARR["x_nhwc"], ARR["z"],
                                    ARR["dy_nhwc"], axis="bn_group")
    for r in range(WORLD):
        res = world[r]
        _close(res[key + "/y"], y[r], 1e-5)
        _close(res[key + "/rm"], rm[r], 1e-5)
        _close(res[key + "/rv"], rv[r], 1e-5)
        _close(res[key + "/gx"], gx[r], 1e-4)
        if key == "groupbn":
            _close(res[key + "/gz"], gz[r], 1e-5)


def test_convert_syncbn_model_equals_the_whole_batch(world):
    torch.manual_seed(5)
    model = torch.nn.Sequential(torch.nn.Conv2d(3, 8, 3, padding=1),
                                torch.nn.BatchNorm2d(8), torch.nn.ReLU())
    img = torch.from_numpy(ARR["img"].reshape(-1, 3, 6, 6))
    out = model(img)
    (out * torch.from_numpy(ARR["dimg"].reshape(-1, 8, 6, 6))).sum(
        ).backward()
    out = out.detach().numpy().reshape(WORLD, 2, 8, 6, 6)
    for r in range(WORLD):
        res = world[r]
        assert str(res["convert/type"]) == "SyncBatchNorm"
        _close(res["convert/y"], out[r], 1e-5)
        _close(res["convert/rm"], model[1].running_mean.numpy(), 1e-5)
        _close(res["convert/rv"], model[1].running_var.numpy(), 1e-5)
    _close(world[0]["convert/gw"] + world[1]["convert/gw"],
           model[0].weight.grad.numpy(), 1e-4)


def test_convert_syncbn_model_carries_the_state():
    from apex_tpu_torch.parallel import SyncBatchNorm, convert_syncbn_model

    bn = torch.nn.BatchNorm2d(4, momentum=0.3)
    with torch.no_grad():
        bn.weight.uniform_()
        bn.bias.uniform_()
        bn.running_mean.uniform_()
        bn.running_var.uniform_(0.5, 1.5)
        bn.num_batches_tracked.fill_(7)
    bn.eval()
    sbn = convert_syncbn_model(bn)
    assert isinstance(sbn, SyncBatchNorm) and not sbn.training
    assert sbn.momentum == 0.3
    for k, v in bn.state_dict().items():
        assert torch.equal(sbn.state_dict()[k], v), k
    x = torch.randn(3, 4, 5, 5)
    torch.testing.assert_close(sbn(x), bn(x), rtol=1e-6, atol=1e-6)
    # without a process group the world is 1: training equals torch's
    # BatchNorm on this batch (the unbiased running variance too)
    bn.train()
    sbn.train()
    torch.testing.assert_close(sbn(x), bn(x), rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(sbn.running_var, bn.running_var, rtol=1e-6,
                               atol=1e-6)


def test_sync_batch_norm_module_fields_match_jax():
    """The JAX flax module's fields: ``use_bias=False`` keeps no bias,
    ``track_running_stats=False`` keeps no statistics, ``fuse_relu``."""
    from apex_tpu_torch.parallel import SyncBatchNorm

    m = SyncBatchNorm(5, use_bias=False, channel_last=True, fuse_relu=True,
                      track_running_stats=False)
    assert m.bias is None and m.running_mean is None
    x = torch.randn(4, 3, 5)
    y = m(x)
    assert bool((y >= 0).all()) and y.shape == x.shape


# ---------------------------------------------------------------------------
# LARC
# ---------------------------------------------------------------------------

LARC_CASES = {
    "clip_small": ({"w": np.full(10, 2.0)}, {"w": np.full(10, 1e-4)},
                   dict(clip=True)),
    "clip_big": ({"w": np.full(10, 2.0)}, {"w": np.full(10, 100.0)},
                 dict(clip=True)),
    "no_clip": ({"w": np.full(10, 2.0)}, {"w": np.full(10, 100.0)},
                dict(clip=False)),
    "zero_grad_wd": ({"w": np.full(4, 3.0)}, {"w": np.zeros(4)},
                     dict(clip=True, weight_decay=0.1)),
    "tree_wd": ({"a": np.linspace(-1, 1, 12).reshape(3, 4), "b": np.zeros(5)},
                {"a": np.linspace(0.3, -2, 12).reshape(3, 4),
                 "b": np.ones(5)}, dict(clip=False, weight_decay=1e-2)),
}


@pytest.mark.parametrize("case", sorted(LARC_CASES))
def test_larc_adjust_gradients_equals_jax(case):
    params, grads, kw = LARC_CASES[case]
    want = jlarc({k: jnp.asarray(v, jnp.float32) for k, v in grads.items()},
                 {k: jnp.asarray(v, jnp.float32) for k, v in params.items()},
                 0.1, trust_coefficient=0.02, **kw)
    got = larc_adjust_gradients(
        {k: torch.tensor(v, dtype=torch.float32) for k, v in grads.items()},
        {k: torch.tensor(v, dtype=torch.float32) for k, v in params.items()},
        0.1, trust_coefficient=0.02, **kw)
    for k in grads:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-5, atol=0)


def test_larc_wrapper_steps_equal_jax():
    """``LARC(FusedSGD(momentum, weight_decay))``: 3 steps against the JAX
    wrapper, the decay folded by LARC and the optimizer's restored."""
    rng = np.random.default_rng(9)
    p0 = {"w": rng.normal(size=(6, 4)).astype(np.float32),
          "b": rng.normal(size=4).astype(np.float32)}
    gs = [{k: rng.normal(size=v.shape).astype(np.float32) for k, v in
           p0.items()} for _ in range(3)]
    jopt = JLARC(JFusedSGD(lr=0.1, momentum=0.9, weight_decay=1e-3),
                 trust_coefficient=0.02)
    topt = LARC(FusedSGD(lr=0.1, momentum=0.9, weight_decay=1e-3),
                trust_coefficient=0.02)
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    tp = {k: torch.from_numpy(v) for k, v in p0.items()}
    js, ts = jopt.init(jp), topt.init(tp)
    for g in gs:
        jp, js = jopt.step({k: jnp.asarray(v) for k, v in g.items()}, js, jp)
        tp, ts = topt.step({k: torch.from_numpy(v) for k, v in g.items()},
                           ts, tp)
        assert topt.weight_decay == 1e-3  # restored after the step
    for k in p0:
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]),
                                   rtol=1e-5, atol=1e-7)
    assert topt.lr == 0.1  # attributes read through to the optimizer
    with pytest.raises(NotImplementedError, match="optax"):
        larc_transform(0.1)


# ---------------------------------------------------------------------------
# the imagenet example's data-parallel step: main_amp --cpu 2
# ---------------------------------------------------------------------------

ARGS = ["--synthetic", "--arch", "resnet18", "--epochs", "1",
        "--steps-per-epoch", "2", "-b", "8", "--image-size", "32",
        "--num-classes", str(CLASSES), "--deterministic", "--print-freq",
        "1", "--opt-level", "O0", "--sync_bn", "--optimizer", "sgd"]


def _no_vma(monkeypatch):
    """``jax.shard_map`` with ``check_vma=False`` inside the JAX example
    (see the module docstring)."""
    orig = jax.shard_map
    monkeypatch.setattr(jax, "shard_map", lambda *a, **k: orig(
        *a, **{**k, "check_vma": False}))


def test_main_amp_cpu_world_matches_the_jax_step(tmp_path, monkeypatch):
    model = jresnet.build_model("resnet18", num_classes=CLASSES,
                                sync_bn=True)
    v = jax.jit(lambda k: model.init(
        k, jnp.zeros((2, 32, 32, 3), jnp.float32), train=False))(
        jax.random.PRNGKey(11))
    params, bstats = v["params"], v["batch_stats"]
    base_lr = 0.1 * 8 / 256
    jopt = JFusedSGD(lr=base_lr, momentum=0.9, weight_decay=1e-4)
    jparams, jopt, jst = jamp.initialize(params, jopt, opt_level="O0")
    opt_state = jopt.init(jparams)
    np_tree = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    ck = {"epoch": 0, "arch": "resnet18", "params": np_tree(jparams),
          "batch_stats": np_tree(bstats),
          "opt_state": tuple(np_tree(f) for f in opt_state),
          "amp": jst.state_dict(), "best_prec1": 0.0}
    with open(tmp_path / "start.pkl", "wb") as f:
        pickle.dump(ck, f)
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    env.pop("XLA_FLAGS", None)
    run = subprocess.run(
        [sys.executable, "-m", "apex_tpu_torch.examples.imagenet.main_amp",
         *ARGS, "--cpu", "2", "--resume", "start.pkl"],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=600)
    assert run.returncode == 0, run.stderr[-3000:]
    out = run.stdout
    assert "devices: 2 x cpu" in out and "loaded checkpoint" in out
    losses = [float(line.split("Loss ")[1].split()[0])
              for line in out.splitlines() if line.startswith("Epoch: [0]")]
    with open(tmp_path / "checkpoint.pkl", "rb") as f:
        got = pickle.load(f)

    _no_vma(monkeypatch)
    mesh = Mesh(np.array(jax.devices()[:2]), ("data",))
    step = jmain.make_train_step(model, jopt, jst.scaler(0), mesh,
                                 jnp.bfloat16, False)
    state = (jparams, bstats, opt_state, jst.scaler_state(0))
    want = []
    for i, (x, y) in enumerate(jmain.synthetic_batches(
            np.random.default_rng(0), 2, 8, 32, CLASSES)):
        lr = jmain.adjust_learning_rate(base_lr, 0, i, 2)
        *state, loss, _, _ = step(*state, jnp.asarray(x), jnp.asarray(y),
                                  jnp.float32(lr))
        want.append(float(loss))
    np.testing.assert_allclose(losses, want, rtol=1e-5)
    _close_per_leaf(state[0], got["params"], 1e-4, "params")
    _close_per_leaf(state[1], got["batch_stats"], 1e-4, "batch_stats")


# ---------------------------------------------------------------------------
# the simple DDP example
# ---------------------------------------------------------------------------

SIMPLE = REPO / "examples" / "simple" / "distributed" / \
    "distributed_data_parallel.py"
_JAX_SIMPLE = ("import sys, runpy, jax\n"
               "if sys.argv[1] == 'mean':\n"
               "    orig = jax.shard_map\n"
               "    jax.shard_map = lambda *a, **k: orig(\n"
               "        *a, **{**k, 'check_vma': False})\n"
               "sys.argv = ['x'] + sys.argv[2:]\n"
               f"runpy.run_path({str(SIMPLE)!r}, run_name='__main__')\n")


def _loss_lines(text):
    return [(int(line.split()[1][:-1]), float(line.split()[-1]))
            for line in text.splitlines() if line.startswith("step ")]


@pytest.mark.parametrize("world_size", [1, 2])
def test_simple_ddp_example_matches_the_jax_script(tmp_path, world_size):
    w_key = jax.random.split(jax.random.PRNGKey(0), 3)
    x = jax.random.normal(w_key[0], (64 * world_size, 1024))
    y = jax.random.normal(w_key[1], (64 * world_size, 16))
    w = jax.random.normal(w_key[2], (1024, 16)) * 0.01
    np.savez(tmp_path / "data.npz", x=np.asarray(x), y=np.asarray(y),
             w=np.asarray(w))
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    env.pop("XLA_FLAGS", None)
    steps = "101"
    jrun = subprocess.run(
        [sys.executable, "-c", _JAX_SIMPLE,
         "mean" if world_size > 1 else "as_is", "--cpu", str(world_size),
         "--steps", steps], env=env, capture_output=True, text=True,
        timeout=600)
    assert jrun.returncode == 0, jrun.stderr[-3000:]
    port_args = (["--cpu", "2"] if world_size > 1 else ["--device", "cpu"])
    trun = subprocess.run(
        [sys.executable, "-m",
         "apex_tpu_torch.examples.simple.distributed.distributed_data_parallel",
         *port_args, "--steps", steps, "--data", str(tmp_path / "data.npz")],
        env=env, capture_output=True, text=True, timeout=600)
    assert trun.returncode == 0, trun.stderr[-3000:]
    assert f"world size {world_size} (cpu)" in trun.stdout
    want, got = _loss_lines(jrun.stdout), _loss_lines(trun.stdout)
    assert [s for s, _ in got] == [s for s, _ in want] == [0, 100]
    np.testing.assert_allclose([l for _, l in got], [l for _, l in want],
                               rtol=0, atol=2e-6)
    assert got[-1][1] < got[0][1] and "done." in trun.stdout


def test_main_amp_refuses_a_world_without_a_launcher(monkeypatch, tmp_path):
    from apex_tpu_torch.examples.imagenet import main_amp

    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.delenv("RANK", raising=False)
    with pytest.raises(SystemExit, match="torchrun"):
        main_amp.main(main_amp.parse(ARGS + ["--device", "cpu"]))
    with pytest.raises(SystemExit, match="runs on the CPU"):
        main_amp.main(main_amp.parse(ARGS + ["--cpu", "2", "--device",
                                             "cuda"]))
