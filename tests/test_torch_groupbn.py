"""``parallel.sync_batch_norm`` (its single-device form),
``contrib.groupbn.BatchNorm2d_NHWC`` and ``contrib.cudnn_gbn``'s
``GroupBatchNorm2d`` of the port against the JAX package's, on the CPU.

Numpy-seeded NHWC inputs (fp32 and bf16) through both, in training (the
output, the new running statistics) and evaluation, NCHW too for
``sync_batch_norm``; the fused ReLU and the add + ReLU epilogue; the
gradients of the input, the residual and the parameters; the JAX
``(params, state)`` carried across with ``params_from_jax``; a training
axis at world 1 and an axis outside the model-parallel layout refused;
a group sync without a process group refused, and the cuDNN alias's own
refusal.

Tolerances: fp32 outputs, statistics and gradients within 1e-6 of each
result's largest entry (fp32 statistics summed in orders the frameworks
choose); bf16 outputs within one bf16 rounding (2^-8) of the largest.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.contrib.cudnn_gbn import GroupBatchNorm2d as JGBN
from apex_tpu.contrib.groupbn import BatchNorm2d_NHWC as JBN
from apex_tpu.parallel import sync_batch_norm as jsbn
from apex_tpu_torch.contrib.cudnn_gbn import GroupBatchNorm2d as TGBN
from apex_tpu_torch.contrib.groupbn import BatchNorm2d_NHWC as TBN
from apex_tpu_torch.convert import params_from_jax
from apex_tpu_torch.parallel import sync_batch_norm as tsbn

TOL = {"float32": 1e-6, "bfloat16": 2.0 ** -8}
SHAPE = (4, 6, 6, 16)


def _np(x):
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _close(got, want, tol):
    want = _np(want)
    got = got.detach().float().numpy()
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= tol * np.abs(want).max(), (
        np.abs(got - want).max(), np.abs(want).max())


def _arrays(seed, shape=SHAPE, c=None):
    rng = np.random.default_rng(seed)
    c = shape[-1] if c is None else c
    x = (rng.standard_normal(shape) * 1.5 + 0.7).astype(np.float32)
    w = (1 + 0.2 * rng.standard_normal(c)).astype(np.float32)
    b = (0.1 * rng.standard_normal(c)).astype(np.float32)
    rm = (0.1 * rng.standard_normal(c)).astype(np.float32)
    rv = (1 + 0.1 * rng.random(c)).astype(np.float32)
    return x, w, b, rm, rv


@pytest.mark.parametrize("fuse_relu", [False, True])
@pytest.mark.parametrize("channel_last", [True, False])
@pytest.mark.parametrize("training", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_sync_batch_norm_matches(dtype, training, channel_last, fuse_relu):
    shape = SHAPE if channel_last else (4, 16, 6, 6)
    x, w, b, rm, rv = _arrays(0, shape, 16)
    kw = dict(training=training, momentum=0.1, eps=1e-5, axis_name=None,
              channel_last=channel_last, fuse_relu=fuse_relu)
    jy, jrm, jrv = jsbn(jnp.asarray(x).astype(getattr(jnp, dtype)),
                        jnp.asarray(w), jnp.asarray(b), jnp.asarray(rm),
                        jnp.asarray(rv), **kw)
    ty, trm, trv = tsbn(torch.from_numpy(x).to(getattr(torch, dtype)),
                        *(torch.from_numpy(a) for a in (w, b, rm, rv)), **kw)
    assert ty.dtype == getattr(torch, dtype)
    _close(ty, jy, TOL[dtype])
    _close(trm, jrm, 1e-6)
    _close(trv, jrv, 1e-6)


def test_sync_batch_norm_gradients_match():
    x, w, b, rm, rv = _arrays(1)
    dy = np.random.default_rng(5).standard_normal(SHAPE).astype(np.float32)
    kw = dict(training=True, axis_name=None, fuse_relu=True)
    jg = jax.grad(lambda x, w, b: jnp.sum(jsbn(
        x, w, b, jnp.asarray(rm), jnp.asarray(rv), **kw)[0] * dy),
        argnums=(0, 1, 2))(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))
    tt = [torch.from_numpy(a).requires_grad_() for a in (x, w, b)]
    y = tsbn(*tt, torch.from_numpy(rm), torch.from_numpy(rv), **kw)[0]
    tg = torch.autograd.grad((y * torch.from_numpy(dy)).sum(), tt)
    for g, j in zip(tg, jg):
        _close(g, j, 1e-6)


def test_sync_batch_norm_refuses_an_axis_in_training():
    """Since A6.3 a training axis names the ranks the statistics are
    synced over: with no process group a world of 1, the JAX function's
    result over a one-device mesh axis. An axis that is not one of the
    initialised model-parallel layout's is refused; evaluation reads no
    batch statistics, so it takes any axis name."""
    from apex_tpu_torch.transformer import parallel_state as ps

    arrays = _arrays(2)
    x, w, b, rm, rv = (torch.from_numpy(a) for a in arrays)
    got = tsbn(x, w, b, rm, rv, training=True)  # default axis "data"
    mesh = jax.sharding.Mesh(np.array(jax.devices()[:1]), ("data",))
    rep = jax.sharding.PartitionSpec()
    want = jax.jit(jax.shard_map(
        lambda *a: jsbn(*a, training=True), mesh=mesh, in_specs=rep,
        out_specs=rep, check_vma=False))(*(jnp.asarray(a) for a in arrays))
    for g, j in zip(got, want):
        _close(g, j, 1e-6)
    ps.initialize_model_parallel(1, 1)
    try:
        with pytest.raises(ValueError, match="not an axis"):
            tsbn(x, w, b, rm, rv, training=True, axis_name="bn_group")
        tsbn(x, w, b, rm, rv, training=True, axis_name="data")
        tsbn(x, w, b, rm, rv, training=False, axis_name="bn_group")
    finally:
        ps.destroy_model_parallel()


@pytest.mark.parametrize("mode", ["plain", "relu", "addrelu"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_batchnorm2d_nhwc_train_then_eval(dtype, mode):
    x, _, _, _, _ = _arrays(3)
    z = np.random.default_rng(6).standard_normal(SHAPE).astype(np.float32)
    fuse = mode == "relu"
    jbn, tbn = JBN(16, fuse_relu=fuse), TBN(16, fuse_relu=fuse)
    jp, js = jbn.init()
    jp = jax.tree_util.tree_map(lambda a: a + 0.3, jp)
    tp = params_from_jax(jax.tree_util.tree_map(np.asarray, jp))
    ts = params_from_jax(jax.tree_util.tree_map(np.asarray, js))
    jx = jnp.asarray(x).astype(getattr(jnp, dtype))
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    jz = tz = None
    if mode == "addrelu":
        jz, tz = jnp.asarray(z).astype(jx.dtype), torch.from_numpy(z).to(
            tx.dtype)
    for training in (True, True, False):
        jy, js = jbn.apply(jp, js, jx, jz, training=training)
        ty, ts = tbn.apply(tp, ts, tx, tz, training=training)
        _close(ty, jy, TOL[dtype])
        for k in ("running_mean", "running_var"):
            _close(ts[k], js[k], 1e-6)
    if mode != "plain":
        assert float(ty.min()) >= 0.0


def test_batchnorm2d_nhwc_gradients_with_residual():
    x, _, _, _, _ = _arrays(4)
    z = np.random.default_rng(7).standard_normal(SHAPE).astype(np.float32)
    dy = np.random.default_rng(8).standard_normal(SHAPE).astype(np.float32)
    jbn, tbn = JBN(16), TBN(16)
    jp, js = jbn.init()
    jg = jax.grad(lambda p, x, z: jnp.sum(jbn.apply(p, js, x, z)[0] * dy),
                  argnums=(0, 1, 2))(jp, jnp.asarray(x), jnp.asarray(z))
    tp, ts = tbn.init(device="cpu")
    tp = {k: v.requires_grad_() for k, v in tp.items()}
    tx, tz = (torch.from_numpy(a).requires_grad_() for a in (x, z))
    y, _ = tbn.apply(tp, ts, tx, tz)
    gw, gb, gx, gz = torch.autograd.grad((y * torch.from_numpy(dy)).sum(),
                                         (tp["weight"], tp["bias"], tx, tz))
    for g, j in ((gw, jg[0]["weight"]), (gb, jg[0]["bias"]), (gx, jg[1]),
                 (gz, jg[2])):
        _close(g, j, 1e-6)


def test_init_matches_and_group_sync_refuses():
    jp, js = JBN(8).init()
    tp, ts = TBN(8).init(device="cpu")
    for k in jp:
        np.testing.assert_array_equal(tp[k].numpy(), np.asarray(jp[k]))
    for k in js:
        np.testing.assert_array_equal(ts[k].numpy(), np.asarray(js[k]))
    # a group of 2 or 4 ranks needs a process group of that many
    # (synced across ranks in tests/test_torch_sync_batchnorm.py)
    with pytest.raises(ValueError, match="torch.distributed"):
        TBN(8, bn_group=2)
    with pytest.raises(ValueError, match="torch.distributed"):
        TGBN(8, group_size=4)


def test_cudnn_gbn_alias_and_its_refusal():
    x, _, _, _, _ = _arrays(5)
    jg, tg = JGBN(16, group_size=1), TGBN(16, group_size=1)
    jp, js = jg.init()
    tp, ts = tg.init(device="cpu")
    jy, _ = jg.apply(jp, js, jnp.asarray(x))
    ty, _ = tg.apply(tp, ts, torch.from_numpy(x))
    _close(ty, jy, 1e-6)
    with pytest.raises(NotImplementedError) as j:
        JGBN(8, group_size=2, affine=False)
    with pytest.raises(NotImplementedError) as t:
        TGBN(8, group_size=2, affine=False)
    assert str(t.value) == str(j.value)
