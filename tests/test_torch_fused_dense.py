"""``fused_dense`` and ``mlp`` of the port against the JAX package's, on
the CPU.

The three functions (``fused_dense``, ``dense_no_bias``,
``fused_dense_gelu_dense``) and the two modules (``FusedDense``,
``FusedDenseGeluDense``) with flax-initialised params carried across
(``params_from_jax`` + ``load_state_dict``), then ``mlp`` and ``MLP``
with each activation, with and without bias; fp32 and bf16, forward and
every gradient, on numpy-seeded inputs.

Tolerances: fp32 outputs and gradients within 1e-5 of each result's
largest entry (summation order; the port's bias-GeLU runs the add and
the tanh in fp32 as JAX's fp32 ``gelu`` does); bf16 within 2^-6 of each
result's largest entry (the two frameworks round bf16 products and
elementwise steps at other places, and the port's bias-GeLU rounds its
output once where XLA may round ``h + bias`` first: a product or two of
bf16 roundings of values of order the largest).
"""
import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu import fused_dense as jfd
from apex_tpu import mlp as jmlp
from apex_tpu_torch import fused_dense as tfd
from apex_tpu_torch import mlp as tmlp
from apex_tpu_torch.convert import params_from_jax

TOL = {"float32": 1e-5, "bfloat16": 2.0 ** -6}
DTYPES = ["float32", "bfloat16"]


def _np(t):
    return np.asarray(jnp.asarray(t).astype(jnp.float32))


def _close(got, want, dtype):
    want = _np(want)
    got = got.detach().float().numpy()
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= TOL[dtype] * np.abs(want).max(), (
        np.abs(got - want).max(), np.abs(want).max())


def _arrays(seed, shapes, dtype, scale=1.0):
    rng = np.random.default_rng(seed)
    arrs = [(rng.standard_normal(s) * scale).astype(np.float32)
            for s in shapes]
    return ([jnp.asarray(a).astype(getattr(jnp, dtype)) for a in arrs],
            [torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrs])


def _check_fn(jfn, tfn, jargs, targs, dy, dtype):
    """Output and the gradient of every argument, JAX against the port."""
    def loss(*a):
        y = jfn(*a)
        return jnp.sum(y.astype(jnp.float32) * jnp.asarray(dy)), y
    (_, jy), jgrads = jax.value_and_grad(
        loss, argnums=tuple(range(len(jargs))), has_aux=True)(*jargs)
    targs = [t.clone().requires_grad_(True) for t in targs]
    ty = tfn(*targs)
    assert ty.dtype == targs[0].dtype
    (ty.float() * torch.from_numpy(dy)).sum().backward()
    _close(ty, jy, dtype)
    for t, jg in zip(targs, jgrads):
        _close(t.grad, jg, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_fused_dense_matches_jax(dtype):
    jargs, targs = _arrays(0, [(2, 6, 32), (24, 32), (24,)], dtype)
    dy = np.random.default_rng(1).standard_normal((2, 6, 24)).astype(
        np.float32)
    _check_fn(jfd.fused_dense, tfd.fused_dense, jargs, targs, dy, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_dense_no_bias_matches_jax(dtype):
    jargs, targs = _arrays(2, [(12, 32), (20, 32)], dtype)
    dy = np.random.default_rng(3).standard_normal((12, 20)).astype(
        np.float32)
    _check_fn(jfd.dense_no_bias, tfd.dense_no_bias, jargs, targs, dy, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_fused_dense_gelu_dense_matches_jax(dtype):
    jargs, targs = _arrays(4, [(2, 8, 32), (64, 32), (64,), (16, 64),
                               (16,)], dtype, scale=0.5)
    dy = np.random.default_rng(5).standard_normal((2, 8, 16)).astype(
        np.float32)
    _check_fn(jfd.fused_dense_gelu_dense, tfd.fused_dense_gelu_dense,
              jargs, targs, dy, dtype)


def test_fused_dense_takes_mixed_dtypes_as_jax_does():
    """bf16 x against fp32 weights: the product in fp32 (JAX promotes),
    rounded once to bf16."""
    jargs, targs = _arrays(6, [(8, 32), (16, 32), (16,)], "float32")
    jy = jfd.fused_dense(jargs[0].astype(jnp.bfloat16), *jargs[1:])
    ty = tfd.fused_dense(targs[0].to(torch.bfloat16), *targs[1:])
    assert ty.dtype == torch.bfloat16
    _close(ty, jy, "bfloat16")


def _module_params(module, key, x):
    return module.init(jax.random.PRNGKey(key), x)["params"]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("bias", [True, False])
def test_fused_dense_module_matches_flax(bias, dtype):
    jx, tx = _arrays(7, [(3, 5, 48)], dtype)
    jm = jfd.FusedDense(48, 24, bias=bias)
    jp = _module_params(jm, 0, jx[0])
    tm = tfd.FusedDense(48, 24, bias=bias, device="cpu")
    tm.load_state_dict(params_from_jax(jax.tree_util.tree_map(
        np.asarray, jp)))
    tm = tm.to(getattr(torch, dtype))
    jp = jax.tree_util.tree_map(lambda a: a.astype(getattr(jnp, dtype)), jp)
    dy = np.random.default_rng(8).standard_normal((3, 5, 24)).astype(
        np.float32)

    def jloss(p, x):
        y = jm.apply({"params": p}, x)
        return jnp.sum(y.astype(jnp.float32) * jnp.asarray(dy)), y
    (_, jy), (jg, jdx) = jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True)(jp, jx[0])
    x = tx[0].clone().requires_grad_(True)
    ty = tm(x)
    (ty.float() * torch.from_numpy(dy)).sum().backward()
    _close(ty, jy, dtype)
    _close(x.grad, jdx, dtype)
    for name, p in tm.named_parameters():
        _close(p.grad, jg[name], dtype)
    assert (tm.bias is None) == (not bias)


@pytest.mark.parametrize("dtype", DTYPES)
def test_fused_dense_gelu_dense_module_matches_flax(dtype):
    jx, tx = _arrays(9, [(4, 40)], dtype)
    jm = jfd.FusedDenseGeluDense(40, 96, 24)
    jp = _module_params(jm, 1, jx[0])
    tm = tfd.FusedDenseGeluDense(40, 96, 24, device="cpu")
    assert {k: tuple(v.shape) for k, v in tm.state_dict().items()} == {
        k: v.shape for k, v in jp.items()}
    tm.load_state_dict(params_from_jax(jax.tree_util.tree_map(
        np.asarray, jp)))
    tm = tm.to(getattr(torch, dtype))
    jp = jax.tree_util.tree_map(lambda a: a.astype(getattr(jnp, dtype)), jp)
    dy = np.random.default_rng(10).standard_normal((4, 24)).astype(
        np.float32)

    def jloss(p, x):
        y = jm.apply({"params": p}, x)
        return jnp.sum(y.astype(jnp.float32) * jnp.asarray(dy)), y
    (_, jy), (jg, jdx) = jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True)(jp, jx[0])
    x = tx[0].clone().requires_grad_(True)
    ty = tm(x)
    (ty.float() * torch.from_numpy(dy)).sum().backward()
    _close(ty, jy, dtype)
    _close(x.grad, jdx, dtype)
    for name, p in tm.named_parameters():
        _close(p.grad, jg[name], dtype)


def test_modules_init_and_refusals():
    """The port's own init: flax's shapes and names, uniform within
    1/sqrt(fan_in), reproducible from the generator; bias=False raises in
    FusedDenseGeluDense as in the reference."""
    g = torch.Generator().manual_seed(0)
    m = tfd.FusedDense(64, 8, generator=g, device="cpu")
    assert m.weight.shape == (8, 64) and m.bias.shape == (8,)
    assert float(m.weight.detach().abs().max()) <= 1 / 8
    again = tfd.FusedDense(64, 8, generator=torch.Generator().manual_seed(0),
                           device="cpu")
    assert torch.equal(m.weight, again.weight)
    gd = tfd.FusedDenseGeluDense(16, 64, 4, device="cpu")
    assert float(gd.weight2.detach().abs().max()) <= 1 / 8
    with pytest.raises(RuntimeError, match="bias=True"):
        tfd.FusedDenseGeluDense(4, 8, 4, bias=False, device="cpu")
    with pytest.raises(RuntimeError, match="bias=True"):
        jfd.FusedDenseGeluDense(4, 8, 4, bias=False).init(
            jax.random.PRNGKey(0), jnp.ones((1, 4)))
    mm = tmlp.MLP([32, 16, 4], device="cpu")
    assert sorted(n for n, _ in mm.named_parameters()) == [
        "bias_0", "bias_1", "weight_0", "weight_1"]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("bias", [True, False])
@pytest.mark.parametrize("activation", ["none", "relu", "sigmoid"])
def test_mlp_matches_jax(activation, bias, dtype):
    sizes = [48, 64, 32, 8]
    shapes = [(16, 48)] + [(sizes[i + 1], sizes[i]) for i in range(3)]
    shapes += [(sizes[i + 1],) for i in range(3)] if bias else []
    jargs, targs = _arrays(11, shapes, dtype, scale=0.3)
    dy = np.random.default_rng(12).standard_normal((16, 8)).astype(
        np.float32)

    def split(args):
        return args[0], list(args[1:4]), (list(args[4:7]) if bias else None)

    def jfn(*a):
        x, ws, bs = split(a)
        return jmlp.mlp(x, ws, bs, activation)

    def tfn(*a):
        x, ws, bs = split(a)
        return tmlp.mlp(x, ws, bs, activation)
    _check_fn(jfn, tfn, jargs, targs, dy, dtype)


@pytest.mark.parametrize("activation", ["none", "relu", "sigmoid"])
def test_mlp_module_matches_flax(activation):
    sizes = [24, 32, 16]
    jx, tx = _arrays(13, [(8, 24)], "float32")
    jm = jmlp.MLP(sizes, activation=activation)
    jp = _module_params(jm, 2, jx[0])
    tm = tmlp.MLP(sizes, activation=activation, device="cpu")
    tm.load_state_dict(params_from_jax(jax.tree_util.tree_map(
        np.asarray, jp)))
    jy = jm.apply({"params": jp}, jx[0])
    _close(tm(tx[0]), jy, "float32")


def test_mlp_refuses_an_unknown_activation():
    x = torch.ones(2, 4)
    with pytest.raises(TypeError, match="relu or none or sigmoid"):
        tmlp.mlp(x, [torch.ones(3, 4)], activation="gelu")
    with pytest.raises(TypeError, match="relu or none or sigmoid"):
        tmlp.MLP([4, 3], activation="tanh", device="cpu")(x)
    assert isinstance(jmlp.MLP, type) and issubclass(jmlp.MLP, nn.Module)
