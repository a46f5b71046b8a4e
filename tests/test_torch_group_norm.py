"""``contrib.group_norm`` of the port against the JAX package's, on the
CPU.

Numpy-seeded NHWC inputs (fp32, bf16, fp16) through ``group_norm_nhwc``
with and without the affine and swish, the three ``cuda_group_norm_*``
aliases, and the ``GroupNorm`` module with flax-initialised parameters
carried across (``params_from_jax`` + ``load_state_dict``): the output
and the gradients of the input, weight and bias; the refusals.

Tolerances: fp32 outputs and gradients within 1e-6 of each result's
largest entry (fp32 statistics over up to 2048 elements a group, summed
in orders the frameworks choose); a bf16 or fp16 output within one
rounding to its dtype of the largest entry (2^-8, 2^-11: the fp32 value
before the cast may fall either side of a rounding boundary).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.contrib import group_norm as jgn
from apex_tpu_torch.contrib import group_norm as tgn
from apex_tpu_torch.convert import params_from_jax

TOL = {"float32": 1e-6, "bfloat16": 2.0 ** -8, "float16": 2.0 ** -11}
SHAPE = (2, 8, 8, 32)


def _case(seed, dtype, shape=SHAPE):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal(shape) * 2 + 0.5).astype(np.float32)
    w = (1 + 0.3 * rng.standard_normal(shape[-1])).astype(np.float32)
    b = (0.2 * rng.standard_normal(shape[-1])).astype(np.float32)
    return x, w, b


def _close(got, want, tol):
    want = np.asarray(jnp.asarray(want).astype(jnp.float32))
    got = got.detach().float().numpy()
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= tol * np.abs(want).max(), (
        np.abs(got - want).max(), np.abs(want).max())


@pytest.mark.parametrize("act", [None, "swish", "silu"])
@pytest.mark.parametrize("affine", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
def test_forward_matches(dtype, affine, act):
    x, w, b = _case(0, dtype)
    jx = jnp.asarray(x).astype(getattr(jnp, dtype))
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    jw = jb = tw = tb = None
    if affine:
        jw, jb = jnp.asarray(w), jnp.asarray(b)
        tw, tb = torch.from_numpy(w), torch.from_numpy(b)
    want = jgn.group_norm_nhwc(jx, 8, jw, jb, 1e-5, act)
    got = tgn.group_norm_nhwc(tx, 8, tw, tb, 1e-5, act)
    assert got.dtype == tx.dtype
    _close(got, want, TOL[dtype])


@pytest.mark.parametrize("act", [None, "swish"])
def test_gradients_match(act):
    x, w, b = _case(1, "float32")
    dy = np.random.default_rng(2).standard_normal(SHAPE).astype(np.float32)
    jg = jax.grad(lambda x, w, b: jnp.sum(
        jgn.group_norm_nhwc(x, 4, w, b, 1e-5, act) * dy), argnums=(0, 1, 2))(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))
    tt = [torch.from_numpy(a).requires_grad_() for a in (x, w, b)]
    out = tgn.group_norm_nhwc(tt[0], 4, tt[1], tt[2], 1e-5, act)
    tg = torch.autograd.grad((out * torch.from_numpy(dy)).sum(), tt)
    for g, j in zip(tg, jg):
        _close(g, j, 1e-6)


@pytest.mark.parametrize("name", ["cuda_group_norm_nhwc_one_pass",
                                  "cuda_group_norm_nhwc_two_pass",
                                  "cuda_group_norm_v2_nhwc"])
def test_kernel_variant_aliases(name):
    x, w, b = _case(3, "float32")
    want = getattr(jgn, name)(jnp.asarray(x), 16, jnp.asarray(w),
                              jnp.asarray(b), 1e-5, "swish")
    got = getattr(tgn, name)(torch.from_numpy(x), 16, torch.from_numpy(w),
                             torch.from_numpy(b), 1e-5, "swish")
    _close(got, want, 1e-6)


def test_module_with_flax_parameters():
    x, _, _ = _case(4, "float32")
    jmod = jgn.GroupNorm(num_groups=8, num_channels=32, act="swish")
    variables = jmod.init(jax.random.PRNGKey(0), jnp.asarray(x))
    # perturb the flax initialisers' ones / zeros so the load is visible
    params = jax.tree_util.tree_map(lambda a: a + 0.25, variables["params"])
    want = jmod.apply({"params": params}, jnp.asarray(x))
    tmod = tgn.GroupNorm(8, 32, act="swish", device="cpu")
    tmod.load_state_dict(params_from_jax(
        jax.tree_util.tree_map(np.asarray, params)))
    _close(tmod(torch.from_numpy(x)), want, 1e-6)
    assert tgn.GroupNorm(8, 32, affine=False, device="cpu").weight is None


def test_refusals_match():
    x = np.zeros((1, 2, 2, 6), np.float32)
    for args in ((4, None, None, 1e-5, None), (3, None, None, 1e-5, "gelu")):
        with pytest.raises(ValueError) as j:
            jgn.group_norm_nhwc(jnp.asarray(x), *args)
        with pytest.raises(ValueError) as t:
            tgn.group_norm_nhwc(torch.from_numpy(x), *args)
        assert str(t.value) == str(j.value)
    with pytest.raises(ValueError) as j:
        jgn.GroupNorm(2, 8).init(jax.random.PRNGKey(0), jnp.asarray(x))
    with pytest.raises(ValueError) as t:
        tgn.GroupNorm(2, 8, device="cpu")(torch.from_numpy(x))
    assert str(t.value) == str(j.value)
