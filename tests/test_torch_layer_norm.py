"""apex_tpu_torch.ops.layer_norm against the JAX package's layer_norm.

The same numpy-seeded inputs go through JAX's Pallas LayerNorm forward
and backward in interpret mode (as the JAX tests run them on the CPU)
and through the port on the CPU (its plain PyTorch versions, through
the autograd Function for gradients). The CUDA kernels are held against
the plain versions on the card by ``tests/test_torch_cuda.py`` and
``chip_smoke.py``.

Tolerances: fp32 atol/rtol 1e-5 on y and the statistics; bf16 input
2e-2 on y (one bf16 rounding of values of order 1), statistics fp32.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.normalization import FusedLayerNorm as JaxFusedLayerNorm
from apex_tpu.ops.layer_norm import _layer_norm_fwd_impl, _ln_bwd_pallas
from apex_tpu.ops.layer_norm import layer_norm as jax_layer_norm
from apex_tpu_torch.normalization import (
    FusedLayerNorm,
    fused_layer_norm,
    fused_layer_norm_affine,
)
from apex_tpu_torch.ops.layer_norm import (
    layer_norm,
    layer_norm_bwd,
    layer_norm_fwd,
    layer_norm_reference,
)


def _case(rows=24, hidden=256, seed=0):
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(rows, hidden)) * 3 + 1).astype(np.float32)
    w = rng.normal(size=(hidden,)).astype(np.float32)
    b = rng.normal(size=(hidden,)).astype(np.float32)
    return x, w, b


@pytest.mark.parametrize("rows,hidden", [(24, 256), (64, 1024)])
@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5),
                                       ("bfloat16", 2e-2)])
def test_layer_norm_matches_jax_interpret(dtype, tol, rows, hidden):
    x, w, b = _case(rows, hidden)
    jy, jmu, jrstd = _layer_norm_fwd_impl(
        jnp.asarray(x, getattr(jnp, dtype)), jnp.asarray(w),
        jnp.asarray(b), 1, 1e-5, True)
    y, mu, rstd = layer_norm_fwd(
        torch.from_numpy(x).to(getattr(torch, dtype)),
        torch.from_numpy(w), torch.from_numpy(b), eps=1e-5)
    assert y.dtype == getattr(torch, dtype)
    assert mu.dtype == rstd.dtype == torch.float32
    assert tuple(mu.shape) == tuple(rstd.shape) == (x.shape[0], 1)
    np.testing.assert_allclose(y.float().numpy(),
                               np.asarray(jy.astype(jnp.float32)),
                               rtol=tol, atol=tol)
    np.testing.assert_allclose(mu.numpy(), np.asarray(jmu),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(rstd.numpy(), np.asarray(jrstd),
                               rtol=1e-5, atol=1e-5)


def test_layer_norm_public_entry_matches_jax_3d():
    """The public entry over a [b, s, h] input (normalized over the
    last dim), as the decode model calls it."""
    x, w, b = _case(rows=12, hidden=128, seed=1)
    x3 = x.reshape(3, 4, 128)
    want = np.asarray(jax_layer_norm(jnp.asarray(x3), jnp.asarray(w),
                                     jnp.asarray(b), 1, 1e-5, False, True))
    got = layer_norm(torch.from_numpy(x3), torch.from_numpy(w),
                     torch.from_numpy(b), eps=1e-5)
    assert tuple(got.shape) == x3.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_layer_norm_centred_variance():
    """A large common offset: the centred two-pass variance keeps the
    statistics exact where E[x^2] - E[x]^2 would cancel."""
    x = np.full((2, 256), 1e4, np.float32)
    x[:, ::2] += 1.0
    y, mu, rstd = layer_norm_reference(
        torch.from_numpy(x), torch.ones(256), torch.zeros(256), 1e-5)
    np.testing.assert_allclose(rstd.numpy(), 1 / np.sqrt(0.25 + 1e-5),
                               rtol=1e-5)
    np.testing.assert_allclose(np.abs(y.numpy()), 1.0, rtol=1e-4)


def test_layer_norm_cpu_keeps_autograd():
    """On the CPU the plain version differentiates as usual."""
    x, w, b = (torch.from_numpy(a) for a in _case(rows=3, hidden=32))
    x.requires_grad_(True)
    layer_norm(x, w, b).sum().backward()
    assert x.grad is not None and torch.isfinite(x.grad).all()



# ---------------------------------------------------------------------------
# backward: dx in dy's dtype, dgamma/dbeta fp32 column sums. Tolerances:
# fp32 atol/rtol 1e-5 on dx, 1e-4 on the column sums (summation order
# over the rows); bf16 dy 2e-2 on dx (one bf16 rounding), 1e-3 on sums
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("rows,hidden", [(24, 256), (64, 1024)])
@pytest.mark.parametrize("x_dtype,dy_dtype,tol,sum_tol", [
    ("float32", "float32", 1e-5, 1e-4),
    ("float32", "bfloat16", 2e-2, 1e-3),
    ("bfloat16", "bfloat16", 2e-2, 1e-3)])
def test_layer_norm_bwd_matches_jax_interpret(rows, hidden, x_dtype,
                                              dy_dtype, tol, sum_tol):
    x, w, b = _case(rows, hidden, seed=2)
    dy = np.random.default_rng(3).normal(size=x.shape).astype(np.float32)
    jx = jnp.asarray(x, getattr(jnp, x_dtype))
    _, jmu, jrstd = _layer_norm_fwd_impl(jx, jnp.asarray(w), jnp.asarray(b),
                                         1, 1e-5, True)
    jdx, jdw, jdb = _ln_bwd_pallas(jnp.asarray(dy, getattr(jnp, dy_dtype)),
                                   jx, jmu, jrstd, jnp.asarray(w), True,
                                   False, True)
    tx = torch.from_numpy(x).to(getattr(torch, x_dtype))
    _, mu, rstd = layer_norm_fwd(tx, torch.from_numpy(w),
                                 torch.from_numpy(b), eps=1e-5)
    dx, dw, db = layer_norm_bwd(
        torch.from_numpy(dy).to(getattr(torch, dy_dtype)), tx, mu, rstd,
        torch.from_numpy(w))
    assert dx.dtype == getattr(torch, dy_dtype)
    assert dw.dtype == db.dtype == torch.float32
    np.testing.assert_allclose(dx.float().numpy(),
                               np.asarray(jdx.astype(jnp.float32)),
                               rtol=tol, atol=tol)
    for got, want in ((dw, jdw), (db, jdb)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=sum_tol, atol=sum_tol)


def test_layer_norm_autograd_matches_jax_vjp_3d():
    """The autograd Function over a [b, s, h] input against jax.vjp of
    the JAX layer_norm: dx, dweight, dbias, fp32 atol/rtol 1e-5 (1e-4
    on the column sums)."""
    x, w, b = _case(rows=12, hidden=128, seed=4)
    x3 = x.reshape(3, 4, 128)
    dy = np.random.default_rng(5).normal(size=x3.shape).astype(np.float32)
    y, vjp = jax.vjp(lambda a, c, d: jax_layer_norm(a, c, d, 1, 1e-5,
                                                    False, True),
                     jnp.asarray(x3), jnp.asarray(w), jnp.asarray(b))
    jdx, jdw, jdb = vjp(jnp.asarray(dy))
    tx, tw, tb = (torch.from_numpy(a).requires_grad_(True)
                  for a in (x3, w, b))
    out = layer_norm(tx, tw, tb, eps=1e-5)
    out.backward(torch.from_numpy(dy))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(y),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jdx),
                               rtol=1e-5, atol=1e-5)
    for got, want in ((tw.grad, jdw), (tb.grad, jdb)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("affine", [True, False])
def test_fused_layer_norm_module_matches_jax(affine):
    """The module and the functional API against the JAX module over a
    2-dim normalized shape; gradients through the Function."""
    x = np.random.default_rng(6).normal(size=(4, 8, 16)).astype(np.float32)
    jmod = JaxFusedLayerNorm((8, 16), elementwise_affine=affine)
    jvars = jmod.init(jax.random.PRNGKey(0), jnp.asarray(x))
    want = np.asarray(jmod.apply(jvars, jnp.asarray(x)))
    mod = FusedLayerNorm((8, 16), elementwise_affine=affine, device="cpu")
    tx = torch.from_numpy(x).requires_grad_(True)
    got = mod(tx)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-5,
                               atol=1e-5)
    got.sum().backward()
    assert torch.isfinite(tx.grad).all()
    if affine:
        assert mod.weight.grad is not None and mod.bias.grad is not None
        again = fused_layer_norm_affine(tx, mod.weight, mod.bias, (8, 16))
    else:
        again = fused_layer_norm(tx, (8, 16))
    torch.testing.assert_close(again, got)


def test_layer_norm_memory_efficient_is_refused():
    """``memory_efficient`` once raised here; it is ported now. The name
    stays: the test holds its output and gradients to JAX's
    ``memory_efficient`` vjp (atol/rtol 1e-5), and a mismatched
    ``normalized_shape`` is still refused."""
    x, w, b = _case(rows=6, hidden=16)
    g = np.random.default_rng(5).normal(size=x.shape).astype(np.float32)
    jy, vjp = jax.vjp(lambda a, c, d: jax_layer_norm(a, c, d, 1, 1e-5, True,
                                                     True),
                      jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))
    jgrads = vjp(jnp.asarray(g))
    tx, tw, tb = (torch.from_numpy(a).requires_grad_(True) for a in (x, w, b))
    y = layer_norm(tx, tw, tb, memory_efficient=True)
    y.backward(torch.from_numpy(g))
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(jy),
                               atol=1e-5, rtol=1e-5)
    for got, want in zip((tx.grad, tw.grad, tb.grad), jgrads):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                                   rtol=1e-5)
    with pytest.raises(ValueError, match="normalized_shape"):
        fused_layer_norm(torch.from_numpy(x), (8,))
