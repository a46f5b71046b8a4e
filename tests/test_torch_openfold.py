"""apex_tpu_torch.contrib.openfold against the JAX package's.

The same numpy-seeded operands go through the JAX package's
``attention_core`` (its flash kernel in Pallas interpret mode, additive
bias and key-padding mask) and ``layer_norm_small_shape``, and through the
port on the CPU (the kernels' plain versions), forward and gradients, the
pair bias's included. Mirrors ``tests/test_fmha_openfold.py``'s openfold
part.

Tolerances: fp32 1e-5 (summation order; a bias gradient summed over a
broadcast batch 1e-4, as the sum of its elements' errors); bf16 2e-2 and
fp16 5e-3 (one rounding of values of order 1 taken at other points); the
eager reference ``attention_reference`` 2e-5 in fp32, as the JAX tests
hold it.
"""
import importlib
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.contrib.openfold import mha as jmha
from apex_tpu.contrib.openfold import layer_norm_small_shape as j_ln
from apex_tpu_torch.contrib import openfold as T
from apex_tpu_torch.contrib.openfold import mha as tmha

TOL = {"float32": 1e-5, "bfloat16": 2e-2, "float16": 5e-3}
DTYPES = list(TOL)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _operands(shape, seed, n_bias=None, bias_scale=0.5):
    rng = np.random.default_rng(seed)
    q, k, v, g = (rng.normal(size=shape).astype(np.float32)
                  for _ in range(4))
    bias = None
    if n_bias is not None:
        bias = (rng.normal(size=n_bias) * bias_scale).astype(np.float32)
    return q, k, v, g, bias


def _grads(q, k, v, g, dtype, mask=None, bias=None, bias_dtype="float32"):
    """(jax, port) ``(o, dq, dk, dv[, dbias])`` of ``attention_core``."""
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    jx = [jnp.asarray(a, jdt) for a in (q, k, v)]
    jm = None if mask is None else jnp.asarray(mask)
    args = list(jx) + ([] if bias is None else
                       [jnp.asarray(bias, getattr(jnp, bias_dtype))])

    def jf(*a):
        return jmha.attention_core(a[0], a[1], a[2], mask=jm,
                                   bias=a[3] if bias is not None else None)
    jo, vjp = jax.vjp(jf, *args)
    jg = vjp(jnp.asarray(g, jdt))
    tx = [torch.from_numpy(a).to(tdt).requires_grad_(True) for a in (q, k, v)]
    if bias is not None:
        tx.append(torch.from_numpy(bias).to(getattr(torch, bias_dtype))
                  .requires_grad_(True))
    tm = None if mask is None else torch.from_numpy(mask)
    to = tmha.attention_core(tx[0], tx[1], tx[2], mask=tm,
                             bias=tx[3] if bias is not None else None)
    to.backward(torch.from_numpy(g).to(tdt))
    return (jo, *jg), (to, *(t.grad for t in tx))


def _check(j, t, dtype, dbias_tol=None):
    for i, (want, got) in enumerate(zip(j, t)):
        tol = TOL[dtype]
        if i == 4 and dbias_tol is not None:
            tol = max(tol, dbias_tol)
        np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype", DTYPES)
def test_attention_bias_matches_jax(dtype):
    """A [1, h, n, n] bias with its gradient summed over the batch."""
    q, k, v, g, bias = _operands((3, 2, 32, 16), 3, (1, 2, 32, 32))
    j, t = _grads(q, k, v, g, dtype, bias=bias)
    _check(j, t, dtype, dbias_tol=1e-4)
    assert t[4].shape == (1, 2, 32, 32)


@pytest.mark.parametrize("dtype", DTYPES)
def test_attention_mask_and_bias_5dim_match_jax(dtype):
    """The AlphaFold calling shape: ``[1, b, h, n, d]`` operands, a
    ``[b, 1, 1, n]`` key mask with a live key in every row, an
    ``[1, h, n, n]`` pair bias."""
    q, k, v, g, bias = _operands((1, 2, 2, 32, 16), 4, (1, 2, 32, 32),
                                 bias_scale=0.3)
    mask = (np.random.default_rng(5).random((2, 1, 1, 32)) < 0.8).astype(
        np.float32)
    mask[..., 0] = 1.0
    j, t = _grads(q, k, v, g, dtype, mask=mask, bias=bias)
    assert tuple(t[0].shape) == (1, 2, 2, 32, 16)
    _check(j, t, dtype, dbias_tol=1e-4)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_attention_general_mask_folds_into_the_bias(dtype):
    """A per-(q, k) {0, 1} mask folds into the bias as (mask - 1) * inf
    beside a learned bias: gradients finite and equal to the JAX
    package's, none into the mask."""
    q, k, v, g, bias = _operands((2, 2, 32, 16), 9, (1, 2, 32, 32))
    mask = (np.random.default_rng(10).random((2, 1, 32, 32)) < 0.8).astype(
        np.float32)
    mask[..., 0] = 1.0
    j, t = _grads(q, k, v, g, dtype, mask=mask, bias=bias)
    _check(j, t, dtype, dbias_tol=1e-4)
    assert all(bool(torch.isfinite(x).all()) for x in t)
    tm = torch.from_numpy(mask).requires_grad_(True)
    tb = torch.from_numpy(bias).requires_grad_(True)
    out = tmha.attention_core(*(torch.from_numpy(a) for a in (q, k, v)),
                              mask=tm, bias=tb)
    out.sum().backward()
    assert tm.grad is None and bool(torch.isfinite(tb.grad).all())


def test_attention_per_key_bias_broadcasts():
    """A ``[1, h, 1, n]`` per-key bias, broadcast over the queries."""
    q, k, v, g, bias = _operands((2, 2, 32, 16), 7, (1, 2, 1, 32))
    j, t = _grads(q, k, v, g, "float32", bias=bias)
    _check(j, t, "float32", dbias_tol=1e-4)


def test_attention_bf16_bias_in_q_dtype():
    """A bias in q's dtype (bf16) runs as it is and its gradient comes
    back in that dtype."""
    q, k, v, g, bias = _operands((2, 2, 32, 16), 11, (1, 2, 32, 32))
    j, t = _grads(q, k, v, g, "bfloat16", bias=bias, bias_dtype="bfloat16")
    assert t[4].dtype == torch.bfloat16
    _check(j, t, "bfloat16")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_triangle_attention_shape_matches_jax(dtype):
    """Triangle attention (starting node): ``[1, n, h, n, d]`` with a
    ``[1, 1, h, n, n]`` bias shared by every row."""
    q, k, v, g, bias = _operands((1, 16, 2, 16, 8), 12, (1, 1, 2, 16, 16))
    j, t = _grads(q, k, v, g, dtype, bias=bias)
    _check(j, t, dtype, dbias_tol=1e-4)


def test_attention_matches_eager_reference():
    """The flash path against the port's eager ``attention_reference``
    (and that against the JAX package's), fp32 2e-5."""
    q, k, v, _, bias = _operands((3, 2, 32, 16), 3, (1, 2, 32, 32))
    mask = np.ones((3, 1, 1, 32), np.float32)
    mask[:, ..., 20:] = 0.0
    tx = [torch.from_numpy(a) for a in (q, k, v)]
    tb, tm = torch.from_numpy(bias), torch.from_numpy(mask)
    out = tmha.attention_core(*tx, mask=tm, bias=tb)
    ref = tmha.attention_reference(*tx, mask=tm, bias=tb)
    jref = jmha.attention_reference(*(jnp.asarray(a) for a in (q, k, v)),
                                    mask=jnp.asarray(mask),
                                    bias=jnp.asarray(bias))
    assert float((out - ref).abs().max()) < 2e-5
    np.testing.assert_allclose(ref.numpy(), np.asarray(jref), rtol=2e-5,
                               atol=2e-5)


def test_attention_5dim_leading_dim_validated():
    q = torch.zeros(2, 2, 16, 16)
    bad_mask = torch.ones(2, 2, 1, 1, 16)
    with pytest.raises(ValueError, match="leading 1 dim"):
        tmha.attention_core(q, q, q, mask=bad_mask)
    with pytest.raises(ValueError, match="leading 1 dim"):
        tmha.attention_reference(q, q, q, mask=bad_mask)
    with pytest.raises(ValueError, match="4- or 5-dim"):
        tmha.attention_core(q[0], q[0], q[0])


def test_fully_masked_key_mask_warns_once_on_the_cpu(monkeypatch):
    """A CPU key mask with a row whose keys are all masked warns (the
    zeros-for-dead-rows edge); a clean mask does not; one warning at
    most."""
    monkeypatch.setattr(tmha, "_warned_fully_masked", False)
    q = torch.randn(2, 2, 16, 16)
    clean = torch.ones(2, 1, 1, 16)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        tmha.attention_core(q, q, q, mask=clean)
    dead = clean.clone()
    dead[1] = 0.0
    with pytest.warns(UserWarning, match="ALL"):
        out = tmha.attention_core(q, q, q, mask=dead)
    assert not bool(out[1].any())
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        tmha.attention_core(q, q, q, mask=dead)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_attention_head_dim_48_padded_route_matches_jax(monkeypatch, dtype):
    """At head dim 48 (no kernel of its own) through the CUDA route's pad
    and slice helpers, the plain versions standing in for the kernels at
    head dim 64: output and every gradient, the pair bias's included,
    against the JAX package's."""
    F = importlib.import_module("apex_tpu_torch.ops.flash_attention")

    seen = []

    def spied(fn):
        def run(q, *a):
            seen.append(q.shape[-1])
            return fn(q, *a)
        return run
    monkeypatch.setattr(F, "_route", lambda *t: True)
    monkeypatch.setattr(F, "_launch_fwd", spied(F._plain_fwd))
    monkeypatch.setattr(F, "_launch_bwd", spied(F._plain_bwd))
    q, k, v, g, bias = _operands((2, 2, 32, 48), 8, (1, 2, 32, 32))
    j, t = _grads(q, k, v, g, dtype, bias=bias)
    assert seen == [64, 64]
    _check(j, t, dtype, dbias_tol=1e-4)
    assert t[0].shape == (2, 2, 32, 48)


def test_can_use_fused_attention_and_toggles():
    assert T.can_use_fused_attention((2, 2, 32, 16), True, True, "cpu")
    assert T.can_use_fused_attention((2, 2, 32, 32), device="cuda")
    # another head dim up to 256 runs zero-padded; past it, no flash
    assert T.can_use_fused_attention((2, 2, 32, 16), device="cuda")
    assert not T.can_use_fused_attention((2, 2, 32, 320), device="cuda")
    assert T.AttnTri is T.attention_core
    before = tmha.is_enabled()
    try:
        tmha.enable()
        assert tmha.is_enabled() is True
        tmha.disable()
        assert tmha.is_enabled() is False
    finally:
        tmha._enabled = before


@pytest.mark.parametrize("dtype", DTYPES)
def test_layer_norm_small_shape_matches_jax(dtype):
    """Forward and the input's and parameters' gradients over one and two
    trailing dims."""
    rng = np.random.default_rng(6)
    for shape, ns in (((4, 8, 32), (32,)), ((3, 4, 8, 16), (8, 16))):
        x, g = (rng.normal(size=shape).astype(np.float32) for _ in range(2))
        w = (rng.normal(size=ns) + 1.0).astype(np.float32)
        b = rng.normal(size=ns).astype(np.float32)
        jdt = getattr(jnp, dtype)
        jy, vjp = jax.vjp(lambda a, c, e: j_ln(a, ns, c, e),
                          jnp.asarray(x, jdt), jnp.asarray(w),
                          jnp.asarray(b))
        jg = vjp(jnp.asarray(g, jdt))
        tx = [torch.from_numpy(x).to(getattr(torch, dtype)),
              torch.from_numpy(w), torch.from_numpy(b)]
        for t in tx:
            t.requires_grad_(True)
        ty = T.layer_norm_small_shape(tx[0], ns, tx[1], tx[2])
        ty.backward(torch.from_numpy(g).to(ty.dtype))
        assert ty.dtype == tx[0].dtype
        tol = TOL[dtype]
        np.testing.assert_allclose(_np(ty), _np(jy), rtol=tol, atol=tol)
        for want, got in zip(jg, (t.grad for t in tx)):
            # parameter gradients: column sums over the rows
            np.testing.assert_allclose(_np(got), _np(want), rtol=tol,
                                       atol=max(tol, 1e-4))
        y2 = T.LayerNormSmallShapeOptImpl.apply(tx[0], ns, tx[1], tx[2])
        assert torch.equal(y2, ty)


def test_layer_norm_small_shape_validation():
    with pytest.raises(ValueError, match="normalized_shape"):
        T.layer_norm_small_shape(torch.zeros(4, 8), (16,), torch.ones(16),
                                 torch.zeros(16))
