"""The port's flat utility sweeps against the JAX package's, on the CPU:
``multi_tensor_scale_flat`` (with and without per-row flags, across
dtypes, at lengths that are whole rows, whole chunks or neither, with
non-finite values planted in known rows), ``multi_tensor_axpby_flat``,
the zero padding helper, and ``clip_grad_norm_flat`` against the JAX
package's and against the port's own tree version.

The same numpy-seeded buffers go through the JAX package, with its
Pallas kernel in interpret mode (``use_kernel=True, interpret=True``)
and on its XLA route, and through the port on the CPU (its plain
version). The CUDA kernels are held against the plain versions on the
card by ``tests/test_torch_cuda.py`` and ``chip_smoke.py``.

Tolerances: the scale is one fp32 multiply and one cast on both sides,
so its output, its flags and its padding agree bit for bit; axpby's two
products and a sum may be contracted into a fused multiply-add by XLA,
so fp32 outputs rtol 1e-6 (a few ulps), bf16 outputs one bf16 rounding
(rtol 8e-3), the flags exactly; the clip's norm is a sum of squares in
another order, rtol 1e-6, and the clipped buffer rtol 1e-6 atol 1e-9.
"""
import importlib
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.contrib.clip_grad import clip_grad_norm_flat as jax_clip_flat
from apex_tpu_torch.contrib.clip_grad import (
    clip_grad_norm_,
    clip_grad_norm_flat,
)
from apex_tpu_torch.multi_tensor_apply.packing import ROW, PackSpec
from apex_tpu_torch.ops.packed_optimizer import (
    _pad_to_rows,
    multi_tensor_axpby_flat,
    multi_tensor_scale_flat,
)

JP = importlib.import_module("apex_tpu.ops.packed_optimizer")

ROUTES = {"interpret": dict(use_kernel=True, interpret=True),
          "xla": dict(use_kernel=False)}
#: whole rows, one chunk, ragged below a chunk, ragged past two chunks, 1
LENGTHS = [3 * ROW, 65536, 5000, 2 * 65536 + 1000 + 3, 1]
DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}


def _pair(a: np.ndarray, dt: str):
    jd, td = DTYPES[dt]
    return jnp.asarray(a).astype(jd), torch.from_numpy(a).to(td)


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _planted(n: int, seed: int) -> np.ndarray:
    """Normal values with an inf in row 0, a nan in the middle row and a
    value that overflows when scaled by 4 in the last row."""
    a = np.random.default_rng(seed).normal(size=n).astype(np.float32)
    rows = -(-n // ROW)
    a[0] = np.inf
    if rows > 2:
        a[(rows // 2) * ROW + 7] = np.nan
        a[n - 1] = 3e38
    return a


@pytest.mark.parametrize("route", list(ROUTES))
@pytest.mark.parametrize("n", LENGTHS)
@pytest.mark.parametrize("x_dt,out_dt", [("bf16", "f32"), ("f32", "f32"),
                                         ("f32", "bf16"), ("bf16", "bf16")])
def test_scale_flat_with_row_flags_matches_jax(x_dt, out_dt, n, route):
    a = np.random.default_rng(n).normal(size=n).astype(np.float32)
    jx, tx = _pair(a, x_dt)
    jout, jfound, jrows = JP.multi_tensor_scale_flat(
        jx, 0.25, DTYPES[out_dt][0], per_row_flags=True, **ROUTES[route])
    tout, tfound, trows = multi_tensor_scale_flat(
        tx, torch.tensor(0.25), DTYPES[out_dt][1], per_row_flags=True)
    assert tout.dtype == DTYPES[out_dt][1] and tout.shape == (n,)
    np.testing.assert_array_equal(_np(tout), _np(jout))
    assert bool(tfound) == bool(jfound) is False
    np.testing.assert_array_equal(trows.numpy(), np.asarray(jrows))
    assert trows.shape == (-(-n // ROW),)


@pytest.mark.parametrize("route", list(ROUTES))
@pytest.mark.parametrize("n", [8 * ROW, 2 * 65536 + 1000 + 3])
@pytest.mark.parametrize("x_dt", ["f32", "bf16"])
def test_scale_flat_row_flags_name_the_planted_rows(x_dt, n, route):
    """inf, nan and an overflow of the product in three known rows: the
    flags name exactly those rows, and the outputs (nan included) agree
    bit for bit."""
    a = _planted(n, 1)
    jx, tx = _pair(a, x_dt)
    jout, jfound, jrows = JP.multi_tensor_scale_flat(
        jx, 4.0, jnp.float32, per_row_flags=True, **ROUTES[route])
    tout, tfound, trows = multi_tensor_scale_flat(tx, 4.0, torch.float32,
                                                  per_row_flags=True)
    rows = -(-n // ROW)
    assert torch.nonzero(trows).flatten().tolist() == [0, rows // 2,
                                                       rows - 1]
    np.testing.assert_array_equal(trows.numpy(), np.asarray(jrows))
    assert bool(tfound) and bool(jfound)
    np.testing.assert_array_equal(_np(tout), _np(jout))


@pytest.mark.parametrize("route", list(ROUTES))
@pytest.mark.parametrize("n", LENGTHS)
@pytest.mark.parametrize("planted", [False, True])
def test_scale_flat_found_inf_matches_jax(n, planted, route):
    a = (_planted(n, 2) if planted else
         np.random.default_rng(2).normal(size=n).astype(np.float32))
    jx, tx = _pair(a, "f32")
    jout, jfound = JP.multi_tensor_scale_flat(jx, 4.0, **ROUTES[route])
    tout, tfound = multi_tensor_scale_flat(tx, 4.0)
    assert tfound.dtype == torch.bool and tfound.dim() == 0
    assert bool(tfound) == bool(jfound) == planted
    np.testing.assert_array_equal(_np(tout), _np(jout))


@pytest.mark.parametrize("n", LENGTHS)
def test_pad_to_rows_matches_jax(n):
    a = np.random.default_rng(3).normal(size=n).astype(np.float32)
    for chunk in (None, 65536, 5000):
        jp, jn = JP._pad_to_rows(jnp.asarray(a), chunk)
        tp, tn = _pad_to_rows(torch.from_numpy(a), chunk)
        assert tn == jn == n
        np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))


@pytest.mark.parametrize("route", list(ROUTES))
@pytest.mark.parametrize("n", [3 * ROW, 5000, 2 * 65536 + 1000 + 3])
@pytest.mark.parametrize("x_dt,y_dt,out_dt", [
    ("f32", "f32", None), ("bf16", "bf16", None), ("bf16", "f32", "f32"),
    ("f32", "bf16", "bf16")])
def test_axpby_flat_matches_jax(x_dt, y_dt, out_dt, n, route):
    rng = np.random.default_rng(n + 4)
    x = rng.normal(size=n).astype(np.float32)
    y = rng.normal(size=n).astype(np.float32)
    (jx, tx), (jy, ty) = _pair(x, x_dt), _pair(y, y_dt)
    jdt = None if out_dt is None else DTYPES[out_dt][0]
    tdt = None if out_dt is None else DTYPES[out_dt][1]
    jout, jfound = JP.multi_tensor_axpby_flat(0.5, -1.25, jx, jy, jdt,
                                              **ROUTES[route])
    tout, tfound = multi_tensor_axpby_flat(torch.tensor(0.5), -1.25, tx,
                                           ty, tdt)
    assert tout.dtype == (tdt or tx.dtype)
    tol = (dict(rtol=8e-3, atol=1e-6) if tout.dtype == torch.bfloat16
           else dict(rtol=1e-6, atol=1e-7))
    np.testing.assert_allclose(_np(tout), _np(jout), **tol)
    assert not bool(tfound) and not bool(jfound)
    y[n // 3] = np.inf
    (jy, ty) = _pair(y, y_dt)
    _, jfound = JP.multi_tensor_axpby_flat(0.5, -1.25, jx, jy, jdt,
                                           **ROUTES[route])
    _, tfound = multi_tensor_axpby_flat(0.5, -1.25, tx, ty, tdt)
    assert bool(tfound) and bool(jfound)


def test_axpby_flat_refuses_unequal_buffers():
    with pytest.raises(ValueError, match="must match"):
        multi_tensor_axpby_flat(1.0, 1.0, torch.zeros(4), torch.zeros(5))


def _grad_tree(seed: int, scale: float):
    rng = np.random.default_rng(seed)
    return {"w": torch.from_numpy(rng.normal(size=(96, 64)) * scale).float(),
            "b": torch.from_numpy(rng.normal(size=70) * scale).float(),
            "layers": {"k": torch.from_numpy(
                rng.normal(size=(3, 40, 33)) * scale).float()}}


@pytest.mark.parametrize("route", list(ROUTES))
@pytest.mark.parametrize("scale,max_norm", [(1.0, 1.0), (1e-3, 1.0),
                                            (1.0, 1e9)])
def test_clip_grad_norm_flat_matches_jax_and_the_tree(scale, max_norm,
                                                      route):
    """Clipping (norm above max_norm), no clipping (below), on a packed
    buffer: the same norm and buffer as the JAX package's, and as the
    port's tree version on the tree itself."""
    tree = _grad_tree(5, scale)
    spec = PackSpec(tree)
    flat = spec.pack(tree)
    jclipped, jnorm = jax_clip_flat(jnp.asarray(flat.numpy()), max_norm,
                                    **ROUTES[route])
    tclipped, tnorm = clip_grad_norm_flat(flat, max_norm)
    np.testing.assert_allclose(float(tnorm), float(jnorm), rtol=1e-6)
    np.testing.assert_allclose(tclipped.numpy(), np.asarray(jclipped),
                               rtol=1e-6, atol=1e-9)
    clipped_tree, norm = clip_grad_norm_(tree, max_norm)
    np.testing.assert_allclose(float(tnorm), float(norm), rtol=1e-6)
    np.testing.assert_allclose(tclipped.numpy(),
                               spec.pack(clipped_tree).numpy(), rtol=1e-6,
                               atol=1e-9)
    coef = min(max_norm / (float(norm) + 1e-6), 1.0)
    assert math.isclose(float(tclipped.norm()), float(norm) * coef,
                        rel_tol=1e-5)


@pytest.mark.parametrize("norm_type", [2.0, math.inf, 1.0, 3.0])
def test_clip_grad_norm_tree_matches_jax(norm_type):
    from apex_tpu.contrib.clip_grad import clip_grad_norm_ as jax_clip

    tree = _grad_tree(6, 0.1)
    jtree = {k: (jnp.asarray(v.numpy()) if not isinstance(v, dict) else
                 {kk: jnp.asarray(vv.numpy()) for kk, vv in v.items()})
             for k, v in tree.items()}
    jclipped, jnorm = jax_clip(jtree, 0.5, norm_type=norm_type)
    tclipped, tnorm = clip_grad_norm_(tree, 0.5, norm_type=norm_type)
    np.testing.assert_allclose(float(tnorm), float(jnorm), rtol=1e-5)
    for k in ("w", "b"):
        np.testing.assert_allclose(tclipped[k].numpy(),
                                   np.asarray(jclipped[k]), rtol=1e-5,
                                   atol=1e-9)
    with pytest.raises(NotImplementedError, match="host"):
        clip_grad_norm_(tree, 0.5, error_if_nonfinite=True)
