"""``contrib.conv_bias_relu`` of the port against the JAX package's, on
the CPU.

The four functions on numpy-seeded NHWC inputs, HWIO kernels carried
across once with ``convert.conv_kernel_from_jax``, 1x1 and 3x3 kernels
at paddings 0 and 1 and strides 1 and 2, fp32 and bf16: the output and
the gradients of the input, the kernel, the bias (and the mask's
product); the frozen scale and bias get no gradient on either side.

Tolerances: fp32 within 1e-5 of each result's largest entry (a conv's
sum of up to 144 products in orders the libraries choose); bf16 outputs
within 2^-7 of the largest (products summed in fp32, then one bf16
rounding, which may fall either side; the bias add a second rounding).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.contrib import conv_bias_relu as jcbr
from apex_tpu_torch.contrib import conv_bias_relu as tcbr
from apex_tpu_torch.convert import conv_kernel_from_jax

TOL = {"float32": 1e-5, "bfloat16": 2.0 ** -7}
CASES = [(3, 1, 1), (3, 1, 2), (1, 0, 2), (3, 0, 1), (1, 0, 1)]


def _np(x):
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _close(got, want, tol):
    want = _np(want)
    got = got.detach().float().numpy()
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= tol * np.abs(want).max(), (
        np.abs(got - want).max(), np.abs(want).max())


def _arrays(seed, k, cin=8, cout=12, hw=9):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in
            ((2, hw, hw, cin), (k, k, cin, cout), (cout,), (cout,))]


def _pair(arrs, dtype):
    x, w, b, s = arrs
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    j = [jnp.asarray(x).astype(jd), jnp.asarray(w).astype(jd),
         jnp.asarray(b), jnp.asarray(s)]
    t = [torch.from_numpy(x).to(td), conv_kernel_from_jax(w, dtype=td),
         torch.from_numpy(b), torch.from_numpy(s)]
    return j, t


@pytest.mark.parametrize("k,padding,stride", CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("fn", ["ConvBiasReLU", "ConvBias",
                                "ConvFrozenScaleBiasReLU"])
def test_forward_matches(fn, dtype, k, padding, stride):
    (jx, jw, jb, js), (tx, tw, tb, ts) = _pair(_arrays(0, k), dtype)
    if fn == "ConvFrozenScaleBiasReLU":
        want = jcbr.ConvFrozenScaleBiasReLU(jx, jw, js, jb, padding, stride)
        got = tcbr.ConvFrozenScaleBiasReLU(tx, tw, ts, tb, padding, stride)
    else:
        want = getattr(jcbr, fn)(jx, jw, jb, padding, stride)
        got = getattr(tcbr, fn)(tx, tw, tb, padding, stride)
    assert got.dtype == tx.dtype and got.is_contiguous()
    _close(got, want, TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mask_relu_matches(dtype):
    (jx, jw, jb, _), (tx, tw, tb, _) = _pair(_arrays(1, 3), dtype)
    mask = (np.random.default_rng(2).random((2, 9, 9, 1)) > 0.3).astype(
        np.float32)
    want = jcbr.ConvBiasMaskReLU(jx, jw, jb, jnp.asarray(mask), 1, 1)
    got = tcbr.ConvBiasMaskReLU(tx, tw, tb, torch.from_numpy(mask), 1, 1)
    _close(got, want, TOL[dtype])


@pytest.mark.parametrize("k,padding,stride", CASES[:3])
def test_gradients_match(k, padding, stride):
    arrs = _arrays(3, k)
    (jx, jw, jb, js), (tx, tw, tb, ts) = _pair(arrs, "float32")
    out = tcbr.ConvBiasReLU(tx, tw, tb, padding, stride)
    dy = np.random.default_rng(4).standard_normal(out.shape).astype(
        np.float32)
    for fn in ("ConvBiasReLU", "ConvBias"):
        jg = jax.grad(lambda x, w, b: jnp.sum(getattr(jcbr, fn)(
            x, w, b, padding, stride) * dy), argnums=(0, 1, 2))(jx, jw, jb)
        leaves = [a.detach().clone().requires_grad_() for a in (tx, tw, tb)]
        y = getattr(tcbr, fn)(*leaves, padding, stride)
        gx, gw, gb = torch.autograd.grad((y * torch.from_numpy(dy)).sum(),
                                         leaves)
        _close(gx, jg[0], 1e-5)
        _close(gw.permute(2, 3, 1, 0), jg[1], 1e-5)  # back to HWIO
        _close(gb, jg[2], 1e-5)


def test_frozen_scale_and_bias_get_no_gradient():
    (jx, jw, jb, js), (tx, tw, tb, ts) = _pair(_arrays(5, 3), "float32")
    jg = jax.grad(lambda s, b, w: jnp.sum(
        jcbr.ConvFrozenScaleBiasReLU(jx, w, s, b, 1, 1)),
        argnums=(0, 1, 2))(js, jb, jw)
    assert not np.asarray(jg[0]).any() and not np.asarray(jg[1]).any()
    ts.requires_grad_()
    tb.requires_grad_()
    tw.requires_grad_()
    y = tcbr.ConvFrozenScaleBiasReLU(tx, tw, ts, tb, 1, 1)
    gs, gb, gw = torch.autograd.grad(y.sum(), (ts, tb, tw),
                                     allow_unused=True)
    assert gs is None and gb is None
    _close(gw.permute(2, 3, 1, 0), jg[2], 1e-5)
