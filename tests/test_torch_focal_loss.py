"""``contrib.focal_loss`` of the port against the JAX package's, on the
CPU.

Numpy-seeded logits (fp32, bf16, fp16) padded past ``num_real_classes``,
targets with ignored (-2), all-negative (-1) and positive rows, label
smoothing 0 and 0.1, gamma 2 and 1.5; the loss and its gradient through
both, and ``FocalLoss.apply``.

Tolerances: the loss and its gradient within 1e-6 of their largest
entry (elementwise fp32 math, then one sum whose order the frameworks
choose; ``sigmoid`` and ``logaddexp`` may round an ulp apart), a bf16 or
fp16 gradient also within the one rounding to its dtype (2^-8 of the
largest entry) that may fall either way of such an ulp; the gradient of
ignored rows and padded classes exactly zero on both.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.contrib.focal_loss import FocalLoss as JFocal
from apex_tpu.contrib.focal_loss import focal_loss as jfocal
from apex_tpu_torch.contrib.focal_loss import FocalLoss as TFocal
from apex_tpu_torch.contrib.focal_loss import focal_loss as tfocal

TOL = 1e-6


def _case(seed, dtype, shape=(3, 50, 12), real=10):
    rng = np.random.default_rng(seed)
    logits = (rng.standard_normal(shape) * 3.0).astype(np.float32)
    y = rng.integers(-2, real, shape[:-1]).astype(np.int32)
    y[0, :4] = -2
    y[1, :4] = -1
    npos = float(max(1, (y >= 0).sum()))
    return logits, y, npos


@pytest.mark.parametrize("gamma", [2.0, 1.5])
@pytest.mark.parametrize("smoothing", [0.0, 0.1])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
def test_loss_and_gradient_match(dtype, smoothing, gamma):
    logits, y, npos = _case(0, dtype)
    jl = jnp.asarray(logits).astype(getattr(jnp, dtype))
    jloss, jgrad = jax.value_and_grad(lambda p: jfocal(
        p, jnp.asarray(y), jnp.float32(npos), 10, 0.25, gamma,
        smoothing))(jl)
    tl = torch.from_numpy(logits).to(getattr(torch, dtype)).requires_grad_()
    tloss = tfocal(tl, torch.from_numpy(y), torch.tensor(npos), 10, 0.25,
                   gamma, smoothing)
    (tgrad,) = torch.autograd.grad(tloss, tl)
    assert tloss.dtype == torch.float32 and tloss.dim() == 0
    assert abs(float(tloss.detach()) - float(jloss)) <= TOL * abs(float(jloss))
    want = np.asarray(jgrad.astype(jnp.float32))
    got = tgrad.float().numpy()
    assert tgrad.dtype == getattr(torch, dtype)
    assert np.abs(got - want).max() <= TOL * np.abs(want).max() + (
        0.0 if dtype == "float32" else 2.0 ** -8 * np.abs(want).max())
    # ignored rows and padded classes: exactly zero on both
    dead = np.broadcast_to((y == -2)[..., None], got.shape) | (
        np.arange(12) >= 10)
    assert not got[dead].any() and not want[dead].any()


def test_apply_spelling():
    logits, y, npos = _case(1, "float32")
    j = JFocal.apply(jnp.asarray(logits), jnp.asarray(y), jnp.float32(npos),
                     10, 0.25, 2.0, 0.1)
    t = TFocal.apply(torch.from_numpy(logits), torch.from_numpy(y), npos, 10,
                     0.25, 2.0, 0.1)
    assert abs(float(t) - float(j)) <= TOL * abs(float(j))
