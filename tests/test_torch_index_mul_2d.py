"""``contrib.index_mul_2d`` of the port against the JAX package's, on the
CPU.

Numpy-seeded ``in1``, ``in2`` and repeated indices through both: the
forward, the gradient of both inputs and the double backward (the
gradient of a function of the first gradient), fp32, fp16 and bf16; the
contract checks' messages.

Tolerances: the forward bit for bit (one product, one rounding, on
both); the gradients and the double backward within 1e-6 of each
result's largest entry (``grad_in1`` sums the rows of repeated indices,
whose order the two frameworks choose; fp32 only, where a sum is kept
in its own dtype).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.contrib.index_mul_2d import index_mul_2d as jmul
from apex_tpu_torch.contrib.index_mul_2d import index_mul_2d as tmul

DTYPES = ["float32", "float16", "bfloat16"]


def _case(seed, dtype, n1=13, n=40, d=24):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((n1, d)).astype(np.float32)
    b = rng.standard_normal((n, d)).astype(np.float32)
    idx = rng.integers(0, n1, n).astype(np.int64)
    idx[:5] = 3  # repeats
    j = [jnp.asarray(a).astype(getattr(jnp, dtype)),
         jnp.asarray(b).astype(getattr(jnp, dtype)), jnp.asarray(idx)]
    t = [torch.from_numpy(a).to(getattr(torch, dtype)),
         torch.from_numpy(b).to(getattr(torch, dtype)),
         torch.from_numpy(idx)]
    return j, t


def _np(x):
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _close(got, want, tol=1e-6):
    want = _np(want)
    got = got.detach().float().numpy()
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= tol * np.abs(want).max()


@pytest.mark.parametrize("dtype", DTYPES)
def test_forward_is_bitwise(dtype):
    (ja, jb, ji), (ta, tb, ti) = _case(0, dtype)
    got = tmul(ta, tb, ti)
    want = jmul(ja, jb, ji)
    assert got.dtype == getattr(torch, dtype)
    np.testing.assert_array_equal(got.float().numpy(), _np(want))


def test_gradients_and_double_backward_match():
    (ja, jb, ji), (ta, tb, ti) = _case(1, "float32")
    w = np.random.default_rng(2).standard_normal((40, 24)).astype(np.float32)

    def jloss(a, b):
        return jnp.sum(jmul(a, b, ji) ** 2 * w)
    jg1, jg2 = jax.grad(jloss, argnums=(0, 1))(ja, jb)
    jh = jax.grad(lambda b: jnp.sum(jax.grad(jloss)(ja, b) ** 2))(jb)

    ta.requires_grad_(True)
    tb.requires_grad_(True)
    loss = (tmul(ta, tb, ti) ** 2 * torch.from_numpy(w)).sum()
    g1, g2 = torch.autograd.grad(loss, (ta, tb), create_graph=True)
    (h,) = torch.autograd.grad((g1 ** 2).sum(), tb)
    _close(g1, jg1)
    _close(g2, jg2)
    _close(h, jh)


@pytest.mark.parametrize("args,message", [
    (((2, 2, 2), (2, 2), (1,), "float32"),
     "in1 and in2 must be 2-dimension tensors."),
    (((2, 2), (2, 2), (1, 2), "float32"), "idx1 must be a 1-dimension tensor."),
    (((2, 2), (3, 2), (2,), "float32"), "in2 and idx1 must agree on dim 0."),
    (((2, 2), (2, 2), (2,), "bfloat16"),
     "input1's dtype and input2's dtype must be the same."),
])
def test_contract_checks_raise_the_same_messages(args, message):
    s1, s2, si, dt2 = args
    with pytest.raises(RuntimeError) as jerr:
        jmul(jnp.zeros(s1), jnp.zeros(s2, getattr(jnp, dt2)),
             jnp.zeros(si, jnp.int32))
    with pytest.raises(RuntimeError) as terr:
        tmul(torch.zeros(s1), torch.zeros(s2, dtype=getattr(torch, dt2)),
             torch.zeros(si, dtype=torch.int64))
    assert str(terr.value) == str(jerr.value) == message
