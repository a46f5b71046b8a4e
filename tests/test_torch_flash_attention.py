"""apex_tpu_torch.ops.flash_attention against the JAX package's.

The same numpy-seeded inputs go through JAX's Pallas flash attention in
interpret mode (JAX forces interpret off the TPU) with 16-row tiles, so
a 48-long sequence spans several tiles and runs the online-softmax
recurrence, and through the port on the CPU (its plain versions). The
CUDA kernels are held against the plain versions on the card by
``tests/test_torch_cuda.py`` and ``chip_smoke.py``.

Tolerances: fp32 atol/rtol 1e-5 on o, lse, dq, dk, dv (summation order
only); bf16 2e-2 (one bf16 rounding of values of order 1, taken at
other points: the TPU kernel rounds p against the running max). The
hash dropout mask is compared bit for bit.
"""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu_torch.ops import flash_attention as T

J = importlib.import_module("apex_tpu.ops.flash_attention")

B, N, S, D = 2, 2, 48, 16
TOL = {"float32": 1e-5, "bfloat16": 2e-2}


def _inputs(seed=0, s_q=S, s_k=S):
    rng = np.random.default_rng(seed)
    q, do = (rng.normal(size=(B, N, s_q, D)).astype(np.float32)
             for _ in range(2))
    k, v = (rng.normal(size=(B, N, s_k, D)).astype(np.float32)
            for _ in range(2))
    mask = np.ones((B, s_k), bool)
    mask[0, 40:] = False
    mask[1, :] = False  # batch row 1: every key masked
    return q, k, v, do, mask


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


CASES = [
    # causal, masked, dropout_p
    (True, False, 0.0),
    (False, True, 0.0),
    (True, True, 0.0),
    (True, False, 0.2),
    (False, True, 0.1),
]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal,masked,p", CASES,
                         ids=["causal", "kv_mask", "causal_kv_mask",
                              "dropout", "kv_mask_dropout"])
def test_flash_attention_matches_jax_interpret(causal, masked, p, dtype):
    q, k, v, do, mask = _inputs()
    seed = 7 if p else None
    jx = [jnp.asarray(a, getattr(jnp, dtype)) for a in (q, k, v, do)]
    jmask = jnp.asarray(mask) if masked else None
    jkw = dict(causal=causal, kv_mask=jmask, dropout_p=p, dropout_seed=seed,
               block_q=16, block_k=16)
    jo, vjp = jax.vjp(lambda a, b, c: J.flash_attention(a, b, c, **jkw),
                      *jx[:3])
    jdq, jdk, jdv = vjp(jx[3])
    _, jlse = J._fwd(*jx[:3], None,
                     None if jmask is None else jmask.astype(jnp.int8),
                     None, None, seed, D ** -0.5, causal, p, 16, 16, True)

    tx = [torch.from_numpy(a).to(getattr(torch, dtype)) for a in
          (q, k, v, do)]
    for t in tx[:3]:
        t.requires_grad_(True)
    tkw = dict(causal=causal, kv_mask=torch.from_numpy(mask) if masked
               else None, dropout_p=p, dropout_seed=seed)
    to = T.flash_attention(*tx[:3], **tkw)
    to.backward(tx[3])
    _, tlse = T.flash_attention_fwd(*(t.detach() for t in tx[:3]), **tkw)

    assert to.dtype == getattr(torch, dtype)
    assert tlse.dtype == torch.float32 and tuple(tlse.shape) == (B, N, S)
    tol = TOL[dtype]
    for want, got in ((jo, to), (jlse, tlse), (jdq, tx[0].grad),
                      (jdk, tx[1].grad), (jdv, tx[2].grad)):
        np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol)


def test_fully_masked_row_gives_zeros_and_zero_grads():
    q, k, v, do, mask = _inputs(1)
    tq, tk, tv = (torch.from_numpy(a).requires_grad_(True) for a in (q, k, v))
    o = T.flash_attention(tq, tk, tv, kv_mask=torch.from_numpy(mask))
    _, lse = T.flash_attention_fwd(tq.detach(), tk.detach(), tv.detach(),
                                   kv_mask=torch.from_numpy(mask))
    o.backward(torch.from_numpy(do))
    assert torch.equal(o[1], torch.zeros_like(o[1]))
    assert bool((lse[1] == -1e30).all())
    for t in (tq, tk, tv):
        assert torch.isfinite(t.grad).all()
        assert torch.equal(t.grad[1], torch.zeros_like(t.grad[1]))


@pytest.mark.parametrize("causal,masked,p", CASES[:4],
                         ids=["causal", "kv_mask", "causal_kv_mask",
                              "dropout"])
def test_plain_backward_matches_autograd_of_plain_forward(causal, masked, p):
    """The plain backward (scores recomputed from lse) equals torch
    autograd through the plain forward, fp32, atol/rtol 1e-5."""
    q, k, v, do, mask = _inputs(2)
    kw = dict(causal=causal, kv_mask=torch.from_numpy(mask) if masked
              else None, dropout_p=p, dropout_seed=11 if p else None)
    tq, tk, tv = (torch.from_numpy(a).requires_grad_(True) for a in (q, k, v))
    o, lse = T.flash_attention_fwd_reference(tq, tk, tv, **kw)
    o.backward(torch.from_numpy(do))
    dq, dk, dv = T.flash_attention_bwd_reference(
        tq.detach(), tk.detach(), tv.detach(), o.detach(), lse.detach(),
        torch.from_numpy(do), **kw)
    for got, want in ((dq, tq.grad), (dk, tk.grad), (dv, tv.grad)):
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def test_dropout_mask_is_bit_exact():
    got = T.dropout_mask_reference(-123456789, 2, 3, 24, 40, 0.3)
    want = np.asarray(J.dropout_mask_reference(-123456789, 2, 3, 24, 40,
                                               0.3))
    np.testing.assert_array_equal(got.numpy(), want)
    assert 0.6 < float(got.mean()) < 0.8


def test_mha_reference_matches_jax():
    q, k, v, _, mask = _inputs(3)
    kw = dict(causal=True, dropout_p=0.1, dropout_seed=5)
    want = J.mha_reference(*(jnp.asarray(a) for a in (q, k, v)),
                           kv_mask=jnp.asarray(mask), **kw)
    got = T.mha_reference(*(torch.from_numpy(a) for a in (q, k, v)),
                          kv_mask=torch.from_numpy(mask), **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def test_sbhd_and_cross_lengths_match_jax():
    """The [s, b, n, d] wrapper over s_q != s_k (not causal)."""
    q, k, v, do, _ = _inputs(4, s_q=32, s_k=48)
    sb = [np.ascontiguousarray(a.transpose(2, 0, 1, 3))
          for a in (q, k, v, do)]
    jo, vjp = jax.vjp(lambda a, b, c: J.flash_attention_sbhd(
        a, b, c, block_q=16, block_k=16), *(jnp.asarray(a) for a in sb[:3]))
    jgrads = vjp(jnp.asarray(sb[3]))
    tx = [torch.from_numpy(a).requires_grad_(True) for a in sb[:3]]
    to = T.flash_attention_sbhd(*tx)
    to.backward(torch.from_numpy(sb[3]))
    assert tuple(to.shape) == (32, B, N, D)
    np.testing.assert_allclose(to.detach().numpy(), np.asarray(jo),
                               rtol=1e-5, atol=1e-5)
    for t, g in zip(tx, jgrads):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(g),
                                   rtol=1e-5, atol=1e-5)


def test_bias_and_varlen_are_refused():
    q = torch.zeros(1, 1, 8, 16)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        T.flash_attention(q, q, q, bias=torch.zeros(1, 1, 8, 8))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        T.flash_attention_varlen(q[0, 0], q[0, 0], q[0, 0],
                                 torch.tensor([0, 8]))
    with pytest.raises(ValueError, match="dropout_seed"):
        T.flash_attention(q, q, q, dropout_p=0.1)
