"""``contrib.transducer`` of the port against the JAX package's, on the
CPU.

The joint on numpy-seeded ``f``, ``g`` and ragged lengths: plain, with
ReLU, packed (the output and the keep-mask), with the gradients of ``f``
and ``g``; with dropout (drawn from a ``torch.Generator``, so held to its
invariants: kept entries scaled by ``1 / (1 - p)``, the mask in the
probe, packed row for row). The loss at ragged lengths (one utterance at
full length, one with no label), fp32 and bf16 logits, dense and
``packed_input``: the per-utterance losses, the alphas of ``debug_list``
and the gradient of the logits; the refusals.

Tolerances: the joint and its masks bit for bit (one addition, a ReLU
and a scatter), its gradients within 1e-6 of their largest entry (sums
over T or U); the losses within 1e-5 of the largest, the alphas within
1e-5 of the largest finite entry (those past the label length are
~-1e30 on both), the logits' gradient within 1e-5 of its largest entry
(the DP's logaddexp chains in fp32; XLA and torch round ``exp`` and
``log1p`` apart), a bf16 one within one bf16 rounding (2^-8).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.contrib import transducer as jtr
from apex_tpu_torch.contrib import transducer as ttr

DP_TOL = 1e-5


def _np(x):
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _close(got, want, tol):
    want = _np(want)
    got = got.detach().float().numpy()
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= tol * np.abs(want).max(), (
        np.abs(got - want).max(), np.abs(want).max())


def _joint_inputs(seed, b=3, t=7, u=5, h=16):
    rng = np.random.default_rng(seed)
    f = rng.standard_normal((b, t, h)).astype(np.float32)
    g = rng.standard_normal((b, u, h)).astype(np.float32)
    f_len = np.array([7, 3, 5][:b], np.int64)
    g_len = np.array([5, 2, 4][:b], np.int64)
    return f, g, f_len, g_len


def _j(*arrs):
    return [jnp.asarray(a) for a in arrs]


def _t(*arrs):
    return [torch.from_numpy(a) for a in arrs]


@pytest.mark.parametrize("relu", [False, True])
@pytest.mark.parametrize("pack", [False, True])
def test_joint_matches(pack, relu):
    f, g, f_len, g_len = _joint_inputs(0)
    off = np.cumsum(f_len * g_len)
    kw = dict(pack_output=pack, relu=relu, return_mask=True)
    if pack:
        kw.update(packed_batch=int(off[-1]))
    jout, jmask = jtr.transducer_joint(*_j(f, g, f_len, g_len),
                                       batch_offset=jnp.asarray(off), **kw)
    tout, tmask = ttr.transducer_joint(*_t(f, g, f_len, g_len),
                                       batch_offset=torch.from_numpy(off),
                                       **kw)
    np.testing.assert_array_equal(tout.numpy(), _np(jout))
    if relu:
        np.testing.assert_array_equal(tmask.numpy(), _np(jmask))
    else:
        assert tmask is None and jmask is None

    dy = np.random.default_rng(1).standard_normal(tout.shape).astype(
        np.float32)
    jg = jax.grad(lambda f, g: jnp.sum(jtr.transducer_joint(
        f, g, jnp.asarray(f_len), jnp.asarray(g_len),
        batch_offset=jnp.asarray(off), **{k: v for k, v in kw.items()
                                          if k != "return_mask"}) * dy),
        argnums=(0, 1))(*_j(f, g))
    tf, tg = (torch.from_numpy(a).requires_grad_() for a in (f, g))
    out = ttr.transducer_joint(
        tf, tg, *_t(f_len, g_len), batch_offset=torch.from_numpy(off),
        **{k: v for k, v in kw.items() if k != "return_mask"})
    grads = torch.autograd.grad((out * torch.from_numpy(dy)).sum(), (tf, tg))
    for got, want in zip(grads, jg):
        _close(got, want, 1e-6)


def test_joint_dropout_invariants_and_probe():
    f, g, f_len, g_len = _joint_inputs(2)
    off = np.cumsum(f_len * g_len)
    pb = int(off[-1])
    joint = ttr.TransducerJoint(pack_output=True, relu=True, dropout=True,
                                dropout_prob=0.25, probe_mask=True)
    gen = torch.Generator().manual_seed(0)
    out = joint(*_t(f, g, f_len, g_len), torch.from_numpy(off), pb,
                dropout_key=gen)
    mask = joint.mask_probe[0]
    plain = ttr.transducer_joint(*_t(f, g, f_len, g_len), pack_output=True,
                                 relu=True, batch_offset=torch.from_numpy(
                                     off), packed_batch=pb)
    assert out.shape == mask.shape == (pb, 16)
    assert set(mask.unique().tolist()) <= {0.0, 1.0}
    np.testing.assert_array_equal(out.numpy(),
                                  (plain * mask / 0.75).numpy())
    relu_alive = float((plain > 0).float().mean())
    kept = float(mask.mean()) / relu_alive
    assert 0.6 < kept < 0.9  # ~0.75 of the ReLU's survivors
    again = joint(*_t(f, g, f_len, g_len), torch.from_numpy(off), pb,
                  dropout_key=torch.Generator().manual_seed(0))
    assert torch.equal(again, out)  # the generator decides the mask
    evaluated = joint(*_t(f, g, f_len, g_len), torch.from_numpy(off), pb,
                      training=False)
    assert torch.equal(evaluated, plain)
    with pytest.raises(ValueError) as j:
        jtr.transducer_joint(*_j(f, g, f_len, g_len), dropout_prob=0.1)
    with pytest.raises(ValueError) as t:
        ttr.transducer_joint(*_t(f, g, f_len, g_len), dropout_prob=0.1)
    assert str(t.value) == str(j.value)
    with pytest.raises(ValueError) as j:
        jtr.transducer_joint(*_j(f, g, f_len, g_len), pack_output=True)
    with pytest.raises(ValueError) as t:
        ttr.transducer_joint(*_t(f, g, f_len, g_len), pack_output=True)
    assert str(t.value) == str(j.value)


def _loss_inputs(seed, b=4, t=9, u_max=6, v=11):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((b, t, u_max, v)) * 2.0).astype(np.float32)
    label = rng.integers(0, v - 1, (b, u_max - 1)).astype(np.int64)
    f_len = np.array([9, 4, 6, 1][:b], np.int64)
    y_len = np.array([5, 2, 0, 3][:b], np.int64)
    return x, label, f_len, y_len


def _pack(x, f_len, y_len):
    rows = [x[i, tt, uu] for i in range(x.shape[0])
            for tt in range(int(f_len[i])) for uu in range(int(y_len[i]) + 1)]
    return np.stack(rows), np.cumsum(f_len * (y_len + 1))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_loss_alphas_and_gradient_match(dtype):
    x, label, f_len, y_len = _loss_inputs(3)
    blank = 10
    jx = jnp.asarray(x).astype(getattr(jnp, dtype))
    def jloss(x):
        losses, alphas = jtr.transducer_loss(
            x, *_j(label, f_len, y_len), blank, return_alphas=True)
        return jnp.sum(losses * jnp.arange(1.0, 5.0)), (losses, alphas)
    (_, (jl, ja)), jg = jax.value_and_grad(jloss, has_aux=True)(jx)
    tx = torch.from_numpy(x).to(getattr(torch, dtype)).requires_grad_()
    tl, ta = ttr.transducer_loss(tx, *_t(label, f_len, y_len), blank,
                                 return_alphas=True)
    (tg,) = torch.autograd.grad((tl * torch.arange(1.0, 5.0)).sum(), tx)
    _close(tl, jl, DP_TOL)
    finite = _np(ja) > -1e29
    np.testing.assert_array_equal(ta.detach().numpy() > -1e29, finite)
    got, want = ta.detach().numpy()[finite], _np(ja)[finite]
    assert np.abs(got - want).max() <= DP_TOL * np.abs(want).max()
    assert tg.dtype == tx.dtype
    _close(tg, jg, DP_TOL if dtype == "float32" else 2.0 ** -8)


def test_packed_loss_module_matches_dense_and_jax():
    x, label, f_len, y_len = _loss_inputs(4)
    blank = 10
    packed, off = _pack(x, f_len, y_len)
    jmod, tmod = jtr.TransducerLoss(packed_input=True), ttr.TransducerLoss(
        packed_input=True)
    jdbg, tdbg = [], []
    jl = jmod(jnp.asarray(packed), *_j(label, f_len, y_len), blank,
              batch_offset=jnp.asarray(off), max_f_len=9, debug_list=jdbg)
    jg = jax.grad(lambda p: jnp.sum(jmod(
        p, *_j(label, f_len, y_len), blank, batch_offset=jnp.asarray(off),
        max_f_len=9)))(jnp.asarray(packed))
    tp = torch.from_numpy(packed).requires_grad_()
    tl = tmod(tp, *_t(label, f_len, y_len), blank,
              batch_offset=torch.from_numpy(off), max_f_len=9,
              debug_list=tdbg)
    (tg,) = torch.autograd.grad(tl.sum(), tp)
    _close(tl, jl, DP_TOL)
    _close(tg, jg, DP_TOL)
    assert tdbg[0].shape == jdbg[0].shape == (4, 9, 6)
    dense = ttr.transducer_loss(torch.from_numpy(x), *_t(label, f_len, y_len),
                                blank)
    _close(tl, dense.numpy(), DP_TOL)
    with pytest.raises(ValueError) as j:
        jmod(jnp.asarray(packed), *_j(label, f_len, y_len), blank)
    with pytest.raises(ValueError) as t:
        tmod(tp, *_t(label, f_len, y_len), blank)
    assert str(t.value) == str(j.value)
