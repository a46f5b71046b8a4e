"""apex_tpu_torch.ops.flash_attention against the JAX package's.

The same numpy-seeded inputs go through JAX's Pallas flash attention in
interpret mode (JAX forces interpret off the TPU) with 16-row tiles, so
a 48-long sequence spans several tiles and runs the online-softmax
recurrence, and through the port on the CPU (its plain versions). The
CUDA kernels are held against the plain versions on the card by
``tests/test_torch_cuda.py`` and ``chip_smoke.py``.

Tolerances: fp32 atol/rtol 1e-5 on o, lse, dq, dk, dv (summation order
only); bf16 2e-2 (one bf16 rounding of values of order 1, taken at
other points: the TPU kernel rounds p against the running max), the
same at head dims 128 and 256, where the bf16 kernels on the card run
their products on the tensor cores with these plain versions as their
judge, and for causal cross shapes (s_q != s_k, multiples of 8 as the
JAX kernels require; the mask is ``k > q``, aligned at the top left).
The hash dropout mask is compared bit for bit.
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


def _inputs(seed=0, s_q=S, s_k=S, d=D):
    rng = np.random.default_rng(seed)
    q, do = (rng.normal(size=(B, N, s_q, d)).astype(np.float32)
             for _ in range(2))
    k, v = (rng.normal(size=(B, N, s_k, d)).astype(np.float32)
            for _ in range(2))
    mask = np.ones((B, s_k), bool)
    mask[0, (5 * s_k) // 6:] = False
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


def _check_against_jax(causal, masked, p, dtype, d=D, s_q=S, s_k=S):
    """o, lse, dq, dk, dv of the port (its plain versions on the CPU)
    against the JAX package's Pallas kernels in interpret mode, 16-row
    tiles, on the same numpy inputs."""
    q, k, v, do, mask = _inputs(s_q=s_q, s_k=s_k, d=d)
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
                     None, None, seed, d ** -0.5, causal, p, 16, 16, True)

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
    assert tlse.dtype == torch.float32 and tuple(tlse.shape) == (B, N, s_q)
    tol = TOL[dtype]
    for want, got in ((jo, to), (jlse, tlse), (jdq, tx[0].grad),
                      (jdk, tx[1].grad), (jdv, tx[2].grad)):
        np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal,masked,p", CASES,
                         ids=["causal", "kv_mask", "causal_kv_mask",
                              "dropout", "kv_mask_dropout"])
def test_flash_attention_matches_jax_interpret(causal, masked, p, dtype):
    _check_against_jax(causal, masked, p, dtype)


@pytest.mark.parametrize("d", [128, 256])
@pytest.mark.parametrize("causal,masked,p", CASES,
                         ids=["causal", "kv_mask", "causal_kv_mask",
                              "dropout", "kv_mask_dropout"])
def test_flash_attention_wide_heads_match_jax_interpret(causal, masked, p,
                                                        d):
    """bf16 at the head dims whose tensor-core kernels keep the widest
    accumulators (128; 256, whose dk/dv kernel walks the queries twice)."""
    _check_against_jax(causal, masked, p, "bfloat16", d=d)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("s_q,s_k", [(32, 48), (48, 32), (24, 64)])
def test_flash_attention_causal_cross_matches_jax_interpret(s_q, s_k, dtype):
    """Causal with s_q != s_k: the kernels stop each query tile at the
    diagonal and start each key tile's query walk at it."""
    _check_against_jax(True, False, 0.0, dtype, s_q=s_q, s_k=s_k)


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


@pytest.mark.parametrize("offset", [0, 1, 3, 8])
def test_kernel_operands_are_16_byte_aligned(offset):
    """The bf16 kernels copy 16-byte chunks: a contiguous view at an odd
    element offset reaches them as an aligned copy, an aligned one as
    itself."""
    base = torch.arange(2 * 64 + 16, dtype=torch.float32).to(torch.bfloat16)
    view = base[offset:offset + 2 * 64].view(1, 1, 2, 64)
    got = T._aligned(view)
    assert got.data_ptr() % 16 == 0 and torch.equal(got, view)
    assert (got.data_ptr() == view.data_ptr()) == (view.data_ptr() % 16 == 0)


def test_bias_and_varlen_are_refused():
    q = torch.zeros(1, 1, 8, 16)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        T.flash_attention(q, q, q, bias=torch.zeros(1, 1, 8, 8))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        T.flash_attention_varlen(q[0, 0], q[0, 0], q[0, 0],
                                 torch.tensor([0, 8]))
    with pytest.raises(ValueError, match="dropout_seed"):
        T.flash_attention(q, q, q, dropout_p=0.1)


# ---------------------------------------------------------------------------
# which attention path a model takes: flash where the device's kernels take
# the head dim, the path without flash elsewhere (the JAX package's rule)
# ---------------------------------------------------------------------------

#: head dims that a GPT-2/BERT-style model runs: hidden / heads
HEAD_DIMS = [16, 32, 64, 80, 96, 128, 160, 256]


@pytest.mark.parametrize("d", HEAD_DIMS)
def test_flash_attention_available_per_head_dim(d):
    on_card = T.flash_attention_available(1024, 1024, d,
                                          torch.device("cuda"))
    assert on_card == (d in (32, 64, 96, 128, 256))
    assert T.flash_attention_available(1024, 1024, d, "cpu")
    assert T.flash_attention_available(1000, 1000, d, None)


def _route_spy(monkeypatch):
    """Calls of each attention path in ``parallel_attention``, with the
    availability rule of the CUDA kernels for the CPU run."""
    from apex_tpu_torch.transformer.testing import (
        standalone_transformer_lm as lm,
    )

    calls = {"flash": 0, "softmax": 0}
    flash, soft = lm.flash_attention_sbhd, lm._softmax_attention

    def spy_flash(*a, **kw):
        calls["flash"] += 1
        return flash(*a, **kw)

    def spy_soft(*a, **kw):
        calls["softmax"] += 1
        return soft(*a, **kw)
    monkeypatch.setattr(lm, "flash_attention_sbhd", spy_flash)
    monkeypatch.setattr(lm, "_softmax_attention", spy_soft)
    monkeypatch.setattr(
        lm, "flash_attention_available",
        lambda s_q, s_k, d, device: T.flash_attention_available(
            s_q, s_k, d, torch.device("cuda")))
    return calls


@pytest.mark.parametrize("d", HEAD_DIMS)
@pytest.mark.parametrize("use_flash", [None, True, False])
def test_model_takes_flash_only_at_a_head_dim_the_card_takes(
        monkeypatch, d, use_flash):
    """``use_flash_attention=None`` takes flash at an instantiated head dim
    and the path without flash (the fused softmax) at any other; ``True``
    at another head dim raises; ``False`` never takes flash."""
    from apex_tpu_torch.transformer.testing import (
        GPTConfig,
        gpt_loss,
        init_gpt_params,
    )

    calls = _route_spy(monkeypatch)
    cfg = GPTConfig(num_layers=1, hidden_size=2 * d, num_attention_heads=2,
                    vocab_size=64, max_position_embeddings=16,
                    hidden_dropout=0.0, attention_dropout=0.0,
                    use_flash_attention=use_flash)
    assert cfg.kv_channels == d
    params = init_gpt_params(cfg, torch.Generator().manual_seed(0))
    tokens = torch.arange(32).reshape(2, 16) % 64
    on_card = d in T.KERNEL_HEAD_DIMS
    if use_flash and not on_card:
        with pytest.raises(ValueError, match="head dim"):
            gpt_loss(cfg, params, tokens, tokens)
        return
    loss = gpt_loss(cfg, params, tokens, tokens)
    assert torch.isfinite(loss)
    takes_flash = on_card and use_flash is not False
    assert calls == {"flash": int(takes_flash),
                     "softmax": int(not takes_flash)}
