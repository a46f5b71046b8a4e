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
The hash dropout mask is compared bit for bit. The additive bias (every
broadcast shape, with and without its gradient) and the segment ids of
``flash_attention_varlen`` run in fp32, bf16 and fp16: fp16 at 5e-3 (one
fp16 rounding, 2^-11, of values up to a few, taken at other points on the
two sides), dbias at its dtype's tolerance.
"""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

T = importlib.import_module("apex_tpu_torch.ops.flash_attention")

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


def test_dropout_without_seed_is_refused():
    q = torch.zeros(1, 1, 8, 16)
    with pytest.raises(ValueError, match="dropout_seed"):
        T.flash_attention(q, q, q, dropout_p=0.1)


# ---------------------------------------------------------------------------
# the additive bias and the segment ids (packed varlen sequences)
# ---------------------------------------------------------------------------

#: fp16 parity: one fp16 rounding (2^-11) of values up to a few, taken at
#: other points on the two sides (the TPU kernel rounds p against the
#: running max of its tile, the plain version against the row's)
TOL_F16 = 5e-3
TOLS = {**TOL, "float16": TOL_F16}

#: the bias shapes of the JAX kernels' ``_bias_args``: full, broadcast over
#: batch, the key-padding form [b, 1, 1, s_k], broadcast over batch and head
BIAS_SHAPES = {"full": (B, N, S, S), "batch1": (1, N, S, S),
               "keypad": (B, 1, 1, S), "shared": (1, 1, S, S)}


def _bias(shape, seed=5):
    """A bias of order 1; the key-padding form folds a -1e30 mask in, with
    every key of batch row 1 masked (a fully masked row through the
    bias)."""
    rng = np.random.default_rng(seed)
    bias = (0.5 * rng.normal(size=shape)).astype(np.float32)
    if shape[1:3] == (1, 1):
        bias[0, ..., (5 * S) // 6:] = -1e30
        bias[1] = -1e30
    return bias


def _bias_case(shape_name, causal, bias_grad, dtype, p=0.0):
    """o, lse, dq, dk, dv and dbias of the port (its plain versions on the
    CPU) against the JAX package's Pallas kernels in interpret mode, 16-row
    tiles, on the same numpy inputs; dbias is zeros with ``bias_grad``
    off."""
    q, k, v, do, _ = _inputs(6)
    bias = _bias(BIAS_SHAPES[shape_name])
    seed = 9 if p else None
    jdt = getattr(jnp, dtype)
    jx = [jnp.asarray(a, jdt) for a in (q, k, v, do)]
    jb = jnp.asarray(bias)
    jkw = dict(causal=causal, bias_grad=bias_grad, dropout_p=p,
               dropout_seed=seed, block_q=16, block_k=16)
    jo, vjp = jax.vjp(lambda a, b, c, e: J.flash_attention(
        a, b, c, bias=e, **jkw), *jx[:3], jb)
    jdq, jdk, jdv, jdb = vjp(jx[3])
    _, jlse = J._fwd(*jx[:3], jb, None, None, None, seed, D ** -0.5, causal,
                     p, 16, 16, True)

    tx = [torch.from_numpy(a).to(getattr(torch, dtype)) for a in
          (q, k, v, do)]
    tb = torch.from_numpy(bias).requires_grad_(True)
    for t in tx[:3]:
        t.requires_grad_(True)
    tkw = dict(causal=causal, dropout_p=p, dropout_seed=seed)
    to = T.flash_attention(*tx[:3], bias=tb, bias_grad=bias_grad, **tkw)
    to.backward(tx[3])
    _, tlse = T.flash_attention_fwd(*(t.detach() for t in tx[:3]),
                                    bias=tb.detach(), **tkw)
    tol = TOLS[dtype]
    for want, got in ((jo, to), (jlse, tlse), (jdq, tx[0].grad),
                      (jdk, tx[1].grad), (jdv, tx[2].grad)):
        np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol)
    assert tb.grad.shape == tb.shape and tb.grad.dtype == torch.float32
    if not bias_grad:
        assert not bool(tb.grad.any()) and not bool(jnp.any(jdb))
    else:
        np.testing.assert_allclose(_np(tb.grad), _np(jdb), rtol=tol,
                                   atol=tol)
    if shape_name == "keypad":  # batch row 1: every key masked by the bias
        assert not bool(to[1].any()) and bool((tlse[1] == -1e30).all())
        assert not bool(tx[0].grad[1].any())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
@pytest.mark.parametrize("bias_grad", [True, False],
                         ids=["bias_grad", "const_bias"])
@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
@pytest.mark.parametrize("shape_name", list(BIAS_SHAPES))
def test_flash_bias_matches_jax_interpret(shape_name, causal, bias_grad,
                                          dtype):
    """Every broadcast shape of the bias, causal and not, with and without
    its gradient (dbias summed over the broadcast dims), in every dtype."""
    _bias_case(shape_name, causal, bias_grad, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
def test_flash_bias_with_dropout_matches_jax_interpret(dtype):
    """A full bias with its gradient under hash dropout 0.1."""
    _bias_case("full", True, True, dtype, p=0.1)


def test_flash_bias_shape_is_checked():
    q = torch.zeros(2, 2, 8, 16)
    with pytest.raises(ValueError, match=r"must be \[b\|1, n\|1"):
        T.flash_attention(q, q, q, bias=torch.zeros(2, 2, 8, 4))
    with pytest.raises(ValueError, match=r"must be \[b\|1, n\|1"):
        T.flash_attention(q, q, q, bias=torch.zeros(3, 1, 1, 8))


def test_plain_backward_dbias_matches_autograd():
    """The plain backward's dbias (ds, before any sum) equals torch
    autograd through the plain forward with a full bias, fp32 1e-5."""
    q, k, v, do, _ = _inputs(7)
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    tb = torch.from_numpy(_bias((B, N, S, S), 8)).requires_grad_(True)
    o, lse = T.flash_attention_fwd_reference(tq, tk, tv, bias=tb,
                                             causal=True)
    o.backward(torch.from_numpy(do))
    *_, dbias = T.flash_attention_bwd_reference(
        tq, tk, tv, o.detach(), lse.detach(), torch.from_numpy(do),
        bias=tb.detach(), bias_grad=True, causal=True)
    torch.testing.assert_close(dbias, tb.grad, rtol=1e-5, atol=1e-5)


#: packed sequences of 16 tokens' multiples and not: JAX's segment ids run
#: on 16-row tiles, so several tiles hold two sequences; the last case
#: leaves 8 tokens past cu_seqlens[-1] (one padding segment)
VARLEN_CASES = {"three": ([20, 36, 8], 64), "ragged": ([5, 27, 16], 48),
                "padded": ([24, 16], 48)}


def _varlen_inputs(lens, total, seed=10, n=2, d=D):
    rng = np.random.default_rng(seed)
    q, k, v, do = (rng.normal(size=(total, n, d)).astype(np.float32)
                   for _ in range(4))
    cu = np.concatenate([[0], np.cumsum(lens)]).astype(np.int32)
    return q, k, v, do, cu


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
@pytest.mark.parametrize("case", list(VARLEN_CASES))
def test_flash_varlen_matches_jax_interpret(case, causal, dtype):
    """flash_attention_varlen (segment ids from cu_seqlens) against the
    JAX package's in interpret mode, forward and backward."""
    lens, total = VARLEN_CASES[case]
    q, k, v, do, cu = _varlen_inputs(lens, total)
    jdt = getattr(jnp, dtype)
    jx = [jnp.asarray(a, jdt) for a in (q, k, v, do)]
    jo, vjp = jax.vjp(lambda a, b, c: J.flash_attention_varlen(
        a, b, c, jnp.asarray(cu), causal=causal, block_q=16, block_k=16),
        *jx[:3])
    jgrads = vjp(jx[3])
    tx = [torch.from_numpy(a).to(getattr(torch, dtype)).requires_grad_(True)
          for a in (q, k, v)]
    to = T.flash_attention_varlen(*tx, torch.from_numpy(cu), causal=causal)
    to.backward(torch.from_numpy(do).to(getattr(torch, dtype)))
    assert tuple(to.shape) == (total, 2, D) and to.dtype == tx[0].dtype
    tol = TOLS[dtype]
    for want, got in ((jo, to), *zip(jgrads, (t.grad for t in tx))):
        np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol)


@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
@pytest.mark.parametrize("case", list(VARLEN_CASES))
def test_flash_varlen_matches_per_sequence_reference(case, causal):
    """The port's varlen attention against its per-sequence reference and
    the JAX package's ``mha_reference_varlen``, fp32 1e-5."""
    lens, total = VARLEN_CASES[case]
    q, k, v, _, cu = _varlen_inputs(lens, total, seed=11)
    tx = [torch.from_numpy(a) for a in (q, k, v)]
    got = T.flash_attention_varlen(*tx, torch.from_numpy(cu), causal=causal)
    ref = T.mha_reference_varlen(*tx, torch.from_numpy(cu), causal=causal)
    jref = J.mha_reference_varlen(*(jnp.asarray(a) for a in (q, k, v)),
                                  jnp.asarray(cu), causal=causal)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(ref.numpy(), np.asarray(jref), rtol=1e-5,
                               atol=1e-5)


def test_segment_ids_match_jax():
    cu = np.array([0, 5, 5, 17, 30], np.int32)
    got = T.segment_ids_from_cu_seqlens(torch.from_numpy(cu), 36)
    want = J.segment_ids_from_cu_seqlens(jnp.asarray(cu), 36)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_mha_reference_with_bias_matches_jax():
    q, k, v, _, _ = _inputs(12)
    bias = _bias((1, N, S, S), 13)
    want = J.mha_reference(*(jnp.asarray(a) for a in (q, k, v)),
                           bias=jnp.asarray(bias), causal=True)
    got = T.mha_reference(*(torch.from_numpy(a) for a in (q, k, v)),
                          bias=torch.from_numpy(bias), causal=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


# ---------------------------------------------------------------------------
# which attention path a model takes: flash where the device's kernels take
# the head dim, the path without flash elsewhere (the JAX package's rule)
# ---------------------------------------------------------------------------

#: head dims that a GPT-2/BERT-style model runs: hidden / heads (and one
#: past the kernels' 256)
HEAD_DIMS = [16, 32, 64, 80, 96, 128, 160, 256, 320]


@pytest.mark.parametrize("d", HEAD_DIMS)
def test_flash_attention_available_per_head_dim(d):
    on_card = T.flash_attention_available(1024, 1024, d,
                                          torch.device("cuda"))
    assert on_card == (d <= 256)
    for dt in (torch.float32, torch.bfloat16, torch.float16):
        assert T.flash_attention_available(1024, 1024, d, "cuda",
                                           dt) == on_card
    assert not T.flash_attention_available(1024, 1024, d, "cuda",
                                           torch.float64)
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
    """``use_flash_attention=None`` takes flash at a head dim up to 256
    (the kernels' own or zero-padded to the next) and the path without
    flash (the fused softmax) past it; ``True`` past 256 raises; ``False``
    never takes flash."""
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
    on_card = d <= T.MAX_HEAD_DIM
    if use_flash and not on_card:
        with pytest.raises(ValueError, match="head dim"):
            gpt_loss(cfg, params, tokens, tokens)
        return
    loss = gpt_loss(cfg, params, tokens, tokens)
    assert torch.isfinite(loss)
    takes_flash = on_card and use_flash is not False
    assert calls == {"flash": int(takes_flash),
                     "softmax": int(not takes_flash)}


# ---------------------------------------------------------------------------
# head dims between the instantiated ones: the CUDA route zero-pads q, k, v
# (and o, do) to the next instantiated head dim and cuts the results back
# ---------------------------------------------------------------------------

def _spied(fn, seen):
    def run(q, *a):
        seen.append(q.shape[-1])
        return fn(q, *a)
    return run


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal,masked,p", [CASES[0], CASES[4]],
                         ids=["causal", "kv_mask_dropout"])
@pytest.mark.parametrize("d", [16, 48, 80, 160])
def test_head_padded_route_matches_jax_interpret(d, causal, masked, p,
                                                 dtype):
    """The pad and slice helpers of the CUDA route around the plain
    versions, at head dims no kernel is instantiated for, against the JAX
    module in interpret mode: o, lse, dq, dk and dv at the unpadded width,
    the plain versions run at the padded one, the scale ``1/sqrt(d)`` of
    the unpadded d."""
    q, k, v, do, mask = _inputs(d=d)
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

    tq, tk, tv, tdo = (torch.from_numpy(a).to(getattr(torch, dtype))
                       for a in (q, k, v, do))
    args = (torch.from_numpy(mask) if masked else None, None, None, None,
            causal, d ** -0.5, p, T._resolve_seed(p, seed))
    seen = []
    o, lse = T._head_padded_fwd(_spied(T._plain_fwd, seen), tq, tk, tv,
                                *args)
    dq, dk, dv, dbias = T._head_padded_bwd(_spied(T._plain_bwd, seen), tq,
                                           tk, tv, o, lse, tdo, *args,
                                           False)
    assert seen == [T.kernel_head_dim(d)] * 2 and seen[0] > d
    assert dbias is None
    for t in (o, dq, dk, dv):
        assert t.shape == tq.shape and t.dtype == tq.dtype
        assert t.is_contiguous()
    tol = TOL[dtype]
    for want, got in ((jo, o), (jlse, lse), (jdq, dq), (jdk, dk),
                      (jdv, dv)):
        np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol)


def test_kernel_head_dim_is_the_next_instantiated_one():
    """Each head dim up to 256 runs at the narrowest instantiated head dim
    that holds it; past 256 the CUDA route refuses."""
    for d in range(1, 257):
        k = T.kernel_head_dim(d)
        assert k in T.KERNEL_HEAD_DIMS and k >= d
        assert all(j < d for j in T.KERNEL_HEAD_DIMS if j < k)
    with pytest.raises(ValueError, match="head dims up to 256"):
        T.kernel_head_dim(257)
