"""apex_tpu_torch.contrib.multihead_attn against the JAX package's.

The JAX package's ``SelfMultiheadAttn`` / ``EncdecMultiheadAttn`` build
their parameters; ``params_from_jax`` carries them to the port; the same
numpy-seeded ``[s, b, h]`` inputs and masks go through both (the JAX flash
kernel in Pallas interpret mode, the port's plain versions on the CPU),
forward and the gradients of the input and of every parameter. Mirrors
``tests/test_multihead_attn.py``'s variant matrix: bias, separate qkv
parameters, key-padding and additive masks, the pre-LayerNorm with the
residual add, encoder-decoder, and the path without flash.

The residual dropout draws from a ``torch.Generator`` (the JAX package's
from its key), so the parity tests run it at 0; the attention dropout of
the flash path is the kernels' counter hash, so with the JAX package's
seed (drawn from its dropout key) it compares at the usual tolerance.

Tolerances: fp32 2e-5 (summation order through two projections and the
attention); bf16 3e-2 and fp16 1e-2 (a rounding of values of order 1 in
each projection and the attention, taken at other points).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.contrib import multihead_attn as JM
from apex_tpu.contrib.multihead_attn import multihead_attn as jmod
from apex_tpu_torch.contrib import multihead_attn as TM
from apex_tpu_torch.contrib.multihead_attn import multihead_attn as tmod
from apex_tpu_torch.convert import params_from_jax

S, B, H, N = 16, 2, 32, 4
TOL = {"float32": 2e-5, "bfloat16": 3e-2, "float16": 1e-2}


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _inputs(seed=0, s=S, sk=None):
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(s, B, H)) * 0.5).astype(np.float32)
    g = rng.normal(size=(s, B, H)).astype(np.float32)
    mem = (rng.normal(size=(sk or s, B, H)) * 0.5).astype(np.float32)
    return x, g, mem


def _pad_mask(s=S):
    """1 = masked out: batch row 0 masks its last 5 keys."""
    m = np.zeros((B, s), np.int32)
    m[0, -5:] = 1
    return m


def _run(jm, tm, dtype, x, g, mem=None, key_padding_mask=None,
         attn_mask=None, jkw=None, tkw=None, seed=0):
    """(jax, port) ``(out, dx, {name: dparam})`` of one module call."""
    jparams = jm.init(jax.random.PRNGKey(seed))
    tparams = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams))
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    jx = jnp.asarray(x, jdt)
    jmem = None if mem is None else jnp.asarray(mem, jdt)
    jmask = None if key_padding_mask is None else jnp.asarray(
        key_padding_mask)
    jattn = None if attn_mask is None else jnp.asarray(attn_mask)

    def jf(p, a):
        return jm(p, a, jmem, key_padding_mask=jmask, attn_mask=jattn,
                  **(jkw or {}))[0]
    jo, vjp = jax.vjp(jf, jparams, jx)
    jdp, jdx = vjp(jnp.asarray(g, jdt))

    for t in tparams.values():
        t.requires_grad_(True)
    tx = torch.from_numpy(x).to(tdt).requires_grad_(True)
    tmem = None if mem is None else torch.from_numpy(mem).to(tdt)
    tmask = None if key_padding_mask is None else torch.from_numpy(
        key_padding_mask)
    tattn = None if attn_mask is None else torch.from_numpy(attn_mask)
    to, weights = tm(tparams, tx, tmem, key_padding_mask=tmask,
                     attn_mask=tattn, **(tkw or {}))
    assert weights is None
    to.backward(torch.from_numpy(g).to(to.dtype))
    return ((jo, jdx, jdp),
            (to, tx.grad, {k: t.grad for k, t in tparams.items()}))


def _check(j, t, dtype):
    tol = TOL[dtype]
    (jo, jdx, jdp), (to, tdx, tdp) = j, t
    assert to.dtype == getattr(torch, dtype)
    np.testing.assert_allclose(_np(to), _np(jo), rtol=tol, atol=tol)
    np.testing.assert_allclose(_np(tdx), _np(jdx), rtol=tol, atol=tol)
    assert set(tdp) == set(jdp)
    for name, want in jdp.items():
        np.testing.assert_allclose(_np(tdp[name]), _np(want), rtol=tol,
                                   atol=tol, err_msg=name)


@pytest.mark.parametrize("bias", [False, True])
@pytest.mark.parametrize("separate", [False, True])
def test_self_attn_matches_jax(bias, separate):
    x, g, _ = _inputs(1)
    kw = dict(bias=bias, separate_qkv_params=separate)
    _check(*_run(JM.SelfMultiheadAttn(H, N, **kw),
                 TM.SelfMultiheadAttn(H, N, **kw), "float32", x, g),
           "float32")


@pytest.mark.parametrize("dtype", list(TOL))
def test_self_attn_key_padding_mask_matches_jax(dtype):
    """A boolean key-padding mask (the kernels' key mask)."""
    x, g, _ = _inputs(2)
    _check(*_run(JM.SelfMultiheadAttn(H, N, bias=True),
                 TM.SelfMultiheadAttn(H, N, bias=True), dtype, x, g,
                 key_padding_mask=_pad_mask()), dtype)


@pytest.mark.parametrize("dtype", list(TOL))
def test_self_attn_additive_key_padding_mask_matches_jax(dtype):
    """``mask_additive`` with a ``[b, s]`` additive key-padding mask: the
    kernels' bias input at ``[b, 1, 1, s]``, no gradient into it."""
    x, g, _ = _inputs(3)
    add = np.where(_pad_mask() != 0, -1e30, 0.0).astype(np.float32)
    kw = dict(mask_additive=True)
    _check(*_run(JM.SelfMultiheadAttn(H, N, **kw),
                 TM.SelfMultiheadAttn(H, N, **kw), dtype, x, g,
                 key_padding_mask=add), dtype)


def test_self_attn_additive_attn_mask_matches_jax():
    """A ``[1, 1, s, s]`` additive attention mask (a causal one)."""
    x, g, _ = _inputs(4)
    causal = np.triu(np.full((S, S), -1e30, np.float32), 1)[None, None]
    _check(*_run(JM.SelfMultiheadAttn(H, N), TM.SelfMultiheadAttn(H, N),
                 "float32", x, g, attn_mask=causal), "float32")


@pytest.mark.parametrize("dtype", list(TOL))
def test_self_attn_norm_add_matches_jax(dtype):
    """``include_norm_add``: the LayerNorm kernels before the projection,
    the residual after it, a key-padding mask."""
    x, g, _ = _inputs(5)
    kw = dict(include_norm_add=True, bias=True)
    _check(*_run(JM.SelfMultiheadAttn(H, N, **kw),
                 TM.SelfMultiheadAttn(H, N, **kw), dtype, x, g,
                 key_padding_mask=_pad_mask()), dtype)


def test_self_attn_attention_dropout_matches_jax():
    """Attention dropout 0.2 on the flash path: the port keyed by the
    seed the JAX package draws from its dropout key gives its keep bits,
    so outputs and gradients agree."""
    x, g, _ = _inputs(6)
    key = jax.random.PRNGKey(11)
    _, k_attn = jax.random.split(key)
    seed = int(jax.random.randint(k_attn, (), -(2 ** 31), 2 ** 31 - 1,
                                  jnp.int32))
    j, t = _run(JM.SelfMultiheadAttn(H, N, dropout=0.2),
                TM.SelfMultiheadAttn(H, N, dropout=0.2), "float32", x, g,
                jkw=dict(dropout_key=key), tkw=dict(dropout_seed=seed))
    _check(j, t, "float32")
    j0, _ = _run(JM.SelfMultiheadAttn(H, N), TM.SelfMultiheadAttn(H, N),
                 "float32", x, g)
    assert float(np.abs(_np(j[0]) - _np(j0[0])).max()) > 1e-3


@pytest.mark.parametrize("dtype", list(TOL))
def test_encdec_attn_matches_jax(dtype):
    """Queries from the decoder (12 positions) over 20 encoder positions
    with a key-padding mask, pre-LayerNorm and residual."""
    x, g, mem = _inputs(7, s=12, sk=20)
    kw = dict(bias=True, include_norm_add=True)
    _check(*_run(JM.EncdecMultiheadAttn(H, N, **kw),
                 TM.EncdecMultiheadAttn(H, N, **kw), dtype, x, g, mem=mem,
                 key_padding_mask=_pad_mask(20)), dtype)


@pytest.mark.parametrize("masked", ["none", "pad", "additive"])
def test_path_without_flash_matches_jax(monkeypatch, masked):
    """Where the card's kernels do not take the head dim, both packages
    run the materialised scores (``mask_softmax_dropout``)."""
    monkeypatch.setattr(jmod, "flash_attention_available",
                        lambda *a, **k: False)
    monkeypatch.setattr(tmod, "flash_attention_available",
                        lambda *a, **k: False)
    calls = {"flash": 0}
    real = tmod.flash_attention

    def spy(*a, **k):
        calls["flash"] += 1
        return real(*a, **k)
    monkeypatch.setattr(tmod, "flash_attention", spy)
    x, g, _ = _inputs(8)
    mask = None
    additive = masked == "additive"
    if masked == "pad":
        mask = _pad_mask()
    elif additive:
        mask = np.where(_pad_mask() != 0, -1e30, 0.0).astype(np.float32)
    kw = dict(bias=True, mask_additive=additive)
    _check(*_run(JM.SelfMultiheadAttn(H, N, **kw),
                 TM.SelfMultiheadAttn(H, N, **kw), "float32", x, g,
                 key_padding_mask=mask), "float32")
    assert calls["flash"] == 0


def test_mask_softmax_dropout_matches_jax():
    rng = np.random.default_rng(9)
    scores = rng.normal(size=(B, N, S, S)).astype(np.float32)
    pad = _pad_mask()
    add = rng.normal(size=(B, N, S, S)).astype(np.float32)
    for mask, additive in ((None, False), (pad, False), (add, True),
                           (np.where(pad != 0, -1e30, 0.0).astype(
                               np.float32), True)):
        want = JM.mask_softmax_dropout(
            jnp.asarray(scores), None if mask is None else jnp.asarray(mask),
            additive)
        got = TM.mask_softmax_dropout(
            torch.from_numpy(scores),
            None if mask is None else torch.from_numpy(mask), additive)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                                   atol=1e-6)


def test_mask_softmax_dropout_draws_from_the_generator():
    """Probability dropout keeps about 1 - p, scales the kept by
    1 / (1 - p), and repeats under the same generator seed."""
    scores = torch.randn(B, N, S, S)
    out = [TM.mask_softmax_dropout(scores, dropout_prob=0.25,
                                   generator=torch.Generator().manual_seed(3))
           for _ in range(2)]
    assert torch.equal(out[0], out[1])
    kept = (out[0] != 0).float().mean()
    assert 0.65 < float(kept) < 0.85
    with pytest.raises(ValueError, match="generator"):
        TM.mask_softmax_dropout(scores, dropout_prob=0.1)


def test_additive_mask_carries_no_gradient():
    """A mask that requires grad gets none, on the flash path and on the
    materialised one."""
    x, _, _ = _inputs(10)
    m = TM.SelfMultiheadAttn(H, N, mask_additive=True)
    params = m.init(torch.Generator().manual_seed(0), device="cpu")
    mask = torch.zeros(B, S).requires_grad_(True)
    out, _ = m(params, torch.from_numpy(x).requires_grad_(True),
               key_padding_mask=mask)
    out.sum().backward()
    assert mask.grad is None


def test_init_shapes_dtypes_and_refusals():
    g = torch.Generator().manual_seed(0)
    m = TM.SelfMultiheadAttn(H, N, bias=True, include_norm_add=True,
                             separate_qkv_params=True)
    params = m.init(g, device="cpu", dtype=torch.bfloat16)
    jparams = JM.SelfMultiheadAttn(
        H, N, bias=True, include_norm_add=True,
        separate_qkv_params=True).init(jax.random.PRNGKey(0))
    assert {k: tuple(v.shape) for k, v in params.items()} == {
        k: tuple(v.shape) for k, v in jparams.items()}
    assert all(v.dtype == torch.bfloat16 for v in params.values())
    e = TM.EncdecMultiheadAttn(H, N, bias=True).init(g, device="cpu")
    assert tuple(e["kv_weight"].shape) == (2 * H, H)
    assert float(e["kv_weight"].abs().max()) <= (
        np.sqrt(1.5) * np.sqrt(6.0 / (3 * H)))
    with pytest.raises(ValueError, match="divisible"):
        TM.SelfMultiheadAttn(30, 4)
    with pytest.raises(ValueError, match="additive mask not supported"):
        TM.SelfMultiheadAttn(H, N, mask_additive=True,
                             include_norm_add=True)
    with pytest.raises(ValueError, match="both defined"):
        m(params, torch.zeros(S, B, H, dtype=torch.bfloat16),
          key_padding_mask=torch.zeros(B, S),
          attn_mask=torch.zeros(1, 1, S, S))
