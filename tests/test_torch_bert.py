"""The port's BERT path against the JAX package's, on the CPU: the
encoder, its loss, the cross entropy the bench trains it with, the
global gradient norm and FusedLAMB.

A 2-layer BERT (hidden 64, 4 heads, seq 16, vocab 128) built from the
same JAX weights (``params_from_jax``) and fed the same numpy-seeded
tokens, padding and labels:
- ``bert_forward`` LM and binary logits with a padding mask, without
  flash (the masked fused softmax) and with flash (the key mask);
- tokens in the padded positions do not reach the real ones;
- ``bert_model_provider``'s loss and every gradient;
- the same in bf16 at seq 128, where both dispatchers take the masked
  fused softmax (the port's autograd Function over the plain versions
  of kernels #15 and #16, counted), with and without ``selective``
  recompute;
- ``softmax_cross_entropy_loss`` with label smoothing and a padding
  index, losses and logit gradients;
- ``multi_tensor_l2norm``, global and per tensor;
- 5 ``FusedLAMB`` steps on the same gradients under each option set,
  ``found_inf`` skipping a step, and what is not ported refused (the
  packed path is held by ``test_torch_packed_lamb.py``).

Tolerances: fp32 logits and loss rtol 1e-5 (atol 1e-5 on logits of
order 1); every gradient leaf within 1e-5 of its largest entry; the
cross entropy rtol/atol 1e-6; norms rtol 1e-6; LAMB params and moments
over 5 steps rtol 1e-5, atol 1e-6 (per-leaf norms and the trust ratio
are summed in another order); bf16 params of the master-weights case
within one bf16 rounding (rtol 8e-3); the bf16 BERT loss rtol 1e-3 and
each gradient leaf within 5e-2 of its largest entry (bf16 rounds at
other places in the two frameworks).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.contrib.xentropy import (
    softmax_cross_entropy_loss as jax_xent,
)
from apex_tpu.ops.multi_tensor import multi_tensor_l2norm as jax_l2norm
from apex_tpu.optimizers import FusedLAMB as JaxFusedLAMB
from apex_tpu.transformer.testing import GPTConfig as JaxGPTConfig
from apex_tpu.transformer.testing.standalone_bert import (
    bert_model_provider as jax_bert_provider,
)
from apex_tpu_torch._tree import tree_leaves, tree_map, value_and_grad
from apex_tpu_torch.contrib.xentropy import (
    SoftmaxCrossEntropyLoss,
    softmax_cross_entropy_loss,
)
from apex_tpu_torch.convert import params_from_jax
from apex_tpu_torch.ops.multi_tensor import l2norm, multi_tensor_l2norm
from apex_tpu_torch.optimizers import (
    FusedLAMB,
    FusedMixedPrecisionLamb,
    FusedSGD,
)
from apex_tpu_torch.transformer.testing import (
    GPTConfig,
    bert_forward,
    bert_model_provider,
)
from test_torch_training import _count_softmax_route, _sharpen_attention

SHAPE = dict(num_layers=2, hidden_size=64, num_attention_heads=4,
             vocab_size=128, max_position_embeddings=16, hidden_dropout=0.0,
             attention_dropout=0.0, add_binary_head=True)
B, S = 2, 16


def _setup(seed, flash):
    jcfg = JaxGPTConfig(**SHAPE, use_flash_attention=flash)
    tcfg = GPTConfig(**SHAPE, use_flash_attention=flash)
    jparams, jfwd, jloss = jax_bert_provider(jcfg, jax.random.PRNGKey(seed))
    tparams = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams))
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, 128, size=(B, S)).astype(np.int32)
    padding = np.ones((B, S), np.int32)
    padding[0, 11:] = 0
    padding[1, 5:] = 0
    return jcfg, tcfg, jparams, jfwd, jloss, tparams, tokens, padding


def _t(a):
    return torch.from_numpy(np.asarray(a))


@pytest.mark.parametrize("flash", [False, True])
def test_bert_forward_matches_jax(flash):
    _, tcfg, jp, jfwd, _, tp, tokens, padding = _setup(0, flash)
    jlm, jbin = jfwd(jp, jnp.asarray(tokens), jnp.asarray(padding))
    tlm, tbin = bert_forward(tcfg, tp, _t(tokens), _t(padding))
    assert tlm.shape == (B, S, 128) and tlm.dtype == torch.float32
    assert tbin.shape == (B, 2)
    np.testing.assert_allclose(tlm.numpy(), np.asarray(jlm), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(tbin.numpy(), np.asarray(jbin), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("flash", [False, True])
def test_padded_tokens_do_not_leak(flash):
    """The JAX package's check (``test_standalone_models.py``): changing
    the tokens of padded positions leaves the real positions' logits."""
    _, tcfg, _, _, _, tp, tokens, padding = _setup(1, flash)
    a, _ = bert_forward(tcfg, tp, _t(tokens), _t(padding))
    tokens2 = np.where(padding == 0, 7, tokens)
    b, _ = bert_forward(tcfg, tp, _t(tokens2), _t(padding))
    for i, n in enumerate(padding.sum(1)):
        torch.testing.assert_close(a[i, :n], b[i, :n], atol=1e-5, rtol=0)


def test_bert_loss_and_every_grad_match_jax():
    _, tcfg, jp, _, jloss, tp, tokens, padding = _setup(2, False)
    rng = np.random.default_rng(2)
    labels = rng.integers(0, 128, size=(B, S)).astype(np.int32)
    binary = np.array([0, 1], np.int32)
    jl, jg = jax.value_and_grad(lambda p: jloss(
        p, jnp.asarray(tokens), jnp.asarray(labels), jnp.asarray(padding),
        padding_mask=jnp.asarray(padding),
        binary_labels=jnp.asarray(binary)))(jp)
    _, _, tloss = bert_model_provider(tcfg, torch.Generator().manual_seed(0))
    tl, tg = value_and_grad(lambda p: tloss(
        p, _t(tokens), _t(labels), _t(padding), padding_mask=_t(padding),
        binary_labels=_t(binary)), tp)
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    jleaves = jax.tree_util.tree_leaves(jg)
    assert len(jleaves) == len(tree_leaves(tg))
    for a, b in zip(jleaves, tree_leaves(tg)):
        a = np.asarray(a)
        assert np.abs(a - b.numpy()).max() <= 1e-5 * np.abs(a).max()


@pytest.mark.parametrize("rg", [None, "selective"])
def test_bert_bf16_masked_fused_softmax_matches_jax(rg, monkeypatch):
    """bf16 compute over fp32 params at seq 128 under a padding mask: the
    int8 ``[b, 1, 1, s]`` mask reaches the masked fused softmax in both
    packages; ``selective`` replays its forward once per layer. The MLM
    loss alone, as the bench trains BERT: the binary head's gradients sum
    two bf16 rows, too few for the 5e-2 bound (its fp32 gradients are
    held above)."""
    shape = dict(SHAPE, max_position_embeddings=128)
    jcfg = JaxGPTConfig(**shape, compute_dtype=jnp.bfloat16,
                        use_flash_attention=False, recompute_granularity=rg)
    tcfg = GPTConfig(**shape, compute_dtype=torch.bfloat16,
                     use_flash_attention=False, recompute_granularity=rg)
    jp, _, jloss = jax_bert_provider(jcfg, jax.random.PRNGKey(7))
    jp = _sharpen_attention(jp)
    tp = params_from_jax(jax.tree_util.tree_map(np.asarray, jp))
    rng = np.random.default_rng(7)
    tokens, labels = (rng.integers(0, 128, size=(B, 128)).astype(np.int32)
                      for _ in range(2))
    padding = np.ones((B, 128), np.int32)
    padding[0, 90:] = 0
    padding[1, 40:] = 0
    jl, jg = jax.value_and_grad(lambda p: jloss(
        p, jnp.asarray(tokens), jnp.asarray(labels), jnp.asarray(padding),
        padding_mask=jnp.asarray(padding)))(jp)
    _, _, tloss = bert_model_provider(tcfg, torch.Generator().manual_seed(0))
    counts = _count_softmax_route(monkeypatch)
    tl, tg = value_and_grad(lambda p: tloss(
        p, _t(tokens), _t(labels), _t(padding), padding_mask=_t(padding)),
        tp)
    layers = SHAPE["num_layers"]
    assert counts == {
        "softmax_fwd_reference": 0,
        "softmax_masked_fwd_reference": layers * (2 if rg else 1),
        "softmax_bwd_reference": layers, "forward_softmax": 0}
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-3)
    for a, b in zip(jax.tree_util.tree_leaves(jg), tree_leaves(tg)):
        a = np.asarray(a, np.float32)
        assert np.abs(a - b.float().numpy()).max() <= 5e-2 * np.abs(a).max()


@pytest.mark.parametrize("smoothing,padding_idx", [(0.0, -1), (0.1, 0),
                                                   (0.2, 3)])
def test_softmax_cross_entropy_matches_jax(smoothing, padding_idx):
    rng = np.random.default_rng(3)
    logits = (rng.normal(size=(24, 40)) * 2).astype(np.float32)
    labels = rng.integers(0, 40, size=24).astype(np.int32)
    labels[::5] = padding_idx
    g = rng.normal(size=24).astype(np.float32)
    jl, vjp = jax.vjp(lambda x: jax_xent(x, jnp.asarray(labels), smoothing,
                                         padding_idx), jnp.asarray(logits))
    (jdx,) = vjp(jnp.asarray(g))
    tx = _t(logits).requires_grad_(True)
    tl = softmax_cross_entropy_loss(tx, _t(labels), smoothing, padding_idx)
    tl.backward(_t(g))
    assert tl.dtype == torch.float32
    np.testing.assert_allclose(tl.detach().numpy(), np.asarray(jl),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jdx), rtol=1e-6,
                               atol=1e-6)
    assert float(tl.detach()[::5].abs().max()) == 0.0
    assert float(tx.grad[::5].abs().max()) == 0.0
    torch.testing.assert_close(
        SoftmaxCrossEntropyLoss.apply(tx, _t(labels), smoothing,
                                      padding_idx), tl)


def test_multi_tensor_l2norm_matches_jax():
    rng = np.random.default_rng(4)
    tree = {"a": rng.normal(size=(3, 5)).astype(np.float32),
            "b": [rng.normal(size=7).astype(np.float32),
                  rng.normal(size=(2, 2, 2)).astype(np.float32)]}
    jn, jper = jax_l2norm(jax.tree_util.tree_map(jnp.asarray, tree),
                          per_tensor=True)
    tn, tper = multi_tensor_l2norm(tree_map(_t, tree), per_tensor=True)
    np.testing.assert_allclose(float(tn), float(jn), rtol=1e-6)
    np.testing.assert_allclose(tper.numpy(), np.asarray(jper), rtol=1e-6)
    assert float(l2norm(tree_map(_t, tree))) == float(tn)
    zero, none = multi_tensor_l2norm({})
    assert float(zero) == 0.0 and none is None


LAMB_CASES = {
    "default": dict(),
    "master_weights": dict(master_weights=True),
    "nvlamb": dict(use_nvlamb=True),
    "no_weight_decay": dict(weight_decay=0.0),
    "l2_not_adam_w": dict(adam_w_mode=False),
    "clip_norm_0.05": dict(max_grad_norm=0.05),
    "no_clip": dict(max_grad_norm=0.0),
    "no_bias_correction_no_averaging": dict(bias_correction=False,
                                            grad_averaging=False),
}


def _lamb_tree(rng, dtype=np.float32):
    return {"w": (rng.normal(size=(8, 6)) * 0.5).astype(dtype),
            "b": np.zeros(6, dtype),
            "layers": {"k": (rng.normal(size=(2, 5, 3)) * 0.2).astype(dtype)}}


@pytest.mark.parametrize("case", list(LAMB_CASES))
def test_five_lamb_steps_match_jax(case):
    kw = dict(lr=1e-2, **LAMB_CASES[case])
    rng = np.random.default_rng(5)
    p0 = _lamb_tree(rng)
    grads = [_lamb_tree(rng) for _ in range(5)]
    bf16 = case == "master_weights"
    jopt, topt = JaxFusedLAMB(**kw), FusedLAMB(**kw)
    jp = jax.tree_util.tree_map(
        lambda a: jnp.asarray(a, jnp.bfloat16 if bf16 else jnp.float32), p0)
    tp = tree_map(lambda a: _t(a).to(torch.bfloat16 if bf16
                                     else torch.float32), p0)
    js, ts = jopt.init(jp), topt.init(tp)
    for g in grads:
        jp, js = jopt.step(jax.tree_util.tree_map(jnp.asarray, g), js, jp)
        tp, ts = topt.step(tree_map(_t, g), ts, tp)
    pairs = [(js.exp_avg, ts.exp_avg), (js.exp_avg_sq, ts.exp_avg_sq)]
    if bf16:
        pairs.append((js.master_params, ts.master_params))
    else:
        pairs.append((jp, tp))
    for jt, tt in pairs:
        for a, b in zip(jax.tree_util.tree_leaves(jt), tree_leaves(tt)):
            np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-5,
                                       atol=1e-6)
    for a, b in zip(jax.tree_util.tree_leaves(jp), tree_leaves(tp)):
        assert b.dtype == (torch.bfloat16 if bf16 else torch.float32)
        np.testing.assert_allclose(b.float().numpy(),
                                   np.asarray(a.astype(jnp.float32)),
                                   rtol=8e-3 if bf16 else 1e-5, atol=1e-6)
    assert int(ts.step) == int(js.step) == 5


def test_lamb_found_inf_skips_the_step():
    """A set ``found_inf`` leaves params and state as they were, in both
    packages; an unset one steps as without it; ``grad_scale`` unscales."""
    rng = np.random.default_rng(6)
    p0, g = _lamb_tree(rng), _lamb_tree(rng)
    topt = FusedMixedPrecisionLamb(lr=1e-2)
    tp = tree_map(_t, p0)
    ts = topt.init(tp)
    sp, ss = topt.step(tree_map(_t, g), ts, tp,
                       found_inf=torch.tensor(True))
    for a, b in zip(tree_leaves(tp), tree_leaves(sp)):
        assert torch.equal(a, b)
    assert int(ss.step) == 0
    jopt = JaxFusedLAMB(lr=1e-2, master_weights=True)
    jp = jax.tree_util.tree_map(jnp.asarray, p0)
    jnp_, _ = jopt.step(jax.tree_util.tree_map(jnp.asarray, g),
                        jopt.init(jp), jp, found_inf=jnp.asarray(False),
                        grad_scale=4.0)
    tnp, _ = topt.step(tree_map(lambda a: _t(a) * 4.0, g), ts, tp,
                       found_inf=torch.tensor(False), grad_scale=4.0)
    for a, b in zip(jax.tree_util.tree_leaves(jnp_), tree_leaves(tnp)):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-5,
                                   atol=1e-6)


def test_lamb_refuses_what_is_not_ported():
    # FusedSGD adopts a GradBuckets layout since A6.2; a layout without
    # the packed state is still refused, as the JAX package refuses it
    with pytest.raises(ValueError, match="packed_spec requires packed"):
        FusedSGD(lr=0.1, packed_spec=object())
    with pytest.raises(RuntimeError, match="AMSGrad"):
        FusedLAMB(amsgrad=True)


def test_bert_without_binary_head_has_no_pooler():
    cfg = dataclasses.replace(GPTConfig(**SHAPE), add_binary_head=False)
    params, fwd, _ = bert_model_provider(cfg, torch.Generator().manual_seed(0))
    assert "binary_head" not in params
    lm, binary = fwd(params, torch.zeros(1, 8, dtype=torch.long))
    assert binary is None and lm.shape == (1, 8, 128)
