"""The port's train step against the JAX package's, on the CPU.

A 2-layer GPT (hidden 64, 4 heads, seq 32, vocab 128) built from the
same JAX weights (``params_from_jax``) and fed the same numpy-seeded
tokens: ``gpt_loss`` and every gradient against
``jax.value_and_grad(gpt_loss)`` with ``use_flash_attention=True`` (the
Pallas kernels in interpret mode), the chunked LM-head cross entropy in
both variants, 5 packed-Adam steps along the JAX loss curve, a bf16 O2
run, and the ``"full"`` recompute.

Tolerances: fp32 loss rtol 1e-5, each gradient leaf within 1e-5 of its
largest entry, the 5-step loss curve rtol 1e-5 and the masters atol
1e-4 (Adam moves an element whose gradient sits at the rounding level
by up to lr either way); bf16 O2: loss rtol 1e-3 and each gradient leaf
within 5e-2 of its largest entry (bf16 rounds at other places in the
two frameworks); recompute "full" equals no recompute exactly.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.contrib.xentropy import lm_head_cross_entropy as jax_lm_ce
from apex_tpu.optimizers import FusedAdam as JaxFusedAdam
from apex_tpu.transformer.enums import AttnMaskType as JaxMask
from apex_tpu.transformer.testing import GPTConfig as JaxGPTConfig
from apex_tpu.transformer.testing import gpt_loss as jax_gpt_loss
from apex_tpu.transformer.testing import init_gpt_params as jax_init
from apex_tpu.transformer.testing.standalone_transformer_lm import (
    transformer_layer as jax_transformer_layer,
)
from apex_tpu_torch._tree import tree_leaves, value_and_grad
from apex_tpu_torch.contrib.xentropy import lm_head_cross_entropy
from apex_tpu_torch.convert import params_from_jax
from apex_tpu_torch.optimizers import FusedAdam
from apex_tpu_torch.transformer.enums import AttnMaskType
from apex_tpu_torch.transformer.testing import (
    GPTConfig,
    gpt_loss,
    transformer_layer,
)

SHAPE = dict(num_layers=2, hidden_size=64, num_attention_heads=4,
             vocab_size=128, max_position_embeddings=32, hidden_dropout=0.0,
             attention_dropout=0.0)


def _setup(seed=0, **kw):
    jcfg = JaxGPTConfig(**SHAPE, use_flash_attention=True, **{
        k: (getattr(jnp, v) if k == "compute_dtype" else v)
        for k, v in kw.items()})
    tcfg = GPTConfig(**SHAPE, **{
        k: (getattr(torch, v) if k == "compute_dtype" else v)
        for k, v in kw.items()})
    jp = jax_init(jcfg, jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, 128, size=(2, 32)).astype(np.int32)
    labels = np.roll(tokens, -1, axis=1)
    return jcfg, tcfg, jp, tokens, labels


def _jax_vg(cfg, params, tokens, labels):
    return jax.value_and_grad(lambda p: jax_gpt_loss(
        cfg, p, jnp.asarray(tokens), jnp.asarray(labels)))(params)


def _torch_vg(cfg, params, tokens, labels, **kw):
    return value_and_grad(lambda p: gpt_loss(
        cfg, p, torch.from_numpy(tokens), torch.from_numpy(labels), **kw),
        params)


def _close_leaves(jtree, ttree, tol):
    for a, b in zip(jax.tree_util.tree_leaves(jtree), tree_leaves(ttree)):
        a = np.asarray(jnp.asarray(a).astype(jnp.float32))
        b = b.float().numpy()
        assert np.abs(a - b).max() <= tol * np.abs(a).max(), (
            np.abs(a - b).max(), np.abs(a).max())


def test_gpt_loss_and_every_grad_match_jax():
    jcfg, tcfg, jp, tokens, labels = _setup()
    jl, jg = _jax_vg(jcfg, jp, tokens, labels)
    tp = params_from_jax(jax.tree_util.tree_map(np.asarray, jp))
    tl, tg = _torch_vg(tcfg, tp, tokens, labels)
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    _close_leaves(jg, tg, 1e-5)


def test_bf16_o2_loss_and_grads_match_jax():
    """bf16 compute over bf16 params with saved bf16 CE logits (the
    bench's configuration)."""
    jcfg, tcfg, jp, tokens, labels = _setup(
        1, compute_dtype="bfloat16", ce_save_logits=True)
    jp = jax.tree_util.tree_map(lambda x: x.astype(jnp.bfloat16), jp)
    tp = params_from_jax(jax.tree_util.tree_map(np.asarray, jp),
                         dtype=torch.bfloat16)
    jl, jg = _jax_vg(jcfg, jp, tokens, labels)
    tl, tg = _torch_vg(tcfg, tp, tokens, labels)
    assert all(g.dtype == torch.bfloat16 for g in tree_leaves(tg))
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-3)
    _close_leaves(jg, tg, 5e-2)


@pytest.mark.parametrize("saved", [None, "bfloat16", "float32"])
def test_lm_head_cross_entropy_matches_jax(saved):
    """Both variants, losses and d(hidden), d(weight): fp32 rtol/atol
    1e-5; the saved-bf16 variant computes the CE of bf16 logits in both
    packages, compared at 1e-4."""
    rng = np.random.default_rng(2)
    h = rng.normal(size=(64, 32)).astype(np.float32)
    w = (rng.normal(size=(96, 32)) * 0.1).astype(np.float32)
    lab = rng.integers(0, 96, size=64).astype(np.int32)
    g = rng.normal(size=64).astype(np.float32)
    jdt = None if saved is None else getattr(jnp, saved)
    tdt = None if saved is None else getattr(torch, saved)
    jl, vjp = jax.vjp(lambda a, b: jax_lm_ce(
        a, b, jnp.asarray(lab), chunk_size=16, save_logits_dtype=jdt),
        jnp.asarray(h), jnp.asarray(w))
    jdh, jdw = vjp(jnp.asarray(g))
    th, tw = (torch.from_numpy(a).requires_grad_(True) for a in (h, w))
    tl = lm_head_cross_entropy(th, tw, torch.from_numpy(lab), chunk_size=16,
                               save_logits_dtype=tdt)
    tl.backward(torch.from_numpy(g))
    tol = 1e-4 if saved == "bfloat16" else 1e-5
    for got, want in ((tl, jl), (th.grad, jdh), (tw.grad, jdw)):
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                   rtol=tol, atol=tol)
    with pytest.raises(ValueError, match="divisible"):
        lm_head_cross_entropy(th, tw, torch.from_numpy(lab), chunk_size=24)


def test_five_packed_adam_steps_track_the_jax_loss_curve():
    jcfg, tcfg, jp, tokens, labels = _setup(3)
    tp = params_from_jax(jax.tree_util.tree_map(np.asarray, jp))
    kw = dict(lr=1e-3, master_weights=True, packed=True)
    jopt, topt = JaxFusedAdam(**kw), FusedAdam(**kw)
    js, ts = jopt.init(jp), topt.init(tp)
    jcurve, tcurve = [], []
    for _ in range(5):
        jl, jg = _jax_vg(jcfg, jp, tokens, labels)
        tl, tg = _torch_vg(tcfg, tp, tokens, labels)
        jp, js = jopt.step(jg, js, jp)
        tp, ts = topt.step(tg, ts, tp)
        jcurve.append(float(jl))
        tcurve.append(float(tl))
    np.testing.assert_allclose(tcurve, jcurve, rtol=1e-5)
    assert tcurve[-1] < tcurve[0]
    np.testing.assert_allclose(ts.master_params.numpy(),
                               np.asarray(js.master_params), atol=1e-4)


def test_full_recompute_gives_the_same_gradients():
    _, tcfg, jp, tokens, labels = _setup(4)
    tp = params_from_jax(jax.tree_util.tree_map(np.asarray, jp))
    remat = dataclasses.replace(tcfg, recompute_granularity="full")
    l0, g0 = _torch_vg(tcfg, tp, tokens, labels)
    l1, g1 = _torch_vg(remat, tp, tokens, labels)
    assert float(l0) == float(l1)
    for a, b in zip(tree_leaves(g0), tree_leaves(g1)):
        assert torch.equal(a, b)


def test_dropout_is_seeded_and_survives_recompute():
    """With dropout on, the same generator seed gives the same loss and
    gradients with and without recompute; another seed differs."""
    _, tcfg, jp, tokens, labels = _setup(5)
    tcfg = dataclasses.replace(tcfg, hidden_dropout=0.1,
                               attention_dropout=0.1)
    tp = params_from_jax(jax.tree_util.tree_map(np.asarray, jp))
    remat = dataclasses.replace(tcfg, recompute_granularity="full")

    def run(cfg, seed):
        return _torch_vg(cfg, tp, tokens, labels, deterministic=False,
                         generator=torch.Generator().manual_seed(seed))
    l0, g0 = run(tcfg, 1)
    l1, g1 = run(remat, 1)
    l2, _ = run(tcfg, 2)
    l3, _ = _torch_vg(tcfg, tp, tokens, labels)  # deterministic: none
    assert float(l0) == float(l1) and float(l0) != float(l2)
    assert float(l3) != float(l0)
    for a, b in zip(tree_leaves(g0), tree_leaves(g1)):
        assert torch.equal(a, b)


def test_padding_mask_layer_matches_jax():
    """A non-causal layer with a key-padding mask ([b, 1, 1, s], nonzero
    = masked) takes the flash path with kv_mask in both packages."""
    jcfg, tcfg, jp, _, _ = _setup(6)
    jcfg = dataclasses.replace(jcfg, attn_mask_type=JaxMask.padding)
    tcfg = dataclasses.replace(tcfg, attn_mask_type=AttnMaskType.padding)
    rng = np.random.default_rng(6)
    hidden = rng.normal(size=(32, 2, 64)).astype(np.float32)
    mask = np.zeros((2, 1, 1, 32), np.int8)
    mask[0, ..., 20:] = 1
    jlp = {k: v[0] for k, v in jp["layers"].items()}
    want = jax_transformer_layer(jcfg, jlp, jnp.asarray(hidden),
                                 jnp.asarray(mask), None, None, True)
    tlp = {k: torch.from_numpy(np.array(v)) for k, v in jlp.items()}
    got = transformer_layer(tcfg, tlp, torch.from_numpy(hidden),
                            torch.from_numpy(mask), None, True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def test_paths_not_ported_are_refused():
    _, tcfg, jp, tokens, labels = _setup(7)
    tp = params_from_jax(jax.tree_util.tree_map(np.asarray, jp))
    t, lab = torch.from_numpy(tokens), torch.from_numpy(labels)
    for bad, err in ((dict(use_flash_attention=False), NotImplementedError),
                     (dict(recompute_granularity="selective"),
                      NotImplementedError),
                     (dict(attn_mask_type=AttnMaskType.padding),
                      NotImplementedError),
                     (dict(recompute_granularity="bogus"), ValueError)):
        with pytest.raises(err):
            gpt_loss(dataclasses.replace(tcfg, **bad), tp, t, lab)
    with pytest.raises(ValueError, match="max_position_embeddings"):
        gpt_loss(tcfg, tp, torch.zeros(1, 64, dtype=torch.long),
                 torch.zeros(1, 64, dtype=torch.long))
