"""``gpt_model_provider`` and its ``cpu_offload`` against the JAX
package's, and the port's GPT scaling study.

A 2-layer GPT (hidden 64, 4 heads, seq 32, vocab 128) from the JAX
provider's weights (``params_from_jax``), fed the same numpy-seeded
tokens: the loss and every gradient of the port's provider, with and
without ``cpu_offload``, against the JAX provider's with the same flag
(its flash kernels in interpret mode). Tolerances: the GPT parity of
``test_torch_training.py``, fp32 loss rtol 1e-5 and each gradient leaf
within 1e-5 of its largest entry.

On the port, the offload only moves the tensors autograd saves (to host
memory through ``torch.autograd.graph.save_on_cpu``): the loss and the
gradients with it equal those without it bit for bit, and the saved
tensors really went through its hooks (counted).

``gpt_scaling_test --device cpu --layers 1 2 --steps 1`` prints the two
parse-compatible lines for each of its four runs and writes its JSON.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.transformer.testing import GPTConfig as JaxGPTConfig
from apex_tpu.transformer.testing import gpt_model_provider as jax_provider
from apex_tpu_torch._tree import tree_leaves, value_and_grad
from apex_tpu_torch.convert import params_from_jax
from apex_tpu_torch.examples.gpt import gpt_scaling_test
from apex_tpu_torch.transformer.testing import GPTConfig, gpt_model_provider

SHAPE = dict(num_layers=2, hidden_size=64, num_attention_heads=4,
             vocab_size=128, max_position_embeddings=32, hidden_dropout=0.0,
             attention_dropout=0.0)


def _tokens(seed=0):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, 128, size=(2, 32)).astype(np.int32)
    return tokens, np.roll(tokens, -1, axis=1)


def _close_leaves(jtree, ttree, tol):
    jl, tl = jax.tree_util.tree_leaves(jtree), tree_leaves(ttree)
    assert len(jl) == len(tl)
    for a, b in zip(jl, tl):
        a = np.asarray(jnp.asarray(a).astype(jnp.float32))
        b = b.float().numpy()
        assert np.abs(a - b).max() <= tol * np.abs(a).max(), (
            np.abs(a - b).max(), np.abs(a).max())


def _port(cpu_offload, jparams=None, seed=0):
    params, fwd, loss = gpt_model_provider(
        GPTConfig(**SHAPE), torch.Generator().manual_seed(seed),
        cpu_offload=cpu_offload, device="cpu")
    if jparams is not None:
        params = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams))
    return params, fwd, loss


@pytest.mark.parametrize("cpu_offload", [False, True])
def test_provider_loss_and_grads_match_jax(cpu_offload):
    jcfg = JaxGPTConfig(**SHAPE, use_flash_attention=True)
    jparams, jfwd, jloss = jax_provider(jcfg, jax.random.PRNGKey(0),
                                        cpu_offload=cpu_offload)
    tokens, labels = _tokens()
    jl, jg = jax.value_and_grad(lambda p: jloss(
        p, jnp.asarray(tokens), jnp.asarray(labels)))(jparams)
    params, fwd, loss = _port(cpu_offload, jparams)
    tl, tg = value_and_grad(lambda p: loss(
        p, torch.from_numpy(tokens), torch.from_numpy(labels)), params)
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    _close_leaves(jg, tg, 1e-5)
    # the forward gives the JAX forward's logits
    jlogits = jfwd(jparams, jnp.asarray(tokens))
    tlogits = fwd(params, torch.from_numpy(tokens))
    np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits),
                               rtol=1e-5, atol=1e-5)


def test_offload_is_bit_for_bit_and_goes_through_the_hooks(monkeypatch):
    packed = []
    real = torch.autograd.graph.save_on_cpu

    class Counting(real):
        def __init__(self, pin_memory=False, device_type="cuda"):
            super().__init__(pin_memory=pin_memory, device_type=device_type)
            pack, unpack = self.pack_hook, self.unpack_hook

            def counted(t):
                packed.append(tuple(t.shape))
                return pack(t)

            torch.autograd.graph.saved_tensors_hooks.__init__(
                self, counted, unpack)

    monkeypatch.setattr(torch.autograd.graph, "save_on_cpu", Counting)
    tokens, labels = _tokens(1)
    out = []
    for off in (False, True):
        params, fwd, loss = _port(off, seed=3)
        out.append(value_and_grad(lambda p: loss(
            p, torch.from_numpy(tokens), torch.from_numpy(labels)), params))
        if not off:
            assert packed == []
    assert len(packed) > 20  # every layer's saved activations
    (l0, g0), (l1, g1) = out
    assert torch.equal(l0, l1)
    for a, b in zip(tree_leaves(g0), tree_leaves(g1)):
        assert torch.equal(a, b)
    _, fwd_off, _ = _port(True, seed=3)
    params, fwd_on, _ = _port(False, seed=3)
    assert torch.equal(fwd_off(params, torch.from_numpy(tokens)),
                       fwd_on(params, torch.from_numpy(tokens)))


def test_provider_places_params_and_takes_pipeline_flags():
    params, _, _ = gpt_model_provider(
        GPTConfig(**SHAPE), torch.Generator().manual_seed(0),
        pre_process=False, post_process=False, device="cpu")
    assert all(p.device.type == "cpu" for p in tree_leaves(params))
    assert sum(p.numel() for p in tree_leaves(params)) == sum(
        int(np.prod(p.shape)) for p in jax.tree_util.tree_leaves(
            jax_provider(JaxGPTConfig(**SHAPE), jax.random.PRNGKey(0))[0]))


def test_scaling_study_cli_on_cpu(tmp_path, capsys):
    out = tmp_path / "gpt_scaling.json"
    results = gpt_scaling_test.main([
        "--device", "cpu", "--layers", "1", "2", "--steps", "1",
        "--hidden", "64", "--heads", "4", "--seq", "32", "--vocab", "128",
        "--batch", "2", "--out", str(out)])
    text = capsys.readouterr().out
    lines = text.splitlines()
    assert sum(l.startswith("Number of Parameters: ") for l in lines) == 4
    assert sum(l.startswith("Average Iteration Time: ") and
               l.endswith(" s") for l in lines) == 4
    assert [(r["layers"], r["cpu_offload"]) for r in results] == [
        (1, False), (1, True), (2, False), (2, True)]
    data = json.loads(out.read_text())
    assert len(data["results"]) == 4 and data["config"]["offload"] == "both"
    # offload changes no arithmetic: equal final losses per size
    assert results[0]["final_loss"] == results[1]["final_loss"]
    assert results[2]["final_loss"] == results[3]["final_loss"]
    assert results[0]["n_params"] < results[2]["n_params"]


def test_scaling_study_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        gpt_scaling_test.main(["--layers", "1", "--steps", "1"])
