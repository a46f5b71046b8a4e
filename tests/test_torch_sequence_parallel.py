"""Sequence parallelism across ranks: the GPT with
``sequence_parallel=True`` in a gloo world of 4 against the JAX
package's under ``jax.shard_map(check_vma=True)`` (the mirror of
``tests/test_sequence_parallel.py``), at TP 4 and TP 2, fused and
unfused, with recompute.

One gloo world of 4 CPU processes is spawned once for the file
(``test_torch_tensor_parallel.spawn_world``). Every rank shards the same
numpy-seeded weights and runs the same tokens; the JAX side runs them
over 2 or 4 of conftest's CPU devices. Held: the loss within
``rtol=2e-4`` on every rank and every gradient within ``atol=5e-4``,
shard for shard, the replicated ones included (the norms, ``proj_b``,
``fc2_b``, the position embedding: each rank sees only its sequence
rows, and the copy into the tensor region sums their gradients); the
loss under sequence parallelism equal to plain tensor parallelism's
within 1e-5; the two backwards of ``gather_from_sequence_parallel_region``
(the JAX test's three cases); and the dropout streams' structure
(without sequence parallelism every rank draws the embedding's mask
alike, with it each rank its own).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import PartitionSpec as P

from apex_tpu.transformer import tensor_parallel as jtp
from apex_tpu_torch.transformer.testing import GPTConfig

from test_torch_tensor_parallel import (
    ARR as _TP_ARR,
    GPT,
    WORKER_PRELUDE,
    WORLD,
    _jax_gpt,
    check_gpt,
    smap,
    spawn_world,
)

#: (label, tp, GPTConfig keywords): every one with sequence parallelism
CASES = (
    ("sp4", 4, {}),
    ("sp4_fused_sel", 4, {"fused_block": True,
                          "recompute_granularity": "selective_elementwise"}),
    ("sp2_fused", 2, {"fused_block": True}),
    ("sp2_full", 2, {"recompute_granularity": "full"}),
)

_WORKER = WORKER_PRELUDE + r"""
from apex_tpu_torch.transformer.testing import standalone_transformer_lm as slm

ps.initialize_model_parallel(4)
r = ps.get_tensor_model_parallel_rank()
tokens, labels = T("tokens").long(), T("labels").long()
for sp in (False, True):
    cfg = GPTConfig(**spec["gpt"], tensor_model_parallel_size=4,
                    sequence_parallel=sp)
    shard = shard_gpt_params(tree("params"), cfg, r, 4)
    res[f"tp_vs_sp/{sp}"] = np.array(float(gpt_loss(
        cfg, shard, tokens, labels, axis_name="tensor")))

# the gather's two backwards (the JAX test's cases)
x = T("seq_x").chunk(4)[r].clone().requires_grad_(True)
full = tp.gather_from_sequence_parallel_region(x, "tensor", False)
(full * full).sum().backward()
res["dual/false"] = np32(x.grad)
x.grad = None
full = tp.gather_from_sequence_parallel_region(x, "tensor", True)
(full * full).sum().backward()
res["dual/true"] = np32(x.grad)
x.grad = None
w = T("seq_w").chunk(4)[r]
full = tp.gather_from_sequence_parallel_region(x, "tensor", True)
wf = tp.gather_from_sequence_parallel_region(w, "tensor", True).detach()
((full * wf).sum() / 4).backward()
res["dual/varying"] = np32(x.grad)

# the dropout streams: the embedding's mask on every rank
masks = []
orig = slm._dropout
def spy(x, rate, seed, deterministic):
    y = orig(x, rate, seed, deterministic)
    if not masks:
        masks.append(y == 0)
    return y
slm._dropout = spy
for sp in (False, True):
    masks.clear()
    cfg = GPTConfig(**dict(spec["gpt"], hidden_dropout=0.5),
                    tensor_model_parallel_size=4, sequence_parallel=sp)
    shard = shard_gpt_params(tree("params"), cfg, r, 4)
    loss = gpt_loss(cfg, shard, tokens, labels, axis_name="tensor",
                    generator=torch.Generator().manual_seed(11),
                    deterministic=False)
    res[f"dropout/{sp}/mask"] = masks[0].numpy()
    res[f"dropout/{sp}/loss"] = np.array(float(loss))
slm._dropout = orig

for label, tpn, kw in spec["cases"]:
    if tpn == 4:
        gpt_case(label, 4, dict(kw, sequence_parallel=True))
ps.destroy_model_parallel()
ps.initialize_model_parallel(2)
for label, tpn, kw in spec["cases"]:
    if tpn == 2:
        gpt_case(label, 2, dict(kw, sequence_parallel=True))
ps.destroy_model_parallel()
dist.destroy_process_group()
np.savez(f"{out}/rank{rank}.npz", **res)
"""


def _inputs():
    rng = np.random.default_rng(19)
    out = {k: v for k, v in _TP_ARR.items()
           if k.startswith("params/") or k in ("tokens", "labels")}
    out["seq_x"] = rng.normal(size=(WORLD * 2, 3)).astype(np.float32)
    out["seq_w"] = rng.normal(size=(WORLD * 2, 3)).astype(np.float32)
    return out


ARR = _inputs()


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    return spawn_world(tmp_path_factory.mktemp("gloo_sp"), _WORKER, ARR,
                       {"gpt": GPT, "cases": [list(c) for c in CASES]})


@pytest.mark.parametrize("label,tpn,kw", CASES, ids=[c[0] for c in CASES])
def test_gpt_sp_matches_jax(world, label, tpn, kw):
    loss, grads = _jax_gpt(tpn, sequence_parallel=True, **kw)
    check_gpt(world, label, tpn, loss, grads,
              GPTConfig(**GPT, tensor_model_parallel_size=tpn))


def test_gpt_sp_equals_tp_without_sp(world):
    for r in range(WORLD):
        np.testing.assert_allclose(float(world[r]["tp_vs_sp/True"]),
                                   float(world[r]["tp_vs_sp/False"]),
                                   rtol=1e-5)


def test_gather_seq_backward_duality_matches_jax(world):
    x, w = jnp.asarray(ARR["seq_x"]), jnp.asarray(ARR["seq_w"])

    def with_flag(flag):
        def loss(xl):
            full = jtp.gather_from_sequence_parallel_region(xl, "tensor",
                                                            flag)
            return jnp.sum(full * full)
        return smap(jax.grad(loss), P("tensor", None), P("tensor", None),
                    check_vma=False)(x)

    def varying(xl, wl):
        full = jtp.gather_from_sequence_parallel_region(xl, "tensor", True)
        return jnp.sum(full * jax.lax.all_gather(wl, "tensor", axis=0,
                                                 tiled=True)) / WORLD

    g_var = smap(jax.grad(varying), (P("tensor", None), P("tensor", None)),
                 P("tensor", None), check_vma=False)(x, w)
    for key, want in (("false", with_flag(False)), ("true", with_flag(True)),
                      ("varying", g_var)):
        got = np.concatenate([world[r]["dual/" + key] for r in range(WORLD)])
        np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5,
                                   err_msg=key)
    # the replicated consumer: the split passes 2x through, the
    # reduce-scatter counts the world's copies; the varying one gives w
    np.testing.assert_allclose(
        np.concatenate([world[r]["dual/false"] for r in range(WORLD)]),
        2 * ARR["seq_x"], rtol=1e-6)
    np.testing.assert_allclose(
        np.concatenate([world[r]["dual/true"] for r in range(WORLD)]),
        2 * WORLD * ARR["seq_x"], rtol=1e-6)
    np.testing.assert_allclose(
        np.concatenate([world[r]["dual/varying"] for r in range(WORLD)]),
        ARR["seq_w"], rtol=1e-5)


def test_dropout_streams(world):
    """Without sequence parallelism the embedding's activations are
    replicated and every rank drops the same elements; with it each rank
    holds its own rows and draws its own mask (the generator forked by
    rank, as the JAX package folds the rank into its key). The loss is the
    same on every rank either way."""
    base = world[0]["dropout/False/mask"]
    assert 0.3 < base.mean() < 0.7
    for r in range(1, WORLD):
        np.testing.assert_array_equal(world[r]["dropout/False/mask"], base)
    sp = [world[r]["dropout/True/mask"] for r in range(WORLD)]
    assert sp[0].shape[0] * WORLD == base.shape[0]
    assert len({m.tobytes() for m in sp}) == WORLD
    for sp_on in ("False", "True"):
        losses = {float(world[r][f"dropout/{sp_on}/loss"])
                  for r in range(WORLD)}
        assert len(losses) == 1 and np.isfinite(losses.pop())
