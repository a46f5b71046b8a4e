"""``contrib.sparsity`` of the port against the JAX package's, on the CPU.

``create_mask`` at ranks 1-4 and ``apply_2_to_4`` on numpy-seeded
weights, normal and integer-valued (many ties), fp32, bf16 and fp16;
``ASP`` over a nested tree of dicts, lists and a named tuple (the same
path strings reach the whitelist, the same leaves are masked) and a
wrapped FusedAdam step; the permutation searches: the swap score map,
``channel_swap_search`` and ``exhaustive_search`` without escapes, with
escapes (drawn from a ``torch.Generator``: another random sequence than
JAX's), ``apply_permutation_C``/``_K``; the refusals.

Tolerances: the masks, ``apply_2_to_4`` and the permutations applied bit
for bit (a 2:4 score is one fp32 addition on both sides; a ranking is a
stable sort); the permutations found without escapes equal; kept
magnitudes and the swap score map within 1e-6 of their largest entry
(sums over rows in orders the frameworks choose); the wrapped step's
params within 1e-6 of their largest entry, its masked entries exactly
zero; with escapes, a valid permutation keeping at least what the search
without escapes keeps; the refusals' messages equal.
"""
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.contrib import sparsity as jsp
from apex_tpu.contrib.sparsity import permutation_search as jps
from apex_tpu.optimizers import FusedAdam as JAdam
from apex_tpu_torch.contrib import sparsity as tsp
from apex_tpu_torch.contrib.sparsity import permutation_search as tps
from apex_tpu_torch.convert import params_from_jax
from apex_tpu_torch.optimizers import FusedAdam as TAdam

DTYPES = ["float32", "bfloat16", "float16"]


def _weights(seed, shape, ties):
    rng = np.random.default_rng(seed)
    if ties:
        return rng.integers(-2, 3, shape).astype(np.float32)
    return rng.standard_normal(shape).astype(np.float32)


def _np(x):
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", [(30,), (12, 20), (8, 12, 3),
                                   (8, 16, 3, 3), (5, 7)])
def test_masks_are_bitwise(shape, dtype, ties):
    w = _weights(0, shape, ties)
    want = jsp.create_mask(jnp.asarray(w).astype(getattr(jnp, dtype)))
    got = tsp.create_mask(torch.from_numpy(w).to(getattr(torch, dtype)))
    assert got.dtype == getattr(torch, dtype) and got.shape == w.shape
    np.testing.assert_array_equal(got.float().numpy(), _np(want))


@pytest.mark.parametrize("ties", [False, True])
def test_apply_2_to_4_is_bitwise(ties):
    w = _weights(1, (16, 24), ties)
    got = tsp.apply_2_to_4(torch.from_numpy(w))
    np.testing.assert_array_equal(got.numpy(), _np(jsp.apply_2_to_4(
        jnp.asarray(w))))
    kept_t = float(tsp.sum_after_2_to_4(torch.from_numpy(w)))
    kept_j = float(jsp.sum_after_2_to_4(jnp.asarray(w)))
    assert abs(kept_t - kept_j) <= 1e-6 * kept_j


class Pair(NamedTuple):
    a: object
    b: object


def _tree(rng):
    return {"embed": rng.standard_normal((16, 8)).astype(np.float32),
            "blocks": [{"w": rng.standard_normal((8, 12)).astype(np.float32),
                        "b": rng.standard_normal(12).astype(np.float32)},
                       {"w": rng.standard_normal((12, 8)).astype(np.float32),
                        "b": rng.standard_normal(8).astype(np.float32)}],
            "conv": rng.standard_normal((8, 4, 3, 3)).astype(np.float32),
            "pair": Pair(rng.standard_normal((4, 8)).astype(np.float32),
                         rng.standard_normal((6, 4)).astype(np.float32))}


def test_asp_whitelist_sees_jax_paths_and_masks_match():
    tree = _tree(np.random.default_rng(2))
    seen = {"jax": [], "torch": []}

    def whitelist(side):
        def pick(path, p):
            seen[side].append(path)
            return p.ndim >= 2 and "embed" not in path
        return pick
    jmasks = jsp.ASP(whitelist=whitelist("jax")).compute_sparse_masks(
        jax.tree_util.tree_map(jnp.asarray, tree))
    tt = {k: v for k, v in params_from_jax(
        {k: v for k, v in tree.items() if k != "pair"}).items()}
    tt["pair"] = Pair(*(torch.from_numpy(a) for a in tree["pair"]))
    tmasks = tsp.ASP(whitelist=whitelist("torch")).compute_sparse_masks(tt)
    assert seen["torch"] == seen["jax"]
    assert "blocks/1/w" in seen["torch"] and "pair/None" in seen["torch"]
    assert isinstance(tmasks["pair"], Pair)
    for got, want in zip(jax.tree_util.tree_leaves(
            {k: list(v) if k == "pair" else v for k, v in tmasks.items()}),
            jax.tree_util.tree_leaves(
                {k: list(v) if k == "pair" else v
                 for k, v in jmasks.items()})):
        np.testing.assert_array_equal(got.numpy(), _np(want))
    assert not tmasks["embed"].eq(0).any()


def test_asp_default_whitelist_and_wrapped_adam_step():
    rng = np.random.default_rng(3)
    tree = {"w": rng.standard_normal((8, 16)).astype(np.float32),
            "odd": rng.standard_normal((8, 6)).astype(np.float32),
            "b": rng.standard_normal(16).astype(np.float32)}
    jp = jax.tree_util.tree_map(jnp.asarray, tree)
    tp = params_from_jax(tree)
    jasp, tasp = jsp.ASP(), tsp.ASP()
    jm, tm = jasp.compute_sparse_masks(jp), tasp.compute_sparse_masks(tp)
    for k in tree:
        np.testing.assert_array_equal(tm[k].numpy(), _np(jm[k]))
    assert float(tm["odd"].min()) == 1.0 and float(tm["b"].min()) == 1.0
    jp, tp = jasp.apply_masks(jp, jm), tasp.apply_masks(tp, tm)
    jopt, topt = JAdam(lr=1e-2, weight_decay=0.01), TAdam(
        lr=1e-2, weight_decay=0.01)
    jstep, tstep = jasp.wrap_step(jopt.step, jm), tasp.wrap_step(
        topt.step, tm)
    js, ts = jopt.init(jp), topt.init(tp)
    for i in range(3):
        g = {k: rng.standard_normal(v.shape).astype(np.float32)
             for k, v in tree.items()}
        jp, js = jstep(jax.tree_util.tree_map(jnp.asarray, g), js, jp)
        tp, ts = tstep(params_from_jax(g), ts, tp)
    for k in tree:
        want = _np(jp[k])
        assert np.abs(tp[k].numpy() - want).max() <= 1e-6 * np.abs(
            want).max()
        assert not tp[k][tm[k] == 0].any()


def test_asp_refusals_match():
    with pytest.raises(NotImplementedError) as j:
        jsp.ASP(allow_permutation=True)
    with pytest.raises(NotImplementedError) as t:
        tsp.ASP(allow_permutation=True)
    assert str(t.value) == str(j.value)
    with pytest.raises(ValueError) as j:
        jsp.create_mask(jnp.zeros((4, 4)), "m8n4")
    with pytest.raises(ValueError) as t:
        tsp.create_mask(torch.zeros(4, 4), "m8n4")
    assert str(t.value) == str(j.value)


def test_swap_score_map_matches():
    m = _weights(4, (12, 16), False)
    jm = jnp.asarray(m)
    tm = torch.from_numpy(m)
    stripes_j = jm.T.reshape(4, 4, 12).transpose(0, 2, 1)
    stripes_t = tm.t().reshape(4, 4, 12).permute(0, 2, 1)
    want = _np(jps._kept_replace(stripes_j, jm))
    got = tps._kept_replace(stripes_t, tm).numpy()
    assert np.abs(got - want).max() <= 1e-6 * np.abs(want).max()
    gain_j, a_j, b_j = jps._best_swap(jm)
    gain_t, a_t, b_t = tps._best_swap(tm)
    assert {int(a_t), int(b_t)} == {int(a_j), int(b_j)}
    assert abs(float(gain_t) - float(gain_j)) <= 1e-6 * float(want.max())


@pytest.mark.parametrize("seed", [5, 6, 7])
def test_channel_swap_search_without_escapes_matches(seed):
    m = _weights(seed, (24, 32), False)
    jperm, jkept = jsp.channel_swap_search(m, max_iters=200)
    tperm, tkept = tsp.channel_swap_search(m, max_iters=200)
    np.testing.assert_array_equal(tperm, jperm)
    assert abs(tkept - jkept) <= 1e-6 * jkept
    w = torch.from_numpy(m)
    np.testing.assert_array_equal(
        tsp.apply_permutation_C(w, tperm).numpy(),
        _np(jsp.apply_permutation_C(jnp.asarray(m), jperm)))
    np.testing.assert_array_equal(
        tsp.apply_permutation_K(w.t(), tperm).numpy(),
        _np(jsp.apply_permutation_K(jnp.asarray(m).T, jperm)))


def test_channel_swap_search_with_escapes_is_valid_and_no_worse():
    m = _weights(8, (16, 24), False)
    _, greedy = tsp.channel_swap_search(m, max_iters=200)
    perm, kept = tsp.channel_swap_search(
        m, max_iters=200, escape_attempts=4,
        key=torch.Generator().manual_seed(0))
    assert sorted(perm.tolist()) == list(range(24))
    assert kept >= greedy
    again = float(tsp.sum_after_2_to_4(torch.from_numpy(m)[:, perm]))
    assert abs(again - kept) <= 1e-6 * kept


@pytest.mark.parametrize("seed", [9, 10])
def test_exhaustive_search_without_escapes_matches(seed):
    m = _weights(seed, (12, 16), False)
    jperm, jkept = jsp.exhaustive_search(m, escape_attempts=0)
    tperm, tkept = tsp.exhaustive_search(m, escape_attempts=0)
    np.testing.assert_array_equal(tperm, jperm)
    assert abs(tkept - jkept) <= 1e-6 * jkept


def test_exhaustive_search_with_escapes_and_a_warm_start():
    m = _weights(11, (16, 16), False)
    pg, kg = tsp.channel_swap_search(m, max_iters=200)
    perm, kept = tsp.exhaustive_search(
        m, escape_attempts=3, key=torch.Generator().manual_seed(1),
        initial_permutation=pg)
    assert sorted(perm.tolist()) == list(range(16))
    assert kept >= kg - 1e-6 * kg
    again = float(tsp.sum_after_2_to_4(torch.from_numpy(m)[:, perm]))
    assert abs(again - kept) <= 1e-6 * kept
    assert tps._canonical_group_perms(8).shape == (35, 8)


@pytest.mark.parametrize("call", [
    lambda sp: sp.exhaustive_search(np.ones((4, 6))),
    lambda sp: sp.exhaustive_search(np.ones((4, 8)), window_size=6),
    lambda sp: sp.exhaustive_search(np.ones((4, 16)), escape_attempts=2),
    lambda sp: sp.channel_swap_search(np.ones((4, 8)), escape_attempts=2),
    lambda sp: sp.apply_2_to_4(np.ones((4, 6), np.float32)),
])
def test_search_refusals_match(call):
    with pytest.raises(ValueError) as j:
        call(jsp)
    with pytest.raises(ValueError) as t:
        call(tsp)
    assert str(t.value) == str(j.value)
