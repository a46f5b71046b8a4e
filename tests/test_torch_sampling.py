"""apex_tpu_torch carried sampling against the JAX package's.

The hash counter must be bit-exact (it keys every sampled token), and
``sample_tokens`` must return identical tokens for identical logits:
greedy, temperature, top-k, top-p, their mix, and a row whose filter
thresholds lie beyond the top-64 prefix (the deep-sort branch).
Tolerance: none — tokens and hash bits are compared exactly.
"""
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.serving import sampling as jsamp
from apex_tpu_torch.serving import sampling as tsamp

# the modules (each package's ``ops`` re-exports a function of this name)
jfa = importlib.import_module("apex_tpu.ops.flash_attention")
tfa = importlib.import_module("apex_tpu_torch.ops.flash_attention")

I32 = np.iinfo(np.int32)


def _ints(rng, size):
    x = rng.integers(I32.min, I32.max, size=size, dtype=np.int64,
                     endpoint=True).astype(np.int32)
    flat = x.reshape(-1)
    extremes = np.asarray([I32.min, I32.max, -1, 0, 1, I32.min + 1],
                          np.int32)
    flat[:extremes.size] = extremes
    return x


def test_i32_constant_patterns():
    for v in (0x9E3779B1, 0x85EBCA77, 0x27D4EB2F, 0x80000000, 0x7FFFFFFF,
              0, 0xFFFFFFFF):
        assert tfa._i32(v) == int(jfa._i32(v))


def test_shr_logical_bit_exact():
    x = _ints(np.random.default_rng(0), 4096)
    for n in (1, 8, 13, 16, 31):
        want = np.asarray(jfa._shr_logical(jnp.asarray(x), n))
        got = tfa._shr_logical(torch.from_numpy(x), n).numpy()
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_hash_keep_bits_bit_exact(seed):
    """Random int32 keys over the whole range, negative values and the
    extremes included, broadcast the way the sampler calls it."""
    rng = np.random.default_rng(seed)
    s = _ints(rng, (64, 1))
    bh = _ints(rng, (64, 1))
    qi = _ints(rng, (64, 1))
    ki = _ints(rng, (1, 257))
    want = np.asarray(jfa._hash_keep_bits(*map(jnp.asarray, (s, bh, qi, ki))))
    got = tfa._hash_keep_bits(*map(torch.from_numpy, (s, bh, qi, ki)))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_uniform_from_hash_bit_exact():
    rng = np.random.default_rng(3)
    seeds, rids, pos = (_ints(rng, (8, 1)) for _ in range(3))
    idx = np.arange(1000, dtype=np.int32)[None, :]
    want = np.asarray(jsamp.uniform_from_hash(
        *map(jnp.asarray, (seeds, rids, pos, idx))))
    got = tsamp.uniform_from_hash(
        *map(torch.from_numpy, (seeds, rids, pos, idx))).numpy()
    np.testing.assert_array_equal(got, want)
    assert (got > 0).all() and (got < 1).all()


def test_i32_wrap_matches():
    for v in (0, 1, -1, 2 ** 31, 2 ** 31 - 1, 2 ** 40 + 5, -(2 ** 33) - 7):
        assert tsamp.i32_wrap(v) == jsamp.i32_wrap(v)


# rows: greedy, temperature only, top-k, top-p, top-k + top-p, a
# top-p near 1 on a flat row (thresholds beyond the 64-wide prefix ->
# the deep-sort branch), top-k beyond the prefix
POLICIES = [(0.0, 0, 1.0), (0.8, 0, 1.0), (1.1, 20, 1.0), (0.9, 0, 0.7),
            (0.7, 12, 0.9), (1.0, 0, 0.999), (1.3, 200, 1.0)]


def _batch(seed, V=512):
    rng = np.random.default_rng(seed)
    R = len(POLICIES)
    logits = (rng.normal(size=(R, V)) * 2.0).astype(np.float32)
    logits[5] = (rng.normal(size=V) * 0.01).astype(np.float32)  # flat row
    temps = np.asarray([p[0] for p in POLICIES], np.float32)
    top_ks = np.asarray([p[1] for p in POLICIES], np.int32)
    top_ps = np.asarray([p[2] for p in POLICIES], np.float32)
    seeds = rng.integers(-2 ** 31, 2 ** 31, size=R).astype(np.int32)
    rids = rng.integers(0, 1000, size=R).astype(np.int32)
    pos = rng.integers(0, 4096, size=R).astype(np.int32)
    return logits, temps, top_ks, top_ps, seeds, rids, pos


@pytest.mark.parametrize("seed", range(4))
def test_sample_tokens_identical(seed):
    args = _batch(seed)
    want = np.asarray(jsamp.sample_tokens(*map(jnp.asarray, args)))
    got = tsamp.sample_tokens(*map(torch.from_numpy, args))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_deep_sort_branch_taken():
    """The flat top-p row's thresholds lie beyond the prefix: the
    prefilter leaves it uncovered, so the full sort runs."""
    logits, temps, top_ks, top_ps = (torch.from_numpy(a)
                                     for a in _batch(0)[:4])
    scaled = logits / temps.clamp(min=1e-6)[:, None]
    _, _, covered = tsamp._thresholds(
        torch.topk(scaled, tsamp.TOP_FILTER_WIDTH).values, scaled, top_ks,
        top_ps)
    assert not bool(covered[5]) and not bool(covered[6])
    assert bool(covered[:5].all())
    want = np.asarray(jsamp._filtered_logits(
        *map(jnp.asarray, (logits.numpy(), temps.numpy(), top_ks.numpy(),
                           top_ps.numpy()))))
    got = tsamp._filtered_logits(logits, temps, top_ks, top_ps).numpy()
    np.testing.assert_array_equal(np.isfinite(got), np.isfinite(want))


@pytest.mark.parametrize("seed", range(3))
def test_sort_path_decides_tokens_like_jax(seed):
    """Every sampled row's top-p reaches past the TOP_FILTER_WIDTH prefix
    (flat rows, top-p 0.99): the full sort's thresholds decide what each
    keeps (more tokens than the prefix holds), and the sampled tokens
    equal the JAX sampler's, which takes its sort under lax.cond."""
    rng = np.random.default_rng(100 + seed)
    R, V = 4, 512
    logits = (rng.normal(size=(R, V)) * 0.02).astype(np.float32)
    temps = np.asarray([0.0, 0.8, 1.0, 1.2], np.float32)
    top_ks = np.zeros(R, np.int32)
    top_ps = np.full(R, 0.99, np.float32)
    seeds = rng.integers(-2 ** 31, 2 ** 31, size=R).astype(np.int32)
    rids = rng.integers(0, 1000, size=R).astype(np.int32)
    pos = rng.integers(0, 4096, size=R).astype(np.int32)
    args = (logits, temps, top_ks, top_ps, seeds, rids, pos)
    allowed = tsamp._filtered_logits(*map(torch.from_numpy, args[:4]))
    kept = torch.isfinite(allowed).sum(dim=-1)
    assert bool((kept[1:] > tsamp.TOP_FILTER_WIDTH).all())
    want = np.asarray(jsamp.sample_tokens(*map(jnp.asarray, args)))
    got = tsamp.sample_tokens(*map(torch.from_numpy, args))
    np.testing.assert_array_equal(got.numpy(), want)


def test_greedy_rows_and_host_flag():
    args = list(_batch(1))
    args[1] = np.zeros_like(args[1])  # all greedy
    t = [torch.from_numpy(a) for a in args]
    want = np.argmax(args[0], axis=-1)
    np.testing.assert_array_equal(
        tsamp.sample_tokens(*t).numpy(), want)
    np.testing.assert_array_equal(
        tsamp.sample_tokens(*t, any_sampled=False).numpy(), want)


def test_sampling_params_validation():
    with pytest.raises(ValueError):
        tsamp.SamplingParams(temperature=-0.1)
    with pytest.raises(ValueError):
        tsamp.SamplingParams(top_p=0.0)
    with pytest.raises(ValueError):
        tsamp.SamplingParams(top_k=-1)
    assert tsamp.resolve(None) is tsamp.GREEDY
