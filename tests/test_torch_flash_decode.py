"""apex_tpu_torch.ops.flash_decode against the JAX package's flash_decode.

The same numpy-seeded inputs go through JAX (its XLA path and its Pallas
kernel in interpret mode, as the JAX tests run it on the CPU) and
through the port on the CPU, where the port runs its plain PyTorch
version. The CUDA kernel itself is held against that plain version on
the card by ``tests/test_torch_cuda.py`` and ``chip_smoke.py``.

Tolerances: fp32 atol/rtol 1e-5 (summation order only); bf16 2e-2 (one
bf16 rounding of outputs of order 1).
"""
import functools
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.ops.flash_decode import flash_decode as jax_flash_decode
from apex_tpu_torch import _build
from apex_tpu_torch.ops.flash_decode import (
    _DECODE_BLOCKS_PER_SM,
    DECODE_MAX_SPLITS,
    DECODE_MIN_SPLIT,
    _decode_split_plain,
    decode_plan,
    flash_decode,
    flash_decode_available,
    paged_decode_reference,
)

# the module (the package re-exports a function of the same name)
fd = importlib.import_module("apex_tpu_torch.ops.flash_decode")

TOL = {"float32": 1e-5, "bfloat16": 2e-2}


def _case(seed=0, P=8, n=4, ps=16, d=16, lens=(0, 5, 16, 33, 48), mp=3):
    rng = np.random.default_rng(seed)
    return dict(
        q=rng.normal(size=(len(lens), n, d)).astype(np.float32),
        k=rng.normal(size=(P, n, ps, d)).astype(np.float32),
        v=rng.normal(size=(P, n, ps, d)).astype(np.float32),
        pt=rng.integers(1, P, size=(len(lens), mp)).astype(np.int32),
        lens=np.asarray(lens, np.int32))


def _torch(c, dtype, q_dtype=None):
    q_dtype = q_dtype or dtype
    return (torch.from_numpy(c["q"]).to(q_dtype),
            torch.from_numpy(c["k"]).to(dtype),
            torch.from_numpy(c["v"]).to(dtype),
            torch.from_numpy(c["pt"]), torch.from_numpy(c["lens"]))


def _jax(c, dtype, q_dtype=None):
    q_dtype = q_dtype or dtype
    return (jnp.asarray(c["q"], q_dtype), jnp.asarray(c["k"], dtype),
            jnp.asarray(c["v"], dtype), jnp.asarray(c["pt"]),
            jnp.asarray(c["lens"]))


@pytest.mark.parametrize("mode", ["xla", "interpret"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_decode_matches_jax(mode, dtype):
    c = _case()
    kw = {"use_kernel": False} if mode == "xla" else {"interpret": True}
    want = np.asarray(
        jax_flash_decode(*_jax(c, getattr(jnp, dtype)), **kw)
        .astype(jnp.float32))
    got = flash_decode(*_torch(c, getattr(torch, dtype)))
    assert got.dtype == getattr(torch, dtype)
    tol = TOL[dtype]
    np.testing.assert_allclose(got.float().numpy(), want, rtol=tol, atol=tol)


def test_flash_decode_chunk_shape_matches_jax():
    """The chunked-prefill flattening: many rows sharing page tables,
    per-row lengths ending mid-page."""
    c = _case(seed=3, P=12, n=2, ps=8, d=32,
              lens=tuple(range(0, 40, 3)), mp=5)
    want = np.asarray(jax_flash_decode(*_jax(c, jnp.float32),
                                       interpret=True))
    got = flash_decode(*_torch(c, torch.float32)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_flash_decode_empty_slot_is_zero():
    c = _case()
    out = flash_decode(*_torch(c, torch.float32))
    assert c["lens"][0] == 0
    assert torch.equal(out[0], torch.zeros_like(out[0]))
    assert out[1:].abs().sum() > 0


def test_flash_decode_garbage_pages_inert():
    """Entries past the length point at real pages or at the garbage
    page: the output is the same bit for bit."""
    c = _case()
    a = flash_decode(*_torch(c, torch.float32))
    pt2 = c["pt"].copy()
    for b, L in enumerate(c["lens"]):
        pt2[b, -(-int(L) // 16):] = 0
    c2 = dict(c, pt=pt2)
    assert torch.equal(a, flash_decode(*_torch(c2, torch.float32)))


def test_flash_decode_mixed_dtype_no_pool_cast():
    """fp32 q over a bf16 pool: output fp32, agrees with JAX's mixed
    path, and the plain version never casts the whole pool."""
    c = _case(seed=5)
    want = np.asarray(jax_flash_decode(*_jax(c, jnp.bfloat16, jnp.float32),
                                       use_kernel=False))
    q, k, v, pt, lens = _torch(c, torch.bfloat16, torch.float32)
    casts = []
    orig = torch.Tensor.float

    def spy(t, *a, **kw):
        casts.append(tuple(t.shape))
        return orig(t, *a, **kw)

    torch.Tensor.float = spy
    try:
        got = flash_decode(q, k, v, pt, lens)
    finally:
        torch.Tensor.float = orig
    assert got.dtype == torch.float32
    assert tuple(k.shape) not in casts, "whole-pool dtype cast"
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_flash_decode_reference_equals_wrapper_on_cpu():
    c = _case(seed=7)
    args = _torch(c, torch.float32)
    assert torch.equal(flash_decode(*args), paged_decode_reference(*args))


def test_flash_decode_shape_validation():
    c = _case()
    q, k, v, pt, lens = _torch(c, torch.float32)
    with pytest.raises(ValueError, match="do not match q"):
        flash_decode(q[:, :2], k, v, pt, lens)
    with pytest.raises(ValueError, match="differ"):
        flash_decode(q, k, v[:-1], pt, lens)
    assert flash_decode_available(16, 64)
    assert not flash_decode_available(12, 64)   # page % 8
    assert not flash_decode_available(16, 512)  # head dim



# ---------------------------------------------------------------------------
# split-K: the kernel splits each slot's token axis and merges the splits in
# split order. Its plain model (`_decode_split_plain`) against the dense
# plain version and JAX's decode (the Pallas kernel in interpret mode), at
# split lengths that end mid-page (page 8) and at whole pages, with empty
# slots and with every split of every slot empty. Tolerances as above: the
# model sums in another order (fp32 1e-5) and rounds once to bf16.
# ---------------------------------------------------------------------------

SPLIT_LENS = {"ragged": (0, 5, 16, 33, 48), "empty_slots": (0, 19, 0, 40, 0),
              "all_empty": (0, 0, 0, 0, 0)}


@functools.lru_cache(maxsize=None)
def _split_case(lens_name, dtype):
    c = _case(seed=11, P=24, n=3, ps=8, d=16, lens=SPLIT_LENS[lens_name],
              mp=6)
    want = np.asarray(jax_flash_decode(*_jax(c, getattr(jnp, dtype)),
                                       interpret=True).astype(jnp.float32))
    return c, want


@pytest.mark.parametrize("split_len", [3, 8, 13, 20, 48])
@pytest.mark.parametrize("lens_name", list(SPLIT_LENS))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_split_model_matches_jax_and_plain(dtype, lens_name,
                                                  split_len):
    c, want = _split_case(lens_name, dtype)
    q, k, v, pt, lens = _torch(c, getattr(torch, dtype))
    got = _decode_split_plain(q, k, v, pt, lens, 16 ** -0.5, split_len)
    plain = paged_decode_reference(q, k, v, pt, lens)
    assert got.dtype == q.dtype
    tol = TOL[dtype]
    np.testing.assert_allclose(got.float().numpy(), want, rtol=tol, atol=tol)
    np.testing.assert_allclose(got.float().numpy(), plain.float().numpy(),
                               rtol=tol, atol=tol)
    empty = lens == 0
    assert torch.equal(got[empty], torch.zeros_like(got[empty]))


@pytest.mark.parametrize("n_slots,n_heads,page_size,pages_per_seq,n_sms", [
    (8, 16, 8, 32, 132),     # the 345M decode step
    (64, 16, 8, 32, 132),    # its chunk step: the pairs fill the card
    (8, 16, 8, 128, 132),    # 8 slots at the 345M's whole context
    (64, 16, 8, 128, 132),
    (1, 1, 8, 1, 132),       # one page: one split
    (2, 4, 16, 3, 132),
    (1, 2, 8, 1000, 8),
    (3, 5, 24, 7, 1),
    (4, 4, 8, 0, 132)])      # no page a slot
def test_decode_plan_covers_every_token_once(n_slots, n_heads, page_size,
                                             pages_per_seq, n_sms):
    """The split planner: whole pages a split, every token of the longest
    context in exactly one split, no split starting past it, splits of at
    least ``DECODE_MIN_SPLIT`` tokens where the context allows, at most
    ``DECODE_MAX_SPLITS`` (a thread block cluster), and no more blocks
    than about ``_DECODE_BLOCKS_PER_SM`` an SM need."""
    plan = decode_plan(n_slots, n_heads, page_size, pages_per_seq, n_sms)
    t_max = page_size * pages_per_seq
    assert 1 <= plan.splits <= DECODE_MAX_SPLITS
    assert plan.split_len % page_size == 0
    owner = [t // plan.split_len for t in range(t_max)]
    assert all(0 <= s < plan.splits for s in owner)
    assert sorted(set(owner)) == list(range(plan.splits)) or t_max == 0
    assert (plan.splits - 1) * plan.split_len < max(t_max, 1)
    if plan.splits > 1:
        assert plan.split_len >= DECODE_MIN_SPLIT
        assert n_slots * n_heads * (plan.splits - 1) < \
            _DECODE_BLOCKS_PER_SM * n_sms


@pytest.mark.parametrize("pages_per_seq,splits", [(32, 4), (8, 1)])
def test_decode_launch_hands_the_plan_to_the_kernel(monkeypatch,
                                                    pages_per_seq, splits):
    """On the kernel route the wrapper passes the planned split count and
    length — checked with the library replaced by a recorder."""
    calls = []

    class FakeLib:
        def apex_flash_decode(self, *args):
            calls.append(args)
            return 0

    monkeypatch.setattr(_build, "kernels", FakeLib)
    monkeypatch.setattr(_build, "current_stream", lambda dev: 0)
    monkeypatch.setattr(_build, "sm_count", lambda index: 132)
    c = _case(P=300, n=16, ps=8, d=64, lens=(1,) * 8, mp=pages_per_seq)
    fd._launch(*_torch(c, torch.bfloat16), 0.125)
    (args,) = calls
    assert args[6:13] == (8, 16, 64, 8, pages_per_seq, splits,
                          pages_per_seq * 8 // splits)
