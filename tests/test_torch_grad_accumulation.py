"""fp32 ``main_grad`` accumulation against the JAX package's
(``tests/test_grad_accumulation.py``): the weight-gradient GEMM
accumulating into an fp32 buffer (``addmm_`` in place), the
half-buffer form, and the loop over microbatches with bf16 compute and
fp32 accumulation.

Inputs are numpy-seeded and cast to bf16 on both sides. Tolerances: the
GEMM forms against numpy in fp64 within 1e-5 (fp32 accumulation of bf16
products) and against the JAX ones within 1e-5; the loop against the
JAX loop within the JAX test's bound for bf16 gradients that round
differently (``n_micro`` ulps of bf16 of the largest entry), and
against its own sum of per-microbatch gradients exactly (the same
computation in the same order).
"""
import gc
import weakref

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.transformer.tensor_parallel import (
    accumulate_main_grads as jaccumulate,
    wgrad_gemm_accum_fp16 as jwgrad16,
    wgrad_gemm_accum_fp32 as jwgrad32,
)
from apex_tpu_torch._tree import value_and_grad
from apex_tpu_torch.transformer.tensor_parallel import (
    accumulate_main_grads,
    init_main_grads,
    wgrad_gemm_accum_fp16,
    wgrad_gemm_accum_fp32,
)

BF16_ULP = 0.0079


def _bf16(a):
    return torch.from_numpy(np.asarray(a, np.float32)).to(torch.bfloat16)


def test_wgrad_gemm_accum_fp32_matches_jax_and_accumulates():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(6, 4, 16)).astype(np.float32)
    dy = rng.normal(size=(6, 4, 8)).astype(np.float32)
    tx, tdy = _bf16(x), _bf16(dy)
    main = torch.full((8, 16), 0.5)
    out = wgrad_gemm_accum_fp32(tx, tdy, main)
    assert out is main and out.dtype == torch.float32
    xf = tx.float().numpy().reshape(-1, 16).astype(np.float64)
    dyf = tdy.float().numpy().reshape(-1, 8).astype(np.float64)
    ref = 0.5 + dyf.T @ xf
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-5, atol=1e-5)
    want = jwgrad32(jnp.asarray(x, jnp.bfloat16),
                    jnp.asarray(dy, jnp.bfloat16),
                    jnp.full((8, 16), 0.5, jnp.float32))
    np.testing.assert_allclose(out.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    out2 = wgrad_gemm_accum_fp32(tx, tdy, out)
    np.testing.assert_allclose(out2.numpy(), 2 * ref - 0.5, rtol=1e-5,
                               atol=1e-5)


def test_wgrad_gemm_accum_fp16_keeps_buffer_dtype():
    rng = np.random.default_rng(1)
    x = rng.normal(size=(4, 16)).astype(np.float32)
    dy = rng.normal(size=(4, 8)).astype(np.float32)
    main = torch.zeros((8, 16), dtype=torch.bfloat16)
    out = wgrad_gemm_accum_fp16(_bf16(x), _bf16(dy), main)
    assert out is main and out.dtype == torch.bfloat16
    want = jwgrad16(jnp.asarray(x, jnp.bfloat16),
                    jnp.asarray(dy, jnp.bfloat16),
                    jnp.zeros((8, 16), jnp.bfloat16))
    np.testing.assert_array_equal(out.float().numpy(),
                                  np.asarray(want, np.float32))


def _setup(n_micro=32, mbs=4, h=16):
    rng = np.random.default_rng(2)
    w1 = (rng.normal(size=(h, h)) * 0.5).astype(np.float32)
    w2 = (rng.normal(size=(h, h)) * 0.5).astype(np.float32)
    xs = rng.normal(size=(n_micro, mbs, h)).astype(np.float32)
    ys = rng.normal(size=(n_micro, mbs, h)).astype(np.float32)
    tparams = {"w1": _bf16(w1), "w2": _bf16(w2)}
    jparams = {"w1": jnp.asarray(w1, jnp.bfloat16),
               "w2": jnp.asarray(w2, jnp.bfloat16)}
    return (tparams, (_bf16(xs), torch.from_numpy(ys)),
            jparams, (jnp.asarray(xs, jnp.bfloat16), jnp.asarray(ys)))


def _micro_grad_fn(params, micro):
    """One microbatch's bf16 gradients of a small bf16 MLP."""
    x, y = micro

    def loss(p):
        h = torch.tanh(x @ p["w1"].to(x.dtype))
        return torch.mean(((h @ p["w2"].to(x.dtype)).float() - y) ** 2)

    return value_and_grad(loss, params)[1]


def _jax_micro_grad_fn(params, micro):
    x, y = micro

    def loss(p):
        h = jnp.tanh(x @ p["w1"].astype(x.dtype))
        out = h @ p["w2"].astype(x.dtype)
        return jnp.mean((out.astype(jnp.float32) - y) ** 2)

    return jax.grad(loss)(params)


def test_accumulate_matches_summed_grads_and_jax():
    tparams, tmicro, jparams, jmicro = _setup()
    acc = accumulate_main_grads(_micro_grad_fn, tparams, tmicro)
    summed = init_main_grads(tparams)
    for i in range(tmicro[0].shape[0]):
        g = _micro_grad_fn(tparams, (tmicro[0][i], tmicro[1][i]))
        for k in summed:
            summed[k] += g[k].float()
    want = jaccumulate(_jax_micro_grad_fn, jparams, jmicro)
    for k in tparams:
        assert acc[k].dtype == torch.float32
        torch.testing.assert_close(acc[k], summed[k], rtol=0, atol=0)
        tol = 32 * BF16_ULP * float(np.abs(np.asarray(want[k])).max())
        np.testing.assert_allclose(acc[k].numpy(), np.asarray(want[k]),
                                   atol=tol, err_msg=k)


def test_fp32_accumulation_beats_bf16_accumulation():
    tparams, (xs, ys), _, _ = _setup(n_micro=64)
    acc32 = accumulate_main_grads(_micro_grad_fn, tparams, (xs, ys))
    acc16 = {k: torch.zeros_like(v) for k, v in tparams.items()}
    exact = {k: torch.zeros(v.shape, dtype=torch.float64)
             for k, v in tparams.items()}
    for i in range(xs.shape[0]):
        g = _micro_grad_fn(tparams, (xs[i], ys[i]))
        for k in tparams:
            acc16[k] = (acc16[k] + g[k]).to(torch.bfloat16)
            exact[k] += g[k].double()
    for k in tparams:
        err32 = float((acc32[k].double() - exact[k]).abs().max())
        err16 = float((acc16[k].double() - exact[k]).abs().max())
        assert err32 < err16, (k, err32, err16)


def test_fp32_buffer_dtype_enforced():
    x = torch.zeros((4, 8), dtype=torch.bfloat16)
    dy = torch.zeros((4, 6), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="fp32 main_grad"):
        wgrad_gemm_accum_fp32(x, dy, torch.zeros((6, 8),
                                                 dtype=torch.bfloat16))
    tparams, micro, _, _ = _setup(n_micro=2)
    with pytest.raises(ValueError, match="fp32"):
        accumulate_main_grads(
            _micro_grad_fn, tparams, micro,
            main_grads={k: torch.zeros_like(v) for k, v in tparams.items()})


def test_accumulate_continues_existing_buffer():
    tparams, micro, _, _ = _setup(n_micro=8)
    first = accumulate_main_grads(_micro_grad_fn, tparams, micro)
    snapshot = {k: v.clone() for k, v in first.items()}
    resumed = accumulate_main_grads(_micro_grad_fn, tparams, micro,
                                    main_grads=first)
    assert resumed is first  # in place
    for k in tparams:
        torch.testing.assert_close(resumed[k], 2 * snapshot[k], rtol=1e-5,
                                   atol=1e-5)


def test_one_microbatch_of_gradients_alive_at_a_time():
    """The memory contract of the JAX scan: each microbatch's gradients
    are consumed (added into the buffers and dropped) before the next
    microbatch's are computed."""
    tparams, micro, _, _ = _setup(n_micro=16)
    alive = []

    def grad_fn(params, m):
        gc.collect()
        assert all(r() is None for r in alive), "an earlier grad is alive"
        g = _micro_grad_fn(params, m)
        alive.extend(weakref.ref(t) for t in g.values())
        return g

    accumulate_main_grads(grad_fn, tparams, micro)
    assert len(alive) == 2 * 16
