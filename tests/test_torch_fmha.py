"""apex_tpu_torch.contrib.fmha against the JAX package's.

The same numpy-seeded packed ``qkv [total, 3, h, d]`` and ``cu_seqlens``
go through the JAX package's ``fmha_varlen`` / ``FMHA`` (its flash kernel
in Pallas interpret mode on the CPU, segment ids from ``cu_seqlens``) and
through the port on the CPU (the plain versions of the flash kernels),
forward and backward. Mirrors ``tests/test_fmha_openfold.py``'s fmha
part.

Tolerances: fp32 1e-5 (summation order only); bf16 2e-2 and fp16 5e-3
(one rounding of values of order 1, 2^-8 and 2^-11, taken at other
points: the TPU kernel rounds p against the running max of its tile).
Attention dropout is the shared counter hash, so outputs and gradients
under dropout compare at the same tolerances.
"""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.contrib.fmha import FMHA as JFMHA
from apex_tpu.contrib.fmha import fmha_varlen as j_fmha_varlen
from apex_tpu_torch.contrib.fmha import FMHA, fmha_varlen
from apex_tpu_torch.ops.flash_attention import mha_reference_varlen

TOL = {"float32": 1e-5, "bfloat16": 2e-2, "float16": 5e-3}
DTYPES = list(TOL)


def _packed(lens, h=2, d=16, seed=0, pad=0):
    rng = np.random.default_rng(seed)
    total = sum(lens) + pad
    qkv = rng.normal(size=(total, 3, h, d)).astype(np.float32)
    g = rng.normal(size=(total, h, d)).astype(np.float32)
    cu = np.concatenate([[0], np.cumsum(lens)]).astype(np.int32)
    return qkv, g, cu


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _both(qkv, g, cu, dtype, jfn, tfn):
    """(jax out, jax dqkv), (port out, port dqkv) of ``fn(qkv, cu)``."""
    jq = jnp.asarray(qkv, getattr(jnp, dtype))
    jo, vjp = jax.vjp(lambda a: jfn(a, jnp.asarray(cu)), jq)
    (jdq,) = vjp(jnp.asarray(g.reshape(jo.shape), getattr(jnp, dtype)))
    tq = torch.from_numpy(qkv).to(getattr(torch, dtype)).requires_grad_(True)
    to = tfn(tq, torch.from_numpy(cu))
    to.backward(torch.from_numpy(g.reshape(to.shape)).to(to.dtype))
    return (jo, jdq), (to, tq.grad)


def _assert_close(j, t, dtype):
    for want, got in zip(j, t):
        np.testing.assert_allclose(_np(got), _np(want), rtol=TOL[dtype],
                                   atol=TOL[dtype])


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
def test_fmha_varlen_matches_jax(causal, dtype):
    """Three sequences (one ending inside a 16-row tile), forward and the
    packed qkv's gradient."""
    qkv, g, cu = _packed([24, 40, 16])
    j, t = _both(qkv, g, cu, dtype,
                 lambda a, c: j_fmha_varlen(a, c, causal=causal),
                 lambda a, c: fmha_varlen(a, c, causal=causal))
    assert tuple(t[0].shape) == (80, 2, 16) and t[0].dtype == t[1].dtype
    _assert_close(j, t, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fmha_head_dim_48_padded_route_matches_jax(monkeypatch, dtype):
    """At head dim 48 (no kernel of its own) through the CUDA route's pad
    and slice helpers, the plain versions standing in for the kernels at
    head dim 64: the output and the packed qkv's gradient against the JAX
    package's."""
    F = importlib.import_module("apex_tpu_torch.ops.flash_attention")

    seen = []

    def spied(fn):
        def run(q, *a):
            seen.append(q.shape[-1])
            return fn(q, *a)
        return run
    monkeypatch.setattr(F, "_route", lambda *t: True)
    monkeypatch.setattr(F, "_launch_fwd", spied(F._plain_fwd))
    monkeypatch.setattr(F, "_launch_bwd", spied(F._plain_bwd))
    qkv, g, cu = _packed([24, 40, 16], d=48, seed=3)
    j, t = _both(qkv, g, cu, dtype,
                 lambda a, c: j_fmha_varlen(a, c, causal=True),
                 lambda a, c: fmha_varlen(a, c, causal=True))
    assert seen == [64, 64]
    assert tuple(t[0].shape) == (80, 2, 48)
    _assert_close(j, t, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_fmha_module_matches_jax(dtype):
    """The ``[total, hidden]`` module layout, with tokens past
    ``cu_seqlens[-1]`` (one padding segment)."""
    h, d = 4, 16
    qkv, g, cu = _packed([32, 7, 25], h=h, d=d, seed=1, pad=8)
    total = qkv.shape[0]
    jm = JFMHA(hidden_size=h * d, num_attention_heads=h)
    tm = FMHA(hidden_size=h * d, num_attention_heads=h)
    j, t = _both(qkv.reshape(total, 3 * h * d), g, cu, dtype,
                 jm.__call__, tm.__call__)
    assert tuple(t[0].shape) == (total, h * d)
    _assert_close(j, t, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fmha_dropout_matches_jax(dtype):
    """Attention dropout 0.1 keyed by an int seed: the same keep bits in
    both packages, forward and backward."""
    qkv, g, cu = _packed([30, 34], seed=2)
    kw = dict(dropout_seed=3)
    j, t = _both(qkv, g, cu, dtype,
                 lambda a, c: j_fmha_varlen(a, c, 0.1, **kw),
                 lambda a, c: fmha_varlen(a, c, 0.1, **kw))
    _assert_close(j, t, dtype)


def test_fmha_dropout_inference_mode_off():
    """``is_training=False`` turns dropout off, as the reference does;
    training mode with a seed differs from it."""
    qkv, _, cu = _packed([16, 16], seed=3)
    mod = FMHA(hidden_size=32, num_attention_heads=2,
               attention_probs_dropout_prob=0.5)
    flat = torch.from_numpy(qkv.reshape(32, 96))
    cu_t = torch.from_numpy(cu)
    o_eval = mod(flat, cu_t, is_training=False)
    assert torch.equal(o_eval, mod(flat, cu_t, is_training=False))
    o_train = mod(flat, cu_t, is_training=True, dropout_seed=3)
    assert float((o_train - o_eval).abs().max()) > 0.0
    with pytest.raises(ValueError, match="dropout_seed"):
        mod(flat, cu_t, is_training=True)


def test_fmha_matches_per_sequence_reference():
    """The packed attention equals dense attention run per sequence (the
    port's ``mha_reference_varlen``), fp32 2e-5 as the JAX test holds
    it."""
    qkv, _, cu = _packed([24, 40, 16], seed=4)
    t = torch.from_numpy(qkv)
    out = fmha_varlen(t, torch.from_numpy(cu))
    ref = mha_reference_varlen(t[:, 0], t[:, 1], t[:, 2],
                               torch.from_numpy(cu))
    assert float((out - ref).abs().max()) < 2e-5


def test_fmha_bad_qkv_shape():
    with pytest.raises(ValueError, match="total, 3, h, d"):
        fmha_varlen(torch.zeros(8, 2, 2, 4), torch.tensor([0, 8]))


def test_fmha_config_and_geometry():
    class Cfg:
        hidden_size, num_attention_heads = 64, 4
        attention_probs_dropout_prob = 0.1

    mod = FMHA(Cfg())
    assert (mod.h, mod.d, mod.p_dropout) == (4, 16, 0.1)
    with pytest.raises(ValueError, match="hidden size"):
        FMHA(hidden_size=30, num_attention_heads=4)
    with pytest.raises(ValueError, match="need hidden_size"):
        FMHA(hidden_size=32)
