"""The port's fused scale-mask-softmax against the JAX package's, on the
CPU.

The same numpy-seeded scores (and masks, and output gradients) go
through the three JAX functions with ``interpret=True`` (the Pallas
kernels under the interpreter, as ``tests/test_transformer_functional.py``
runs them) and through the port, whose CPU route is the kernels' plain
versions: forward and VJP, fp32 and bf16, causal, masked with a
``[b, 1, 1, sk]`` padding mask and with a ``[b, 1, sq, sk]`` mask that
masks one row fully, unmasked, scale 1 and 0.5. Then the dispatcher
``FusedScaleMaskSoftmax``: the same ``is_kernel_available`` decision as
JAX over a grid of dtype flag x sq x sk x mask type, the same output on
the ``forward_softmax`` route (fp32 input, a ``mask_func``), and the
same ``get_batch_per_block``.

Tolerances: fp32 atol 1e-6, rtol 1e-5 (the exp and the row sum are
taken in another order); bf16 atol 4e-3, rtol 1e-2 (both compute in
fp32 and round once; two roundings of values up to 1 may land one bf16
ulp, 2^-8, apart).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.transformer.enums import AttnMaskType as JaxMask
from apex_tpu.transformer.functional import (
    FusedScaleMaskSoftmax as JaxFSMS,
    scaled_masked_softmax as jax_masked,
    scaled_softmax as jax_plain,
    scaled_upper_triang_masked_softmax as jax_causal,
)
from apex_tpu_torch import _device
from apex_tpu_torch.transformer.enums import AttnMaskType
from apex_tpu_torch.transformer.functional import (
    FusedScaleMaskSoftmax,
    generic_scaled_masked_softmax,
    scaled_masked_softmax,
    scaled_softmax,
    scaled_upper_triang_masked_softmax,
)
from apex_tpu_torch.transformer.functional.fused_softmax import (
    softmax_bwd,
    softmax_fwd,
    softmax_masked_fwd,
)

B, NP, SQ, SK = 2, 3, 8, 128
TOL = {"float32": dict(atol=1e-6, rtol=1e-5),
       "bfloat16": dict(atol=4e-3, rtol=1e-2)}


def _arrays(seed, shape, dtype):
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=shape) * 3).astype(np.float32)
    dy = rng.normal(size=shape).astype(np.float32)
    jx, jdy = (jnp.asarray(a).astype(getattr(jnp, dtype)) for a in (x, dy))
    tx, tdy = (torch.from_numpy(a).to(getattr(torch, dtype)) for a in (x, dy))
    return jx, jdy, tx, tdy


def _masks(kind):
    """A numpy int8 mask, nonzero = masked out: a ``[b, 1, 1, sk]``
    padding mask, or a general ``[b, 1, sq, sk]`` one."""
    rng = np.random.default_rng(11)
    if kind == "padding":
        m = np.zeros((B, 1, 1, SK), np.int8)
        m[0, ..., 100:] = 1
        m[1, ..., 37:] = 1
    else:  # general [b, 1, sq, sk], one row masked fully
        m = (rng.uniform(size=(B, 1, SQ, SK)) > 0.7).astype(np.int8)
        m[1, 0, 3, :] = 1
    return m


def _compare(got, want, dtype):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               **TOL[dtype])


def _run_both(jfn, tfn, jx, jdy, tx, tdy):
    jy, vjp = jax.vjp(jfn, jx)
    (jdx,) = vjp(jdy)
    tx = tx.clone().requires_grad_(True)
    ty = tfn(tx)
    ty.backward(tdy)
    return (ty, jy), (tx.grad, jdx)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("scale", [1.0, 0.5])
def test_causal_matches_jax(dtype, scale):
    jx, jdy, tx, tdy = _arrays(0, (B, NP, SK, SK), dtype)
    (ty, jy), (tdx, jdx) = _run_both(
        lambda x: jax_causal(x, scale, True),
        lambda x: scaled_upper_triang_masked_softmax(x, scale),
        jx, jdy, tx, tdy)
    assert ty.dtype == tx.dtype and tdx.dtype == tx.dtype
    _compare(ty, jy, dtype)
    _compare(tdx, jdx, dtype)
    # above the diagonal: exactly 0 (exp(-10000 - max) underflows)
    assert bool((ty.float().triu(1) == 0).all())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", ["padding", "general"])
@pytest.mark.parametrize("scale", [1.0, 0.5])
def test_masked_matches_jax(dtype, kind, scale):
    jx, jdy, tx, tdy = _arrays(1, (B, NP, SQ, SK), dtype)
    m = _masks(kind)
    (ty, jy), (tdx, jdx) = _run_both(
        lambda x: jax_masked(x, jnp.asarray(m), scale, True),
        lambda x: scaled_masked_softmax(x, torch.from_numpy(m), scale),
        jx, jdy, tx, tdy)
    _compare(ty, jy, dtype)
    _compare(tdx, jdx, dtype)
    if kind == "general":
        # the fully masked row is the uniform 1/sk, as on the TPU
        np.testing.assert_allclose(ty[1, :, 3].detach().float().numpy(),
                                   1.0 / SK, **TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("scale", [1.0, 0.5])
def test_unmasked_matches_jax(dtype, scale):
    jx, jdy, tx, tdy = _arrays(2, (B, NP, SQ, SK), dtype)
    (ty, jy), (tdx, jdx) = _run_both(
        lambda x: jax_plain(x, scale, True),
        lambda x: scaled_softmax(x, scale), jx, jdy, tx, tdy)
    _compare(ty, jy, dtype)
    _compare(tdx, jdx, dtype)


def test_generic_matches_the_masked_function():
    """The generic (any shape) softmax computes the same function."""
    _, _, tx, _ = _arrays(3, (B, NP, SQ, 40), "float32")
    m = torch.zeros(B, 1, SQ, 40, dtype=torch.int8)
    m[..., 30:] = 1
    y = generic_scaled_masked_softmax(tx, m, 0.5)
    torch.testing.assert_close(y, scaled_masked_softmax(tx, m, 0.5))
    torch.testing.assert_close(y.sum(-1), torch.ones(B, NP, SQ))


def test_cpu_tensors_take_the_plain_versions():
    """CPU tensors launch nothing; the wrappers return the plain
    versions' results."""
    _, _, tx, tdy = _arrays(4, (B, NP, SK, SK), "float32")
    _device.reset_launch_counts()
    y = softmax_fwd(tx, 0.5, True)
    ym = softmax_masked_fwd(tx, torch.zeros(B, 1, 1, SK, dtype=torch.bool))
    softmax_bwd(tdy, y, 0.5)
    assert not any(_device.launch_counts().values())
    torch.testing.assert_close(ym, torch.softmax(tx, -1))


# ---------------------------------------------------------------------------
# the dispatcher
# ---------------------------------------------------------------------------

FLAGS = {"fp16": (True, False), "bf16": (False, True), "fp32": (False, False)}


@pytest.mark.parametrize("flags", list(FLAGS))
@pytest.mark.parametrize("mask_type", ["causal", "padding"])
@pytest.mark.parametrize("fusion", [True, False])
def test_is_kernel_available_matches_jax(flags, mask_type, fusion):
    fp16, bf16 = FLAGS[flags]
    kw = dict(input_in_fp16=fp16, input_in_bf16=bf16,
              scaled_masked_softmax_fusion=fusion)
    j = JaxFSMS(attn_mask_type=getattr(JaxMask, mask_type), **kw)
    t = FusedScaleMaskSoftmax(attn_mask_type=getattr(AttnMaskType,
                                                     mask_type), **kw)
    for sq in (1, 16, 128, 512):
        for sk in (16, 17, 100, 128, 200, 256, 512, 16384, 16512):
            want = j.is_kernel_available(None, 2, 4, sq, sk)
            assert t.is_kernel_available(None, 2, 4, sq, sk) == want, (
                sq, sk)


@pytest.mark.parametrize("mask_type", ["causal", "padding"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dispatcher_output_matches_jax(mask_type, dtype):
    """fp32 input goes to ``forward_softmax`` in both packages, bf16 to
    a kernel; with a ``mask_func`` (used on the forward_softmax route
    only) and a scale."""
    sq = SK if mask_type == "causal" else SQ
    jx, _, tx, _ = _arrays(5, (B, NP, sq, SK), dtype)
    m = _masks("general")[:, :, :sq] if mask_type == "padding" else None
    kw = dict(input_in_fp16=False, input_in_bf16=dtype == "bfloat16",
              scale=0.25)
    j = JaxFSMS(attn_mask_type=getattr(JaxMask, mask_type),
                mask_func=lambda x, mm: jnp.where(mm != 0, -500.0, x), **kw)
    t = FusedScaleMaskSoftmax(
        attn_mask_type=getattr(AttnMaskType, mask_type),
        mask_func=lambda x, mm: x.masked_fill(mm != 0, -500.0), **kw)
    want = j(jx, None if m is None else jnp.asarray(m))
    got = t(tx, None if m is None else torch.from_numpy(m))
    assert got.dtype == tx.dtype
    _compare(got, want, dtype)


def test_get_batch_per_block_matches_jax():
    for sq, sk, b, np_ in ((8, 128, 2, 3), (1024, 1024, 8, 16),
                           (512, 512, 16, 16), (7, 16384, 1, 1),
                           (5, 40000, 3, 1), (3, 1, 1, 1)):
        assert FusedScaleMaskSoftmax.get_batch_per_block(sq, sk, b, np_) \
            == JaxFSMS.get_batch_per_block(sq, sk, b, np_)


def test_dispatcher_refuses_both_half_flags():
    with pytest.raises(RuntimeError, match="both fp16 and bf16"):
        FusedScaleMaskSoftmax(input_in_fp16=True, input_in_bf16=True)
    with pytest.raises(RuntimeError, match="fp32 when scaled"):
        FusedScaleMaskSoftmax(scale=0.5, softmax_in_fp32=False)
