"""``transformer.functional.fused_rope`` of the port against the JAX
package's, on the CPU.

The four layouts (sbhd with ``freqs``, cached cos/sin, ``thd`` packed
varlen, 2-D image), with ``d2`` equal to and below the head dim (the
rest passed through), positions restarting at every ``cu_seqlens``
boundary, and the gradients of ``t``, ``freqs``, ``cos`` and ``sin``,
fp32 and bf16, on numpy-seeded inputs.

Tolerances: fp32 outputs and gradients rtol 1e-5, atol 1e-6 (the two
frameworks' cos and sin differ by an ulp or two, and the gradients of
``freqs`` sum over the batch and heads in another order); bf16 outputs
within one bf16 rounding (rtol 2^-7, atol 1e-6: the same fp32 value
rounded once on both sides, an ulp apart where it lies on a tie); the
pass-through dims bit for bit.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.transformer.functional import fused_rope as jrope
from apex_tpu_torch.transformer.functional import fused_rope as trope

TOL = {"float32": (1e-5, 1e-6), "bfloat16": (2.0 ** -7, 1e-6)}
DTYPES = ["float32", "bfloat16"]


def _np(t):
    return np.asarray(jnp.asarray(t).astype(jnp.float32))


def _close(got, want, dtype):
    rtol, atol = TOL[dtype]
    np.testing.assert_allclose(got.detach().float().numpy(), _np(want),
                               rtol=rtol, atol=atol)


def _rand(rng, shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _both(a, dtype):
    return (jnp.asarray(a).astype(getattr(jnp, dtype)),
            torch.from_numpy(a).to(getattr(torch, dtype)))


def _check(jfn, tfn, arrays, dtypes, dy, out_dtype):
    """Output and the gradient of every float argument."""
    jargs = [_both(a, d)[0] for a, d in zip(arrays, dtypes)]
    targs = [_both(a, d)[1].requires_grad_(True) for a, d in
             zip(arrays, dtypes)]

    def loss(*a):
        y = jfn(*a)
        return jnp.sum(y.astype(jnp.float32) * jnp.asarray(dy)), y
    (_, jy), jg = jax.value_and_grad(
        loss, argnums=tuple(range(len(jargs))), has_aux=True)(*jargs)
    ty = tfn(*targs)
    assert ty.dtype == targs[0].dtype and ty.shape == targs[0].shape
    (ty.float() * torch.from_numpy(dy)).sum().backward()
    _close(ty, jy, out_dtype)
    for t, g, d in zip(targs, jg, dtypes):
        _close(t.grad, g, d)
    return ty, targs


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("d2", [32, 16])
def test_sbhd_matches_jax(d2, dtype):
    rng = np.random.default_rng(0)
    s, b, h, d = 12, 2, 3, 32
    t = _rand(rng, (s, b, h, d))
    freqs = _rand(rng, (s, 1, 1, d2), 2.0)
    dy = _rand(rng, (s, b, h, d))
    ty, targs = _check(jrope.fused_apply_rotary_pos_emb,
                       trope.fused_apply_rotary_pos_emb, [t, freqs],
                       [dtype, "float32"], dy, dtype)
    # the dims past d2 pass through untouched
    assert torch.equal(ty[..., d2:], targs[0][..., d2:])


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("d2", [32, 16])
def test_cached_matches_jax(d2, dtype):
    rng = np.random.default_rng(1)
    s, b, h, d = 10, 3, 2, 32
    t = _rand(rng, (s, b, h, d))
    f = _rand(rng, (s, 1, 1, d2), 2.0)
    dy = _rand(rng, (s, b, h, d))
    _check(jrope.fused_apply_rotary_pos_emb_cached,
           trope.fused_apply_rotary_pos_emb_cached,
           [t, np.cos(f), np.sin(f)], [dtype, dtype, dtype], dy, dtype)


def test_cached_equals_freqs_form():
    rng = np.random.default_rng(2)
    t = torch.from_numpy(_rand(rng, (6, 2, 2, 16)))
    f = torch.from_numpy(_rand(rng, (6, 1, 1, 16)))
    torch.testing.assert_close(
        trope.fused_apply_rotary_pos_emb(t, f),
        trope.fused_apply_rotary_pos_emb_cached(t, torch.cos(f),
                                                torch.sin(f)),
        rtol=0, atol=0)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("d2", [32, 8])
def test_thd_matches_jax_and_restarts_positions(d2, dtype):
    rng = np.random.default_rng(3)
    lens = [5, 1, 9, 3]
    total, h, d = sum(lens), 2, 32
    cu = np.concatenate([[0], np.cumsum(lens)]).astype(np.int32)
    t = _rand(rng, (total, h, d))
    freqs = _rand(rng, (max(lens), 1, 1, d2), 2.0)
    dy = _rand(rng, (total, h, d))
    ja = jnp.asarray(cu)
    ty, targs = _check(
        lambda x, f: jrope.fused_apply_rotary_pos_emb_thd(x, ja, f),
        lambda x, f: trope.fused_apply_rotary_pos_emb_thd(
            x, torch.from_numpy(cu), f),
        [t, freqs], [dtype, "float32"], dy, dtype)
    # each packed sequence equals the sbhd rotation of it alone from
    # position 0
    for i, n in enumerate(lens):
        seq = targs[0][cu[i]:cu[i + 1]].detach()[:, None]
        alone = trope.fused_apply_rotary_pos_emb(
            seq, targs[1].detach()[:n])[:, 0]
        assert torch.equal(ty[cu[i]:cu[i + 1]].detach(), alone)


@pytest.mark.parametrize("dtype", DTYPES)
def test_2d_matches_jax(dtype):
    rng = np.random.default_rng(4)
    b, img_h, img_w, h, d = 2, 3, 4, 2, 16
    t = _rand(rng, (b, img_h * img_w, h, d))
    fh = _rand(rng, (1, 5, 1, d // 2), 2.0)
    fw = _rand(rng, (1, 6, 1, d // 2), 2.0)
    dy = _rand(rng, t.shape)
    _check(lambda x, ch, sh, cw, sw: jrope.fused_apply_rotary_pos_emb_2d(
               x, img_h, img_w, ch, sh, cw, sw),
           lambda x, ch, sh, cw, sw: trope.fused_apply_rotary_pos_emb_2d(
               x, img_h, img_w, ch, sh, cw, sw),
           [t, np.cos(fh), np.sin(fh), np.cos(fw), np.sin(fw)],
           [dtype] + ["float32"] * 4, dy, dtype)


def test_2d_refuses_a_wrong_sequence_length():
    t = torch.zeros(1, 5, 1, 8)
    c = torch.ones(1, 4, 1, 4)
    with pytest.raises(ValueError, match="img_h \\* img_w"):
        trope.fused_apply_rotary_pos_emb_2d(t, 2, 2, c, c, c, c)
