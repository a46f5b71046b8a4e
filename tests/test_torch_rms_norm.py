"""The port's RMSNorm, the memory-efficient norms, the normalization
modules and the LayerNorm backward at any width, against the JAX package
on the CPU.

The same numpy-seeded inputs go through ``apex_tpu.ops.layer_norm`` with
``interpret=True`` (the Pallas kernel bodies on the CPU, as
``tests/test_fused_layer_norm.py`` runs them) and through
``apex_tpu_torch.ops.layer_norm`` (its plain versions on CPU tensors,
through the autograd Functions for gradients). The CUDA kernels are held
against the plain versions on the card by ``tests/test_torch_cuda.py``
and ``chip_smoke.py``.

Tolerances: fp32 outputs and dx atol/rtol 1e-5, the column sums (dgamma,
dbeta) 1e-4 (summation order over the rows); bf16 values one bf16
rounding, atol/rtol 2e-2, sums 1e-3 absolute over |sum| of order 1
(2e-2 relative). ``memory_efficient`` against the plain backward: fp32
atol/rtol 1e-4 (x-hat rebuilt from y carries y's fp32 rounding, over
|w| >= 0.05), bf16 each gradient within 3e-2 of its norm (one bf16
rounding of y an element).
"""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.contrib.layer_norm import FastLayerNorm as JaxFastLayerNorm
from apex_tpu.normalization import FusedRMSNorm as JaxFusedRMSNorm
from apex_tpu.normalization import MixedFusedLayerNorm as JaxMixedLN
from apex_tpu.normalization import MixedFusedRMSNorm as JaxMixedRMSNorm
from apex_tpu.normalization import manual_rms_norm as jax_manual_rms_norm
from apex_tpu.ops.layer_norm import _ln_bwd_xla
from apex_tpu.ops.layer_norm import layer_norm as jax_layer_norm
from apex_tpu.ops.layer_norm import rms_norm as jax_rms_norm
from apex_tpu.transformer.layers import FusedLayerNorm as JaxSPLayerNorm
from apex_tpu_torch import _build
from apex_tpu_torch.contrib.layer_norm import FastLayerNorm, FastLayerNormFN
from apex_tpu_torch.normalization import (
    FusedLayerNorm,
    FusedRMSNorm,
    MixedFusedLayerNorm,
    MixedFusedRMSNorm,
    fused_rms_norm,
    fused_rms_norm_affine,
    manual_rms_norm,
    mixed_dtype_fused_layer_norm_affine,
    mixed_dtype_fused_rms_norm_affine,
)
from apex_tpu_torch.transformer.layers import FastLayerNorm as SPFastLN
from apex_tpu_torch.transformer.layers import FusedLayerNorm as SPLayerNorm
from apex_tpu_torch.transformer.layers import MixedFusedLayerNorm as SPMixed
from apex_tpu_torch.transformer.testing import standalone_transformer_lm

# the module (the package re-exports a function of the same name)
tln = importlib.import_module("apex_tpu_torch.ops.layer_norm")

JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
TOL = {"float32": (1e-5, 1e-4), "bfloat16": (2e-2, 2e-2)}


def _case(shape=(6, 8, 128), seed=0, dtype="float32", w_floor=0.0):
    """x, w (over the last two dims), dy as numpy fp32 values exact in
    ``dtype``; ``w_floor`` keeps |w| away from 0."""
    rng = np.random.default_rng(seed)

    def a(*s, scale=1.0, shift=0.0):
        v = (rng.normal(size=s) * scale + shift).astype(np.float32)
        return np.array(jnp.asarray(v, JDT[dtype]).astype(jnp.float32))
    w = a(*shape[1:])
    if w_floor:
        w = np.sign(w) * (np.abs(w) + w_floor)
    return a(*shape, scale=2.0, shift=0.5), w.astype(np.float32), a(*shape)


def _close(got, want, tol, what):
    np.testing.assert_allclose(
        got.detach().float().numpy(),
        np.asarray(jnp.asarray(want).astype(jnp.float32)), rtol=tol,
        atol=tol, err_msg=what)


def _rel(a, c):
    """``|a - c| / |c|``, norms over all elements, in fp32."""
    return float((a.float() - c.float()).norm() / c.float().norm())


def _jax_rms(x, w, dy, dtype, memory_efficient, affine=True):
    args = (jnp.asarray(x, JDT[dtype]),) + ((jnp.asarray(w),) if affine
                                             else ())
    fn = (lambda a, c: jax_rms_norm(a, c, 2, 1e-5, memory_efficient, True)) \
        if affine else (lambda a: jax_rms_norm(a, None, 2, 1e-5,
                                               memory_efficient, True))
    y, vjp = jax.vjp(fn, *args)
    return y, vjp(jnp.asarray(dy, JDT[dtype]))


@pytest.mark.parametrize("affine", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rms_norm_matches_jax_interpret(dtype, affine):
    """#4 and #5: forward and backward over a 2-dim normalized shape
    against the Pallas kernels in interpret mode (the JAX custom VJP)."""
    x, w, dy = _case(dtype=dtype)
    jy, jgrads = _jax_rms(x, w, dy, dtype, False, affine)
    tx = torch.from_numpy(x).to(TDT[dtype]).requires_grad_(True)
    tw = torch.from_numpy(w).requires_grad_(True)
    y = tln.rms_norm(tx, tw if affine else None, 1e-5, normalized_ndim=2)
    y.backward(torch.from_numpy(dy).to(TDT[dtype]))
    assert y.dtype == tx.grad.dtype == TDT[dtype]
    tol, sum_tol = TOL[dtype]
    _close(y, jy, tol, "y")
    _close(tx.grad, jgrads[0], tol, "dx")
    if affine:
        assert tw.grad.dtype == torch.float32
        _close(tw.grad, jgrads[1], sum_tol, "dweight")


def test_rms_norm_statistics_match_jax_kernel():
    """The forward's fp32 rstd per row and the backward's dgamma against
    the JAX kernels' own outputs, at rows x 1024 (the 345M's width)."""
    from apex_tpu.ops.layer_norm import _rms_bwd_pallas, _rms_fwd_pallas

    x, w, dy = _case(shape=(24, 1024), seed=3)
    jy, jrstd = _rms_fwd_pallas(jnp.asarray(x), jnp.asarray(w), 1e-5, True,
                                True)
    jdx, jdw = _rms_bwd_pallas(jnp.asarray(dy), jnp.asarray(x), jrstd,
                               jnp.asarray(w), True, False, True)
    tx, tw = torch.from_numpy(x), torch.from_numpy(w)
    y, rstd = tln.rms_norm_fwd(tx, tw)
    dx, dw = tln.rms_norm_bwd(torch.from_numpy(dy), tx, rstd, tw)
    assert tuple(rstd.shape) == (24, 1) and rstd.dtype == torch.float32
    _close(y, jy, 1e-5, "y")
    _close(rstd, jrstd, 1e-5, "rstd")
    _close(dx, jdx, 1e-5, "dx")
    _close(dw, jdw, 1e-4, "dgamma")


def _xhat(y, w, b, eps=1e-5):
    """x-hat rebuilt in fp32 from a norm's output, written out here apart
    from the port's: ``(y - b) / w``, |w| clamped to eps, its sign kept."""
    mag = w.float().abs().clamp_min(eps)
    yf = y.float() if b is None else y.float() - b.float()
    return yf / torch.where(w < 0, -mag, mag)


@pytest.mark.parametrize("norm", ["layer_norm", "rms_norm"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_memory_efficient_matches_jax_and_the_plain_backward(norm, dtype):
    """``memory_efficient`` saves y and rebuilds x-hat in fp32: its
    gradients equal JAX's memory-efficient ones, those of the port's plain
    backward given the same fp32 x-hat, and the plain backward's (which
    keeps x) within the rounding of y."""
    x, w, dy = _case(seed=4, dtype=dtype, w_floor=0.05)
    b = np.random.default_rng(9).normal(size=w.shape).astype(np.float32)
    jx, jw, jb = (jnp.asarray(x, JDT[dtype]), jnp.asarray(w),
                  jnp.asarray(b))
    if norm == "layer_norm":
        _, vjp = jax.vjp(lambda a, c, d: jax_layer_norm(a, c, d, 2, 1e-5,
                                                        True, True),
                         jx, jw, jb)
    else:
        _, vjp = jax.vjp(lambda a, c: jax_rms_norm(a, c, 2, 1e-5, True,
                                                   True), jx, jw)
    jgrads = vjp(jnp.asarray(dy, JDT[dtype]))
    runs = []
    for me in (True, False):
        tx = torch.from_numpy(x).to(TDT[dtype]).requires_grad_(True)
        tw, tb = (torch.from_numpy(v).requires_grad_(True) for v in (w, b))
        if norm == "layer_norm":
            y = tln.layer_norm(tx, tw, tb, normalized_ndim=2,
                               memory_efficient=me)
        else:
            y = tln.rms_norm(tx, tw, normalized_ndim=2, memory_efficient=me)
        y.backward(torch.from_numpy(dy).to(TDT[dtype]))
        runs.append([tx.grad, tw.grad] + ([tb.grad] if norm == "layer_norm"
                                          else []))
    tol, sum_tol = TOL[dtype]
    for i, (got, want) in enumerate(zip(runs[0], jgrads)):
        _close(got, want, tol if i == 0 else sum_tol, f"grad {i}")
    # the plain backward given the fp32 x-hat rebuilt from y (``_xhat``):
    # dx within one rounding of its dtype and dgamma within 1e-5 of their
    # norms (0 on this route, where one function computes both); the same
    # x-hat rounded to bf16 moves dgamma by ~2e-3 of its norm and fails
    hidden = w.size
    x2 = torch.from_numpy(x).to(TDT[dtype]).reshape(-1, hidden)
    dy2 = torch.from_numpy(dy).to(TDT[dtype]).reshape(-1, hidden)
    tw, tb = torch.from_numpy(w).reshape(hidden), torch.from_numpy(b)
    if norm == "layer_norm":
        y, mu, rstd = tln.layer_norm_fwd(x2, tw, tb.reshape(hidden))
        xhat = _xhat(y, tw, tb.reshape(hidden))
        want, bad = (tln.layer_norm_bwd_reference(dy2, xh, mu, rstd, tw,
                                                  x_is_xhat=True)
                     for xh in (xhat, xhat.bfloat16().float()))
    else:
        y, rstd = tln.rms_norm_fwd(x2, tw)
        xhat = _xhat(y, tw, None)
        want, bad = (tln.rms_norm_bwd_reference(dy2, xh, rstd, tw,
                                                x_is_xhat=True)
                     for xh in (xhat, xhat.bfloat16().float()))
    assert _rel(runs[0][0].reshape(-1, hidden), want[0]) < (
        1e-5 if dtype == "float32" else 2.0 ** -8)
    assert _rel(runs[0][1].reshape(hidden), want[1]) < 1e-5
    assert _rel(bad[1], want[1]) > 1e-5
    # x-hat from y carries y's rounding over |w| >= 0.05: up to 20 fp32
    # or bf16 half-ulps an element (1e-4 elementwise in fp32; in bf16 6e-3
    # of dgamma's norm at this seed, limit 3e-2)
    for eff, plain in zip(*runs):
        eff, plain = eff.float(), plain.float()
        if dtype == "float32":
            torch.testing.assert_close(eff, plain, atol=1e-4, rtol=1e-4)
        else:
            assert _rel(eff, plain) < 3e-2


@pytest.mark.parametrize("norm", ["layer_norm", "rms_norm"])
def test_memory_efficient_clamps_negative_and_near_zero_weights(norm):
    """x-hat = (y - b) / w with |w| clamped to eps, its sign kept: a
    negative weight inverts exactly, a weight below eps is clamped, as in
    the JAX package (the same gradients, 1e-5)."""
    x, w, dy = _case(shape=(4, 16, 32), seed=5)
    w[0, 3], w[1, 5], w[2, 7] = -0.5, 1e-8, -3e-7
    jx, jw = jnp.asarray(x), jnp.asarray(w)
    if norm == "layer_norm":
        jb = jnp.zeros_like(jw)
        _, vjp = jax.vjp(lambda a, c: jax_layer_norm(a, c, jb, 2, 1e-5, True,
                                                     True), jx, jw)
    else:
        _, vjp = jax.vjp(lambda a, c: jax_rms_norm(a, c, 2, 1e-5, True,
                                                   True), jx, jw)
    jdx, jdw = vjp(jnp.asarray(dy))
    tx, tw = (torch.from_numpy(v).requires_grad_(True) for v in (x, w))
    op = tln.layer_norm if norm == "layer_norm" else tln.rms_norm
    kw = dict(normalized_ndim=2, memory_efficient=True)
    y = op(tx, tw, None, **kw) if norm == "layer_norm" else op(tx, tw, **kw)
    y.backward(torch.from_numpy(dy))
    _close(tx.grad, jdx, 1e-5, "dx")
    # the clamped columns' x-hat is y / eps: large, so a relative bound
    np.testing.assert_allclose(tw.grad.numpy(), np.asarray(jdw), rtol=1e-5,
                               atol=1e-4)
    clamp = tln._clamp_by_magnitude(torch.tensor([-0.5, 1e-8, -3e-7, 0.0]),
                                    1e-5)
    assert clamp.tolist() == pytest.approx([-0.5, 1e-5, -1e-5, 1e-5])


@pytest.mark.parametrize("affine", [True, False])
def test_rms_norm_modules_match_jax(affine):
    """``FusedRMSNorm`` and ``MixedFusedRMSNorm`` and the functional API
    against the JAX modules over a 2-dim normalized shape."""
    x = np.random.default_rng(6).normal(size=(4, 8, 16)).astype(np.float32)
    for jcls, tcls in ((JaxFusedRMSNorm, FusedRMSNorm),
                       (JaxMixedRMSNorm, MixedFusedRMSNorm)):
        jmod = jcls((8, 16), elementwise_affine=affine)
        jvars = jmod.init(jax.random.PRNGKey(0), jnp.asarray(x))
        want = np.asarray(jmod.apply(jvars, jnp.asarray(x)))
        mod = tcls((8, 16), elementwise_affine=affine, device="cpu")
        assert (mod.weight is not None) == affine
        assert not hasattr(mod, "bias")
        tx = torch.from_numpy(x).requires_grad_(True)
        got = mod(tx)
        np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-5,
                                   atol=1e-5)
        got.sum().backward()
        assert torch.isfinite(tx.grad).all()
    w = torch.full((8, 16), 1.5)
    tx = torch.from_numpy(x)
    want = np.asarray(jax_rms_norm(jnp.asarray(x), jnp.full((8, 16), 1.5),
                                   2, 1e-5, False, True))
    for got in (fused_rms_norm_affine(tx, w, (8, 16)),
                mixed_dtype_fused_rms_norm_affine(tx, w, (8, 16))):
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(
        fused_rms_norm(tx, (8, 16)).numpy(),
        np.asarray(jax_rms_norm(jnp.asarray(x), None, 2, 1e-5, False,
                                True)), rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError, match="normalized_shape"):
        fused_rms_norm(tx, (4, 16))


def test_mixed_modules_pin_fp32_params_and_match_jax():
    """The ``Mixed*`` classes keep fp32 parameters and refuse another
    ``param_dtype`` (``ValueError``), as the JAX modules do."""
    x = np.random.default_rng(7).normal(size=(2, 4, 32)).astype(np.float32)
    for cls in (MixedFusedLayerNorm, MixedFusedRMSNorm):
        with pytest.raises(ValueError, match="float32"):
            cls(32, param_dtype=torch.bfloat16)
        assert cls(32, device="cpu").weight.dtype == torch.float32
    jmod = JaxMixedLN(32)
    want = jmod.apply(jmod.init(jax.random.PRNGKey(0), jnp.asarray(x)),
                      jnp.asarray(x))
    _close(MixedFusedLayerNorm(32, device="cpu")(torch.from_numpy(x)), want,
           1e-5, "y")
    got = mixed_dtype_fused_layer_norm_affine(
        torch.from_numpy(x), torch.ones(32), torch.zeros(32), 32)
    _close(got, want, 1e-5, "functional")


@pytest.mark.parametrize("affine", [True, False])
def test_manual_rms_norm_matches_jax(affine):
    x = np.random.default_rng(8).normal(size=(3, 5, 24)).astype(np.float32)
    w = np.random.default_rng(9).normal(size=(5, 24)).astype(np.float32)
    want = jax_manual_rms_norm(jnp.asarray(x), (5, 24),
                               jnp.asarray(w) if affine else None, 1e-6)
    got = manual_rms_norm(torch.from_numpy(x), (5, 24),
                          torch.from_numpy(w) if affine else None, 1e-6)
    _close(got, want, 1e-5, "y")


def test_transformer_layer_norms_and_contrib_match_jax():
    """``transformer.layers`` (the sequence-parallel tag) and
    ``contrib.layer_norm`` (``FastLayerNorm``, ``FastLayerNormFN``) over
    the same kernels, against the JAX classes."""
    x = np.random.default_rng(10).normal(size=(2, 3, 64)).astype(np.float32)
    jmod = JaxSPLayerNorm(64, sequence_parallel_enabled=True)
    want = jmod.apply(jmod.init(jax.random.PRNGKey(0), jnp.asarray(x)),
                      jnp.asarray(x))
    assert jmod.sequence_parallel_param_names == ("weight", "bias")
    sp = dict(sequence_parallel_enabled=True, device="cpu")
    for mod in (SPLayerNorm(64, **sp), SPMixed(64, **sp),
                SPFastLN(64, **sp)):
        assert mod.sequence_parallel_param_names == ("weight", "bias")
        _close(mod(torch.from_numpy(x)), want, 1e-5, type(mod).__name__)
    assert SPLayerNorm(64, device="cpu").sequence_parallel_param_names == ()
    jfast = JaxFastLayerNorm(64)
    jwant = jfast.apply(jfast.init(jax.random.PRNGKey(0), jnp.asarray(x)),
                        jnp.asarray(x))
    _close(FastLayerNorm(64, device="cpu")(torch.from_numpy(x)), jwant, 1e-5,
           "fast")
    g = torch.linspace(0.5, 1.5, 64)
    b = torch.linspace(-1, 1, 64)
    want_fn = jax_layer_norm(jnp.asarray(x), jnp.asarray(g.numpy()),
                             jnp.asarray(b.numpy()), 1, 1e-5, True, True)
    _close(FastLayerNormFN.apply(torch.from_numpy(x), g, b, 1e-5, True),
           want_fn, 1e-5, "fast fn")


@pytest.mark.parametrize("cls", [
    FusedLayerNorm, FusedRMSNorm, MixedFusedLayerNorm, MixedFusedRMSNorm,
    SPLayerNorm, SPMixed, SPFastLN, FastLayerNorm],
    ids=lambda c: f"{c.__module__.split('.')[1]}.{c.__name__}")
def test_norm_modules_build_on_the_card_unless_the_cpu_is_named(cls):
    """No device named: the parameters go to the card, as every entry
    point's do; with no card that raises and names ``device='cpu'``."""
    if torch.cuda.is_available():
        assert cls(64).weight.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            cls(64)
    assert cls(64, device="cpu").weight.device.type == "cpu"


def test_rms_norm_forward_is_a_saveable_op():
    """The RMSNorm forward is the custom op the selective recompute
    policy keeps, as ``apex_tpu_rms_norm_fwd`` is in the JAX policy."""
    assert tln.RMS_NORM_FWD == "apex_tpu_torch::rms_norm_fwd"
    saveable = standalone_transformer_lm._SELECTIVE_SAVEABLE_OPS
    assert tln.RMS_NORM_FWD in saveable
    seen = []

    class Spy(torch.utils._python_dispatch.TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            seen.append(func.name())
            return func(*args, **(kwargs or {}))

    with Spy():
        tln.rms_norm(torch.ones(2, 8), torch.ones(8))
    assert tln.RMS_NORM_FWD in seen


@pytest.mark.parametrize("hidden", [32768, 40000])
def test_layer_norm_bwd_takes_wide_rows(hidden, monkeypatch):
    """The LayerNorm backward at widths past a block's shared memory: on
    the CPU route its plain version against JAX's; on the kernel route the
    wrapper hands such a row to the kernel (which keeps its column
    partials in device memory) instead of refusing it — checked with the
    library replaced by a recorder of the call."""
    rng = np.random.default_rng(hidden)
    x = rng.normal(size=(3, hidden)).astype(np.float32)
    w = rng.normal(size=(hidden,)).astype(np.float32)
    dy = rng.normal(size=(3, hidden)).astype(np.float32)
    tx, tw = torch.from_numpy(x), torch.from_numpy(w)
    _, mu, rstd = tln.layer_norm_fwd(tx, tw, torch.zeros(hidden))
    dx, dw, db = tln.layer_norm_bwd(torch.from_numpy(dy), tx, mu, rstd, tw)
    jdx, jdw, jdb = _ln_bwd_xla(jnp.asarray(dy), jnp.asarray(x),
                                jnp.asarray(mu.numpy()),
                                jnp.asarray(rstd.numpy()), jnp.asarray(w),
                                True)
    _close(dx, jdx, 1e-5, "dx")
    _close(dw, jdw, 1e-4, "dgamma")
    _close(db, jdb, 1e-4, "dbeta")

    calls = []

    class FakeLib:
        def apex_layer_norm_bwd_blocks(self, rows):
            return -(-rows // 32)

        def apex_layer_norm_bwd(self, *args):
            calls.append(args)
            return 0

    monkeypatch.setattr(_build, "kernels", FakeLib)
    monkeypatch.setattr(_build, "current_stream", lambda dev: 0)
    tln._launch_bwd(torch.from_numpy(dy), tx, mu, rstd, tw)
    (args,) = calls
    assert args[10:15] == (3, hidden, 0, 0, 0)  # rows, hidden, dtypes, xhat
