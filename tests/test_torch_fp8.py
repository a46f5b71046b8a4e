"""The port's fp8 recipe against the JAX package's, on the CPU.

``fused_dense.fp8`` (quantizers, delayed scaling, ``fp8_fused_dense``
and ``fp8_fused_dense_qgrad`` with their backwards, ``record_grad_amax``)
and the GPT's fp8 path (``GPTConfig.fp8``), on the same numpy-seeded
inputs through both packages.

Tolerances:
- the quantizers' bytes bit for bit on every finite and infinite input
  (fp32 and bf16 sources, saturation included); NaN as NaN (JAX writes
  e5m2's NaN as 0x7e, torch as 0x7f);
- the delayed-scaling state of one layer over 3 steps bit for bit
  (histories and scales: the same amaxes and one true division);
- the fp8 GEMM's output: fp8 products are exact in fp32, so the two
  frameworks differ only in the order of the fp32 sums and in the
  output's rounding: ``|d| <= 2^-20 * sum|products| + ulp * |y|`` with
  ``ulp`` 0 in fp32, 2^-7 in bf16, 2^-10 in fp16 (one rounding of two
  nearby values); the same bound holds the card route's padded
  ``torch._scaled_mm`` (run on the CPU) to the plain version;
- the fp32 backward GEMMs (dgrad, wgrad) within 1e-5 of each result's
  largest entry (summation order);
- the 2-layer GPT with fp8 (unfused; fused block under
  ``selective_elementwise``; ``"full"``) against JAX's over 2 steps: the
  loss rtol 1e-5, each gradient leaf within 1e-4 of its largest entry,
  every fp8 history and scale rtol 1e-6. The two frameworks round the
  fp32 LayerNorm and GEMM outputs a few ulps apart, so the amaxes (and
  scales) differ by ulps and an element near an e4m3 or e5m2 rounding
  boundary may round the other way (measured: the loss bit-equal, the
  gradients within 6e-6, the states within 5e-7).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu import fused_dense as jfd
from apex_tpu.transformer.testing import GPTConfig as JaxGPTConfig
from apex_tpu.transformer.testing import gpt_forward as jax_gpt_forward
from apex_tpu.transformer.testing import gpt_loss as jax_gpt_loss
from apex_tpu.transformer.testing import init_gpt_fp8_carriers as jax_carriers
from apex_tpu.transformer.testing import init_gpt_fp8_states as jax_states
from apex_tpu.transformer.testing import init_gpt_params as jax_init
from apex_tpu.transformer.testing import (
    record_gpt_grad_amaxes as jax_record,
)
from apex_tpu_torch import _device
from apex_tpu_torch._tree import tree_leaves, value_and_grad
from apex_tpu_torch.convert import fp8_state_from_jax, params_from_jax
from apex_tpu_torch.fused_dense import fp8
from apex_tpu_torch.transformer.testing import (
    FP8_GEMM_NAMES,
    GPTConfig,
    gpt_forward,
    gpt_hidden,
    gpt_loss,
    init_gpt_fp8_carriers,
    init_gpt_fp8_states,
    record_gpt_grad_amaxes,
)
from apex_tpu_torch.transformer.testing import standalone_transformer_lm as lm

ULP = {"float32": 0.0, "bfloat16": 2.0 ** -7, "float16": 2.0 ** -10}
SUM_TOL = 2.0 ** -20


def _np(t):
    return np.asarray(jnp.asarray(t).astype(jnp.float32))


def _wide(seed, shape, dtype=np.float32):
    """Values over 2^-20 .. 2^20 of either sign, zeros and the
    formats' edges (448, 57344 and past them)."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape) * 2.0 ** rng.integers(-20, 21, shape)
    flat = x.reshape(-1)
    flat[:8] = [0.0, -0.0, 448.0, -448.0, 464.0, 57344.0, -61440.0, 1e9]
    return x.astype(dtype)


# ---------------------------------------------------------------------------
# the quantizers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("src", ["float32", "bfloat16"])
@pytest.mark.parametrize("fmt", ["e4m3", "e5m2"])
@pytest.mark.parametrize("scale", [1.0, 3.7, 2.0 ** -9])
def test_quantizer_bytes_match_jax(fmt, src, scale):
    x = _wide(0, (4096,))
    x[8:11] = [np.inf, -np.inf, np.nan]
    jx = jnp.asarray(x).astype(getattr(jnp, src))
    tx = torch.from_numpy(x).to(getattr(torch, src))
    jq = getattr(jfd, f"quantize_{fmt}")(jx, jnp.float32(scale))
    tq = getattr(fp8, f"quantize_{fmt}")(tx, torch.tensor(scale))
    assert tq.dtype == (torch.float8_e4m3fn if fmt == "e4m3"
                        else torch.float8_e5m2)
    jb = np.asarray(jq).view(np.uint8)
    tb = tq.view(torch.uint8).numpy()
    nan = np.isnan(np.asarray(jq.astype(jnp.float32)))
    assert np.array_equal(nan, torch.isnan(tq.float()).numpy())
    assert nan.sum() == 1
    np.testing.assert_array_equal(tb[~nan], jb[~nan])


# ---------------------------------------------------------------------------
# one layer: states, outputs, gradients
# ---------------------------------------------------------------------------

def _layer_inputs(seed, dtype, m=24, k=48, n=32):
    rng = np.random.default_rng(seed)
    xs = [(rng.standard_normal((2, m // 2, k)) * (1.0 + 3 * i)).astype(
        np.float32) for i in range(3)]
    w = (rng.standard_normal((n, k)) * 0.2).astype(np.float32)
    b = (rng.standard_normal(n) * 0.1).astype(np.float32)
    dy = (rng.standard_normal((2, m // 2, n)) * 1e-3).astype(np.float32)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    return ([jnp.asarray(x).astype(jdt) for x in xs],
            [torch.from_numpy(x).to(tdt) for x in xs],
            jnp.asarray(w).astype(jdt), torch.from_numpy(w).to(tdt),
            jnp.asarray(b), torch.from_numpy(b), dy)


def _assert_state_equal(jstate, tstate):
    for jm, tm in zip((jstate.x, jstate.w, jstate.g),
                      (tstate.x, tstate.w, tstate.g)):
        if jm is None:
            assert tm is None
            continue
        np.testing.assert_array_equal(tm.amax_history.numpy(),
                                      np.asarray(jm.amax_history))
        np.testing.assert_array_equal(tm.scale.numpy(), np.asarray(jm.scale))


def _assert_gemm_close(got, want, mag, dtype):
    err = np.abs(got - want)
    limit = SUM_TOL * mag + ULP[dtype] * np.abs(want)
    assert (err <= limit).all(), float((err - limit).max())


@pytest.mark.parametrize("margin", [0.0, 1.0])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_delayed_scaling_states_bitwise_over_three_steps(dtype, margin):
    jxs, txs, jw, tw, jb, tb, _ = _layer_inputs(1, dtype)
    jst = jfd.init_fp8_dense_state(4, with_grad_meta=True)
    tst = fp8.init_fp8_dense_state(4, with_grad_meta=True, device="cpu")
    for jx, tx in zip(jxs, txs):
        jy, jst = jfd.fp8_fused_dense(jx, jw, jb, jst, margin=margin)
        ty, tst = fp8.fp8_fused_dense(tx, tw, tb, tst, margin=margin)
        jst = jfd.record_grad_amax(jst, jnp.max(jnp.abs(jy)), margin=margin)
        tst = fp8.record_grad_amax(tst, ty.abs().amax(), margin=margin)
        _assert_state_equal(jst, tst)
    assert float(tst.x.scale) != 1.0 and float(tst.g.scale) != 1.0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fp8_fused_dense_output_and_grads_match_jax(dtype):
    jxs, txs, jw, tw, jb, tb, dy = _layer_inputs(2, dtype)
    jst = jfd.init_fp8_dense_state()
    tst = fp8.init_fp8_dense_state(device="cpu")
    # a first call calibrates the scales
    _, jst = jfd.fp8_fused_dense(jxs[0], jw, jb, jst)
    _, tst = fp8.fp8_fused_dense(txs[0], tw, tb, tst)
    jx, tx = jxs[1], txs[1].clone().requires_grad_(True)
    twg = tw.clone().requires_grad_(True)

    # bias-free, so that the output is the GEMM's one rounding
    def jf(x, w):
        y, _ = jfd.fp8_fused_dense(x, w, None, jst)
        return jnp.sum(y.astype(jnp.float32) * jnp.asarray(dy)), y
    (_, jy), (jdx, jdw) = jax.value_and_grad(jf, argnums=(0, 1),
                                             has_aux=True)(jx, jw)
    ty, _ = fp8.fp8_fused_dense(tx, twg, None, tst)
    assert ty.dtype == tx.dtype
    (ty.float() * torch.from_numpy(dy)).sum().backward()
    qx = fp8.quantize_e4m3(txs[1], tst.x.scale).float().reshape(-1, 48)
    qw = fp8.quantize_e4m3(tw, tst.w.scale).float()
    mag = ((qx.abs() @ qw.abs().t()) / (tst.x.scale * tst.w.scale)).numpy()
    _assert_gemm_close(ty.detach().float().numpy().reshape(-1, 32),
                       _np(jy).reshape(-1, 32), mag, dtype)
    for got, want in ((tx.grad, jdx), (twg.grad, jdw)):
        want = _np(want)
        tol = 1e-5 if dtype == "float32" else 2.0 ** -7
        assert np.abs(got.float().numpy() - want).max() \
            <= tol * np.abs(want).max()


def test_qgrad_backward_and_carrier_match_jax():
    jxs, txs, jw, tw, _, _, dy = _layer_inputs(3, "float32")
    jst = jfd.init_fp8_dense_state(with_grad_meta=True)
    tst = fp8.init_fp8_dense_state(with_grad_meta=True, device="cpu")
    # calibrate x, w and g
    for jx, tx in zip(jxs[:2], txs[:2]):
        _, jst = jfd.fp8_fused_dense(jx, jw, None, jst)
        _, tst = fp8.fp8_fused_dense(tx, tw, None, tst)
    jst = jfd.record_grad_amax(jst, jnp.float32(np.abs(dy).max()))
    tst = fp8.record_grad_amax(tst, torch.tensor(np.abs(dy).max()))
    _assert_state_equal(jst, tst)

    def jf(x, w, c):
        y, st = jfd.fp8_fused_dense_qgrad(x, w, None, jst, c)
        return jnp.sum(y * jnp.asarray(dy)), st
    (_, jnew), (jdx, jdw, jamax) = jax.value_and_grad(
        jf, argnums=(0, 1, 2), has_aux=True)(jxs[2], jw, jnp.float32(0.0))
    tx = txs[2].clone().requires_grad_(True)
    twg = tw.clone().requires_grad_(True)
    carrier = torch.zeros((), requires_grad=True)
    ty, tnew = fp8.fp8_fused_dense_qgrad(tx, twg, None, tst, carrier)
    (ty * torch.from_numpy(dy)).sum().backward()
    _assert_state_equal(jnew, tnew)
    # the carrier's gradient is max|dY| exactly, as its JAX cotangent
    assert float(carrier.grad) == float(np.abs(dy).max()) == float(jamax)
    for got, want in ((tx.grad, jdx), (twg.grad, jdw)):
        want = _np(want)
        assert np.abs(got.numpy() - want).max() <= 1e-5 * np.abs(want).max()
    _assert_state_equal(jfd.record_grad_amax(jnew, jamax),
                        fp8.record_grad_amax(tnew, carrier.grad))


def test_shared_carrier_sums_the_amaxes():
    """Two layers on one carrier: its gradient is the sum of their
    max|dY|, as a shared carrier's cotangent is in JAX."""
    tst = fp8.init_fp8_dense_state(with_grad_meta=True, device="cpu")
    x = torch.randn(8, 16, generator=torch.Generator().manual_seed(0))
    w = torch.randn(16, 16, generator=torch.Generator().manual_seed(1))
    carrier = torch.zeros((), requires_grad=True)
    h, _ = fp8.fp8_fused_dense_qgrad(x, w, None, tst, carrier)
    y, _ = fp8.fp8_fused_dense_qgrad(h, w, None, tst, carrier)
    dy = torch.full_like(y, 0.5)
    (dh,) = torch.autograd.grad(y, [h], dy, retain_graph=True)
    y.backward(dy)
    assert float(carrier.grad) == float(dy.abs().amax() + dh.abs().amax())


def test_refusals():
    st = fp8.init_fp8_dense_state(device="cpu")  # no grad meta
    x, w = torch.ones(4, 8), torch.ones(2, 8)
    with pytest.raises(ValueError, match="grad"):
        fp8.fp8_fused_dense_qgrad(x, w, None, st, torch.zeros(()))
    with pytest.raises(ValueError, match="gradient meta"):
        fp8.record_grad_amax(st, torch.tensor(1.0))
    # a reduction over parallel_state axes needs the model-parallel state
    with pytest.raises(RuntimeError, match="not initialized"):
        fp8.fp8_fused_dense(x, w, None, st, amax_reduction_axes=("data",))
    full = fp8.init_fp8_dense_state(with_grad_meta=True, device="cpu")
    with pytest.raises(RuntimeError, match="not initialized"):
        fp8.record_grad_amax(full, 1.0, amax_reduction_axes="tensor")
    cfg = GPTConfig(num_layers=1, hidden_size=16, num_attention_heads=2,
                    vocab_size=32, max_position_embeddings=8, fp8=True,
                    fp8_amax_reduction_axes=("data", "tensor"))
    with pytest.raises(RuntimeError, match="not initialized"):
        record_gpt_grad_amaxes(cfg, init_gpt_fp8_states(cfg, device="cpu"),
                               init_gpt_fp8_carriers(cfg, device="cpu"))
    with pytest.raises(ValueError, match="fp8_gemm takes"):
        fp8.fp8_gemm(x.to(torch.float8_e4m3fn), w.t().to(torch.float8_e4m3fn),
                      torch.tensor(1.0), torch.tensor(1.0), torch.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
@pytest.mark.parametrize("mkn", [(7, 1000, 1000), (24, 48, 32),
                                 (33, 64, 1000)])
def test_scaled_mm_route_pads_exactly(mkn, dtype):
    """The card route's operand handling (zero-padding to multiples of
    16, the column-major ``qw.t()``, the folded dequantization, the cut)
    on CPU tensors, where ``torch._scaled_mm`` also runs, against the
    plain version; one count a call."""
    m, k, n = mkn
    rng = np.random.default_rng(m + k + n)
    x = torch.from_numpy(rng.standard_normal((m, k)).astype(np.float32))
    w = torch.from_numpy((rng.standard_normal((n, k)) * 0.05).astype(
        np.float32))
    sx, sw = 448.0 / x.abs().amax(), 448.0 / w.abs().amax()
    qx, qw = fp8.quantize_e4m3(x, sx), fp8.quantize_e4m3(w, sw)
    _device.reset_launch_counts()
    got = fp8._scaled_mm(qx, qw, sx, sw, getattr(torch, dtype))
    assert _device.launch_counts()["fp8_gemm"] == 1
    _device.reset_launch_counts()
    want = fp8.fp8_gemm_reference(qx, qw, sx, sw, getattr(torch, dtype))
    assert got.shape == (m, n) and got.is_contiguous()
    mag = ((qx.float().abs() @ qw.float().abs().t()) / (sx * sw)).numpy()
    _assert_gemm_close(got.float().numpy(), want.float().numpy(), mag, dtype)


def test_fp8_gemm_takes_the_plain_version_on_the_cpu():
    qx = torch.ones(4, 8).to(torch.float8_e4m3fn)
    _device.reset_launch_counts()
    y = fp8.fp8_gemm(qx, qx, torch.tensor(2.0), torch.tensor(4.0),
                     torch.float32)
    assert not any(_device.launch_counts().values())
    assert torch.equal(y, torch.full((4, 4), 1.0))


# ---------------------------------------------------------------------------
# the GPT's fp8 path
# ---------------------------------------------------------------------------

SHAPE = dict(num_layers=2, hidden_size=64, num_attention_heads=4,
             vocab_size=128, max_position_embeddings=32, hidden_dropout=0.0,
             attention_dropout=0.0, fp8=True)
GPT_CASES = {
    "unfused": {},
    "fused_block_selective_elementwise": dict(
        fused_block=True, recompute_granularity="selective_elementwise"),
    "full": dict(recompute_granularity="full"),
}


def _gpt_setup(extra):
    jcfg = JaxGPTConfig(**SHAPE, **extra)
    tcfg = GPTConfig(**SHAPE, **extra)
    jp = jax_init(jcfg, jax.random.PRNGKey(0))
    tp = params_from_jax(jax.tree_util.tree_map(np.asarray, jp))
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, 128, size=(2, 32)).astype(np.int32)
    return jcfg, tcfg, jp, tp, tokens, np.roll(tokens, -1, axis=1)


def _assert_states_close(jstates, tstates, rtol=1e-6):
    for name in FP8_GEMM_NAMES:
        for jm, tm in zip(jstates[name], tstates[name]):
            for a, b in zip(jm, tm):
                np.testing.assert_allclose(b.numpy(), np.asarray(a),
                                           rtol=rtol, atol=0)


@pytest.mark.parametrize("case", list(GPT_CASES))
def test_fp8_gpt_matches_jax_over_two_steps(case):
    jcfg, tcfg, jp, tp, tokens, labels = _gpt_setup(GPT_CASES[case])
    js = jax_states(jcfg)
    ts = init_gpt_fp8_states(tcfg, device="cpu")
    _assert_states_close(js, ts, rtol=0)
    for _ in range(2):
        def jf(p, c):
            return jax_gpt_loss(jcfg, p, jnp.asarray(tokens),
                                jnp.asarray(labels), fp8_states=js,
                                fp8_carriers=c)
        (jl, jnew), (jg, jamax) = jax.value_and_grad(
            jf, argnums=(0, 1), has_aux=True)(jp, jax_carriers(jcfg))
        js = jax_record(jcfg, jnew, jamax)
        box = {}

        def tf(tree):
            loss, box["states"] = gpt_loss(
                tcfg, tree[0], torch.from_numpy(tokens),
                torch.from_numpy(labels), fp8_states=ts,
                fp8_carriers=tree[1])
            return loss
        tl, (tg, tamax) = value_and_grad(
            tf, (tp, init_gpt_fp8_carriers(tcfg, device="cpu")))
        ts = record_gpt_grad_amaxes(tcfg, box["states"], tamax)
        np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
        for a, b in zip(jax.tree_util.tree_leaves(jg), tree_leaves(tg)):
            a = _np(a)
            assert np.abs(b.numpy() - a).max() <= 1e-4 * np.abs(a).max()
        _assert_states_close(js, ts)
    for name in FP8_GEMM_NAMES:
        for meta in ts[name]:
            assert (meta.amax_history[:, :2] > 0).all(), name
        assert (ts[name].g.scale != 1.0).all(), name
    # gradients reach the params through the quantized GEMMs
    assert float(tg["layers"]["qkv_w"].norm()) > 0


def test_fp8_states_carry_over_from_jax():
    """``convert.fp8_state_from_jax``: a mid-run JAX state gives the
    port's step the same loss and states as JAX's step from it."""
    jcfg, tcfg, jp, tp, tokens, labels = _gpt_setup({})
    js = jax_states(jcfg)
    (_, jnew), (_, jamax) = jax.value_and_grad(
        lambda p, c: jax_gpt_loss(jcfg, p, jnp.asarray(tokens),
                                  jnp.asarray(labels), fp8_states=js,
                                  fp8_carriers=c),
        argnums=(0, 1), has_aux=True)(jp, jax_carriers(jcfg))
    js = jax_record(jcfg, jnew, jamax)
    ts = fp8_state_from_jax(js)
    _assert_states_close(js, ts, rtol=0)
    one = fp8_state_from_jax(jfd.init_fp8_dense_state(3))
    assert one.g is None and one.x.amax_history.shape == (3,)
    jl, jnew = jax_gpt_loss(jcfg, jp, jnp.asarray(tokens),
                            jnp.asarray(labels), fp8_states=js,
                            fp8_carriers=jax_carriers(jcfg))
    tl, tnew = gpt_loss(tcfg, tp, torch.from_numpy(tokens),
                        torch.from_numpy(labels), fp8_states=ts,
                        fp8_carriers=init_gpt_fp8_carriers(tcfg, "cpu"))
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    _assert_states_close(jnew, tnew)


def test_fp8_gpt_forward_matches_jax():
    jcfg, tcfg, jp, tp, tokens, _ = _gpt_setup({})
    jl, jnew = jax_gpt_forward(jcfg, jp, jnp.asarray(tokens),
                               fp8_states=jax_states(jcfg),
                               fp8_carriers=jax_carriers(jcfg))
    tl, tnew = gpt_forward(tcfg, tp, torch.from_numpy(tokens),
                           fp8_states=init_gpt_fp8_states(tcfg, "cpu"),
                           fp8_carriers=init_gpt_fp8_carriers(tcfg, "cpu"))
    assert tl.shape == (2, 32, 128) and tl.dtype == torch.float32
    a = np.asarray(jl)
    assert np.abs(tl.detach().numpy() - a).max() <= 1e-5 * np.abs(a).max()
    _assert_states_close(jnew, tnew)


def test_flag_and_states_must_agree():
    jcfg, tcfg, jp, tp, tokens, labels = _gpt_setup({})
    t, lab = torch.from_numpy(tokens), torch.from_numpy(labels)
    states = init_gpt_fp8_states(tcfg, device="cpu")
    carriers = init_gpt_fp8_carriers(tcfg, device="cpu")
    with pytest.raises(ValueError, match="must agree"):
        gpt_loss(tcfg, tp, t, lab)  # the flag without states
    with pytest.raises(ValueError, match="must agree"):
        gpt_forward(tcfg, tp, t)
    off = dataclasses.replace(tcfg, fp8=False)
    with pytest.raises(ValueError, match="must agree"):
        gpt_hidden(off, tp, t, fp8_states=states, fp8_carriers=carriers)
    with pytest.raises(ValueError, match="must agree"):
        jax_gpt_loss(jcfg, jp, jnp.asarray(tokens), jnp.asarray(labels))
    # the exact model, fp8 off, is within e4m3 noise of the fp8 loss
    ref = float(gpt_loss(off, tp, t, lab))
    loss, _ = gpt_loss(tcfg, tp, t, lab, fp8_states=states,
                       fp8_carriers=carriers)
    assert abs(float(loss) - ref) / ref < 0.1


@pytest.mark.parametrize("rg, calls", [
    (None, 8), ("selective", 8), ("selective_elementwise", 8), ("full", 16)])
def test_only_full_recompute_replays_the_fp8_gemm(monkeypatch, rg, calls):
    """The selective policies keep the fp8 GEMM's output (the custom op
    ``FP8_GEMM``, as JAX's ``dots_with_no_batch_dims_saveable`` keeps the
    fp8 einsum); "full" recomputes it: 4 GEMMs a layer, 2 layers, counted
    at the plain version the op runs on the CPU."""
    assert fp8.FP8_GEMM in lm._NO_BATCH_DIM_GEMMS
    count = {"n": 0}
    plain = fp8.fp8_gemm_reference

    def spy(*args):
        count["n"] += 1
        return plain(*args)
    monkeypatch.setattr(fp8, "fp8_gemm_reference", spy)
    extra = dict(recompute_granularity=rg,
                 fused_block=rg == "selective_elementwise")
    _, tcfg, _, tp, tokens, labels = _gpt_setup(extra)
    states = init_gpt_fp8_states(tcfg, device="cpu")
    value_and_grad(lambda tree: gpt_loss(
        tcfg, tree[0], torch.from_numpy(tokens), torch.from_numpy(labels),
        fp8_states=states, fp8_carriers=tree[1])[0],
        (tp, init_gpt_fp8_carriers(tcfg, device="cpu")))
    assert count["n"] == calls
