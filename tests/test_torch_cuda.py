"""The port's CUDA kernels on the card, against their plain versions.

Every test here needs an NVIDIA GPU: it carries the ``cuda`` marker and
skips (from its fixture) on a host without one. The file imports
neither JAX nor ``apex_tpu``, so it runs on the machine with the card,
which has no JAX; ``tests/conftest.py`` imports JAX, hence
``--noconftest`` there:

    python -m pytest --noconftest -q tests/test_torch_cuda.py

Tolerances: fp32 atol 2e-5, rtol 1e-5 (summation order only); bf16 atol
2e-2, rtol 1e-2 (one bf16 rounding of values of order 1); LayerNorm
parameter gradients, column sums over the rows, atol 1e-3 rtol 1e-4;
packed Adam, which rounds every operation as its plain version does,
rtol 1e-6 on fp32 state and one bf16 rounding on the params; the
2-layer train step on the card against the CPU, loss rtol 1e-5 and each
gradient leaf within 1e-4 of its largest entry.
"""
import numpy as np
import pytest
import torch

from apex_tpu_torch import _device
from apex_tpu_torch._tree import tree_leaves, tree_map, value_and_grad
from apex_tpu_torch.ops.flash_attention import (
    flash_attention_bwd,
    flash_attention_bwd_reference,
    flash_attention_fwd,
    flash_attention_fwd_reference,
)
from apex_tpu_torch.ops.flash_decode import flash_decode, paged_decode_reference
from apex_tpu_torch.ops.layer_norm import (
    layer_norm,
    layer_norm_bwd_reference,
    layer_norm_fwd,
    layer_norm_reference,
)
from apex_tpu_torch.ops.packed_optimizer import (
    packed_adam_apply,
    packed_adam_reference,
)

pytestmark = pytest.mark.cuda

TOL = {torch.float32: dict(atol=2e-5, rtol=1e-5),
       torch.bfloat16: dict(atol=2e-2, rtol=1e-2)}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernel)")
    return torch.device("cuda")


def _decode_case(dev, kv_dtype, q_dtype, lens=(0, 1, 7, 8, 23, 64),
                 P=64, n=4, ps=8, d=64, mp=8, seed=0):
    """Random pools and a page table in which no page is used twice
    (as the allocator hands them out); page 0 is the garbage page."""
    rng = np.random.default_rng(seed)
    q = torch.from_numpy(rng.normal(size=(len(lens), n, d)).astype(
        np.float32)).to(dev, q_dtype)
    k, v = (torch.from_numpy(rng.normal(size=(P, n, ps, d)).astype(
        np.float32)).to(dev, kv_dtype) for _ in range(2))
    pages = rng.permutation(P - 1)[:len(lens) * mp] + 1
    pt = torch.from_numpy(pages.reshape(len(lens), mp).astype(
        np.int32)).to(dev)
    kl = torch.tensor(lens, dtype=torch.int32, device=dev)
    return q, k, v, pt, kl


@pytest.mark.parametrize("kv_dtype,q_dtype", [
    (torch.float32, torch.float32), (torch.bfloat16, torch.bfloat16),
    (torch.bfloat16, torch.float32)], ids=["f32", "bf16", "f32q_bf16kv"])
def test_flash_decode_kernel_matches_plain(cuda_device, kv_dtype, q_dtype):
    args = _decode_case(cuda_device, kv_dtype, q_dtype)
    _device.reset_launch_counts()
    got = flash_decode(*args)
    assert _device.launch_counts()["flash_decode"] == 1
    want = paged_decode_reference(*args)
    torch.cuda.synchronize()
    assert got.dtype == q_dtype
    assert torch.equal(got[0], torch.zeros_like(got[0]))  # kv_len == 0
    torch.testing.assert_close(got.float(), want.float(), **TOL[q_dtype])


def test_flash_decode_kernel_never_reads_past_the_length(cuda_device):
    """NaN in the garbage page and in the stale rows of each ragged
    last page leaves the output bitwise unchanged."""
    q, k, v, pt, kl = _decode_case(cuda_device, torch.float32,
                                   torch.float32)
    for b, L in enumerate(kl.tolist()):
        pt[b, -(-L // 8):] = 0
    clean = flash_decode(q, k, v, pt, kl)
    kp, vp = k.clone(), v.clone()
    kp[0], vp[0] = float("nan"), float("nan")
    for b, L in enumerate(kl.tolist()):
        if L % 8:
            last = int(pt[b, L // 8])
            kp[last, :, L % 8:] = float("nan")
            vp[last, :, L % 8:] = float("nan")
    assert torch.equal(flash_decode(q, kp, vp, pt, kl), clean)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_layer_norm_kernel_matches_plain(cuda_device, dtype):
    rng = np.random.default_rng(1)
    x = torch.from_numpy((rng.normal(size=(64, 1024)) * 3 + 1).astype(
        np.float32)).to(cuda_device, dtype)
    w, b = (torch.from_numpy(rng.normal(size=(1024,)).astype(
        np.float32)).to(cuda_device) for _ in range(2))
    _device.reset_launch_counts()
    y, mu, rstd = layer_norm_fwd(x, w, b)
    assert _device.launch_counts()["layer_norm_fwd"] == 1
    ry, rmu, rrstd = layer_norm_reference(x, w, b, 1e-5)
    assert y.dtype == dtype
    torch.testing.assert_close(y.float(), ry.float(), **TOL[dtype])
    torch.testing.assert_close(mu, rmu, **TOL[torch.float32])
    torch.testing.assert_close(rstd, rrstd, **TOL[torch.float32])


@pytest.mark.parametrize("x_dtype,dy_dtype", [
    (torch.float32, torch.float32), (torch.float32, torch.bfloat16),
    (torch.bfloat16, torch.bfloat16)])
def test_layer_norm_grad_kernel_matches_plain(cuda_device, x_dtype,
                                              dy_dtype):
    """Autograd through layer_norm on the card runs the backward kernel;
    its dx, dgamma, dbeta equal the plain backward's."""
    rng = np.random.default_rng(2)
    x = torch.from_numpy((rng.normal(size=(4, 64, 1024)) * 3 + 1).astype(
        np.float32)).to(cuda_device, x_dtype).requires_grad_(True)
    w, b = (torch.from_numpy(rng.normal(size=(1024,)).astype(
        np.float32)).to(cuda_device).requires_grad_(True) for _ in range(2))
    dy = torch.from_numpy(rng.normal(size=(4, 64, 1024)).astype(
        np.float32)).to(cuda_device, dy_dtype)
    _device.reset_launch_counts()
    y = layer_norm(x, w, b)
    y.backward(dy.to(y.dtype))
    counts = _device.launch_counts()
    assert counts["layer_norm_fwd"] == 1 and counts["layer_norm_bwd"] == 1
    _, mu, rstd = layer_norm_reference(x.detach().reshape(-1, 1024), w, b,
                                       1e-5)
    rdx, rdw, rdb = layer_norm_bwd_reference(
        dy.to(y.dtype).reshape(-1, 1024), x.detach().reshape(-1, 1024), mu,
        rstd, w)
    torch.testing.assert_close(x.grad.float().reshape(-1, 1024),
                               rdx.float(), **TOL[x_dtype])
    torch.testing.assert_close(w.grad, rdw, atol=1e-3, rtol=1e-4)
    torch.testing.assert_close(b.grad, rdb, atol=1e-3, rtol=1e-4)
    with torch.no_grad():  # serving: the forward kernel alone
        _device.reset_launch_counts()
        layer_norm(x, w, b)
        assert _device.launch_counts()["layer_norm_bwd"] == 0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal,masked,p,s_q,s_k", [
    (True, False, 0.0, 256, 256), (False, True, 0.0, 200, 200),
    (True, True, 0.1, 200, 200), (False, False, 0.0, 96, 300)],
    ids=["causal", "kv_mask", "causal_mask_dropout", "cross"])
def test_flash_attention_kernels_match_plain(cuda_device, dtype, causal,
                                             masked, p, s_q, s_k):
    rng = np.random.default_rng(3)

    def t(*shape):
        return torch.from_numpy(rng.normal(size=shape).astype(
            np.float32)).to(cuda_device, dtype)
    q, do = t(2, 4, s_q, 64), t(2, 4, s_q, 64)
    k, v = t(2, 4, s_k, 64), t(2, 4, s_k, 64)
    kv_mask = None
    if masked:
        kv_mask = torch.ones(2, s_k, dtype=torch.bool, device=cuda_device)
        kv_mask[0, s_k // 3:] = False
        kv_mask[1] = False
    kw = dict(causal=causal, kv_mask=kv_mask, dropout_p=p,
              dropout_seed=99 if p else None)
    _device.reset_launch_counts()
    o, lse = flash_attention_fwd(q, k, v, **kw)
    dq, dk, dv = flash_attention_bwd(q, k, v, o, lse, do, **kw)
    counts = _device.launch_counts()
    assert counts["flash_attn_fwd"] == 1 and counts["flash_attn_bwd"] == 1
    ro, rlse = flash_attention_fwd_reference(q, k, v, **kw)
    grads = flash_attention_bwd_reference(q, k, v, ro, rlse, do, **kw)
    torch.cuda.synchronize()
    torch.testing.assert_close(o.float(), ro.float(), **TOL[dtype])
    torch.testing.assert_close(lse, rlse, **TOL[torch.float32])
    for got, want in zip((dq, dk, dv), grads):
        torch.testing.assert_close(got.float(), want.float(), **TOL[dtype])
    if masked:
        assert torch.equal(o[1], torch.zeros_like(o[1]))
        for g in (dq, dk, dv):
            assert torch.equal(g[1], torch.zeros_like(g[1]))


@pytest.mark.parametrize("mode", ["adam", "adamw", "noop", "no_update_mv"])
def test_packed_adam_kernel_matches_plain(cuda_device, mode):
    rng = np.random.default_rng(4)
    n = 64 * 1024

    def t(scale, positive=False):
        a = rng.normal(size=n) * scale
        return torch.from_numpy(np.abs(a) if positive else a).to(
            cuda_device, torch.float32)
    g, m0, v0, src0 = t(1e-3).to(torch.bfloat16), t(1e-3), t(1e-6, True), \
        t(0.02)
    kw = {"adamw": dict(wd=0.1),
          "noop": dict(noop=torch.tensor(True, device=cuda_device)),
          }.get(mode, {})
    write = dict(write_mv=False, write_master=False) \
        if mode == "no_update_mv" else {}
    hyper = dict(param_dtype=torch.bfloat16, lr=1e-4,
                 bc1=torch.tensor(0.1, device=cuda_device),
                 bc2=torch.tensor(0.001, device=cuda_device), **kw)
    m, v, src = m0.clone(), v0.clone(), src0.clone()
    _device.reset_launch_counts()
    p_out, *_ = packed_adam_apply(g, m, v, src, **hyper, **write)
    assert _device.launch_counts()["packed_adam"] == 1
    rp, rm, rv, rs = packed_adam_reference(g, m0, v0, src0, **hyper)
    torch.testing.assert_close(p_out.float(), rp.float(), rtol=8e-3,
                               atol=1e-9)
    if mode in ("noop", "no_update_mv"):
        for got, before in ((m, m0), (v, v0), (src, src0)):
            assert torch.equal(got, before)
    else:
        for got, want in ((m, rm), (v, rv), (src, rs)):
            torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-9)


def test_train_step_on_card_matches_cpu(cuda_device):
    """A 2-layer fp32 GPT: loss and every gradient of gpt_loss on the
    card (kernels) against the CPU (plain versions), then one packed
    Adam step each, through every training kernel."""
    from apex_tpu_torch.optimizers import FusedAdam
    from apex_tpu_torch.transformer.testing import (
        GPTConfig,
        gpt_loss,
        init_gpt_params,
    )

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = GPTConfig(num_layers=2, hidden_size=256, num_attention_heads=4,
                    vocab_size=512, max_position_embeddings=128,
                    hidden_dropout=0.0, attention_dropout=0.0)
    cpu_params = init_gpt_params(cfg, torch.Generator().manual_seed(0))
    rng = np.random.default_rng(5)
    tokens = torch.from_numpy(rng.integers(0, 512, (2, 128)))
    labels = torch.roll(tokens, -1, dims=1)
    out = {}
    for dev in ("cpu", cuda_device):
        params = tree_map(lambda x: x.to(dev, copy=True), cpu_params)
        _device.reset_launch_counts()
        loss, grads = value_and_grad(lambda p: gpt_loss(
            cfg, p, tokens.to(dev), labels.to(dev)), params)
        opt = FusedAdam(lr=1e-4, master_weights=True, packed=True)
        params, _ = opt.step(grads, opt.init(params), params)
        out[str(dev)] = (float(loss), [g.cpu() for g in tree_leaves(grads)],
                         _device.launch_counts())
    (lc, gc, cc), (lg, gg, cg) = out["cpu"], out[str(cuda_device)]
    assert not any(cc.values())
    for name in ("layer_norm_fwd", "layer_norm_bwd", "flash_attn_fwd",
                 "flash_attn_bwd", "packed_adam"):
        assert cg[name] > 0, name
    assert abs(lg - lc) <= 1e-5 * abs(lc)
    for a, b in zip(gc, gg):
        assert float((a - b).abs().max()) <= 1e-4 * float(a.abs().max())


def test_engine_on_card_matches_cpu(cuda_device):
    """A tiny fp32 model served on the card and on the CPU (plain
    versions) emits the same greedy tokens, through both kernels."""
    from apex_tpu_torch.serving import Request, ServingEngine
    from apex_tpu_torch.transformer.testing import GPTConfig, init_gpt_params

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = GPTConfig(num_layers=2, hidden_size=64, num_attention_heads=4,
                    vocab_size=128, max_position_embeddings=64)
    params = init_gpt_params(cfg, torch.Generator().manual_seed(0))
    params["embedding"]["position"] = params["embedding"]["position"] * 40

    def trace():
        rng = np.random.default_rng(4)
        return [Request(prompt=[int(t) for t in rng.integers(0, 128, L)],
                        max_new_tokens=8, arrival_step=2 * i, rid=i)
                for i, L in enumerate((5, 12, 9))]

    kw = dict(n_slots=2, prefill_chunk=4)
    want = ServingEngine(cfg, params, device="cpu", **kw).generate(trace())
    _device.reset_launch_counts()
    got = ServingEngine(cfg, params, device=cuda_device,
                        **kw).generate(trace())
    counts = _device.launch_counts()
    assert got == want
    assert counts["flash_decode"] > 0 and counts["layer_norm_fwd"] > 0
