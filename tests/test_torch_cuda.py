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
rtol 1e-6 on fp32 state and one bf16 rounding on the params; the fused
block tails as the other kernels, their fp32 column sums (bias and
LayerNorm-parameter gradients) atol 1e-3 rtol 1e-4; the 2-layer train
step on the card against the CPU (unfused, and fused under
``selective_elementwise`` recompute), loss rtol 1e-5 and each gradient
leaf within 1e-4 of its largest entry; the fused softmax kernels, whose
probabilities are about 1/sk and gradients smaller, on their relative
term with a floor well under the values: fp32 atol 1e-6 rtol 1e-5
(``__expf``, and the backward's sum order where it cancels), bf16 atol
1e-4 rtol 1e-2 and fp16 atol 1e-5 rtol 1e-3 (one rounding of the
output); the bf16 2-layer non-flash
GPT and BERT steps on the card against the CPU, loss rtol 2e-3 and each
gradient leaf within 5e-2 of its largest entry (bf16 GEMMs round at
other places in cuBLAS and on the CPU).
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
from apex_tpu_torch.ops import fused_block as fb
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
       torch.bfloat16: dict(atol=2e-2, rtol=1e-2),
       torch.float16: dict(atol=1e-3, rtol=1e-3)}
SOFTMAX_TOL = {torch.float32: dict(atol=1e-6, rtol=1e-5),
               torch.bfloat16: dict(atol=1e-4, rtol=1e-2),
               torch.float16: dict(atol=1e-5, rtol=1e-3)}


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


SUM_TOL = dict(atol=1e-3, rtol=1e-4)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("p", [0.0, 0.1])
@pytest.mark.parametrize("rows,n", [(1000, 1024), (40, 4096), (7, 64)])
def test_fused_block_kernels_match_plain(cuda_device, dtype, p, rows, n):
    """The six fused-tail kernels against their plain versions on the
    same CUDA tensors, forward and backward, with and without hash
    dropout (a negative seed), at a row count no block size divides."""
    g = torch.Generator(device=cuda_device).manual_seed(rows + n)

    def t(*shape, scale=1.0, dt=dtype):
        return (torch.randn(*shape, generator=g, device=cuda_device)
                * scale).to(dt)
    x, r, dy, ds = (t(rows, n) for _ in range(4))
    b, lb = t(n, scale=0.1, dt=torch.float32), t(n, scale=0.1,
                                                   dt=torch.float32)
    w = t(n, scale=0.2, dt=torch.float32) + 1.0
    seed = -987654 if p else None
    _device.reset_launch_counts()
    got = {
        "bias_gelu_fwd": (fb._bias_gelu_fwd_impl(x, b),),
        "bias_gelu_bwd": fb._bias_gelu_bwd(dy, x, b),
        "bias_dropout_residual_fwd": (fb._bdr_fwd_impl(x, b, r, seed, p),),
        "bias_dropout_residual_bwd": fb._bdr_bwd(dy, seed, p, dtype),
        "residual_ln_fwd": fb._raln_fwd_impl(x, b, r, w, lb, seed, 1e-5, p),
    }
    s, _, mu, rstd = got["residual_ln_fwd"]
    got["residual_ln_bwd"] = fb._raln_bwd(ds, dy, s, mu, rstd, w, seed, p)
    counts = _device.launch_counts()
    want = {
        "bias_gelu_fwd": (fb.bias_gelu_reference(x, b),),
        "bias_gelu_bwd": fb.bias_gelu_bwd_reference(dy, x, b),
        "bias_dropout_residual_fwd": (fb.bias_dropout_residual_reference(
            x, b, r, seed, p),),
        "bias_dropout_residual_bwd": fb.bias_dropout_residual_bwd_reference(
            dy, seed, p, dtype),
        "residual_ln_fwd": fb.residual_ln_reference(x, b, r, w, lb, seed,
                                                    1e-5, p),
        # the plain backward on the kernel forward's sum and statistics
        "residual_ln_bwd": fb.residual_ln_bwd_reference(ds, dy, s, mu, rstd,
                                                        w, seed, p),
    }
    torch.cuda.synchronize()
    for name in got:
        assert counts[name] == 1, name
        for k, (a, e) in enumerate(zip(got[name], want[name])):
            assert a.dtype == e.dtype and a.shape == e.shape, (name, k)
            tol = SUM_TOL if a.dim() == 1 else (
                TOL[torch.float32] if a.dtype == torch.float32 or
                a.shape[-1] == 1 else TOL[dtype])
            torch.testing.assert_close(a.float(), e.float(), **tol,
                                       msg=f"{name} output {k}")


def test_fused_block_kernels_refuse_what_they_do_not_take(cuda_device):
    x = torch.zeros(8, 60, device=cuda_device)
    b = torch.zeros(60, device=cuda_device)
    with pytest.raises(ValueError, match="multiple of 8"):
        fb.bias_gelu(x, b)
    x = torch.zeros(8, 8192, device=cuda_device)
    b = torch.zeros(8192, device=cuda_device)
    with pytest.raises(ValueError, match="at most 4096"):
        fb.residual_add_layer_norm(x, b, x, b, b)
    with pytest.raises(ValueError, match="one dtype"):
        fb.bias_dropout_residual(x, b, x.to(torch.bfloat16))
    with pytest.raises(ValueError, match="one dtype"):
        fb.bias_gelu(x.half(), b)


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


def test_fused_train_step_on_card_matches_cpu(cuda_device):
    """The same 2-layer fp32 GPT with ``fused_block=True`` and
    ``selective_elementwise`` recompute: card against CPU, through the
    fused-tail kernels, with no forward kernel replayed in backward."""
    from apex_tpu_torch.transformer.testing import (
        GPTConfig,
        gpt_loss,
        init_gpt_params,
    )

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = GPTConfig(num_layers=2, hidden_size=256, num_attention_heads=4,
                    vocab_size=512, max_position_embeddings=128,
                    hidden_dropout=0.0, attention_dropout=0.0,
                    fused_block=True,
                    recompute_granularity="selective_elementwise")
    cpu_params = init_gpt_params(cfg, torch.Generator().manual_seed(1))
    rng = np.random.default_rng(6)
    tokens = torch.from_numpy(rng.integers(0, 512, (2, 128)))
    labels = torch.roll(tokens, -1, dims=1)
    out = {}
    for dev in ("cpu", cuda_device):
        params = tree_map(lambda x: x.to(dev, copy=True), cpu_params)
        _device.reset_launch_counts()
        loss, grads = value_and_grad(lambda p: gpt_loss(
            cfg, p, tokens.to(dev), labels.to(dev)), params)
        out[str(dev)] = (float(loss), [g.cpu() for g in tree_leaves(grads)],
                         _device.launch_counts())
    (lc, gc, cc), (lg, gg, cg) = out["cpu"], out[str(cuda_device)]
    assert not any(cc.values())
    for name in ("flash_attn_fwd", "flash_attn_bwd", "bias_gelu_fwd",
                 "bias_gelu_bwd", "bias_dropout_residual_fwd",
                 "bias_dropout_residual_bwd", "residual_ln_fwd",
                 "residual_ln_bwd"):
        assert cg[name] == 2, (name, cg)
    assert cg["layer_norm_fwd"] == cg["layer_norm_bwd"] == 3, cg
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


SOFTMAX_CASES = {
    # name: (shape [b, np, sq, sk], variant, scale)
    "causal": ((2, 4, 256, 256), "causal", 0.125),
    "unmasked sk 1000": ((2, 2, 16, 1000), "plain", 1.0),
    "padding mask": ((2, 4, 64, 512), "padding", 1.0),
    "general mask, dead row": ((2, 4, 64, 512), "general", 0.5),
    "sk 16384": ((1, 1, 3, 16384), "padding", 1.0),
    "causal sk 2048": ((1, 2, 64, 2048), "causal", 1.0),
}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("case", list(SOFTMAX_CASES))
def test_fused_softmax_kernels_match_plain(cuda_device, dtype, case):
    """Kernels #14-#16 against their plain versions on the same CUDA
    tensors; a fully masked row is the uniform 1/sk."""
    from apex_tpu_torch.transformer.functional import fused_softmax as fs

    shape, variant, scale = SOFTMAX_CASES[case]
    b, n, sq, sk = shape
    g = torch.Generator(device=cuda_device).manual_seed(sk + sq)
    x = (torch.randn(shape, generator=g, device=cuda_device) * 3).to(dtype)
    dy = torch.randn(shape, generator=g, device=cuda_device).to(dtype)
    mask = None
    if variant == "padding":
        mask = torch.zeros(b, 1, 1, sk, dtype=torch.bool, device=cuda_device)
        mask[0, ..., sk // 3:] = True
    elif variant == "general":
        mask = torch.rand(b, 1, sq, sk, generator=g,
                          device=cuda_device) > 0.7
        mask[1, 0, 5] = True
    _device.reset_launch_counts()
    if mask is None:
        y = fs.softmax_fwd(x, scale, variant == "causal")
        want = fs.softmax_fwd_reference(x, scale, variant == "causal")
        key = "softmax_fwd"
    else:
        y = fs.softmax_masked_fwd(x, mask, scale)
        want = fs.softmax_masked_fwd_reference(x, mask, scale)
        key = "softmax_masked_fwd"
    dx = fs.softmax_bwd(dy, y, scale)
    counts = _device.launch_counts()
    torch.cuda.synchronize()
    assert counts[key] == 1 and counts["softmax_bwd"] == 1
    assert y.dtype == dtype and dx.dtype == dtype
    tol = SOFTMAX_TOL[dtype]
    torch.testing.assert_close(y.float(), want.float(), **tol)
    torch.testing.assert_close(
        dx.float(), fs.softmax_bwd_reference(dy, y, scale).float(), **tol)
    if variant == "general":
        torch.testing.assert_close(
            y[1, :, 5].float(), torch.full_like(y[1, :, 5].float(), 1 / sk),
            **tol)


def test_fused_softmax_kernels_refuse_what_they_do_not_take(cuda_device):
    from apex_tpu_torch.transformer.functional import fused_softmax as fs

    x = torch.zeros(1, 1, 2, 16385, device=cuda_device)
    with pytest.raises(ValueError, match="16384"):
        fs.softmax_fwd(x)
    with pytest.raises(TypeError, match="fp32/bf16/fp16"):
        fs.softmax_fwd(torch.zeros(2, 8, dtype=torch.float64,
                                   device=cuda_device))
    y = torch.zeros(2, 8, device=cuda_device)
    with pytest.raises(ValueError, match="dtype and shape"):
        fs.softmax_bwd(y.to(torch.bfloat16), y)


def _card_against_cpu(cuda_device, loss_of, params, kernels):
    """Loss and gradients on the CPU (plain versions) and on the card
    (kernels), compared; ``kernels`` must launch on the card only."""
    out = {}
    for dev in ("cpu", cuda_device):
        p = tree_map(lambda x: x.to(dev, copy=True), params)
        _device.reset_launch_counts()
        loss, grads = value_and_grad(lambda q: loss_of(q, dev), p)
        out[str(dev)] = (float(loss), [g.float().cpu()
                                       for g in tree_leaves(grads)],
                         _device.launch_counts())
    (lc, gc, cc), (lg, gg, cg) = out["cpu"], out[str(cuda_device)]
    assert not any(cc.values())
    for name in kernels:
        assert cg[name] > 0, (name, cg)
    assert abs(lg - lc) <= 2e-3 * abs(lc)
    for a, b in zip(gc, gg):
        assert float((a - b).abs().max()) <= 5e-2 * float(a.abs().max())


def test_no_flash_bf16_train_step_on_card_matches_cpu(cuda_device):
    """A 2-layer bf16 GPT without flash under ``selective`` recompute:
    the causal fused softmax forward (replayed) and backward."""
    from apex_tpu_torch.transformer.testing import (
        GPTConfig,
        gpt_loss,
        init_gpt_params,
    )

    cfg = GPTConfig(num_layers=2, hidden_size=256, num_attention_heads=4,
                    vocab_size=512, max_position_embeddings=128,
                    hidden_dropout=0.0, attention_dropout=0.0,
                    compute_dtype=torch.bfloat16, use_flash_attention=False,
                    recompute_granularity="selective")
    params = tree_map(lambda x: x.to(torch.bfloat16), init_gpt_params(
        cfg, torch.Generator().manual_seed(2)))
    rng = np.random.default_rng(7)
    tokens = torch.from_numpy(rng.integers(0, 512, (2, 128)))
    labels = torch.roll(tokens, -1, dims=1)
    _card_against_cpu(
        cuda_device, lambda p, d: gpt_loss(cfg, p, tokens.to(d),
                                           labels.to(d)),
        params, ("softmax_fwd", "softmax_bwd", "layer_norm_fwd"))


def test_bert_bf16_step_on_card_matches_cpu(cuda_device):
    """A 2-layer bf16 BERT without flash under a padding mask: the
    masked fused softmax and its backward."""
    from apex_tpu_torch.contrib.xentropy import softmax_cross_entropy_loss
    from apex_tpu_torch.transformer.testing import (
        GPTConfig,
        bert_forward,
        init_gpt_params,
    )

    cfg = GPTConfig(num_layers=2, hidden_size=256, num_attention_heads=4,
                    vocab_size=512, max_position_embeddings=128,
                    hidden_dropout=0.0, attention_dropout=0.0,
                    compute_dtype=torch.bfloat16, use_flash_attention=False)
    params = init_gpt_params(cfg, torch.Generator().manual_seed(3))
    rng = np.random.default_rng(8)
    tokens = torch.from_numpy(rng.integers(0, 512, (2, 128)))
    labels = torch.from_numpy(rng.integers(0, 512, (2, 128)))
    pad = torch.ones(2, 128, dtype=torch.int32)
    pad[0, 90:] = 0
    labels[pad == 0] = -1

    def loss_of(p, d):
        logits, _ = bert_forward(cfg, p, tokens.to(d), pad.to(d))
        return softmax_cross_entropy_loss(
            logits.reshape(-1, 512).float(), labels.to(d).reshape(-1),
            padding_idx=-1).mean()
    _card_against_cpu(cuda_device, loss_of, params,
                      ("softmax_masked_fwd", "softmax_bwd"))
