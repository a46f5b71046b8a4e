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
other places in cuBLAS and on the CPU); the packed LAMB and SGD sweeps,
which round every elementwise operation once in their plain versions'
order (PyTorch's CUDA division may round LAMB's quotients an ulp
apart), rtol 1e-6 on fp32 results and one bf16 rounding on bf16 ones,
their row
sums rtol 1e-5 (summation order; one term of 1024 missing moves a sum by
~1e-3), max |x| exactly; 3 packed LAMB, SGD and NovoGrad steps on the
card against the CPU rtol 1e-5 atol 1e-7. Flash attention at every head
dim (bf16 on the tensor cores, fp32 on the CUDA cores; ragged and causal
cross lengths, a fully masked row, dropout) and the fused tails at widths
1000 to 16384 as at 64 and 1024, the bf16 flash backward twice bit for
bit; the flat scale bit for bit (one multiply and one cast on
both sides, nan included), axpby bit for bit (its products and sum
rounded one by one on both), the NovoGrad sweep as the other packed
sweeps (rtol 1e-6 on fp32 results, one bf16 rounding on bf16 params);
the 2-layer GPTs at head dims 128 and 80 as the other card-against-CPU
steps; the RMSNorm kernels and the LayerNorm at hidden 32768 and 65536
as the LayerNorm kernels; the memory-efficient norms against the plain
backward given the same fp32 x-hat (dx within one rounding of its dtype,
the fp32 parameter gradients within 1e-5 of their norm, which an x-hat
rounded to bf16, ~2e-3, fails) and against the plain backward that
keeps x (1e-4 fp32, 8e-3 bf16 of each norm: x-hat from y carries y's
rounding); the row statistics' counts
and maxima exactly, their sums rtol 1e-5; the monitored step's records
exactly. The norm backwards on both sides of their register tier (widths
1 to 8193, every dtype pair, x-hat) and the split decode (lengths at a
split and one either side, splits ending mid-page, every head dim) as
the LayerNorm and decode kernels, and each twice bit for bit. The fp8
GEMM route (``torch._scaled_mm``, the dequantization folded in, padded
to multiples of 16) against its plain version over the same fp8 bytes:
beyond one rounding of the output (2^-7 bf16, 2^-10 fp16), within 2^-13
of the sum of |products| (Hopper's fp8 tensor cores keep fewer bits in
their partial sums); the quantizers' bytes bit for bit against the CPU.
Host IO from card tensors (through one pinned staging buffer), ``GDSFile``
filling card tensors in place, the checkpoint round trip onto the card
and the ``cpu_offload`` GPT step: all bit for bit, against the CPU's
bytes or the step without offload.
"""
import contextlib
import copy
import importlib

import numpy as np
import pytest
import torch

from apex_tpu_torch import _build, _device
from apex_tpu_torch._tree import (
    tree_flatten,
    tree_leaves,
    tree_map,
    tree_unflatten,
    value_and_grad,
)
from apex_tpu_torch.ops.flash_attention import (
    flash_attention_bwd,
    flash_attention_bwd_reference,
    flash_attention_fwd,
    flash_attention_fwd_reference,
)
from apex_tpu_torch.ops import fused_block as fb
from apex_tpu_torch.ops.flash_decode import (
    DecodePlan,
    decode_plan,
    flash_decode,
    paged_decode_reference,
)
from apex_tpu_torch.ops.layer_norm import (
    layer_norm,
    layer_norm_bwd,
    layer_norm_bwd_reference,
    layer_norm_fwd,
    layer_norm_reference,
    rms_norm,
    rms_norm_bwd,
    rms_norm_bwd_reference,
    rms_norm_fwd,
    rms_norm_reference,
)
from apex_tpu_torch.ops.packed_optimizer import (
    multi_tensor_axpby_flat,
    multi_tensor_axpby_flat_reference,
    multi_tensor_scale_flat,
    multi_tensor_scale_flat_reference,
    packed_adam_apply,
    packed_adam_reference,
    packed_lamb_stage1,
    packed_lamb_stage1_reference,
    packed_novograd_apply,
    packed_novograd_reference,
    packed_row_reduce,
    packed_row_reduce_reference,
    packed_row_stats,
    packed_row_stats_reference,
    packed_scale_update,
    packed_scale_update_reference,
    packed_sgd_apply,
    packed_sgd_reference,
)

pytestmark = pytest.mark.cuda

# the modules (the package re-exports functions of the same names)
fd_mod = importlib.import_module("apex_tpu_torch.ops.flash_decode")
ln_mod = importlib.import_module("apex_tpu_torch.ops.layer_norm")

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
    (torch.bfloat16, torch.float32), (torch.float16, torch.float16),
    (torch.float16, torch.float32)],
    ids=["f32", "bf16", "f32q_bf16kv", "f16", "f32q_f16kv"])
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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
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
    (torch.bfloat16, torch.bfloat16), (torch.float16, torch.float16)])
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
    (True, True, 0.1, 200, 200), (False, False, 0.0, 96, 300),
    (True, False, 0.0, 1000, 1000), (True, True, 0.0, 17, 17),
    (True, False, 0.0, 320, 1000), (True, False, 0.0, 1000, 320),
    (False, True, 0.1, 300, 300)],
    ids=["causal", "kv_mask", "causal_mask_dropout", "cross", "ragged_1000",
         "ragged_17_mask", "causal_cross", "causal_cross_short_keys",
         "kv_mask_dropout_300"])
def test_flash_attention_kernels_match_plain(cuda_device, dtype, causal,
                                             masked, p, s_q, s_k):
    """Forward and backward at head dim 64 (bf16 on the tensor cores, fp32
    on the CUDA cores) against the plain versions: lengths that are not a
    whole number of tiles, causal with s_q != s_k both ways, a
    key-padding mask with a fully masked batch row, hash dropout."""
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
        assert bool((lse[1] == -1e30).all())
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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("p", [0.0, 0.1])
@pytest.mark.parametrize("rows,n", [(1000, 1024), (40, 4096), (7, 64),
                                    (40, 5120), (9, 8192), (3, 16384),
                                    (37, 1000), (5, 60)])
def test_fused_block_kernels_match_plain(cuda_device, dtype, p, rows, n):
    """The six fused-tail kernels against their plain versions on the
    same CUDA tensors, forward and backward, with and without hash
    dropout (a negative seed), at a row count no block size divides and
    at widths past one block's span (5120 to 16384) or not a multiple
    of 8 (1000, 60)."""
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
    x = torch.zeros(8, 8192, device=cuda_device)
    b = torch.zeros(8192, device=cuda_device)
    with pytest.raises(ValueError, match="at least 1"):
        fb._launch_bias_gelu_fwd(x[:, :0], b[:0])
    with pytest.raises(ValueError, match="one dtype"):
        fb.bias_dropout_residual(x, b, x.to(torch.bfloat16))
    with pytest.raises(ValueError, match="one dtype"):
        fb.bias_gelu(x.double(), b)


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


PACKED_F32 = dict(rtol=1e-6, atol=1e-9)
PACKED_BF16 = dict(rtol=8e-3, atol=1e-9)
ROW_SUM = dict(rtol=1e-5, atol=0.0)


def _flat(dev, rows, scale, seed, positive=False):
    a = np.random.default_rng(seed).normal(size=rows * 1024) * scale
    return torch.from_numpy(np.abs(a) if positive else a).to(dev,
                                                             torch.float32)


@pytest.mark.parametrize("rows", [8, 37])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("op", ["sqsum", "maxabs"])
def test_packed_row_reduce_kernel_matches_plain(cuda_device, op, dtype,
                                                rows):
    x = _flat(cuda_device, rows, 1.0, 5).to(dtype)
    inv = torch.tensor(0.5, device=cuda_device)
    _device.reset_launch_counts()
    got = packed_row_reduce(x, op=op, inv_scale=inv)
    assert _device.launch_counts()["packed_row_reduce"] == 1
    want = packed_row_reduce_reference(x, op=op, inv_scale=inv)
    assert got.shape == (rows,)
    if op == "maxabs":
        assert torch.equal(got, want)
    else:
        torch.testing.assert_close(got, want, **ROW_SUM)
    # the same inputs give the same bits: a fixed summation order
    assert torch.equal(packed_row_reduce(x, op=op, inv_scale=inv), got)


@pytest.mark.parametrize("rows", [8, 37])
@pytest.mark.parametrize("case", ["adamw", "adam_l2", "no_wd", "bf16",
                                  "noop"])
def test_packed_lamb_stage1_kernel_matches_plain(cuda_device, case, rows):
    dev = cuda_device
    g = _flat(dev, rows, 1e-2, 6)
    if case == "bf16":
        g = g.to(torch.bfloat16)
    m0, v0, src = (_flat(dev, rows, 1e-3, 7), _flat(dev, rows, 1e-5, 8,
                                                    True),
                   _flat(dev, rows, 0.05, 9))
    hyper = dict(clip=torch.tensor(1.7, device=dev),
                 bc1=torch.tensor(0.19, device=dev),
                 bc2=torch.tensor(0.002, device=dev),
                 inv_scale=torch.tensor(0.25, device=dev), wd=0.01,
                 noop=torch.tensor(True, device=dev) if case == "noop"
                 else None)
    hyper.update({"adam_l2": dict(adam_w_mode=False),
                  "no_wd": dict(wd=0.0)}.get(case, {}))
    m, v = m0.clone(), v0.clone()
    _device.reset_launch_counts()
    u, gm, gv, ru, rp = packed_lamb_stage1(g, m, v, src, **hyper)
    assert _device.launch_counts()["packed_lamb_stage1"] == 1
    assert gm is m and gv is v
    wu, wm, wv, wru, wrp = packed_lamb_stage1_reference(g, m0, v0, src,
                                                        **hyper)
    torch.testing.assert_close(u, wu, **PACKED_F32)
    if case == "noop":
        assert torch.equal(m, m0) and torch.equal(v, v0)
    else:
        torch.testing.assert_close(m, wm, **PACKED_F32)
        torch.testing.assert_close(v, wv, **PACKED_F32)
    torch.testing.assert_close(ru, wru, **ROW_SUM)
    torch.testing.assert_close(rp, wrp, **ROW_SUM)


@pytest.mark.parametrize("rows", [8, 37])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("mode", ["master", "no_master", "noop"])
def test_packed_scale_update_kernel_matches_plain(cuda_device, mode, dtype,
                                                  rows):
    dev = cuda_device
    u, src0 = _flat(dev, rows, 1.0, 10), _flat(dev, rows, 0.05, 11)
    coef = torch.linspace(0.0, 3.0, rows, device=dev)
    noop = torch.tensor(True, device=dev) if mode == "noop" else None
    src = src0.clone()
    _device.reset_launch_counts()
    p_out, master = packed_scale_update(
        u, src, coef, param_dtype=dtype, lr=torch.tensor(1e-2, device=dev),
        noop=noop, write_master=mode != "no_master")
    assert _device.launch_counts()["packed_scale_update"] == 1
    wp, wm = packed_scale_update_reference(u, src0, coef, param_dtype=dtype,
                                           lr=1e-2, noop=noop)
    assert p_out.dtype == dtype
    torch.testing.assert_close(p_out.float(), wp.float(),
                               **(PACKED_BF16 if dtype == torch.bfloat16
                                  else PACKED_F32))
    if mode == "master":
        assert master is src
        torch.testing.assert_close(src, wm, **PACKED_F32)
    else:
        assert torch.equal(src, src0)
    if mode == "noop":
        assert torch.equal(p_out, src0.to(dtype))


@pytest.mark.parametrize("case", [
    dict(), dict(momentum=0.9), dict(momentum=0.9, nesterov=True),
    dict(momentum=0.9, dampening=0.3, wd=1e-4, wd_after_momentum=True),
    dict(momentum=0.9, wd=1e-4, first_run=True),
    dict(momentum=0.9, wd=1e-4, noop=True)],
    ids=["plain", "momentum", "nesterov", "wd_after", "first_run", "noop"])
@pytest.mark.parametrize("rows", [8, 37])
def test_packed_sgd_kernel_matches_plain(cuda_device, case, rows):
    dev = cuda_device
    kw = dict(case)
    first = torch.tensor(kw.pop("first_run", False), device=dev)
    noop = torch.tensor(True, device=dev) if kw.pop("noop", False) else None
    g = _flat(dev, rows, 1e-2, 12).to(torch.bfloat16)
    buf0, src0 = _flat(dev, rows, 1e-2, 13), _flat(dev, rows, 0.05, 14)
    buf, src = buf0.clone(), src0.clone()
    hyper = dict(param_dtype=torch.bfloat16,
                 lr=torch.tensor(0.1, device=dev), first_run=first,
                 inv_scale=torch.tensor(0.5, device=dev), noop=noop, **kw)
    _device.reset_launch_counts()
    p_out, gb, gm = packed_sgd_apply(g, buf, src, **hyper)
    assert _device.launch_counts()["packed_sgd"] == 1
    wp, wb, wm = packed_sgd_reference(g, buf0, src0, **hyper)
    torch.testing.assert_close(p_out.float(), wp.float(), **PACKED_BF16)
    if noop is not None:
        assert torch.equal(buf, buf0) and torch.equal(src, src0)
        assert torch.equal(p_out, src0.to(torch.bfloat16))
    else:
        torch.testing.assert_close(buf, wb, **PACKED_F32)
        torch.testing.assert_close(src, wm, **PACKED_F32)


def _packed_case(dev, seed=15):
    rng = np.random.default_rng(seed)

    def tree(scale):
        return {"w": torch.from_numpy(rng.normal(size=(96, 64)) * scale),
                "b": torch.from_numpy(rng.normal(size=64) * scale),
                "layers": {"k": torch.from_numpy(
                    rng.normal(size=(3, 40, 33)) * scale)}}
    params = tree_map(lambda x: x.to(dev, torch.float32), tree(0.05))
    grads = [tree_map(lambda x: x.to(dev, torch.float32), tree(1e-2))
             for _ in range(3)]
    return params, grads


def _packed_opts():
    from apex_tpu_torch.optimizers import FusedLAMB, FusedNovoGrad, FusedSGD

    return {"lamb": lambda: FusedLAMB(lr=1e-3, packed=True),
            "sgd": lambda: FusedSGD(lr=0.1, momentum=0.9,
                                    weight_decay=1e-4, packed=True,
                                    master_weights=True),
            "novograd": lambda: FusedNovoGrad(lr=1e-2, weight_decay=1e-3,
                                              packed=True),
            "novograd_inf": lambda: FusedNovoGrad(
                lr=1e-2, norm_type=0, reg_inside_moment=True,
                weight_decay=1e-3, packed=True)}


_PACKED_KERNELS = {
    "lamb": ("packed_row_reduce", "packed_lamb_stage1",
             "packed_scale_update"),
    "sgd": ("packed_sgd",),
    "novograd": ("packed_row_reduce", "packed_novograd"),
    "novograd_inf": ("packed_row_reduce", "packed_novograd")}


@pytest.mark.parametrize("name", ["lamb", "sgd", "novograd", "novograd_inf"])
def test_packed_steps_on_card_match_cpu(cuda_device, name):
    """3 packed steps (the kernels) against the same steps on the CPU
    (the plain versions), on a 3-leaf tree."""
    params, grads = _packed_case("cpu")
    out = {}
    for dev in ("cpu", cuda_device):
        opt = _packed_opts()[name]()
        p = tree_map(lambda x: x.to(dev, copy=True), params)
        state = opt.init(p)
        _device.reset_launch_counts()
        for g in grads:
            p, state = opt.step(tree_map(lambda x: x.to(dev), g), state, p)
        out[str(dev)] = ([x.cpu() for x in tree_leaves(p)],
                         _device.launch_counts())
    (pc, cc), (pg, cg) = out["cpu"], out[str(cuda_device)]
    assert not any(cc.values())
    for k in _PACKED_KERNELS[name]:
        assert cg[k] == 3, cg
    for a, b in zip(pc, pg):
        torch.testing.assert_close(b, a, rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("name", ["lamb", "sgd", "novograd", "novograd_inf"])
def test_packed_step_makes_no_host_sync(cuda_device, name):
    """One packed step with an overflow flag and a grad scale on the
    device, after one warm-up step, under
    ``torch.cuda.set_sync_debug_mode("error")``: nothing of the step
    (global norm, clip, first-run flag, noop) is read on the host."""
    params, grads = _packed_case(cuda_device)
    opt = _packed_opts()[name]()
    state = opt.init(params)
    params, state = opt.step(grads[0], state, params)
    found_inf = torch.zeros((), dtype=torch.bool, device=cuda_device)
    scale = torch.full((), 2.0, device=cuda_device)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        params, state = opt.step(grads[1], state, params,
                                 found_inf=found_inf, grad_scale=scale)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert int(state.step) == 2


def test_packed_lamb_is_deterministic(cuda_device):
    """Two identical packed LAMB steps on the card give the same bits:
    the row sums and the per-leaf segmented sums take a fixed order."""
    from apex_tpu_torch.optimizers import FusedLAMB

    params, grads = _packed_case(cuda_device)
    runs = []
    for _ in range(2):
        opt = FusedLAMB(lr=1e-3, packed=True)
        p = tree_map(lambda x: x.clone(), params)
        state = opt.init(p)
        for g in grads:
            p, state = opt.step(g, state, p)
        runs.append((tree_leaves(p), state.exp_avg, state.exp_avg_sq))
    for a, b in zip(runs[0][0] + list(runs[0][1:]),
                    runs[1][0] + list(runs[1][1:])):
        assert torch.equal(a, b)


#: head-dim cases: (dtype, causal, masked, dropout p, s_q, s_k); the first
#: runs in fp32 (the CUDA-core kernels) and bf16, the rest are the bf16
#: tensor-core kernels' ragged, cross, masked and dropout tiles
HEAD_DIM_CASES = {
    "f32_causal_kv_mask": (torch.float32, True, True, 0.0, 200, 200),
    "causal_kv_mask": (torch.bfloat16, True, True, 0.0, 200, 200),
    "ragged_1000": (torch.bfloat16, True, False, 0.0, 1000, 1000),
    "ragged_17": (torch.bfloat16, True, False, 0.0, 17, 17),
    "causal_cross_320x1000": (torch.bfloat16, True, False, 0.0, 320, 1000),
    "kv_mask_dead_row_300": (torch.bfloat16, False, True, 0.0, 300, 300),
    "dropout_0.1": (torch.bfloat16, True, False, 0.1, 256, 256),
}


@pytest.mark.parametrize("case", list(HEAD_DIM_CASES))
@pytest.mark.parametrize("d", [32, 64, 96, 128, 256])
def test_flash_attention_head_dims_match_plain(cuda_device, case, d):
    """Every instantiated head dim: forward and backward against the plain
    versions at lengths that are not a whole number of tiles, causal with
    s_q != s_k, a key-padding mask holding a fully masked batch row (o,
    dq, dk, dv exactly 0, lse exactly -1e30) and hash dropout (the same
    keep bits)."""
    from apex_tpu_torch.ops.flash_attention import KERNEL_HEAD_DIMS

    assert d in KERNEL_HEAD_DIMS
    dtype, causal, masked, p, s_q, s_k = HEAD_DIM_CASES[case]
    rng = np.random.default_rng(d)

    def t(*shape):
        return torch.from_numpy(rng.normal(size=shape).astype(
            np.float32)).to(cuda_device, dtype)
    q, do = t(2, 4, s_q, d), t(2, 4, s_q, d)
    k, v = t(2, 4, s_k, d), t(2, 4, s_k, d)
    kv_mask = None
    if masked:
        kv_mask = torch.ones(2, s_k, dtype=torch.bool, device=cuda_device)
        kv_mask[0, (3 * s_k) // 4:] = False
        kv_mask[1] = False
    kw = dict(causal=causal, kv_mask=kv_mask, dropout_p=p,
              dropout_seed=-77 if p else None)
    o, lse = flash_attention_fwd(q, k, v, **kw)
    dq, dk, dv = flash_attention_bwd(q, k, v, o, lse, do, **kw)
    ro, rlse = flash_attention_fwd_reference(q, k, v, **kw)
    grads = flash_attention_bwd_reference(q, k, v, ro, rlse, do, **kw)
    torch.cuda.synchronize()
    torch.testing.assert_close(o.float(), ro.float(), **TOL[dtype])
    torch.testing.assert_close(lse, rlse, **TOL[torch.float32])
    for got, want in zip((dq, dk, dv), grads):
        torch.testing.assert_close(got.float(), want.float(), **TOL[dtype])
    if masked:
        assert bool((lse[1] == -1e30).all())
        for x in (o, dq, dk, dv):
            assert torch.equal(x[1], torch.zeros_like(x[1]))


@pytest.mark.parametrize("d", [32, 64, 96, 128, 256])
def test_flash_backward_is_deterministic(cuda_device, d):
    """The backward twice on the same inputs gives the same bits: each
    gradient element is summed by one thread in a fixed order (two
    launches, no atomics), with dropout and a ragged causal length."""
    rng = np.random.default_rng(40 + d)
    q, k, v, do = (torch.from_numpy(rng.normal(size=(2, 4, 333, d)).astype(
        np.float32)).to(cuda_device, torch.bfloat16) for _ in range(4))
    kw = dict(causal=True, dropout_p=0.1, dropout_seed=5)
    o, lse = flash_attention_fwd(q, k, v, **kw)
    first = flash_attention_bwd(q, k, v, o, lse, do, **kw)
    second = flash_attention_bwd(q, k, v, o, lse, do, **kw)
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert torch.equal(a, b)


def test_flash_attention_takes_misaligned_views(cuda_device):
    """q, k, v viewed at an odd element offset of one buffer, which the
    kernels' 16-byte copies would fault on, give the bits of aligned
    copies of themselves."""
    rng = np.random.default_rng(9)
    n = 2 * 4 * 100 * 64
    flat = torch.from_numpy(rng.normal(size=3 * n + 1).astype(
        np.float32)).to(cuda_device, torch.bfloat16)
    q, k, v = (flat[1 + i * n:1 + (i + 1) * n].view(2, 4, 100, 64)
               for i in range(3))
    assert q.data_ptr() % 16 != 0
    do = torch.ones_like(q)
    o, lse = flash_attention_fwd(q, k, v, causal=True)
    grads = flash_attention_bwd(q, k, v, o, lse, do, causal=True)
    qa, ka, va = (t.clone() for t in (q, k, v))
    ro, rlse = flash_attention_fwd(qa, ka, va, causal=True)
    rgrads = flash_attention_bwd(qa, ka, va, ro, rlse, do, causal=True)
    torch.cuda.synchronize()
    assert torch.equal(o, ro) and torch.equal(lse, rlse)
    for got, want in zip(grads, rgrads):
        assert torch.equal(got, want)


def test_flash_attention_refuses_other_head_dims(cuda_device):
    """Head dims up to 256 run (80 zero-padded to 96); past 256 the path
    without flash takes them, and flash itself refuses."""
    from apex_tpu_torch.ops.flash_attention import flash_attention_available

    for d in (128, 80, 16, 256):
        assert flash_attention_available(1024, 1024, d, cuda_device)
    assert not flash_attention_available(1024, 1024, 320, cuda_device)
    q = torch.zeros(1, 2, 16, 320, device=cuda_device)
    with pytest.raises(ValueError, match="head dims"):
        flash_attention_fwd(q, q, q, causal=True)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("d", [16, 48, 80, 160, 200])
def test_flash_attention_padded_head_dims_match_plain(cuda_device, d,
                                                      dtype):
    """A head dim no kernel is instantiated for runs the next one's
    kernels on zero-padded operands: forward and backward against the
    plain versions at the unpadded width (causal, a ragged length, a
    key-padding mask with a fully masked batch row), one launch each."""
    rng = np.random.default_rng(d)

    def t(*shape):
        return torch.from_numpy(rng.normal(size=shape).astype(
            np.float32)).to(cuda_device, dtype)
    q, k, v, do = (t(2, 4, 333, d) for _ in range(4))
    kv_mask = torch.ones(2, 333, dtype=torch.bool, device=cuda_device)
    kv_mask[1] = False
    tol = _flash_tol(dtype)
    for kw in (dict(causal=True), dict(kv_mask=kv_mask)):
        _device.reset_launch_counts()
        o, lse = flash_attention_fwd(q, k, v, **kw)
        grads = flash_attention_bwd(q, k, v, o, lse, do, **kw)
        counts = _device.launch_counts()
        assert counts["flash_attn_fwd"] == counts["flash_attn_bwd"] == 1
        ro, rlse = flash_attention_fwd_reference(q, k, v, **kw)
        want = flash_attention_bwd_reference(q, k, v, ro, rlse, do, **kw)
        torch.cuda.synchronize()
        assert o.shape == q.shape
        torch.testing.assert_close(o.float(), ro.float(), **tol)
        torch.testing.assert_close(lse, rlse, **TOL[torch.float32])
        for got, ref in zip(grads, want):
            assert got.shape == q.shape
            torch.testing.assert_close(got.float(), ref.float(), **tol)


@pytest.mark.parametrize("hidden,heads,dtype,kernels", [
    (256, 2, torch.float32, ("flash_attn_fwd", "flash_attn_bwd")),
    (160, 2, torch.bfloat16, ("flash_attn_fwd", "flash_attn_bwd")),
    (640, 2, torch.bfloat16, ("softmax_fwd", "softmax_bwd"))],
    ids=["head_dim_128_flash", "head_dim_80_flash_padded",
         "head_dim_320_softmax"])
def test_step_at_other_head_dims_on_card_matches_cpu(cuda_device, hidden,
                                                     heads, dtype, kernels):
    """A 2-layer GPT with ``use_flash_attention=None`` at head dim 128
    takes the flash kernels, at head dim 80 the flash kernels of head dim
    96 on zero-padded operands, at head dim 320 (past flash's 256) the
    fused softmax kernels: loss and gradients on the card against the
    CPU."""
    from apex_tpu_torch.transformer.testing import (
        GPTConfig,
        gpt_loss,
        init_gpt_params,
    )

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = GPTConfig(num_layers=2, hidden_size=hidden,
                    num_attention_heads=heads, vocab_size=512,
                    max_position_embeddings=128, hidden_dropout=0.0,
                    attention_dropout=0.0, compute_dtype=dtype)
    params = init_gpt_params(cfg, torch.Generator().manual_seed(0))
    rng = np.random.default_rng(6)
    tokens = torch.from_numpy(rng.integers(0, 512, (2, 128)))
    labels = torch.roll(tokens, -1, dims=1)
    _card_against_cpu(cuda_device, lambda p, d: gpt_loss(
        cfg, p, tokens.to(d), labels.to(d)), params, kernels)


FLAT_LENGTHS = [8 * 1024, 2 * 65536 + 1000 + 3]


@pytest.mark.parametrize("n", FLAT_LENGTHS, ids=["rows", "ragged"])
@pytest.mark.parametrize("x_dtype,out_dtype", [
    (torch.bfloat16, torch.float32), (torch.float32, torch.float32),
    (torch.float32, torch.bfloat16)])
def test_scale_flat_kernel_matches_plain(cuda_device, n, x_dtype,
                                         out_dtype):
    """``multi_tensor_scale_flat`` with per-row flags: the output as the
    plain version's (one rounding of the same product), the flags naming
    exactly the rows where an inf, a nan or an overflow of the product
    was planted, the found flag without per-row flags; all under
    ``set_sync_debug_mode("error")``."""
    g = torch.Generator(device=cuda_device).manual_seed(n)
    x = torch.randn(n, generator=g, device=cuda_device).to(x_dtype)
    rows = -(-n // 1024)
    bad_rows = [0, rows // 2, rows - 1]
    x[5] = float("inf")
    x[(rows // 2) * 1024 + 17] = float("nan")
    x[n - 1] = 3e38  # finite, but not times 4
    scale = torch.tensor(4.0, device=cuda_device)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out, found, row_bad = multi_tensor_scale_flat(
            x, scale, out_dtype, per_row_flags=True)
        out2, found2 = multi_tensor_scale_flat(x[:1024].clone(), 0.5)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    want, wfound, wrows = multi_tensor_scale_flat_reference(
        x, scale, out_dtype, per_row_flags=True)
    assert out.dtype == out_dtype and out.shape == (n,)
    torch.testing.assert_close(out, want, rtol=0, atol=0, equal_nan=True)
    assert bool(found) and bool(wfound)
    assert torch.equal(row_bad, wrows)
    assert torch.nonzero(row_bad).flatten().tolist() == bad_rows
    assert bool(found2)
    assert torch.equal(out2, multi_tensor_scale_flat_reference(
        x[:1024], 0.5)[0])
    clean, cfound = multi_tensor_scale_flat(x[1024:2048].clone(), scale)
    assert not bool(cfound)


@pytest.mark.parametrize("n", FLAT_LENGTHS, ids=["rows", "ragged"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_axpby_flat_kernel_matches_plain(cuda_device, n, dtype):
    g = torch.Generator(device=cuda_device).manual_seed(n + 1)
    x = torch.randn(n, generator=g, device=cuda_device).to(dtype)
    y = torch.randn(n, generator=g, device=cuda_device)
    a = torch.tensor(0.25, device=cuda_device)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out, found = multi_tensor_axpby_flat(a, 1.5, x, y)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    want, wfound = multi_tensor_axpby_flat_reference(a, 1.5, x, y)
    assert out.dtype == dtype and torch.equal(out, want)
    assert not bool(found) and not bool(wfound)
    y[n - 2] = float("inf")
    out, found = multi_tensor_axpby_flat(a, 1.5, x, y, torch.float32)
    assert bool(found) and out.dtype == torch.float32


@pytest.mark.parametrize("rows", [8, 37])
@pytest.mark.parametrize("case", ["l2", "wd_outside", "wd_inside", "bf16",
                                  "noop"])
def test_packed_novograd_kernel_matches_plain(cuda_device, case, rows):
    n = rows * 1024
    dev = cuda_device
    grad = _flat(dev, rows, 1e-3, 30)
    m0 = _flat(dev, rows, 1e-4, 31)
    src0 = _flat(dev, rows, 0.02, 32)
    denom = torch.rand(rows, device=dev) + 0.5
    pdt = torch.bfloat16 if case == "bf16" else torch.float32
    if case == "bf16":
        grad = grad.to(torch.bfloat16)
    kw = dict(param_dtype=pdt, lr=torch.tensor(1e-3, device=dev),
              bc1=torch.tensor(0.05, device=dev),
              inv_scale=torch.tensor(0.5, device=dev), beta1=0.95,
              beta3=0.05,
              wd=0.0 if case in ("l2", "bf16") else 1e-3,
              reg_inside_moment=case == "wd_inside",
              noop=torch.tensor(True, device=dev) if case == "noop"
              else None)
    m = m0.clone()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        p_out, _ = packed_novograd_apply(grad, m, src0, denom, **kw)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    want_p, want_m = packed_novograd_reference(grad, m0, src0, denom, **kw)
    assert p_out.shape == (n,)
    if case == "noop":
        assert torch.equal(m, m0) and torch.equal(p_out, src0)
    else:
        torch.testing.assert_close(m, want_m, **PACKED_F32)
        torch.testing.assert_close(p_out.float(), want_p.float(),
                                   **(PACKED_F32 if pdt == torch.float32
                                      else TOL[torch.bfloat16]))


def test_loss_scaled_clipped_packed_step_makes_no_host_sync(cuda_device):
    """The flat gradient lifecycle under
    ``set_sync_debug_mode("error")``: scale the loss, unscale the packed
    gradients in one sweep, clip them in two, step packed FusedAdam with
    the scaler's ``found_inf``, update the scale; then an inf in one
    gradient skips the step bit for bit and halves the scale."""
    from apex_tpu_torch.amp import LossScaler
    from apex_tpu_torch.contrib.clip_grad import clip_grad_norm_flat
    from apex_tpu_torch.optimizers import FusedAdam

    params, grads = _packed_case(cuda_device)
    opt = FusedAdam(lr=1e-3, packed=True, master_weights=True)
    state = opt.init(params)
    scaler = LossScaler("dynamic", init_scale=1024.0)
    ss = scaler.init_state(cuda_device)

    def step(params, state, ss, g):
        flat = state.spec.pack(tree_map(lambda x: x * ss.loss_scale, g))
        flat, ss = scaler.unscale_flat(ss, flat, out_dtype=torch.float32)
        flat, _ = clip_grad_norm_flat(flat, 1.0)
        params, state = opt.step(flat, state, params, found_inf=ss.found_inf)
        return params, state, scaler.update_scale(ss)
    params, state, ss = step(params, state, ss, grads[0])
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        params, state, ss = step(params, state, ss, grads[1])
    finally:
        torch.cuda.set_sync_debug_mode("default")
    before = [x.clone() for x in tree_leaves(params)]
    masters = state.master_params.clone()
    bad = tree_map(lambda x: x.clone(), grads[2])
    bad["w"][3, 4] = float("inf")
    params, state, ss2 = step(params, state, ss, bad)
    assert int(state.step) == 2
    assert torch.equal(state.master_params, masters)
    for a, b in zip(before, tree_leaves(params)):
        assert torch.equal(a, b)
    assert float(ss2.loss_scale) == float(ss.loss_scale) / 2
    assert int(ss2.consecutive_skips) == 1


@pytest.mark.parametrize("hidden", [32768, 65536])
def test_layer_norm_kernels_take_wide_rows(cuda_device, hidden):
    """Rows wider than a block's shared memory holds: the backward keeps
    its column partials in device memory; forward and backward as the
    plain versions, with fp32 x and bf16 dy at 32768."""
    g = torch.Generator(device=cuda_device).manual_seed(hidden)
    rows = 40
    x = torch.randn(rows, hidden, generator=g, device=cuda_device) * 3 + 1
    w = torch.randn(hidden, generator=g, device=cuda_device)
    b = torch.randn(hidden, generator=g, device=cuda_device)
    dy_dt = torch.bfloat16 if hidden == 32768 else torch.float32
    dy = torch.randn(rows, hidden, generator=g, device=cuda_device).to(dy_dt)
    _device.reset_launch_counts()
    y, mu, rstd = layer_norm_fwd(x, w, b)
    dx, dw, db = layer_norm_bwd(dy, x, mu, rstd, w)
    counts = _device.launch_counts()
    assert counts["layer_norm_fwd"] == 1 and counts["layer_norm_bwd"] == 1
    ry, rmu, rrstd = layer_norm_reference(x, w, b, 1e-5)
    rdx, rdw, rdb = layer_norm_bwd_reference(dy, x, mu, rstd, w)
    torch.testing.assert_close(y, ry, **TOL[torch.float32])
    torch.testing.assert_close(rstd, rrstd, **TOL[torch.float32])
    assert dx.dtype == dy_dt
    torch.testing.assert_close(dx.float(), rdx.float(), **TOL[dy_dt])
    torch.testing.assert_close(dw, rdw, atol=1e-3, rtol=1e-4)
    torch.testing.assert_close(db, rdb, atol=1e-3, rtol=1e-4)


@pytest.mark.parametrize("rows,hidden,dtype", [
    (64, 1024, torch.float32), (64, 1024, torch.bfloat16),
    (37, 1000, torch.float32), (8, 4096, torch.bfloat16),
    (8, 65536, torch.float32), (64, 1024, torch.float16),
    (37, 1000, torch.float16)])
def test_rms_norm_kernels_match_plain(cuda_device, rows, hidden, dtype):
    """The RMSNorm forward and backward kernels against their plain
    versions (the backward fed the same statistics), and the x-hat form of
    the backward (fp32 x-hat beside a dy of the input's dtype)."""
    g = torch.Generator(device=cuda_device).manual_seed(rows + hidden)
    x = (torch.randn(rows, hidden, generator=g, device=cuda_device) * 2
         + 0.5).to(dtype)
    w = torch.randn(hidden, generator=g, device=cuda_device)
    dy = torch.randn(rows, hidden, generator=g, device=cuda_device).to(dtype)
    _device.reset_launch_counts()
    y, rstd = rms_norm_fwd(x, w)
    dx, dw = rms_norm_bwd(dy, x, rstd, w)
    counts = _device.launch_counts()
    assert counts["rms_norm_fwd"] == 1 and counts["rms_norm_bwd"] == 1
    ry, rrstd = rms_norm_reference(x, w, 1e-5)
    rdx, rdw = rms_norm_bwd_reference(dy, x, rstd, w)
    assert y.dtype == dx.dtype == dtype and rstd.shape == (rows, 1)
    torch.testing.assert_close(y.float(), ry.float(), **TOL[dtype])
    torch.testing.assert_close(rstd, rrstd, **TOL[torch.float32])
    torch.testing.assert_close(dx.float(), rdx.float(), **TOL[dtype])
    torch.testing.assert_close(dw, rdw, atol=1e-3, rtol=1e-4)
    xhat = x.float() * rstd
    hdx, hdw = rms_norm_bwd(dy, xhat, rstd, w, x_is_xhat=True)
    wdx, wdw = rms_norm_bwd_reference(dy, xhat, rstd, w, x_is_xhat=True)
    torch.testing.assert_close(hdx.float(), wdx.float(), **TOL[dtype])
    torch.testing.assert_close(hdw, wdw, atol=1e-3, rtol=1e-4)


#: the forward norms' plan branches: the team kernels (vector widths and
#: ragged ones, up to 8192), a block a row staging the row in shared
#: memory (8193, 32768; 65536 in 16 bits), past it the row swept from
#: L1/L2 (65536 fp32, 131072 in 16 bits)
NORM_FWD_BRANCHES = [(1, 1024), (7, 1024), (8192, 1024), (7, 1001),
                     (7, 1025), (7, 8192), (7, 8193), (1, 32768),
                     (7, 65536), (1, 131072)]


@pytest.mark.parametrize("offset", [0, 1], ids=["aligned", "offset_1"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("rows,hidden", NORM_FWD_BRANCHES)
def test_norm_fwd_kernels_match_plain_at_every_branch(cuda_device, rows,
                                                      hidden, dtype,
                                                      offset):
    """Both forwards against their plain versions at every branch of
    their plan, from contiguous views at an element offset of 0 and of 1
    (a pointer that is not 16-byte aligned: element by element), one
    launch a call: y at its dtype's tolerance, mu and rstd at fp32's."""
    g = torch.Generator(device=cuda_device).manual_seed(rows + hidden)
    flat = (torch.randn(rows * hidden + 1, generator=g, device=cuda_device)
            * 3 + 1).to(dtype)
    x = flat[offset:offset + rows * hidden].view(rows, hidden)
    assert (x.data_ptr() % 16 == 0) == (offset == 0)
    w = torch.randn(hidden, generator=g, device=cuda_device)
    b = torch.randn(hidden, generator=g, device=cuda_device)
    _device.reset_launch_counts()
    y, mu, rstd = layer_norm_fwd(x, w, b)
    ys, rs = rms_norm_fwd(x, w)
    counts = _device.launch_counts()
    assert counts["layer_norm_fwd"] == counts["rms_norm_fwd"] == 1
    ry, rmu, rrstd = layer_norm_reference(x, w, b, 1e-5)
    rys, rrs = rms_norm_reference(x, w, 1e-5)
    torch.cuda.synchronize()
    assert y.dtype == ys.dtype == dtype and mu.shape == rs.shape == (rows, 1)
    torch.testing.assert_close(y.float(), ry.float(), **TOL[dtype])
    torch.testing.assert_close(ys.float(), rys.float(), **TOL[dtype])
    for got, want in ((mu, rmu), (rstd, rrstd), (rs, rrs)):
        torch.testing.assert_close(got, want, **TOL[torch.float32])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hidden", [1024, 1000])
def test_norm_fwd_team_kernels_take_every_plan(cuda_device, hidden, dtype):
    """Every team shape that covers the row (1-8 warps a row, 1-8 vectors
    a lane, at most 32 columns a lane) and a few grids, through the
    internal launchers: y, mu and rstd of both norms against their plain
    versions."""
    g = torch.Generator(device=cuda_device).manual_seed(hidden)
    rows = 777
    x = (torch.randn(rows, hidden, generator=g, device=cuda_device) * 3
         + 1).to(dtype)
    w = torch.randn(hidden, generator=g, device=cuda_device)
    b = torch.randn(hidden, generator=g, device=cuda_device)
    per = 16 // x.element_size()
    ry, rmu, rrstd = layer_norm_reference(x, w, b, 1e-5)
    rys, rrs = rms_norm_reference(x, w, 1e-5)
    tried = 0
    for wpr in (1, 2, 4, 8):
        for vecs in (1, 2, 4, 8):
            if vecs * per > 32 or vecs * per * 32 * wpr < hidden:
                continue
            teams = 8 // wpr
            for blocks in (1, 132, -(-rows // teams)):
                rpb = -(-rows // blocks)
                plan = ln_mod.NormFwdPlan(-(-rows // rpb), rpb, wpr, vecs)
                y, mu, rstd = ln_mod._launch(x, w, b, 1e-5, plan=plan)
                ys, rs = ln_mod._launch_rms(x, w, 1e-5, plan=plan)
                torch.cuda.synchronize()
                torch.testing.assert_close(y.float(), ry.float(),
                                           **TOL[dtype])
                torch.testing.assert_close(ys.float(), rys.float(),
                                           **TOL[dtype])
                for got, want in ((mu, rmu), (rstd, rrstd), (rs, rrs)):
                    torch.testing.assert_close(got, want,
                                               **TOL[torch.float32])
                tried += 1
    assert tried >= 6


def _xhat(y, w, b, eps=1e-5):
    """x-hat rebuilt in fp32 from a norm's output, written out here apart
    from the port's: ``(y - b) / w``, |w| clamped to eps, its sign kept."""
    mag = w.float().abs().clamp_min(eps)
    yf = y.float() if b is None else y.float() - b.float()
    return yf / torch.where(w < 0, -mag, mag)


@pytest.mark.parametrize("norm", ["layer_norm", "rms_norm"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_memory_efficient_norms_match_plain_on_card(cuda_device, norm,
                                                    dtype):
    """``memory_efficient`` rebuilds x-hat in fp32 from the output: the
    gradients equal those of the plain backward given that x-hat (dx
    within one rounding of its dtype, the fp32 parameter gradients within
    1e-5 of their norm; an x-hat rounded to bf16 is ~2e-3 off and fails),
    and those of the plain backward that keeps x within the output's
    rounding, with a negative and a near-zero weight among the columns."""
    g = torch.Generator(device=cuda_device).manual_seed(9)
    x0 = torch.randn(4, 64, 1024, generator=g, device=cuda_device).to(dtype)
    w0 = torch.rand(1024, generator=g, device=cuda_device) + 0.5
    w0[3], w0[5] = -0.75, 1e-7
    b0 = torch.randn(1024, generator=g, device=cuda_device)
    dy = torch.randn(4, 64, 1024, generator=g, device=cuda_device).to(dtype)
    grads = []
    for me in (False, True):
        x, w, b = (t.clone().requires_grad_(True) for t in (x0, w0, b0))
        if norm == "layer_norm":
            layer_norm(x, w, b, memory_efficient=me).backward(dy)
            grads.append((x.grad, w.grad, b.grad))
        else:
            rms_norm(x, w, memory_efficient=me).backward(dy)
            grads.append((x.grad, w.grad))
    def rel(a, c):
        return float((a.float() - c.float()).norm() / c.float().norm())

    x2, dy2 = x0.reshape(-1, 1024), dy.reshape(-1, 1024)
    if norm == "layer_norm":
        y, mu, rstd = layer_norm_fwd(x2, w0, b0)
        xhat = _xhat(y, w0, b0)
        want, bad = (layer_norm_bwd_reference(dy2, xh, mu, rstd, w0,
                                              x_is_xhat=True)
                     for xh in (xhat, xhat.bfloat16().float()))
    else:
        y, rstd = rms_norm_fwd(x2, w0)
        xhat = _xhat(y, w0, None)
        want, bad = (rms_norm_bwd_reference(dy2, xh, rstd, w0,
                                            x_is_xhat=True)
                     for xh in (xhat, xhat.bfloat16().float()))
    assert rel(grads[1][0].reshape(-1, 1024), want[0]) < (
        1e-5 if dtype == torch.float32 else 2.0 ** -8)
    for a, c in zip(grads[1][1:], want[1:]):
        assert rel(a, c) < 1e-5
    assert rel(bad[1], want[1]) > 1e-5  # dgamma; dbeta takes no x-hat
    # x-hat rebuilt from y carries y's rounding (an fp32 or a bf16 ulp of
    # y over |w| >= 0.5 an element), and column 5's weight is clamped to
    # eps, so its weight gradient differs by design: each gradient, column
    # 5's excluded, within 1e-4 (fp32) or 8e-3 (bf16) of its norm
    keep = torch.ones(1024, dtype=torch.bool, device=cuda_device)
    keep[5] = False
    lim = 1e-4 if dtype == torch.float32 else 8e-3
    for a, c in zip(*grads):
        assert rel(a[..., keep], c[..., keep]) < lim


@pytest.mark.parametrize("n", FLAT_LENGTHS, ids=["rows", "ragged"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
def test_packed_row_stats_kernel_matches_plain(cuda_device, n, dtype):
    """Per-row sum of squares, max |x| and non-finite count against the
    plain version: nan and inf planted in known rows show in those rows'
    sums and maxima, the counts exact there and 0 elsewhere; under
    ``set_sync_debug_mode("error")`` with a device ``inv_scale``."""
    g = torch.Generator(device=cuda_device).manual_seed(n + 3)
    x = torch.randn(n, generator=g, device=cuda_device).to(dtype)
    rows = -(-n // 1024)
    x[3 * 1024 + 5] = float("nan")
    x[3 * 1024 + 6] = float("inf")
    x[(rows - 1) * 1024] = float("-inf")
    inv = torch.tensor(0.5, device=cuda_device)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        _device.reset_launch_counts()
        sq, ma, nf = packed_row_stats(x, inv_scale=inv)
        assert _device.launch_counts()["packed_row_stats"] == 1
    finally:
        torch.cuda.set_sync_debug_mode("default")
    wsq, wma, wnf = packed_row_stats_reference(x, inv_scale=inv)
    assert sq.shape == ma.shape == nf.shape == (rows,)
    want_nf = torch.zeros(rows, device=cuda_device)
    want_nf[3], want_nf[rows - 1] = 2, 1
    assert torch.equal(nf, want_nf) and torch.equal(wnf, want_nf)
    assert torch.isnan(sq[3]) and torch.isnan(ma[3])
    assert torch.isinf(sq[rows - 1]) and torch.isinf(ma[rows - 1])
    torch.testing.assert_close(sq, wsq, rtol=1e-5, atol=0.0, equal_nan=True)
    assert torch.equal(ma.nan_to_num(), wma.nan_to_num())
    assert torch.equal(packed_row_stats(x, inv_scale=inv)[0].nan_to_num(),
                       sq.nan_to_num())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_tree_observation_on_card_matches_cpu_and_keeps_nan(cuda_device,
                                                            dtype):
    """``observe(grads=)`` over a gradient tree on the card, under
    ``set_sync_debug_mode("error")``: per-leaf sums of squares (rtol 1e-5:
    another order) and maxima (equal) against the same observation on the
    CPU; a nan leaf and an inf leaf flagged, and only those."""
    from apex_tpu_torch.telemetry.numerics import NumericsMonitor

    g = torch.Generator().manual_seed(3)
    grads = {"a": torch.randn(64, 96, generator=g),
             "b": torch.randn(4096, generator=g),
             "c": torch.randn(7, 5, 3, generator=g),
             "d": torch.randn(300, generator=g)}
    grads = tree_map(lambda x: x.to(dtype), grads)
    grads["b"][17] = float("nan")
    grads["c"][1, 2, 0] = float("-inf")
    mon = NumericsMonitor(grads)
    out = []
    for dev in (torch.device("cpu"), cuda_device):
        ns0 = mon.init(dev)
        tree = tree_map(lambda x: x.to(dev), grads)
        if dev.type == "cuda":
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")
        try:
            ns = mon.observe(ns0, grads=tree)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        out.append(ns)
    cpu, card = out
    assert card.grad_nonfinite.cpu().tolist() == [0.0, 1.0, 1.0, 0.0]
    assert torch.equal(card.grad_nonfinite.cpu(), cpu.grad_nonfinite)
    assert bool(card.overflow)
    assert torch.isnan(card.grad_maxabs[1]) and torch.isnan(card.grad_sq[1])
    assert torch.isinf(card.grad_maxabs[2]) and torch.isinf(card.grad_sq[2])
    assert torch.equal(card.grad_maxabs.cpu().nan_to_num(),
                       cpu.grad_maxabs.nan_to_num())
    torch.testing.assert_close(card.grad_sq.cpu(), cpu.grad_sq, rtol=1e-5,
                               atol=0.0, equal_nan=True)


def test_monitored_step_makes_no_host_sync_and_names_the_leaf(
        cuda_device, tmp_path):
    """The loss-scaled, clipped packed step with the numerics monitor on
    the flat gradients (``packed_row_stats``), ``update_scale(metrics=,
    numerics=)``, the metrics window drained every 2 steps and the
    numerics drain, under ``set_sync_debug_mode("error")``; then an inf in
    one leaf's gradient: after ``flush()`` the JSONL holds exactly one
    ``nonfinite_grads`` record, naming that leaf, and the metrics records
    carry the losses."""
    from apex_tpu_torch import telemetry
    from apex_tpu_torch.amp import LossScaler
    from apex_tpu_torch.contrib.clip_grad import clip_grad_norm_flat
    from apex_tpu_torch.optimizers import FusedAdam
    from apex_tpu_torch.telemetry.numerics import NumericsMonitor

    params, grads = _packed_case(cuda_device)
    opt = FusedAdam(lr=1e-3, packed=True, master_weights=True)
    state = opt.init(params)
    scaler = LossScaler("dynamic", init_scale=1024.0)
    mon = NumericsMonitor(spec=state.spec)
    path = tmp_path / "run.jsonl"
    rec = telemetry.JsonlRecorder(path)
    carry = [params, state, scaler.init_state(cuda_device),
             telemetry.init_metrics(cuda_device), mon.init(cuda_device)]

    def step(g, loss):
        params, state, ss, m, ns = carry
        flat = state.spec.pack(tree_map(lambda x: x * ss.loss_scale, g))
        ns = mon.observe(ns, flat_grads=flat, inv_scale=1.0 / ss.loss_scale)
        flat, ss = scaler.unscale_flat(ss, flat, out_dtype=torch.float32)
        flat, _ = clip_grad_norm_flat(flat, 1.0)
        params, state = opt.step(flat, state, params, found_inf=ss.found_inf)
        ss, m, ns = scaler.update_scale(ss, metrics=m, numerics=ns)
        m = telemetry.drain(telemetry.accumulate(m, loss=loss, tokens=16),
                            rec, every_n=2)
        carry[:] = [params, state, ss, m, mon.drain(ns, rec)]

    losses = torch.tensor([3.0, 2.0, 1.0, 0.5], device=cuda_device)
    step(grads[0], losses[0])
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        _device.reset_launch_counts()
        step(grads[1], losses[1])
        assert _device.launch_counts()["packed_row_stats"] == 1
    finally:
        torch.cuda.set_sync_debug_mode("default")
    bad = tree_map(lambda x: x.clone(), grads[2])
    bad["layers"]["k"][1, 2, 3] = float("inf")
    step(bad, losses[2])
    step(grads[0], losses[3])
    telemetry.flush()
    rec.close()
    records = telemetry.read_jsonl(path)
    anomalies = [r for r in records if r.get("event") == "anomaly"]
    assert [(a["kind"], a["step"], a["first_bad_step"]) for a in anomalies] \
        == [("nonfinite_grads", 3, 3)]
    assert [l["name"] for l in anomalies[0]["leaves"]] == ["['layers']['k']"]
    metrics = [r for r in records if r.get("event") == "metrics"]
    assert [(r["step"], r["loss"], r["tokens"]) for r in metrics] == [
        (2, 2.5, 32.0), (4, 0.75, 32.0)]
    assert metrics[-1]["overflow_skips"] == 1


NORM_PAIRS = [(torch.float32, torch.float32), (torch.float32, torch.bfloat16),
              (torch.bfloat16, torch.bfloat16), (torch.bfloat16, torch.float32)]


def _norm_bwd_pair(norm, dy, x, stats, w, x_is_xhat=False, plan=None):
    """The kernel backward and the plain one on the same statistics."""
    if norm == "layer_norm":
        mu, rstd = stats
        got = ln_mod._launch_bwd(dy, x, mu, rstd, w, x_is_xhat, plan)
        want = layer_norm_bwd_reference(dy, x, mu, rstd, w, x_is_xhat)
    else:
        (rstd,) = stats
        got = ln_mod._launch_rms_bwd(dy, x, rstd, w, x_is_xhat, plan)
        want = rms_norm_bwd_reference(dy, x, rstd, w, x_is_xhat)
    return got, want


@pytest.mark.parametrize("rows", [1, 7, 300])
@pytest.mark.parametrize("hidden", [1, 31, 1000, 1024, 4096, 8192, 8193])
@pytest.mark.parametrize("norm", ["layer_norm", "rms_norm"])
def test_norm_bwd_kernels_across_the_tier(cuda_device, norm, hidden, rows):
    """Both norm backwards on either side of the team kernel's register
    tier (8192) and at unaligned widths (1, 31, 1000: element-by-element
    quads), every dtype pair of x and dy and the x-hat form: dx within
    ``TOL`` of dy's dtype, parameter gradients atol 1e-3 rtol 1e-4, a
    second run bit for bit."""
    g = torch.Generator(device=cuda_device).manual_seed(hidden * 8 + rows)
    x0 = torch.randn(rows, hidden, generator=g, device=cuda_device) * 3 + 1
    dy0 = torch.randn(rows, hidden, generator=g, device=cuda_device)
    w = torch.randn(hidden, generator=g, device=cuda_device)
    for x_dt, dy_dt in NORM_PAIRS:
        x, dy = x0.to(x_dt), dy0.to(dy_dt)
        if norm == "layer_norm":
            _, mu, rstd = layer_norm_reference(x, w, torch.zeros_like(w),
                                               1e-5)
            stats, xhat = (mu, rstd), (x.float() - mu) * rstd
        else:
            _, rstd = rms_norm_reference(x, w, 1e-5)
            stats, xhat = (rstd,), x.float() * rstd
        for xin, is_xhat in ((x, False), (xhat, True)):
            got, want = _norm_bwd_pair(norm, dy, xin, stats, w, is_xhat)
            again, _ = _norm_bwd_pair(norm, dy, xin, stats, w, is_xhat)
            torch.cuda.synchronize()
            assert got[0].dtype == dy_dt
            torch.testing.assert_close(got[0].float(), want[0].float(),
                                       **TOL[dy_dt])
            for a, c in zip(got[1:], want[1:]):
                torch.testing.assert_close(a, c, atol=1e-3, rtol=1e-4)
            for a, c in zip(got, again):
                assert torch.equal(a, c), "two runs differ"


@pytest.mark.parametrize("hidden,n_sms", [(1000, 3), (2048, 2), (4096, 1),
                                          (8193, 2)])
@pytest.mark.parametrize("norm", ["layer_norm", "rms_norm"])
def test_norm_bwd_kernel_follows_its_partitioned_model(cuda_device, norm,
                                                       hidden, n_sms):
    """Under a plan for a small SM count (several blocks, teams of 1-4
    warps, a block-a-row plan past the tier) the kernels' parameter
    gradients against their plain model ``_norm_bwd_partitioned``, which
    sums in the kernels' order (atol 1e-4 rtol 1e-5: the same additions,
    each product rounded apart from its sum on the CPU side; a row
    dropped or counted twice moves a sum by ~1), and dx as the plain
    backward's."""
    rows = 37
    g = torch.Generator(device=cuda_device).manual_seed(hidden)
    x = torch.randn(rows, hidden, generator=g, device=cuda_device) * 3 + 1
    dy = torch.randn(rows, hidden, generator=g, device=cuda_device)
    w = torch.randn(hidden, generator=g, device=cuda_device)
    plan = ln_mod.norm_bwd_plan(rows, hidden, n_sms)
    if norm == "layer_norm":
        _, mu, rstd = layer_norm_reference(x, w, torch.zeros_like(w), 1e-5)
        got = ln_mod._launch_bwd(dy, x, mu, rstd, w, plan=plan)
    else:
        mu = None
        _, rstd = rms_norm_reference(x, w, 1e-5)
        got = ln_mod._launch_rms_bwd(dy, x, rstd, w, plan=plan)
    want = ln_mod._norm_bwd_partitioned(dy, x, mu, rstd, w, plan)
    torch.cuda.synchronize()
    torch.testing.assert_close(got[0], want[0], **TOL[torch.float32])
    for a, c in zip(got[1:], want[1:]):
        torch.testing.assert_close(a, c, atol=1e-4, rtol=1e-5)


def _split_lens(split_len, t_max):
    """Lengths at the first two split boundaries, one either side, an empty
    slot and the whole context."""
    return [0, 1, split_len - 1, split_len, split_len + 1,
            2 * split_len - 1, 2 * split_len + 1, t_max]


@pytest.mark.parametrize("kv_dtype,q_dtype", [
    (torch.float32, torch.float32), (torch.bfloat16, torch.bfloat16),
    (torch.bfloat16, torch.float32)], ids=["f32", "bf16", "f32q_bf16kv"])
@pytest.mark.parametrize("plan", ["default", "mid_page"])
def test_flash_decode_at_split_boundaries(cuda_device, kv_dtype, q_dtype,
                                          plan):
    """The split decode at lengths on and beside split boundaries, under
    the card's plan (32 pages of 8 a slot: 4 splits of 64 on an H100) and
    under 8 splits of 36 tokens (ending mid-page), against the plain version
    within ``TOL``; empty slots exactly 0; a second run bit for bit; every
    slot empty gives zeros."""
    mp, ps = 32, 8
    if plan == "default":
        p = decode_plan(8, 4, ps, mp,
                        _build.sm_count(torch.cuda.current_device()))
    else:
        p = DecodePlan(-(-mp * ps // 36), 36)
    lens = _split_lens(p.split_len, mp * ps)
    q, k, v, pt, kl = _decode_case(cuda_device, kv_dtype, q_dtype,
                                   lens=lens, P=8 * mp + 1, mp=mp)
    _device.reset_launch_counts()
    got = fd_mod._launch(q, k, v, pt, kl, 0.125, p)
    assert _device.launch_counts()["flash_decode"] == 1
    again = fd_mod._launch(q, k, v, pt, kl, 0.125, p)
    want = paged_decode_reference(q, k, v, pt, kl, scale=0.125)
    torch.cuda.synchronize()
    assert got.dtype == q_dtype
    torch.testing.assert_close(got.float(), want.float(), **TOL[q_dtype])
    assert torch.equal(got[0], torch.zeros_like(got[0]))
    assert torch.equal(got, again), "two runs differ"
    empty = fd_mod._launch(q, k, v, pt, torch.zeros_like(kl), 0.125, p)
    assert torch.equal(empty, torch.zeros_like(empty))


@pytest.mark.parametrize("d", [16, 33, 36, 64, 80, 128, 256])
@pytest.mark.parametrize("kv_dtype,q_dtype", [
    (torch.float32, torch.float32), (torch.bfloat16, torch.bfloat16),
    (torch.bfloat16, torch.float32)], ids=["f32", "bf16", "f32q_bf16kv"])
def test_flash_decode_kernel_at_head_dims(cuda_device, kv_dtype, q_dtype, d):
    """Every lane-group width of the decode kernel (4 to 32 lanes a token
    row, two vectors a lane at fp32 d 256) and head dims that are no whole
    number of 16-byte vectors (33; 36 in bf16), read element by element,
    against the plain version within ``TOL``."""
    q, k, v, pt, kl = _decode_case(cuda_device, kv_dtype, q_dtype, d=d,
                                   lens=(0, 1, 9, 30, 64, 17))
    got = flash_decode(q, k, v, pt, kl)
    want = paged_decode_reference(q, k, v, pt, kl)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), want.float(), **TOL[q_dtype])


# ---------------------------------------------------------------------------
# the serving engine's robustness and speculative paths on the card
# ---------------------------------------------------------------------------

def _tiny_serving(dev, position_scale=0.0, **kw):
    """A 2-layer fp32 engine on ``dev``; position table x
    ``position_scale`` (0: greedy decode repeats, so drafts accept)."""
    from apex_tpu_torch.serving import ServingEngine
    from apex_tpu_torch.transformer.testing import GPTConfig, init_gpt_params

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = GPTConfig(num_layers=2, hidden_size=64, num_attention_heads=4,
                    vocab_size=128, max_position_embeddings=64)
    params = init_gpt_params(cfg, torch.Generator().manual_seed(0))
    params["embedding"]["position"] = (params["embedding"]["position"]
                                       * position_scale)
    return cfg, params, ServingEngine(cfg, params, device=dev, **kw)


def _decoding_engine(dev, sampled=False, **kw):
    """An engine with both slots past their prompts (decode steps); with
    ``sampled``, slot 0 samples (temperature 0.8, top-p 0.9, top-k 0)."""
    from apex_tpu_torch.serving import Request
    from apex_tpu_torch.serving.sampling import SamplingParams

    cfg, params, eng = _tiny_serving(dev, n_slots=2, **kw)
    rng = np.random.default_rng(12)
    for i in range(2):
        policy = (SamplingParams(temperature=0.8, top_p=0.9, top_k=0,
                                 seed=5) if sampled and i == 0 else None)
        eng.submit(Request(prompt=[int(t) for t in rng.integers(0, 128, 6)],
                           max_new_tokens=56, rid=70 + i,
                           **({"sampling": policy} if policy else {})))
    while any(r.prefilling for _, r in eng.scheduler.running()) or \
            eng.scheduler.waiting:
        eng.run_step()
    for _ in range(4):
        eng.run_step()
    torch.cuda.synchronize()
    return eng


@pytest.mark.parametrize("sampled", [False, True],
                         ids=["greedy", "sampled"])
@pytest.mark.parametrize("spec_k", [0, 4])
def test_spec_step_makes_one_host_sync(cuda_device, spec_k, sampled):
    """A decode step (speculative at spec_k 4, greedy or with one slot
    sampling) with the metrics drain armed, under
    ``set_sync_debug_mode("warn")``: exactly one synchronising operation
    — the fetch of the emitted matrix. Every upload goes through pinned
    memory, the drain defers without a sync, and the sampler's deep sort
    is selected per row on the device."""
    import warnings

    eng = _decoding_engine(cuda_device, sampled=sampled, spec_k=spec_k,
                           spec_ngram=2, prefill_chunk=4, telemetry_every=1)
    eng.run_step()  # a warm step: every buffer and handle exists
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            em = eng.run_step()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    # (enabling the mode also warns once that it is a prototype)
    syncs = [w for w in caught
             if "called a synchronizing CUDA operation" in str(w.message)]
    assert len(syncs) == 1, [str(w.message) for w in syncs]
    assert em.shape[0] == 2 and (em.reshape(2, -1)[:, 0] >= 0).all()
    if spec_k:
        assert em.shape == (2, spec_k + 1 + 1)
        assert eng._accum["drafted_tokens"] > 0


@pytest.mark.parametrize("spec_k", [0, 4])
def test_poison_mask_isolates_its_row_bitwise(cuda_device, spec_k):
    """One device step from the same state, with and without slot 0
    poisoned: slot 0 reads ``POISONED``, slot 1's emitted tokens, carried
    state and KV pages are bit for bit those of the clean step."""
    import dataclasses as dc

    from apex_tpu_torch.serving import POISONED

    eng = _decoding_engine(cuda_device, spec_k=spec_k, spec_ngram=2)
    pt = torch.from_numpy(eng.scheduler.page_table_array()).to(cuda_device)
    pages0 = eng.kv.pages.clone()
    slots0 = dc.replace(eng.slots, **{
        f.name: getattr(eng.slots, f.name).clone()
        for f in dc.fields(eng.slots)})
    caps = torch.tensor([4, 4], dtype=torch.int32, device=cuda_device)
    runs = []
    for poison in ([False, False], [True, False]):
        eng.kv.pages.copy_(pages0)
        eng.slots = dc.replace(slots0, **{
            f.name: getattr(slots0, f.name).clone()
            for f in dc.fields(slots0)})
        mask = torch.tensor(poison, device=cuda_device)
        if spec_k:
            em = eng._spec_device_step(pt, mask, caps, False)
        else:
            em = eng._device_step(pt, mask, False, False)
        runs.append((em.cpu(), eng.slots.tokens.cpu(),
                     eng.slots.positions.cpu(), eng.kv.pages.clone()))
    (em0, tok0, pos0, kv0), (em1, tok1, pos1, kv1) = runs
    row = (lambda e: e[0]) if em0.dim() == 1 else (lambda e: e[0, 0])
    assert int(row(em1)) == POISONED and int(row(em0)) >= 0
    assert torch.equal(em1[1], em0[1])
    assert torch.equal(tok1[1], tok0[1]) and torch.equal(pos1[1], pos0[1])
    live = [p for p in eng.scheduler.slots[1].pages]
    assert torch.equal(kv1[:, :, live], kv0[:, :, live])


def test_watchdog_fires_on_a_wedged_fetch(cuda_device):
    """A chaos-wedged fetch under ``HangWatchdog(timeout_s=0.3)``: a
    ``HangError`` within the timeout plus a second, a ``hang`` event
    with the step and all-thread stacks, and the recovered engine
    completes the request with the tokens of an unwedged run."""
    import time as _time

    from apex_tpu_torch import telemetry
    from apex_tpu_torch.resilience import (
        HangError,
        HangWatchdog,
        ServingChaos,
    )
    from apex_tpu_torch.serving import Request, ServingEngine

    def req():
        return Request(prompt=[5, 9, 14, 3, 77, 2], max_new_tokens=8,
                       rid=90)

    cfg, params, clean = _tiny_serving(cuda_device, position_scale=40.0,
                                       n_slots=1)
    want = clean.generate([req()])[90]
    ring = telemetry.RingBufferRecorder()
    wd = HangWatchdog(timeout_s=0.3, poll_s=0.02, sink=ring)
    eng = ServingEngine(cfg, params, device=cuda_device, n_slots=1,
                        watchdog=wd, sink=ring,
                        chaos=ServingChaos().wedge_step_at(4, stall_s=20.0))
    r = req()
    t0 = _time.perf_counter()
    with pytest.raises(HangError):
        eng.generate([r])
    waited = _time.perf_counter() - t0
    wd.close()
    # steps 0-3 run warm in milliseconds; the 20 s stall is cut short
    assert waited < 0.3 + 2.0, waited
    hang = ring.events("hang")
    assert len(hang) == 1 and hang[0]["step"] == 4
    assert "MainThread" in hang[0]["stacks"]
    eng2, survivors = ServingEngine.recover_from(eng, watchdog=None,
                                                 chaos=None)
    assert eng2.device == eng.device
    eng2.generate(survivors)
    assert r.out_tokens == want


# ---------------------------------------------------------------------------
# flash attention's additive bias and segment ids, fp16 on every kernel
# ---------------------------------------------------------------------------

#: flash attention in fp16 against its plain version: the kernels round p
#: to fp16 against each tile's running max and the plain version against
#: the row's, so outputs and gradients of order 1 may differ by a few fp16
#: roundings (2^-11 each), summed over the keys
FLASH_F16_TOL = dict(atol=5e-3, rtol=5e-3)
FLASH_DTYPES = [torch.float32, torch.bfloat16, torch.float16]


def _flash_tol(dtype):
    return FLASH_F16_TOL if dtype == torch.float16 else TOL[dtype]


def _flash_inputs(dev, dtype, b, n, s_q, s_k, d, seed):
    rng = np.random.default_rng(seed)

    def t(*shape):
        return torch.from_numpy(rng.normal(size=shape).astype(
            np.float32)).to(dev, dtype)
    return t(b, n, s_q, d), t(b, n, s_k, d), t(b, n, s_k, d), \
        t(b, n, s_q, d)


#: bias shapes [b|1, n|1, s_q|1, s_k] at b 2, n 4, s_q 200, s_k 300, and
#: whether the case is causal (a causal cross shape)
FLASH_BIAS_CASES = {"full": ((2, 4, 200, 300), True),
                    "batch1": ((1, 4, 200, 300), False),
                    "keypad": ((2, 1, 1, 300), False),
                    "shared": ((1, 1, 200, 300), True)}


@pytest.mark.parametrize("bias_grad", [True, False],
                         ids=["bias_grad", "const_bias"])
@pytest.mark.parametrize("case", list(FLASH_BIAS_CASES))
@pytest.mark.parametrize("dtype", FLASH_DTYPES)
def test_flash_bias_kernels_match_plain(cuda_device, dtype, case,
                                        bias_grad):
    """The bias through both kernels against the plain versions, every
    broadcast shape, with and without the dbias the dq kernel writes; the
    key-padding form folds -1e30 in, batch row 1 wholly, which must give
    o = 0, lse = -1e30 and zero gradients there."""
    shape, causal = FLASH_BIAS_CASES[case]
    q, k, v, do = _flash_inputs(cuda_device, dtype, 2, 4, 200, 300, 64, 21)
    g = torch.Generator(device=cuda_device).manual_seed(22)
    bias = 0.5 * torch.randn(shape, generator=g, device=cuda_device)
    if case == "keypad":
        bias[0, ..., 250:] = -1e30
        bias[1] = -1e30
    kw = dict(causal=causal, bias=bias)
    _device.reset_launch_counts()
    o, lse = flash_attention_fwd(q, k, v, **kw)
    got = flash_attention_bwd(q, k, v, o, lse, do, bias_grad=bias_grad,
                              **kw)
    counts = _device.launch_counts()
    assert counts["flash_attn_fwd"] == 1 and counts["flash_attn_bwd"] == 1
    ro, rlse = flash_attention_fwd_reference(q, k, v, **kw)
    want = flash_attention_bwd_reference(q, k, v, ro, rlse, do,
                                         bias_grad=bias_grad, **kw)
    torch.cuda.synchronize()
    assert len(got) == len(want) == (4 if bias_grad else 3)
    tol = _flash_tol(dtype)
    torch.testing.assert_close(o.float(), ro.float(), **tol)
    torch.testing.assert_close(lse, rlse, **TOL[torch.float32])
    for a, e in zip(got, want):
        torch.testing.assert_close(a.float(), e.float(), **tol)
    if case == "keypad":
        assert bool((lse[1] == -1e30).all())
        for x in (o, *got):
            assert not bool(x[1].any())


#: packed sequences: lengths that end inside tiles, a one-token sequence,
#: and 30 tokens past cu_seqlens[-1] (one padding segment)
VARLEN_LENS, VARLEN_TOTAL = [70, 1, 130, 33, 200], 464


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
@pytest.mark.parametrize("dtype", FLASH_DTYPES)
def test_flash_segment_kernels_match_plain(cuda_device, dtype, causal, d):
    """Segment ids from cu_seqlens through both kernels against the plain
    versions (the kernels walk only the tiles a segment can see), and the
    varlen entry point through autograd."""
    from apex_tpu_torch.ops.flash_attention import (
        flash_attention_varlen,
        segment_ids_from_cu_seqlens,
    )

    cu = torch.tensor(np.concatenate([[0], np.cumsum(VARLEN_LENS)]),
                      dtype=torch.int32, device=cuda_device)
    segs = segment_ids_from_cu_seqlens(cu, VARLEN_TOTAL)
    q, k, v, do = _flash_inputs(cuda_device, dtype, 1, 4, VARLEN_TOTAL,
                                VARLEN_TOTAL, d, 23)
    kw = dict(causal=causal, seg_q=segs, seg_k=segs)
    o, lse = flash_attention_fwd(q, k, v, **kw)
    got = flash_attention_bwd(q, k, v, o, lse, do, **kw)
    ro, rlse = flash_attention_fwd_reference(q, k, v, **kw)
    want = flash_attention_bwd_reference(q, k, v, ro, rlse, do, **kw)
    tol = _flash_tol(dtype)
    torch.testing.assert_close(o.float(), ro.float(), **tol)
    torch.testing.assert_close(lse, rlse, **TOL[torch.float32])
    for a, e in zip(got, want):
        torch.testing.assert_close(a.float(), e.float(), **tol)
    qv, kv_, vv = (t[0].transpose(0, 1).contiguous().requires_grad_(True)
                   for t in (q, k, v))
    _device.reset_launch_counts()
    ov = flash_attention_varlen(qv, kv_, vv, cu, causal=causal)
    ov.backward(do[0].transpose(0, 1))
    counts = _device.launch_counts()
    assert counts["flash_attn_fwd"] == 1 and counts["flash_attn_bwd"] == 1
    torch.cuda.synchronize()
    torch.testing.assert_close(ov.transpose(0, 1).float(), o[0].float(),
                               rtol=0, atol=0)
    torch.testing.assert_close(qv.grad.transpose(0, 1).float(),
                               got[0][0].float(), rtol=0, atol=0)


def test_flash_bias_and_segment_backward_is_deterministic(cuda_device):
    """The bf16 backward with a full bias and its gradient, and with
    segment ids, twice on the same inputs: the same bits, dbias included
    (each element written once, no atomics)."""
    q, k, v, do = _flash_inputs(cuda_device, torch.bfloat16, 2, 4, 333,
                                333, 64, 24)
    bias = torch.randn(2, 4, 333, 333, device=cuda_device)
    segs = (torch.arange(333, device=cuda_device) // 50).to(torch.int32)
    for kw in (dict(bias=bias, bias_grad=True, causal=True),
               dict(seg_q=segs, seg_k=segs, causal=True)):
        fkw = {k_: x for k_, x in kw.items() if k_ != "bias_grad"}
        o, lse = flash_attention_fwd(q, k, v, **fkw)
        first = flash_attention_bwd(q, k, v, o, lse, do, **kw)
        second = flash_attention_bwd(q, k, v, o, lse, do, **kw)
        torch.cuda.synchronize()
        for a, b in zip(first, second):
            assert torch.equal(a, b)


def test_flash_fp16_is_available_and_refuses_other_dtypes(cuda_device):
    from apex_tpu_torch.ops.flash_attention import flash_attention_available

    assert flash_attention_available(256, 256, 64, cuda_device,
                                     torch.float16)
    assert not flash_attention_available(256, 256, 64, cuda_device,
                                         torch.float64)
    q = torch.zeros(1, 1, 16, 64, device=cuda_device, dtype=torch.float64)
    with pytest.raises(TypeError, match="f32/bf16/f16"):
        flash_attention_fwd(q, q, q)


@pytest.mark.parametrize("name", ["adam", "sgd", "novograd", "lamb"])
def test_packed_sweeps_take_fp16(cuda_device, name):
    """The packed sweeps with fp16 gradients and an fp16 model copy
    against their plain versions: the fp32 state as in fp32, the fp16
    parameters within one fp16 rounding (2^-11)."""
    dev, rows = cuda_device, 8
    g = _flat(dev, rows, 1e-2, 40).to(torch.float16)
    a, b_, src = (_flat(dev, rows, 1e-3, 41), _flat(dev, rows, 1e-5, 42,
                                                    True),
                  _flat(dev, rows, 0.05, 43))
    f16 = dict(rtol=1e-3, atol=1e-6)
    if name == "adam":
        hyper = dict(param_dtype=torch.float16, lr=1e-4,
                     bc1=torch.tensor(0.1, device=dev),
                     bc2=torch.tensor(0.001, device=dev))
        m, v, s_ = a.clone(), b_.clone(), src.clone()
        p_out, *_ = packed_adam_apply(g, m, v, s_, **hyper)
        rp, rm, rv, rs = packed_adam_reference(g, a, b_, src, **hyper)
        state = ((m, rm), (v, rv), (s_, rs))
    elif name == "sgd":
        hyper = dict(param_dtype=torch.float16,
                     lr=torch.tensor(0.1, device=dev),
                     first_run=torch.tensor(False, device=dev),
                     inv_scale=torch.tensor(0.5, device=dev), momentum=0.9)
        buf, s_ = a.clone(), src.clone()
        p_out, gb, gm = packed_sgd_apply(g, buf, s_, **hyper)
        rp, rb, rs = packed_sgd_reference(g, a, src, **hyper)
        state = ((buf, rb), (s_, rs))
    elif name == "novograd":
        denom = torch.rand(rows, device=dev) + 0.5
        hyper = dict(param_dtype=torch.float16,
                     lr=torch.tensor(1e-3, device=dev),
                     bc1=torch.tensor(0.05, device=dev),
                     inv_scale=torch.tensor(0.5, device=dev), beta1=0.95,
                     beta3=0.05, wd=0.0, reg_inside_moment=False)
        m = a.clone()
        p_out, _ = packed_novograd_apply(g, m, src, denom, **hyper)
        rp, rm = packed_novograd_reference(g, a, src, denom, **hyper)
        state = ((m, rm),)
    else:
        hyper = dict(clip=torch.tensor(1.7, device=dev),
                     bc1=torch.tensor(0.19, device=dev),
                     bc2=torch.tensor(0.002, device=dev),
                     inv_scale=torch.tensor(0.25, device=dev), wd=0.01)
        m, v = a.clone(), b_.clone()
        u, _, _, ru, rp_ = packed_lamb_stage1(g, m, v, src, **hyper)
        wu, wm, wv, wru, wrp = packed_lamb_stage1_reference(g, a, b_, src,
                                                            **hyper)
        torch.testing.assert_close(u, wu, **PACKED_F32)
        torch.testing.assert_close(ru, wru, **ROW_SUM)
        coef = torch.linspace(0.0, 3.0, rows, device=dev)
        p_out, _ = packed_scale_update(
            u, src.clone(), coef, param_dtype=torch.float16,
            lr=torch.tensor(1e-2, device=dev), write_master=False)
        rp, _ = packed_scale_update_reference(
            u, src, coef, param_dtype=torch.float16, lr=1e-2, noop=None)
        state = ((m, wm), (v, wv))
    torch.cuda.synchronize()
    assert p_out.dtype == torch.float16
    torch.testing.assert_close(p_out.float(), rp.float(), **f16)
    for got, want in state:
        torch.testing.assert_close(got, want, **PACKED_F32)


def test_flat_ops_take_fp16(cuda_device):
    """The flat scale and axpby over fp16 buffers (in and out) against
    their plain versions: one rounding of the same fp32 product, bit for
    bit; an inf planted in the input raises the found flag."""
    n = 8 * 1024 + 3
    g = torch.Generator(device=cuda_device).manual_seed(44)
    x = torch.randn(n, generator=g, device=cuda_device).half()
    y = torch.randn(n, generator=g, device=cuda_device).half()
    x[7] = float("inf")
    out, found = multi_tensor_scale_flat(x, 0.5, torch.float16)
    want, wfound = multi_tensor_scale_flat_reference(x, 0.5, torch.float16)
    assert out.dtype == torch.float16 and bool(found) and bool(wfound)
    torch.testing.assert_close(out, want, rtol=0, atol=0)
    out, found = multi_tensor_axpby_flat(0.25, 1.5, x, y, torch.float16)
    want, wfound = multi_tensor_axpby_flat_reference(0.25, 1.5, x, y,
                                                     torch.float16)
    assert bool(found) and bool(wfound)
    torch.testing.assert_close(out, want, rtol=0, atol=0)


# ---------------------------------------------------------------------------
# fp8 (fused_dense.fp8): the library fp8 GEMM route and the GPT's fp8 step
# ---------------------------------------------------------------------------

#: the fp8 GEMM route against its plain version over the same fp8 bytes:
#: beyond one rounding of the output, within 2^-13 of the sum of
#: |products| (the tensor cores' partial sums, the folded scales)
FP8_SUM_TOL = 2.0 ** -13
FP8_OUT_ULP = {torch.float32: 0.0, torch.bfloat16: 2.0 ** -7,
               torch.float16: 2.0 ** -10}


@pytest.mark.parametrize("out_dtype", [torch.bfloat16, torch.float16,
                                       torch.float32])
@pytest.mark.parametrize("mkn", [(256, 1024, 3072), (64, 4096, 1024),
                                 (7, 1000, 1000), (33, 48, 24)])
def test_fp8_gemm_matches_plain(cuda_device, mkn, out_dtype):
    from apex_tpu_torch.fused_dense import fp8

    m, k, n = mkn
    g = torch.Generator(device=cuda_device).manual_seed(m + k + n)
    x = torch.randn(m, k, generator=g, device=cuda_device)
    w = torch.randn(n, k, generator=g, device=cuda_device) * 0.02
    sx = torch.full((), 448.0, device=cuda_device) / x.abs().amax()
    sw = torch.full((), 448.0, device=cuda_device) / w.abs().amax()
    qx, qw = fp8.quantize_e4m3(x, sx), fp8.quantize_e4m3(w, sw)
    _device.reset_launch_counts()
    got = fp8.fp8_gemm(qx, qw, sx, sw, out_dtype)
    assert _device.launch_counts()["fp8_gemm"] == 1
    want = fp8.fp8_gemm_reference(qx, qw, sx, sw, out_dtype).float()
    assert got.shape == (m, n) and got.dtype == out_dtype
    mag = (qx.float().abs() @ qw.float().abs().t()) / (sx * sw)
    over = (got.float() - want).abs() - FP8_OUT_ULP[out_dtype] * want.abs()
    assert float((over / mag.clamp_min(1e-30)).max()) <= FP8_SUM_TOL


def test_fp8_quantizers_match_the_cpu_bytes(cuda_device):
    from apex_tpu_torch.fused_dense import fp8

    g = torch.Generator(device=cuda_device).manual_seed(0)
    x = torch.randn(1 << 16, generator=g, device=cuda_device) * torch.exp2(
        torch.randint(-20, 21, (1 << 16,), generator=g,
                      device=cuda_device).float())
    x[:3] = torch.tensor([1e9, -1e9, 0.0])
    for fn in (fp8.quantize_e4m3, fp8.quantize_e5m2):
        s = torch.full((), 3.7, device=cuda_device)
        assert torch.equal(fn(x, s).view(torch.uint8).cpu(),
                           fn(x.cpu(), s.cpu()).view(torch.uint8))


@pytest.mark.parametrize("fused", [False, True])
def test_fp8_gpt_step_on_the_card(cuda_device, fused):
    """A 2-layer fp8 GPT trained 3 steps on the card: 8 fp8 GEMMs a
    step (4 a layer), finite losses, calibrated states."""
    from apex_tpu_torch.optimizers import FusedAdam
    from apex_tpu_torch.transformer.testing import (
        GPTConfig, gpt_loss, init_gpt_fp8_carriers, init_gpt_fp8_states,
        init_gpt_params, record_gpt_grad_amaxes)

    cfg = GPTConfig(num_layers=2, hidden_size=128, num_attention_heads=2,
                    vocab_size=256, max_position_embeddings=64,
                    hidden_dropout=0.0, attention_dropout=0.0,
                    compute_dtype=torch.bfloat16, fp8=True,
                    fused_block=fused, recompute_granularity=(
                        "selective_elementwise" if fused else None))
    params = init_gpt_params(cfg, torch.Generator(device=cuda_device)
                             .manual_seed(0), device=cuda_device)
    tokens = torch.randint(0, 256, (2, 64), device=cuda_device)
    labels = torch.roll(tokens, -1, dims=1)
    opt = FusedAdam(lr=1e-3, master_weights=True, packed=True)
    ostate = opt.init(params)
    states = init_gpt_fp8_states(cfg, cuda_device)
    losses = []
    for _ in range(3):
        box = {}

        def f(tree):
            loss, box["s"] = gpt_loss(cfg, tree[0], tokens, labels,
                                      fp8_states=states,
                                      fp8_carriers=tree[1])
            return loss
        _device.reset_launch_counts()
        loss, (grads, amaxes) = value_and_grad(
            f, (params, init_gpt_fp8_carriers(cfg, cuda_device)))
        assert _device.launch_counts()["fp8_gemm"] == 8
        states = record_gpt_grad_amaxes(cfg, box["s"], amaxes)
        params, ostate = opt.step(grads, ostate, params)
        losses.append(float(loss))
    assert all(np.isfinite(losses)) and losses[-1] < losses[0]
    for meta in tree_leaves(states):
        assert torch.isfinite(meta).all()
    assert bool((states["fc2"].g.amax_history[:, :3] > 0).all())


# ---------------------------------------------------------------------------
# the single-device contribs and RNN (no kernel of the port on their paths:
# plain PyTorch over cuDNN and cuBLAS), card against CPU
#
# Tolerances: fp32 (TF32 off for cuDNN and cuBLAS) within 1e-5 of each
# result's largest entry, the DP and the optimizer trajectories too;
# gradients through a ReLU (the convs, the Bottleneck, the RNNs) in fp64
# within 1e-8 (in fp32 the two devices' pre-activations, a few ulps
# apart, can fall on either side of 0, where the gradient jumps; fp64
# sums through the BatchNorm's E[x^2] - E[x]^2 cancel to ~1e-10);
# index_mul's forward and the 2:4 masks bit for bit; index_mul's
# grad_in1 within 1e-6 of its largest entry (the card's scatter-add
# atomics sum repeated rows in an order that changes from run to run);
# the legacy Adam within 1e-6 of itself plus 1e-4 of each leaf's largest
# 3-step update (CUDA's and the CPU's fp32 pow may round beta2**t an ulp
# apart, and 1 - beta2**t cancels it up)
# ---------------------------------------------------------------------------

CONTRIB_TOL = 1e-5


@contextlib.contextmanager
def _no_tf32():
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def _near(got, want, tol=CONTRIB_TOL):
    got, want = got.detach().cpu().float(), want.detach().cpu().float()
    assert got.shape == want.shape
    assert float((got - want).abs().max()) <= tol * float(
        want.abs().max()), (float((got - want).abs().max()),
                            float(want.abs().max()))


def _both(cuda_device, fn, *arrays, grad=()):
    """``fn`` on the CPU and the card over the same arrays; returns
    ``(outputs, gradients)`` per device (outputs a tuple), gradients of
    ``sum(output[0] * dy)`` for the arrays at positions ``grad``. No
    kernel of the port launches."""
    out = {}
    for dev in ("cpu", cuda_device):
        xs = [a.to(dev).requires_grad_() if i in grad else a.to(dev)
              for i, a in enumerate(arrays)]
        _device.reset_launch_counts()
        with _no_tf32():
            res = fn(*xs)
            res = res if isinstance(res, tuple) else (res,)
            gs = ()
            if grad:
                dy = torch.randn(res[0].shape, generator=torch.Generator()
                                 .manual_seed(99)).to(dev)
                gs = torch.autograd.grad(
                    (res[0].float() * dy).sum(), [xs[i] for i in grad])
        assert not any(_device.launch_counts().values())
        out[str(dev)] = (res, gs)
    return out["cpu"], out[str(cuda_device)]


def test_index_mul_2d_on_card_matches_cpu(cuda_device):
    from apex_tpu_torch.contrib.index_mul_2d import index_mul_2d

    g = torch.Generator().manual_seed(0)
    a, b = torch.randn(257, 64, generator=g), torch.randn(4096, 64,
                                                          generator=g)
    idx = torch.randint(0, 257, (4096,), generator=g)
    (co, cg), (go, gg) = _both(cuda_device, index_mul_2d, a, b, idx,
                               grad=(0, 1))
    assert torch.equal(go[0].cpu(), co[0])
    _near(gg[0], cg[0], 1e-6)
    assert torch.equal(gg[1].cpu(), cg[1])
    for dt in (torch.float16, torch.bfloat16):
        assert torch.equal(index_mul_2d(a.to(dt).to(cuda_device),
                                        b.to(dt).to(cuda_device),
                                        idx.to(cuda_device)).cpu(),
                           index_mul_2d(a.to(dt), b.to(dt), idx))


def test_focal_loss_on_card_matches_cpu(cuda_device):
    from apex_tpu_torch.contrib.focal_loss import focal_loss

    g = torch.Generator().manual_seed(1)
    logits = torch.randn(4, 2000, 96, generator=g) * 3
    y = torch.randint(-2, 90, (4, 2000), generator=g)
    (co, cg), (go, gg) = _both(
        cuda_device, lambda p, t: focal_loss(p, t, 321.0, 90, 0.25, 2.0, 0.1),
        logits, y, grad=(0,))
    _near(go[0], co[0])
    _near(gg[0], cg[0])


def test_group_norm_on_card_matches_cpu(cuda_device):
    from apex_tpu_torch.contrib.group_norm import group_norm_nhwc

    g = torch.Generator().manual_seed(2)
    x = torch.randn(2, 16, 16, 320, generator=g)
    w, b = torch.randn(320, generator=g), torch.randn(320, generator=g)
    (co, cg), (go, gg) = _both(
        cuda_device, lambda x, w, b: group_norm_nhwc(x, 32, w, b, 1e-5,
                                                     "swish"),
        x, w, b, grad=(0, 1, 2))
    _near(go[0], co[0])
    for a, c in zip(gg, cg):
        _near(a, c)


def test_groupbn_on_card_matches_cpu(cuda_device):
    from apex_tpu_torch.contrib.cudnn_gbn import GroupBatchNorm2d
    from apex_tpu_torch.contrib.groupbn import BatchNorm2d_NHWC
    from apex_tpu_torch.parallel import sync_batch_norm

    g = torch.Generator().manual_seed(3)
    x, z = torch.randn(8, 14, 14, 64, generator=g), torch.randn(
        8, 14, 14, 64, generator=g)
    for bn in (BatchNorm2d_NHWC(64), GroupBatchNorm2d(64, group_size=1)):
        def run(x, z, bn=bn):
            p, s = bn.init(device=x.device)
            y, s = bn.apply(p, s, x, z)
            y2, _ = bn.apply(p, s, x, training=False)
            return y, y2, s["running_mean"], s["running_var"]
        (co, cg), (go, gg) = _both(cuda_device, run, x, z, grad=(0, 1))
        for a, c in zip(go + gg, co + cg):
            _near(a, c)
    (co, _), (go, _) = _both(
        cuda_device, lambda x: sync_batch_norm(
            x, None, None, torch.zeros(64, device=x.device),
            torch.ones(64, device=x.device), training=True, axis_name=None),
        x)
    for a, c in zip(go, co):
        _near(a, c)


def test_conv_bias_relu_on_card_matches_cpu(cuda_device):
    from apex_tpu_torch.contrib import conv_bias_relu as cbr

    g = torch.Generator().manual_seed(4)
    x = torch.randn(4, 14, 14, 64, generator=g)
    w3 = torch.randn(64, 64, 3, 3, generator=g).contiguous(
        memory_format=torch.channels_last) * 0.05
    w1 = torch.randn(128, 64, 1, 1, generator=g).contiguous(
        memory_format=torch.channels_last) * 0.1
    b, s = torch.randn(128, generator=g), torch.rand(128, generator=g)
    mask = (torch.rand(4, 14, 14, 1, generator=g) > 0.3).float()
    cases = [
        (lambda x, w, b: cbr.ConvBiasReLU(x, w, b[:64], 1, 1), w3),
        (lambda x, w, b: cbr.ConvBiasMaskReLU(x, w, b[:64], mask.to(x.device),
                                              1, 1), w3),
        (lambda x, w, b: cbr.ConvBias(x, w, b, 0, 2), w1),
        (lambda x, w, b: cbr.ConvFrozenScaleBiasReLU(x, w, s.to(x.device), b,
                                                     0, 2), w1),
    ]
    for fn, w in cases:
        (co, _), (go, _) = _both(cuda_device, fn, x, w, b)
        _near(go[0], co[0])
        (_, cg), (_, gg) = _both(cuda_device, fn, x.double(), w.double(),
                                 b.double(), grad=(0, 1))
        for a, c in zip(gg, cg):
            _near(a, c, 1e-8)
    bf = cbr.ConvBiasReLU(x.bfloat16().to(cuda_device),
                          w3.bfloat16().to(cuda_device),
                          b[:64].to(cuda_device), 1, 1)
    assert bf.dtype == torch.bfloat16 and bf.shape == (4, 14, 14, 64)


def test_bottleneck_on_card_matches_cpu(cuda_device):
    from apex_tpu_torch.contrib.bottleneck import Bottleneck

    for cin, mid, cout, stride in ((64, 16, 64, 1), (64, 32, 128, 2)):
        cpu = Bottleneck(cin, mid, cout, stride, device="cpu",
                         generator=torch.Generator().manual_seed(5))
        card = Bottleneck(cin, mid, cout, stride, device=cuda_device)
        card.load_state_dict(cpu.state_dict())
        x = torch.randn(4, 14, 14, cin,
                        generator=torch.Generator().manual_seed(6))
        out = {}
        for dev, mod in (("cpu", cpu), (cuda_device, card)):
            with _no_tf32():
                y = mod(x.bfloat16().to(dev))
                assert y.dtype == torch.float32
                mod64 = copy.deepcopy(mod).double()
                xs = x.double().to(dev).requires_grad_()
                gx, gk = torch.autograd.grad(mod64(xs).sum(),
                                             (xs, mod64.conv2.kernel))
            out[str(dev)] = (y, mod.bn3.mean, mod.bn3.var, gx, gk)
        for i, (a, c) in enumerate(zip(out[str(cuda_device)], out["cpu"])):
            _near(a, c, CONTRIB_TOL if i < 3 else 1e-8)


def test_sparsity_on_card_matches_cpu(cuda_device):
    from apex_tpu_torch.contrib.sparsity import (
        ASP,
        apply_2_to_4,
        channel_swap_search,
        create_mask,
    )
    from apex_tpu_torch.optimizers import FusedAdam

    g = torch.Generator().manual_seed(7)
    for shape in ((1024, 1024), (64, 96, 3, 3), (4096,)):
        w = torch.randn(shape, generator=g)
        assert torch.equal(create_mask(w.to(cuda_device)).cpu(),
                           create_mask(w))
    ties = torch.randint(-2, 3, (256, 256), generator=g).float()
    assert torch.equal(create_mask(ties.to(cuda_device)).cpu(),
                       create_mask(ties))
    assert torch.equal(apply_2_to_4(ties.to(cuda_device)).cpu(),
                       apply_2_to_4(ties))
    m = torch.randn(64, 128, generator=g)
    with _no_tf32():
        pc, kc = channel_swap_search(m, max_iters=30)
        pg, kg = channel_swap_search(m.to(cuda_device), max_iters=30)
    assert (pg == pc).all() and abs(kg - kc) <= 1e-6 * kc
    params = {"w": torch.randn(64, 128, generator=g).to(cuda_device),
              "b": torch.randn(128, generator=g).to(cuda_device)}
    asp = ASP()
    masks = asp.compute_sparse_masks(params)
    params = asp.apply_masks(params, masks)
    opt = FusedAdam(lr=1e-2)
    step = asp.wrap_step(opt.step, masks)
    state = opt.init(params)
    for _ in range(3):
        params, state = step(tree_map(torch.ones_like, params), state,
                             params)
    assert not params["w"][masks["w"] == 0].any()


def test_legacy_optimizers_on_card_match_cpu(cuda_device):
    from apex_tpu_torch.contrib.optimizers import FusedAdam, FusedSGD

    g = torch.Generator().manual_seed(8)
    p0 = {"w": torch.randn(256, 512, generator=g) * 0.02,
          "b": torch.randn(512, generator=g) * 0.02}
    grads = [{k: torch.randn(v.shape, generator=g) * 512.0
              for k, v in p0.items()} for _ in range(3)]
    for make in (lambda: FusedAdam(lr=1e-3, max_grad_norm=1.0,
                                   weight_decay=0.01),
                 lambda: FusedAdam(lr=1e-3, eps_inside_sqrt=True),
                 lambda: FusedSGD(lr=0.1, momentum=0.9)):
        res = {}
        for dev in ("cpu", cuda_device):
            opt = make()
            p = tree_map(lambda t: t.to(dev), p0)
            st = opt.init(p)
            for gr in grads:
                gr = tree_map(lambda t: t.to(dev), gr)
                norm = torch.sqrt(sum((t.double() ** 2).sum()
                                      for t in tree_leaves(gr))).float()
                p, st, out = opt.step(gr, st, p, scale=1024.0,
                                      grad_norms=norm,
                                      output_params_dtype=torch.bfloat16)
            res[str(dev)] = (p, out)
        (pc, oc), (pg, og) = res["cpu"], res[str(cuda_device)]
        for k in p0:
            upd = float((pc[k] - p0[k]).abs().max())
            diff = (pg[k].cpu() - pc[k]).abs()
            assert float((diff - 1e-6 * pc[k].abs()).max()) <= 1e-4 * upd
            assert og[k].dtype == torch.bfloat16


def test_transducer_on_card_matches_cpu(cuda_device):
    from apex_tpu_torch.contrib.transducer import (
        TransducerLoss,
        transducer_joint,
    )

    g = torch.Generator().manual_seed(9)
    f, gg_ = torch.randn(2, 40, 64, generator=g), torch.randn(
        2, 13, 64, generator=g)
    f_len, g_len = torch.tensor([40, 23]), torch.tensor([13, 6])
    off = torch.cumsum(f_len * g_len, 0)
    (co, cg), (go, gg) = _both(
        cuda_device, lambda f, g, fl, gl, o: transducer_joint(
            f, g, fl, gl, pack_output=True, relu=True, batch_offset=o,
            packed_batch=int(off[-1])), f, gg_, f_len, g_len, off,
        grad=(0, 1))
    assert torch.equal(go[0].cpu(), co[0])
    for a, c in zip(gg, cg):
        _near(a, c)
    x = torch.randn(2, 40, 13, 129, generator=g) * 2
    label = torch.randint(0, 128, (2, 12), generator=g)
    y_len = torch.tensor([12, 5])
    dbg = []
    (co, cg), (go, gg) = _both(
        cuda_device, lambda x, l, fl, yl: TransducerLoss()(
            x, l, fl, yl, 128, debug_list=dbg), x, label, f_len, y_len,
        grad=(0,))
    _near(go[0], co[0])
    _near(gg[0], cg[0])


def test_rnn_on_card_matches_cpu(cuda_device):
    from apex_tpu_torch import RNN

    for name in ("LSTM", "GRU", "ReLU", "Tanh", "mLSTM"):
        model = getattr(RNN, name)(32, 64, num_layers=2,
                                   bidirectional=name != "mLSTM")
        params = model.init(torch.Generator().manual_seed(10), device="cpu")
        x = torch.randn(12, 4, 32, generator=torch.Generator().manual_seed(11))
        leaves, treedef = tree_flatten(params)
        out = {}
        for dev in ("cpu", cuda_device):
            live = [t.to(dev, torch.float64).requires_grad_()
                    for t in leaves]
            with _no_tf32():
                y, _ = model(tree_unflatten(treedef, [
                    t.to(dev) for t in leaves]), x.to(dev))
                y64, _ = model(tree_unflatten(treedef, live),
                               x.to(dev, torch.float64))
                gs = torch.autograd.grad(y64.square().sum(), live)
            out[str(dev)] = (y,) + gs
        for i, (a, c) in enumerate(zip(out[str(cuda_device)], out["cpu"])):
            _near(a, c, CONTRIB_TOL if i == 0 else 1e-8)


def _card_tensors(dev):
    g = torch.Generator().manual_seed(21)
    return [torch.randn(33, 17, generator=g).to(dev),
            torch.randn(1000, generator=g).to(torch.bfloat16).to(dev),
            torch.randint(0, 1 << 20, (5, 7), generator=g).to(dev),
            torch.tensor(2.5, dtype=torch.float64).to(dev)]


def _raw(t):
    return t.detach().cpu().contiguous().reshape(-1).view(torch.uint8)


def test_hostio_from_card_tensors_matches_the_cpu_bytes(cuda_device,
                                                         tmp_path):
    from apex_tpu_torch.ops import hostio

    assert hostio.native_available()
    card = _card_tensors(cuda_device)
    host = [t.cpu() for t in card]
    offs = hostio.write_arrays(str(tmp_path / "card.bin"), card)
    assert hostio.write_arrays(str(tmp_path / "cpu.bin"), host) == offs
    assert (tmp_path / "card.bin").read_bytes() == \
        (tmp_path / "cpu.bin").read_bytes()
    out = [torch.empty_like(t) for t in card]
    hostio.read_arrays(str(tmp_path / "card.bin"), None, offs, out=out)
    for a, b in zip(out, card):
        assert a.device == b.device and torch.equal(_raw(a), _raw(b))
    arena, aoffs = hostio.flatten(card)
    harena, hoffs = hostio.flatten(host)
    assert aoffs == hoffs and torch.equal(arena, harena)
    for a, b in zip(hostio.unflatten(arena, host, aoffs), host):
        assert torch.equal(_raw(a), _raw(b))


def test_gdsfile_fills_card_tensors_in_place(cuda_device, tmp_path):
    from apex_tpu_torch.contrib.gpu_direct_storage import GDSFile

    card = _card_tensors(cuda_device)[:2]
    path = str(tmp_path / "gds.bin")
    with GDSFile(path, "w") as f:
        for t in card:
            f.save_data(t)
    assert (tmp_path / "gds.bin").read_bytes() == b"".join(
        _raw(t).numpy().tobytes() for t in card)
    outs = [torch.zeros_like(t) for t in card]
    with GDSFile(path, "r") as f:
        back = [f.load_data(o) for o in outs]
    for b, o, t in zip(back, outs, card):
        assert b is o and o.device == t.device
        assert torch.equal(_raw(o), _raw(t))


def test_checkpoint_roundtrip_onto_the_card(cuda_device, tmp_path):
    from apex_tpu_torch.checkpoint import load_checkpoint, save_checkpoint
    from apex_tpu_torch.optimizers import FusedAdam

    g = torch.Generator().manual_seed(5)
    params = {"w": torch.randn(64, 48, generator=g).to(torch.bfloat16),
              "b": [torch.randn(48, generator=g).to(torch.bfloat16)]}
    params = tree_map(lambda t: t.to(cuda_device), params)
    grads = tree_map(lambda t: torch.randn_like(t), params)
    opt = FusedAdam(lr=1e-3, packed=True, master_weights=True)
    state = opt.init(params)
    params, state = opt.step(grads, state, params)
    train = {"params": params, "opt": state, "step": 1}
    save_checkpoint(str(tmp_path / "ck"), train)
    back = load_checkpoint(str(tmp_path / "ck"), target=train)
    for a, b in zip(tree_leaves(back["params"]), tree_leaves(params)):
        assert a.device == b.device and torch.equal(_raw(a), _raw(b))
    for f in ("step", "exp_avg", "exp_avg_sq", "master_params"):
        a, b = getattr(back["opt"], f), getattr(state, f)
        assert a.device == b.device and torch.equal(_raw(a), _raw(b))
    assert back["opt"].spec is state.spec and back["step"] == 1
    p1, s1 = opt.step(grads, back["opt"], back["params"])
    p2, s2 = opt.step(grads, state, params)
    for a, b in zip(tree_leaves(p1), tree_leaves(p2)):
        assert torch.equal(_raw(a), _raw(b))


def test_cpu_offload_step_is_bit_for_bit_on_the_card(cuda_device):
    from apex_tpu_torch.transformer.testing import (
        GPTConfig,
        gpt_model_provider,
    )

    cfg = GPTConfig(num_layers=2, hidden_size=256, num_attention_heads=4,
                    vocab_size=1024, max_position_embeddings=256,
                    hidden_dropout=0.0, attention_dropout=0.0,
                    compute_dtype=torch.bfloat16)
    tokens = torch.randint(0, 1024, (4, 256), device=cuda_device,
                           generator=torch.Generator(cuda_device)
                           .manual_seed(1))
    labels = torch.roll(tokens, -1, dims=1)
    out = []
    for off in (False, True):
        params, _, loss_fn = gpt_model_provider(
            cfg, torch.Generator(cuda_device).manual_seed(0),
            cpu_offload=off, device=cuda_device)
        out.append(value_and_grad(
            lambda p: loss_fn(p, tokens, labels), params))
    (l0, g0), (l1, g1) = out
    assert torch.equal(l0, l1)
    for a, b in zip(tree_leaves(g0), tree_leaves(g1)):
        assert torch.equal(a, b)
