#!/usr/bin/env python3
"""Smoke run of the PyTorch/H100 port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives ``apex_tpu_torch`` (never JAX, never ``apex_tpu``) in phases;
any failure exits non-zero and prints no result line:

1. device and build: print the card's name and power limit, build the
   CUDA kernels from ``apex_tpu_torch/csrc`` with nvcc;
2. kernel checks: each kernel against its plain PyTorch version on the
   card at the GPT-2 345M serving and training shapes, plus edge cases
   (ragged last page, ``kv_len == 0``, garbage-page entries, poisoned
   stale pages, mixed dtypes; a fully masked attention row, hash
   dropout, a length that is not a whole number of tiles; the optimizer's
   noop and no-update-m/v modes; the six fused block tails in fp32 and
   bf16, hash dropout with a negative seed, 1000 rows; the three fused
   softmax kernels in fp32, bf16 and fp16, causal and unmasked at the
   345M shape, masked at the BERT-large shape with a padding mask and a
   general mask holding a fully masked row, sk 1000, 999 and 16384);
   times of kernel, plain version, one PyTorch library call as
   yardstick, and the least time the card could take;
3. full-width serving: GPT-2 345M (24 layers, hidden 1024, 16 heads,
   vocab 50304, bf16, random weights from a seed) through
   ``ServingEngine(n_slots=8, prefill_chunk=8)`` on 16 staggered
   requests of 128 prompt + 64 new tokens, with the kernels' launch
   counts zeroed before and read after;
4. token identity: the same width in fp32 (position table x40) against
   the port's dense ``reference_decode``;
5. the 345M train step (seq 1024, batch 8, bf16 O2, packed FusedAdam):
   the headline step (``fused_block=True``, ``selective_elementwise``
   recompute), 2 warm-up and 6 timed steps, then the unfused step
   without recompute, the fused step without recompute and the step
   without flash attention (``bench.py``'s xla-attention leg: the fused
   softmax kernels under ``selective`` recompute) as further legs
   (2 + 6 steps each); for each, launches per step asserted exactly,
   loss falling, peak memory, a profiled step;
6. the BERT-large step with pytree FusedLAMB (``bench.py``'s
   ``bench_bert_lamb``: 24 x 1024 x 16, vocab 30592, seq 512, batch 16,
   bf16 over fp32 params, ``selective``), with a padding mask, without
   flash (the masked fused softmax) and with flash (2 + 5 steps each),
   checked as the GPT legs;
7. training parity, card (kernels) against CPU (plain versions), on
   2-layer full-width models: fp32 unfused and fused under
   ``selective_elementwise`` (3 packed-Adam steps), bf16 GPT without
   flash (3 packed-Adam steps) and bf16 BERT without flash under a
   padding mask (3 LAMB steps): loss, every gradient, the steps;
8. a ``{"kernels": [...]}`` line, the card line, and last
   ``{"ok": true, "device": {...}}``.

Exits non-zero when no CUDA device is present.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

from apex_tpu_torch import _build, _device
from apex_tpu_torch._tree import tree_leaves, tree_map, value_and_grad
from apex_tpu_torch.contrib.xentropy import softmax_cross_entropy_loss
from apex_tpu_torch.multi_tensor_apply.packing import PackSpec
from apex_tpu_torch.ops import fused_block as fb
from apex_tpu_torch.ops.flash_attention import (
    flash_attention_bwd,
    flash_attention_bwd_reference,
    flash_attention_fwd,
    flash_attention_fwd_reference,
)
from apex_tpu_torch.ops.flash_decode import (
    flash_decode,
    paged_decode_reference,
)
from apex_tpu_torch.ops.layer_norm import (
    layer_norm_bwd,
    layer_norm_bwd_reference,
    layer_norm_fwd,
    layer_norm_reference,
)
from apex_tpu_torch.ops.packed_optimizer import (
    packed_adam_apply,
    packed_adam_reference,
)
from apex_tpu_torch.optimizers import FusedAdam, FusedLAMB
from apex_tpu_torch.serving import (
    Request,
    ServingEngine,
    reference_decode,
)
from apex_tpu_torch.transformer.functional import fused_softmax as fs
from apex_tpu_torch.transformer.testing import (
    GPTConfig,
    bert_forward,
    gpt_forward,
    gpt_loss,
    init_gpt_params,
)

#: H100 SXM data-sheet peaks (dense): HBM bytes/s, fp32 (non-tensor-core)
#: flop/s — the kernels here do their arithmetic in fp32 on CUDA cores —
#: and the bf16 tensor-core rate, the least time any attention kernel
#: could take for its products
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12
BF16_TC_FLOPS = 989e12

# the 345M serving geometry: 16 heads x 64 dims, page 8, 8 slots, 32 pages
# per sequence (max 256 positions), 8 * 32 + 1 pool pages
N_HEADS, HEAD_DIM, PAGE, SLOTS, MP = 16, 64, 8, 8, 32
POOL_PAGES = SLOTS * MP + 1
HIDDEN = 1024

# tolerances of a kernel against its plain version on the same inputs:
# fp32 results differ only in summation order (and the fused softmax's
# __expf, a few fp32 ulps); a bf16 result may differ by one bf16 rounding
# (2^-8 relative) of values of order 1, an fp16 one by one fp16 rounding
# (2^-11) of values up to 1
TOL = {torch.float32: (2e-5, 1e-5), torch.bfloat16: (2e-2, 1e-2),
       torch.float16: (1e-3, 1e-3)}
#: the fused softmax kernels: probabilities of about 1/sk (1e-3 at the
#: paths' shapes, 6e-5 at sk 16384) and gradients near 1e-4, so the
#: relative term carries the check (one rounding of the output, 2^-8
#: bf16, 2^-11 fp16; fp32 __expf and summation order, a few ulps) and the
#: floor sits well under the values compared: it only covers results
#: that round to subnormals or cancel to near 0. The backward's
#: dy - rowsum(dy * y) cancels, and in fp32 the sum's order alone moves dx
#: by up to 7.2e-7 where y is large (short causal rows; H100 80GB HBM3 at
#: 700 W), hence the fp32 floor of 1e-6
SOFTMAX_TOL = {torch.float32: (1e-6, 1e-5), torch.bfloat16: (1e-4, 1e-2),
               torch.float16: (1e-5, 1e-3)}


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, iters: int = 100, warmup: int = 10) -> float:
    """Mean device time of one call over ``iters`` back-to-back calls,
    from CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, match, iters: int = 50):
    """Device time of the kernels whose name contains ``match`` (a
    string, or a tuple of strings for a call that issues several
    kernels), per call of ``fn``, from a ``torch.profiler`` trace (host
    overhead excluded); None when the trace shows no such kernel."""
    from torch.profiler import ProfilerActivity, profile

    matches = (match,) if isinstance(match, str) else tuple(match)
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    total_us = sum(e.device_time_total for e in prof.key_averages()
                   if any(m in e.key for m in matches))
    return total_us / 1e3 / iters if total_us else None


def check_close(name, got, want, dtype, tol=None, margin=False):
    """Max abs error of ``got`` against ``want``; raises where an element
    lies outside ``atol + rtol * |want|``. With ``margin``, also returns
    the largest error over its element's limit (1 would fail)."""
    atol, rtol = TOL[dtype] if tol is None else tol
    got, want = got.float(), want.float()
    if not torch.isfinite(got).all():
        raise AssertionError(f"{name}: kernel output is not finite")
    err = (got - want).abs()
    limit = atol + rtol * want.abs()
    bad = err > limit
    if bad.any():
        raise AssertionError(
            f"{name}: {int(bad.sum())} elements outside atol {atol} rtol "
            f"{rtol}; max abs err {float(err.max()):.3e}")
    if margin:
        return float(err.max()), float((err / limit).max())
    return float(err.max())


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------

def _page_case(g, dev, lens, dtype, q_dtype, n_pools=1):
    """Random pools and a page table over ``lens``; entries past a
    slot's length point at the garbage page 0."""
    B = len(lens)
    pools = [(torch.randn(POOL_PAGES, N_HEADS, PAGE, HEAD_DIM, generator=g,
                          device=dev).to(dtype),
              torch.randn(POOL_PAGES, N_HEADS, PAGE, HEAD_DIM, generator=g,
                          device=dev).to(dtype))
             for _ in range(n_pools)]
    q = torch.randn(B, N_HEADS, HEAD_DIM, generator=g, device=dev).to(q_dtype)
    # distinct pages per slot (rows of one chunked slot share them)
    perm = torch.randperm(POOL_PAGES - 1, generator=g, device=dev) + 1
    pt = torch.zeros(B, MP, dtype=torch.int32, device=dev)
    for b, L in enumerate(lens):
        used = -(-L // PAGE)
        s = (b % SLOTS) * MP
        pt[b, :used] = perm[s:s + used]
    kv_lens = torch.tensor(lens, dtype=torch.int32, device=dev)
    return q, pools, pt, kv_lens


def flash_decode_checks(dev):
    g = torch.Generator(device=dev).manual_seed(1)
    # ragged tails, an empty slot, whole pages, the longest 345M sequence
    dec_lens = [0, 1, 7, 8, 64, 129, 191, 192]
    errs = []
    cases = [("decode bf16", dec_lens, torch.bfloat16, torch.bfloat16),
             ("decode f32", dec_lens, torch.float32, torch.float32),
             ("decode f32 q / bf16 pages", dec_lens, torch.bfloat16,
              torch.float32)]
    # the chunked step: [8 slots x 8 columns] flattened, kv_len per column
    rng = np.random.default_rng(2)
    chunk_lens = []
    for _ in range(SLOTS):
        pos = int(rng.integers(0, 184))
        take = int(rng.integers(0, 9))
        chunk_lens += [pos + j + 1 if j < take else 0 for j in range(8)]
    cases.append(("chunk bf16", chunk_lens, torch.bfloat16, torch.bfloat16))
    for name, lens, kv_dt, q_dt in cases:
        q, pools, pt, kl = _page_case(g, dev, lens, kv_dt, q_dt)
        k, v = pools[0]
        got = flash_decode(q, k, v, pt, kl)
        want = paged_decode_reference(q, k, v, pt, kl)
        if got.dtype != q.dtype:
            raise AssertionError(f"{name}: output dtype {got.dtype}")
        empty = kl == 0
        if empty.any() and got[empty].abs().max() != 0:
            raise AssertionError(f"{name}: kv_len == 0 rows are not zero")
        err = check_close(f"flash_decode {name}", got, want, q.dtype)
        errs.append(err)
        log(f"  flash_decode {name} q{tuple(q.shape)}: max abs err {err:.3e}")
        if name == "decode bf16":
            # stale data the kernel must never read: NaN in the garbage
            # page and in the unused rows of every slot's last page
            kp, vp = k.clone(), v.clone()
            kp[0], vp[0] = float("nan"), float("nan")
            for b, L in enumerate(lens):
                if L % PAGE:
                    last = int(pt[b, L // PAGE])
                    kp[last, :, L % PAGE:] = float("nan")
                    vp[last, :, L % PAGE:] = float("nan")
            poisoned = flash_decode(q, kp, vp, pt, kl)
            if not torch.equal(poisoned, got):
                raise AssertionError(
                    "flash_decode read a masked position (NaN leaked)")
            log("  flash_decode poisoned stale pages: bitwise unchanged")
    # timing at the decode shape, cycling 8 pools (> 50 MB L2) so the
    # K/V reads come from device memory as each layer's pool would
    q, pools, pt, kl = _page_case(g, dev, dec_lens, torch.bfloat16,
                                  torch.bfloat16, n_pools=8)
    it = {"i": 0}

    def nxt():
        it["i"] = (it["i"] + 1) % len(pools)
        return pools[it["i"]]

    ms = time_ms(lambda: flash_decode(q, *nxt(), pt, kl))
    dev_ms = device_ms(lambda: flash_decode(q, *nxt(), pt, kl),
                       "flash_decode_kernel")
    plain_ms = time_ms(lambda: paged_decode_reference(q, *nxt(), pt, kl),
                       iters=20)
    # yardstick: SDPA over the already gathered dense K/V (the gather
    # itself is not timed)
    kd = pools[0][0][pt.long()].permute(0, 2, 1, 3, 4).reshape(
        SLOTS, N_HEADS, MP * PAGE, HEAD_DIM)
    vd = pools[0][1][pt.long()].permute(0, 2, 1, 3, 4).reshape(
        SLOTS, N_HEADS, MP * PAGE, HEAD_DIM)
    mask = (torch.arange(MP * PAGE, device=dev)[None, :]
            < kl[:, None]).reshape(SLOTS, 1, 1, MP * PAGE)
    lib_ms = time_ms(lambda: F.scaled_dot_product_attention(
        q[:, :, None, :], kd, vd, attn_mask=mask))
    tokens = int(kl.sum())
    elem = 2
    nbytes = (2 * tokens * N_HEADS * HEAD_DIM * elem      # K and V rows
              + 2 * q.numel() * elem                      # q in, out
              + sum(-(-L // PAGE) for L in dec_lens) * 4  # page-table reads
              + kl.numel() * 4)
    flops = 4 * tokens * N_HEADS * HEAD_DIM
    b_ms = nbytes / HBM_BYTES_PER_S * 1e3
    f_ms = flops / FP32_FLOPS * 1e3
    log(f"  flash_decode decode bf16 [8,16,64] over {tokens} tokens: "
        f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, sdpa {lib_ms:.4f} "
        f"ms, bound {max(b_ms, f_ms):.4f} ms; kernel device time "
        f"{dev_ms} ms")
    # the chunk shape is timed too, for PERF.md
    qc, pc, ptc, klc = _page_case(g, dev, chunk_lens, torch.bfloat16,
                                  torch.bfloat16, n_pools=8)
    itc = {"i": 0}

    def nxtc():
        itc["i"] = (itc["i"] + 1) % len(pc)
        return pc[itc["i"]]

    ms_c = time_ms(lambda: flash_decode(qc, *nxtc(), ptc, klc))
    dev_c = device_ms(lambda: flash_decode(qc, *nxtc(), ptc, klc),
                      "flash_decode_kernel")
    log(f"  flash_decode chunk bf16 [64,16,64] over {int(klc.sum())} "
        f"tokens: kernel {ms_c:.4f} ms, device time {dev_c} ms")
    return {"name": "flash_decode", "route": "cuda",
            "source": "apex_tpu_torch/csrc/flash_decode.cu",
            "replaces": "apex_tpu/ops/flash_decode.py:147",
            "max_abs_err": max(errs), "ms": ms, "plain_ms": plain_ms,
            "bound_ms": max(b_ms, f_ms),
            "bound_by": "bytes" if b_ms >= f_ms else "operations",
            "library_ms": lib_ms, "device_ms": dev_ms}


def layer_norm_checks(dev):
    g = torch.Generator(device=dev).manual_seed(3)
    errs = []
    timing = None
    # the decode step's 8 rows, the chunk step's 64, the train step's
    # 8 * 1024
    for rows, dt in ((8, torch.float32), (64, torch.float32),
                     (64, torch.bfloat16), (8192, torch.float32),
                     (8192, torch.bfloat16)):
        x = (torch.randn(rows, HIDDEN, generator=g, device=dev) * 3
             + 1).to(dt)
        w = torch.randn(HIDDEN, generator=g, device=dev)
        b = torch.randn(HIDDEN, generator=g, device=dev)
        y, mu, rstd = layer_norm_fwd(x, w, b, eps=1e-5)
        ry, rmu, rrstd = layer_norm_reference(x, w, b, 1e-5)
        err = max(check_close(f"layer_norm y {rows}x{HIDDEN} {dt}", y, ry,
                              dt),
                  check_close("layer_norm mu", mu, rmu, torch.float32),
                  check_close("layer_norm rstd", rstd, rrstd,
                              torch.float32))
        errs.append(err)
        log(f"  layer_norm [{rows},{HIDDEN}] {dt}: max abs err {err:.3e}")
        if rows == 8 and dt == torch.float32:
            ms = time_ms(lambda: layer_norm_fwd(x, w, b, eps=1e-5))
            dev_ms = device_ms(lambda: layer_norm_fwd(x, w, b, eps=1e-5),
                               "ln_fwd_kernel")
            plain_ms = time_ms(
                lambda: layer_norm_reference(x, w, b, 1e-5))
            lib_ms = time_ms(
                lambda: F.layer_norm(x, (HIDDEN,), w, b, 1e-5))
            nbytes = 2 * x.numel() * 4 + 2 * HIDDEN * 4 + 2 * rows * 4
            flops = 8 * x.numel()
            b_ms = nbytes / HBM_BYTES_PER_S * 1e3
            f_ms = flops / FP32_FLOPS * 1e3
            timing = {"ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
                      "device_ms": dev_ms,
                      "bound_ms": max(b_ms, f_ms),
                      "bound_by": "bytes" if b_ms >= f_ms else "operations"}
            log(f"  layer_norm [8,1024] f32: kernel {ms:.4f} ms, plain "
                f"{plain_ms:.4f} ms, F.layer_norm {lib_ms:.4f} ms, bound "
                f"{timing['bound_ms']:.6f} ms; kernel device time "
                f"{dev_ms} ms")
        if rows == 64 and dt == torch.float32:
            log(f"  layer_norm [64,1024] f32: kernel "
                f"{time_ms(lambda: layer_norm_fwd(x, w, b, eps=1e-5)):.4f}"
                f" ms")
        if rows == 8192 and dt == torch.float32:
            # the train step's shape (the model normalises an fp32 copy)
            t_ms = time_ms(lambda: layer_norm_fwd(x, w, b, eps=1e-5))
            t_dev = device_ms(lambda: layer_norm_fwd(x, w, b, eps=1e-5),
                              "ln_fwd_kernel")
            t_plain = time_ms(lambda: layer_norm_reference(x, w, b, 1e-5),
                              iters=20)
            t_lib = time_ms(lambda: F.layer_norm(x, (HIDDEN,), w, b, 1e-5))
            t_bound, t_by = bound(
                2 * x.numel() * 4 + 2 * HIDDEN * 4 + 2 * rows * 4,
                8 * x.numel())
            log(f"  layer_norm [8192,1024] f32: kernel {t_ms:.4f} ms, plain "
                f"{t_plain:.4f} ms, F.layer_norm {t_lib:.4f} ms, bound "
                f"{t_bound:.4f} ms ({t_by}); kernel device time {t_dev} ms")
    return {"name": "layer_norm_fwd", "route": "cuda",
            "source": "apex_tpu_torch/csrc/layer_norm.cu",
            "replaces": "apex_tpu/ops/layer_norm.py:187",
            "max_abs_err": max(errs), **timing}


def bound(nbytes: float, flops: float, peak_flops: float = FP32_FLOPS):
    """(bound_ms, bound_by): the larger of bytes over the HBM rate and
    operations over the peak rate."""
    b_ms = nbytes / HBM_BYTES_PER_S * 1e3
    f_ms = flops / peak_flops * 1e3
    return max(b_ms, f_ms), ("bytes" if b_ms >= f_ms else "operations")


#: a column sum over 8192 rows: summation order moves it by ~1e-6
#: relative; the absolute floor covers columns that nearly cancel
SUM_TOL = (1e-3, 1e-4)


def layer_norm_bwd_checks(dev):
    """The backward kernel at the train step's shape ([8 * 1024, 1024],
    fp32 x as the model normalises an fp32 copy), with fp32 and bf16
    gradients, against its plain version."""
    g = torch.Generator(device=dev).manual_seed(4)
    rows = 8 * 1024
    errs = []
    timing = None
    for x_dt, dy_dt in ((torch.float32, torch.float32),
                        (torch.float32, torch.bfloat16),
                        (torch.bfloat16, torch.bfloat16)):
        x = (torch.randn(rows, HIDDEN, generator=g, device=dev) * 3
             + 1).to(x_dt)
        w = torch.randn(HIDDEN, generator=g, device=dev)
        b = torch.randn(HIDDEN, generator=g, device=dev)
        dy = torch.randn(rows, HIDDEN, generator=g, device=dev).to(dy_dt)
        # the kernel backward takes the kernel forward's statistics, the
        # plain backward the plain forward's
        _, mu, rstd = layer_norm_fwd(x, w, b, eps=1e-5)
        _, rmu, rrstd = layer_norm_reference(x, w, b, 1e-5)
        dx, dw, db = layer_norm_bwd(dy, x, mu, rstd, w)
        rdx, rdw, rdb = layer_norm_bwd_reference(dy, x, rmu, rrstd, w)
        if dx.dtype != dy_dt:
            raise AssertionError(f"layer_norm_bwd dx dtype {dx.dtype}")
        err = max(check_close("layer_norm_bwd mu", mu, rmu, torch.float32),
                  check_close("layer_norm_bwd rstd", rstd, rrstd,
                              torch.float32),
                  check_close(f"layer_norm_bwd dx {x_dt}/{dy_dt}", dx, rdx,
                              dy_dt),
                  check_close("layer_norm_bwd dgamma", dw, rdw, None,
                              SUM_TOL),
                  check_close("layer_norm_bwd dbeta", db, rdb, None,
                              SUM_TOL))
        errs.append(err)
        log(f"  layer_norm_bwd [{rows},{HIDDEN}] x {x_dt} dy {dy_dt}: max "
            f"abs err {err:.3e}")
        if timing is None:
            def run():
                return layer_norm_bwd(dy, x, mu, rstd, w)
            ms = time_ms(run)
            dev_ms = device_ms(run, "ln_bwd_")
            plain_ms = time_ms(
                lambda: layer_norm_bwd_reference(dy, x, mu, rstd, w),
                iters=20)
            xl, wl, bl = (t.clone().requires_grad_(True) for t in (x, w, b))
            yl = F.layer_norm(xl, (HIDDEN,), wl, bl, 1e-5)
            lib_ms = time_ms(lambda: torch.autograd.grad(
                yl, (xl, wl, bl), dy, retain_graph=True), iters=20)
            nbytes = 3 * x.numel() * 4 + 2 * rows * 4 + 3 * HIDDEN * 4
            b_ms, by = bound(nbytes, 12 * x.numel())
            timing = {"ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
                      "device_ms": dev_ms, "bound_ms": b_ms, "bound_by": by}
            log(f"  layer_norm_bwd [{rows},{HIDDEN}] f32: kernel {ms:.4f} "
                f"ms, plain {plain_ms:.4f} ms, F.layer_norm backward "
                f"{lib_ms:.4f} ms, bound {b_ms:.4f} ms ({by}); kernel "
                f"device time {dev_ms} ms")
    return {"name": "layer_norm_bwd", "route": "cuda",
            "source": "apex_tpu_torch/csrc/layer_norm.cu",
            "replaces": "apex_tpu/ops/layer_norm.py:210",
            "max_abs_err": max(errs), **timing}


def _attn_case(g, dev, b, n, s_q, s_k, d, dtype):
    q = torch.randn(b, n, s_q, d, generator=g, device=dev).to(dtype)
    k = torch.randn(b, n, s_k, d, generator=g, device=dev).to(dtype)
    v = torch.randn(b, n, s_k, d, generator=g, device=dev).to(dtype)
    do = torch.randn(b, n, s_q, d, generator=g, device=dev).to(dtype)
    return q, k, v, do


def _attn_flops(b, n, s_q, s_k, d, causal):
    """Products of q.k and p.v for the (q, k) pairs this run computes."""
    if causal:
        pairs = sum(min(i + 1, s_k) for i in range(s_q))
    else:
        pairs = s_q * s_k
    return 4 * b * n * pairs * d


def flash_attention_checks(dev):
    """Forward and backward kernels against their plain versions: the
    345M training shape in bf16 and fp32, a key-padding mask with a
    fully masked batch row, hash dropout 0.1, a length that is not a
    whole number of tiles, and a non-causal cross shape."""
    g = torch.Generator(device=dev).manual_seed(5)
    B, S = 8, 1024
    cases = [
        ("345M bf16 causal", B, N_HEADS, S, S, torch.bfloat16, True, False,
         0.0),
        ("345M f32 causal", B, N_HEADS, S, S, torch.float32, True, False,
         0.0),
        ("kv_mask, dead row, bf16", 2, 4, 256, 256, torch.bfloat16, False,
         True, 0.0),
        ("kv_mask causal f32", 2, 4, 256, 256, torch.float32, True, True,
         0.0),
        ("dropout 0.1 bf16 causal", 2, N_HEADS, S, S, torch.bfloat16, True,
         False, 0.1),
        ("s 1000 f32 causal", 2, 4, 1000, 1000, torch.float32, True, False,
         0.0),
        ("cross 320x1000 bf16", 2, 4, 320, 1000, torch.bfloat16, False,
         False, 0.0),
    ]
    fwd_errs, bwd_errs = [], []
    timing = {}
    for name, b, n, s_q, s_k, dt, causal, masked, p in cases:
        q, k, v, do = _attn_case(g, dev, b, n, s_q, s_k, HEAD_DIM, dt)
        kv_mask = None
        if masked:
            kv_mask = torch.ones(b, s_k, dtype=torch.bool, device=dev)
            kv_mask[0, s_k // 2:] = False
            kv_mask[1, :] = False  # batch row 1: every key masked
        kw = dict(causal=causal, kv_mask=kv_mask, dropout_p=p,
                  dropout_seed=1234 if p else None)
        o, lse = flash_attention_fwd(q, k, v, **kw)
        ro, rlse = flash_attention_fwd_reference(q, k, v, **kw)
        dq, dk, dv = flash_attention_bwd(q, k, v, o, lse, do, **kw)
        rdq, rdk, rdv = flash_attention_bwd_reference(q, k, v, ro, rlse, do,
                                                      **kw)
        if o.dtype != dt or lse.dtype != torch.float32:
            raise AssertionError(f"flash {name}: dtypes {o.dtype} {lse.dtype}")
        fe = max(check_close(f"flash_fwd {name} o", o, ro, dt),
                 check_close(f"flash_fwd {name} lse", lse, rlse,
                             torch.float32))
        be = max(check_close(f"flash_bwd {name} {gname}", got, want, dt)
                 for gname, got, want in (("dq", dq, rdq), ("dk", dk, rdk),
                                          ("dv", dv, rdv)))
        if masked:
            dead = (o[1].abs().max(), dq[1].abs().max(), dk[1].abs().max(),
                    dv[1].abs().max())
            if any(float(x) != 0.0 for x in dead) or \
                    not bool((lse[1] == -1e30).all()):
                raise AssertionError(
                    f"flash {name}: the fully masked row is not zero "
                    f"(o, dq, dk, dv max {[float(x) for x in dead]})")
        fwd_errs.append(fe)
        bwd_errs.append(be)
        log(f"  flash {name} [{b},{n},{s_q}x{s_k},{HEAD_DIM}]: fwd max abs "
            f"err {fe:.3e}, bwd {be:.3e}")
        if name == "345M bf16 causal":
            timing = _flash_timing(q, k, v, do, o, lse, causal)
    return ({"name": "flash_attn_fwd", "route": "cuda",
             "source": "apex_tpu_torch/csrc/flash_attention.cu",
             "replaces": "apex_tpu/ops/flash_attention.py:390",
             "max_abs_err": max(fwd_errs), **timing["fwd"]},
            {"name": "flash_attn_bwd", "route": "cuda",
             "source": "apex_tpu_torch/csrc/flash_attention.cu",
             "replaces": "apex_tpu/ops/flash_attention.py:673",
             "max_abs_err": max(bwd_errs), **timing["bwd"]})


def _flash_timing(q, k, v, do, o, lse, causal):
    b, n, s, d = q.shape
    elem = q.element_size()
    flops = _attn_flops(b, n, s, s, d, causal)
    kw = dict(causal=causal)
    fwd_ms = time_ms(lambda: flash_attention_fwd(q, k, v, **kw), iters=20)
    fwd_dev = device_ms(lambda: flash_attention_fwd(q, k, v, **kw),
                        "flash_fwd_kernel", iters=10)
    fwd_plain = time_ms(
        lambda: flash_attention_fwd_reference(q, k, v, **kw), iters=5)
    fwd_lib = time_ms(lambda: F.scaled_dot_product_attention(
        q, k, v, is_causal=causal), iters=20)
    fb, fby = bound(4 * q.numel() * elem + b * n * s * 4, flops,
                    BF16_TC_FLOPS)

    def bwd():
        return flash_attention_bwd(q, k, v, o, lse, do, **kw)
    bwd_ms = time_ms(bwd, iters=10)
    bwd_dev = device_ms(bwd, "flash_bwd_", iters=5)
    bwd_plain = time_ms(lambda: flash_attention_bwd_reference(
        q, k, v, o, lse, do, **kw), iters=3)
    ql, kl, vl = (t.clone().requires_grad_(True) for t in (q, k, v))

    def sdpa_fwd_bwd():
        out = F.scaled_dot_product_attention(ql, kl, vl, is_causal=causal)
        return torch.autograd.grad(out, (ql, kl, vl), do)
    sdpa_fb = time_ms(sdpa_fwd_bwd, iters=10)
    # backward: 5 products per pair (s, dp, dv, dk, dq) against the
    # forward's 2; reads q, k, v, o, do, lse, writes dq, dk, dv
    bb, bby = bound(8 * q.numel() * elem + b * n * s * 4, flops * 5 / 2,
                    BF16_TC_FLOPS)
    log(f"  flash [8,16,1024,64] bf16 causal: fwd kernel {fwd_ms:.4f} ms "
        f"(device {fwd_dev} ms), plain {fwd_plain:.4f} ms, sdpa fwd "
        f"{fwd_lib:.4f} ms, bound {fb:.4f} ms ({fby}); bwd kernel "
        f"{bwd_ms:.4f} ms (device {bwd_dev} ms), plain {bwd_plain:.4f} ms, "
        f"sdpa fwd+bwd {sdpa_fb:.4f} ms, bound {bb:.4f} ms ({bby})")
    return {"fwd": {"ms": fwd_ms, "device_ms": fwd_dev,
                    "plain_ms": fwd_plain, "library_ms": fwd_lib,
                    "bound_ms": fb, "bound_by": fby},
            "bwd": {"ms": bwd_ms, "device_ms": bwd_dev,
                    "plain_ms": bwd_plain, "library_ms": sdpa_fb,
                    "bound_ms": bb, "bound_by": bby}}


def _rotating(sets):
    """A function returning the next of ``sets`` on every call: timing
    loops cycle through input sets larger than the 50 MB L2 together, so
    each call reads device memory as the train step's fresh activations
    do."""
    it = {"i": -1}

    def nxt():
        it["i"] = (it["i"] + 1) % len(sets)
        return sets[it["i"]]
    return nxt


#: fused-tail forward kernels against their plain versions: each output
#: is one rounding of the same fp32 math (FMA contraction and tanh's ulps
#: aside), so the kernels' general tolerance; the column sums over 8192
#: rows of the backward kernels SUM_TOL
FUSED_CASES = (
    # name, rows, dtype, dropout p, seed
    ("345M bf16", 8192, torch.bfloat16, 0.0, None),
    ("345M f32", 8192, torch.float32, 0.0, None),
    ("345M bf16 dropout 0.1, negative seed", 8192, torch.bfloat16, 0.1,
     -1234567),
    ("1000 rows f32 dropout 0.1", 1000, torch.float32, 0.1, 99),
)


def fused_block_checks(dev):
    """The six fused-tail kernels (#8-#13) against their plain versions
    at the 345M train shapes: bias-GeLU at ``[8192, 4096]`` (the fc1
    output), bias-dropout-residual and residual-add-LayerNorm at
    ``[8192, 1024]``; fp32 and bf16, dropout 0 and 0.1 with a negative
    seed, a row count no block size divides; then each kernel timed at
    the bf16 headline shape (dropout 0)."""
    g = torch.Generator(device=dev).manual_seed(8)
    errs = {k: [] for k in ("bias_gelu_fwd", "bias_gelu_bwd",
                            "bias_dropout_residual_fwd",
                            "bias_dropout_residual_bwd", "residual_ln_fwd",
                            "residual_ln_bwd")}

    def t(rows, n, dt, scale=1.0):
        return (torch.randn(rows, n, generator=g, device=dev)
                * scale).to(dt)

    def vec(n, scale, shift=0.0):
        return torch.randn(n, generator=g, device=dev) * scale + shift

    for name, rows, dt, p, seed in FUSED_CASES:
        # bias-GeLU at the fc1 width
        x, dy = t(rows, 4 * HIDDEN, dt), t(rows, 4 * HIDDEN, dt)
        b = vec(4 * HIDDEN, 0.1)
        y = fb._bias_gelu_fwd_impl(x, b)
        dx, db = fb._bias_gelu_bwd(dy, x, b)
        ry = fb.bias_gelu_reference(x, b)
        rdx, rdb = fb.bias_gelu_bwd_reference(dy, x, b)
        errs["bias_gelu_fwd"].append(check_close(
            f"bias_gelu_fwd {name}", y, ry, dt))
        errs["bias_gelu_bwd"].append(max(
            check_close(f"bias_gelu_bwd {name} dx", dx, rdx, dt),
            check_close(f"bias_gelu_bwd {name} db", db, rdb, None,
                        SUM_TOL)))
        del x, dy, y, dx, ry, rdx
        # the two tails at the hidden width
        x, r, dy, ds = (t(rows, HIDDEN, dt) for _ in range(4))
        b, lb, w = vec(HIDDEN, 0.1), vec(HIDDEN, 0.1), vec(HIDDEN, 0.2, 1.0)
        out = fb._bdr_fwd_impl(x, b, r, seed, p)
        dx, db = fb._bdr_bwd(dy, seed, p, dt)
        rout = fb.bias_dropout_residual_reference(x, b, r, seed, p)
        rdx, rdb = fb.bias_dropout_residual_bwd_reference(dy, seed, p, dt)
        errs["bias_dropout_residual_fwd"].append(check_close(
            f"bias_dropout_residual_fwd {name}", out, rout, dt))
        errs["bias_dropout_residual_bwd"].append(max(
            check_close(f"bias_dropout_residual_bwd {name} dx", dx, rdx, dt),
            check_close(f"bias_dropout_residual_bwd {name} db", db, rdb,
                        None, SUM_TOL)))
        if p and not torch.equal(dx == 0, rdx == 0):
            raise AssertionError(f"{name}: the kernel's dropout mask differs "
                                 f"from dropout_mask_reference")
        s_, y_, mu, rstd = fb._raln_fwd_impl(x, b, r, w, lb, seed, 1e-5, p)
        ref = fb.residual_ln_reference(x, b, r, w, lb, seed, 1e-5, p)
        errs["residual_ln_fwd"].append(max(
            check_close(f"residual_ln_fwd {name} {k}", a, e,
                        torch.float32 if k in ("mu", "rstd") else dt)
            for k, a, e in zip(("sum", "y", "mu", "rstd"),
                               (s_, y_, mu, rstd), ref)))
        got = fb._raln_bwd(ds, dy, s_, mu, rstd, w, seed, p)
        want = fb.residual_ln_bwd_reference(ds, dy, s_, mu, rstd, w, seed, p)
        errs["residual_ln_bwd"].append(max(
            check_close(f"residual_ln_bwd {name} {k}", a, e,
                        dt if k in ("dres", "dx") else None,
                        None if k in ("dres", "dx") else SUM_TOL)
            for k, a, e in zip(("dres", "dx", "dw", "dlb", "db"), got, want)))
        log(f"  fused block {name} [{rows},{HIDDEN}] / [{rows},"
            f"{4 * HIDDEN}]: max abs err " + ", ".join(
                f"{k} {v[-1]:.3e}" for k, v in errs.items()))
        del x, r, dy, ds, out, dx, rout, rdx, s_, y_, ref, got, want
    rows_out = []
    for rec in _fused_timing(dev, g):
        rec["max_abs_err"] = max(errs[rec["name"]])
        rows_out.append(rec)
    return rows_out


def _fused_timing(dev, g, R: int = 8192):
    """Call, device, plain and (for the LayerNorm tail) library times of
    the six kernels at the bf16 headline shapes (``R`` rows), each beside
    its byte bound: every input read once, every output written once."""
    H, F4, bf = HIDDEN, 4 * HIDDEN, torch.bfloat16
    e = 2  # bf16 bytes

    def sets(k, n, count):
        return [tuple((torch.randn(R, n, generator=g, device=dev)).to(bf)
                      for _ in range(k)) for _ in range(count)]
    b4 = torch.randn(F4, generator=g, device=dev).to(bf)
    b1 = torch.randn(H, generator=g, device=dev).to(bf)
    w1 = torch.randn(H, generator=g, device=dev).to(bf)
    lb1 = torch.randn(H, generator=g, device=dev).to(bf)
    ge = _rotating(sets(2, F4, 2))          # (x, dy) at [8192, 4096]
    hs = _rotating(sets(4, H, 4))           # (x, r, dy, dsum) at [8192, 1024]
    st = []
    for x, r, _, _ in [hs() for _ in range(4)]:
        st.append(fb._raln_fwd_impl(x, b1, r, w1, lb1, None, 1e-5, 0.0))
    stn = _rotating(st)

    def raln_bwd_args():
        _, _, dy, ds = hs()
        s_, _, mu, rstd = stn()
        return ds, dy, s_, mu, rstd, w1, None, 0.0

    # a partial yardstick for the LayerNorm tail: F.layer_norm of a sum
    # added beforehand (the add and the dropout are not timed)
    sums = _rotating([x + r for x, r, _, _ in [hs() for _ in range(4)]])
    xl = (hs()[0] + hs()[1]).requires_grad_(True)
    wl, bl = (v.clone().requires_grad_(True) for v in (w1, lb1))
    yl = F.layer_norm(xl, (H,), wl, bl, 1e-5)
    dyl = hs()[2]
    table = [
        ("bias_gelu_fwd", lambda: fb._bias_gelu_fwd_impl(ge()[0], b4),
         lambda: fb.bias_gelu_reference(ge()[0], b4),
         "bias_gelu_fwd_kernel", None, 2 * R * F4 * e + F4 * e,
         20 * R * F4, "ops/fused_block.py:193"),
        ("bias_gelu_bwd", lambda: fb._bias_gelu_bwd(*ge()[::-1], b4),
         lambda: fb.bias_gelu_bwd_reference(*ge()[::-1], b4),
         ("bias_gelu_bwd_kernel", "col_sum_kernel"), None,
         3 * R * F4 * e + F4 * e + F4 * 4, 30 * R * F4,
         "ops/fused_block.py:212"),
        ("bias_dropout_residual_fwd",
         lambda: fb._bdr_fwd_impl(hs()[0], b1, hs()[1], None, 0.0),
         lambda: fb.bias_dropout_residual_reference(hs()[0], b1, hs()[1],
                                                    None, 0.0),
         "bdr_fwd_kernel", None, 3 * R * H * e + H * e, 2 * R * H,
         "ops/fused_block.py:306"),
        ("bias_dropout_residual_bwd",
         lambda: fb._bdr_bwd(hs()[2], None, 0.0, bf),
         lambda: fb.bias_dropout_residual_bwd_reference(hs()[2], None, 0.0,
                                                        bf),
         ("bdr_bwd_kernel", "col_sum_kernel"), None,
         2 * R * H * e + H * 4, R * H, "ops/fused_block.py:335"),
        ("residual_ln_fwd",
         lambda: fb._raln_fwd_impl(hs()[0], b1, hs()[1], w1, lb1, None, 1e-5,
                                   0.0),
         lambda: fb.residual_ln_reference(hs()[0], b1, hs()[1], w1, lb1,
                                          None, 1e-5, 0.0),
         "raln_fwd_kernel",
         lambda: F.layer_norm(sums(), (H,), w1, lb1, 1e-5),
         4 * R * H * e + 3 * H * e + 2 * R * 4, 10 * R * H,
         "ops/fused_block.py:477"),
        ("residual_ln_bwd", lambda: fb._raln_bwd(*raln_bwd_args()),
         lambda: fb.residual_ln_bwd_reference(*raln_bwd_args()),
         ("raln_bwd_kernel", "col_sum_kernel"),
         lambda: torch.autograd.grad(yl, (xl, wl, bl), dyl,
                                     retain_graph=True),
         5 * R * H * e + 2 * R * 4 + H * e + 3 * H * 4, 16 * R * H,
         "ops/fused_block.py:512"),
    ]
    out = []
    for name, run, plain, match, lib, nbytes, flops, replaces in table:
        ms = time_ms(run, iters=50)
        dev_ms = device_ms(run, match, iters=20)
        plain_ms = time_ms(plain, iters=10)
        lib_ms = time_ms(lib, iters=50) if lib is not None else None
        b_ms, by = bound(nbytes, flops)
        log(f"  {name} bf16 {'[8192,4096]' if 'gelu' in name else '[8192,1024]'}"
            f": kernel {ms:.4f} ms (device {dev_ms} ms), plain "
            f"{plain_ms:.4f} ms, library "
            f"{'n/a' if lib_ms is None else f'{lib_ms:.4f} ms'}, bound "
            f"{b_ms:.4f} ms ({by})")
        out.append({"name": name, "route": "cuda",
                    "source": "apex_tpu_torch/csrc/fused_block.cu",
                    "replaces": "apex_tpu/" + replaces, "ms": ms,
                    "device_ms": dev_ms, "plain_ms": plain_ms,
                    "library_ms": lib_ms, "bound_ms": b_ms, "bound_by": by})
    return out


#: the attention scores of the two paths: GPT-2 345M [b 8, 16 heads, 1024,
#: 1024] causal, BERT-large [16, 16, 512, 512] under a padding mask
GPT_SCORES = (8, N_HEADS, 1024, 1024)
BERT_SCORES = (16, N_HEADS, 512, 512)


def fused_softmax_checks(dev):
    """The fused softmax kernels (#14-#16) against their plain versions
    in fp32, bf16 and fp16: causal (scale 1 and 0.125) and unmasked at the
    345M scores, masked at the BERT-large scores with a [b, 1, 1, sk]
    padding mask and a general [b, 1, sq, sk] mask holding a fully masked
    row (uniform 1/sk), sk 1000 and 999 (not a multiple of 128, and not
    of 8: the scalar path), and sk 16384 on a few rows; then each kernel
    timed at the bf16 shapes of the paths."""
    g = torch.Generator(device=dev).manual_seed(9)
    errs = {"softmax_fwd": [], "softmax_masked_fwd": [], "softmax_bwd": []}
    worst = {}  # (kernel, dtype): (largest error over its limit, over
    #             all cases; largest abs error)

    def pad_mask(b, sk):
        """[b, 1, 1, sk], True past a length drawn in [sk / 2, sk]."""
        lens = torch.randint(sk // 2, sk + 1, (b,), generator=g, device=dev)
        return (torch.arange(sk, device=dev) >= lens[:, None])[:, None, None]

    cases = []  # (dtype, name, shape, variant, scale)
    for dt in (torch.float32, torch.bfloat16, torch.float16):
        cases += [(dt, "345M causal", GPT_SCORES, "causal", 1.0),
                  (dt, "345M causal", GPT_SCORES, "causal", 0.125),
                  (dt, "345M unmasked", GPT_SCORES, "plain", 0.125),
                  (dt, "BERT padding mask", BERT_SCORES, "padding", 1.0),
                  (dt, "general mask, dead row", (4, N_HEADS, 512, 512),
                   "general", 0.125),
                  (dt, "sk 1000 causal", (2, 4, 1000, 1000), "causal", 1.0),
                  (dt, "sk 999 masked", (2, 4, 64, 999), "general", 1.0),
                  (dt, "sk 16384 masked", (1, 2, 3, 16384), "padding", 1.0),
                  (dt, "sk 16384 unmasked", (1, 1, 4, 16384), "plain",
                   0.5)]
    for dt, name, shape, variant, scale in cases:
        b, n, sq, sk = shape
        x = (torch.randn(shape, generator=g, device=dev) * 3).to(dt)
        dy = torch.randn(shape, generator=g, device=dev).to(dt)
        mask = None
        if variant == "padding":
            mask = pad_mask(b, sk)
        elif variant == "general":
            mask = torch.rand(b, 1, sq, sk, generator=g, device=dev) > 0.7
            mask[-1, 0, sq // 2] = True  # one row fully masked
        if mask is None:
            key = "softmax_fwd"
            y = fs.softmax_fwd(x, scale, variant == "causal")
            want = fs.softmax_fwd_reference(x, scale, variant == "causal")
        else:
            key = "softmax_masked_fwd"
            y = fs.softmax_masked_fwd(x, mask, scale)
            want = fs.softmax_masked_fwd_reference(x, mask, scale)
        if y.dtype != dt:
            raise AssertionError(f"softmax {name}: output dtype {y.dtype}")
        tol = SOFTMAX_TOL[dt]
        fe, fr = check_close(f"{key} {name} {dt} scale {scale}", y, want,
                             dt, tol, margin=True)
        del want
        dx = fs.softmax_bwd(dy, y, scale)
        be, br = check_close(f"softmax_bwd {name} {dt}", dx,
                             fs.softmax_bwd_reference(dy, y, scale), dt, tol,
                             margin=True)
        if variant == "general":
            dead = y[-1, :, sq // 2].float()
            if (dead - 1.0 / sk).abs().max() > tol[0] + tol[1] / sk:
                raise AssertionError(
                    f"softmax {name}: the fully masked row is not 1/sk")
        if variant == "causal" and bool((y.float().triu(1) != 0).any()):
            raise AssertionError(f"softmax {name}: a causal-masked "
                                 f"probability is not 0")
        errs[key].append(fe)
        errs["softmax_bwd"].append(be)
        for k, e, r in ((key, fe, fr), ("softmax_bwd", be, br)):
            r0, e0 = worst.get((k, dt), (0.0, 0.0))
            worst[k, dt] = (max(r0, r), max(e0, e))
        log(f"  {key} {name} {list(shape)} {dt} scale {scale}: max abs err "
            f"fwd {fe:.3e} ({fr:.2f} of its limit), bwd {be:.3e} "
            f"({br:.2f})")
        del x, dy, y, dx, mask
    for (k, dt), (r, e) in worst.items():
        log(f"  {k} {dt} atol {SOFTMAX_TOL[dt][0]} rtol {SOFTMAX_TOL[dt][1]}: "
            f"largest error {r:.2f} of its limit, max abs err {e:.3e}")
    out = []
    for rec in _softmax_timing(dev, g, pad_mask):
        rec["max_abs_err"] = max(errs[rec["name"]])
        out.append(rec)
    return out


def _softmax_timing(dev, g, pad_mask):
    """Call, device, plain and library times of the three kernels at the
    bf16 scores of the paths, each beside its byte bound: the causal
    forward reads only the scores on and below the diagonal (the others
    do not depend on x) and writes every probability; the masked forward
    reads x and the [b, 1, 1, sk] mask and writes y; the backward reads dy
    and y and writes dx. The library yardsticks are ``F.softmax`` over the
    same bf16 rows (partial: no scale, no mask) for the forwards and
    ``torch._softmax_backward_data`` (scale 1) for the backward."""
    bf = torch.bfloat16
    e = 2
    xg, dyg = (torch.randn(GPT_SCORES, generator=g, device=dev).to(bf)
               for _ in range(2))
    xb, dyb = (torch.randn(BERT_SCORES, generator=g, device=dev).to(bf)
               for _ in range(2))
    mb = pad_mask(BERT_SCORES[0], BERT_SCORES[-1])
    yg = fs.softmax_fwd(xg, 0.125, True)
    yb = fs.softmax_masked_fwd(xb, mb, 0.125)
    b, n, s, _ = GPT_SCORES
    tri = b * n * s * (s + 1) // 2  # scores on and below the diagonal
    table = [
        ("softmax_fwd", "345M causal [8,16,1024,1024]",
         lambda: fs.softmax_fwd(xg, 0.125, True),
         lambda: fs.softmax_fwd_reference(xg, 0.125, True),
         "softmax_fwd_kernel", lambda: F.softmax(xg, dim=-1),
         tri * e + xg.numel() * e, 5 * xg.numel(),
         "transformer/functional/fused_softmax.py:90"),
        ("softmax_masked_fwd", "BERT padding [16,16,512,512]",
         lambda: fs.softmax_masked_fwd(xb, mb, 0.125),
         lambda: fs.softmax_masked_fwd_reference(xb, mb, 0.125),
         "softmax_masked_fwd_kernel", lambda: F.softmax(xb, dim=-1),
         2 * xb.numel() * e + mb.numel(), 5 * xb.numel(),
         "transformer/functional/fused_softmax.py:105"),
        ("softmax_bwd", "345M [8,16,1024,1024]",
         lambda: fs.softmax_bwd(dyg, yg, 0.125),
         lambda: fs.softmax_bwd_reference(dyg, yg, 0.125),
         "softmax_bwd_kernel",
         lambda: torch._softmax_backward_data(dyg, yg, -1, bf),
         3 * yg.numel() * e, 4 * yg.numel(),
         "transformer/functional/fused_softmax.py:121"),
        ("softmax_bwd", "BERT [16,16,512,512]",
         lambda: fs.softmax_bwd(dyb, yb, 0.125),
         lambda: fs.softmax_bwd_reference(dyb, yb, 0.125),
         "softmax_bwd_kernel",
         lambda: torch._softmax_backward_data(dyb, yb, -1, bf),
         3 * yb.numel() * e, 4 * yb.numel(),
         "transformer/functional/fused_softmax.py:121"),
    ]
    out = {}
    for name, where, run, plain, match, lib, nbytes, flops, replaces in table:
        ms = time_ms(run, iters=50)
        dev_ms = device_ms(run, match, iters=20)
        plain_ms = time_ms(plain, iters=5)
        lib_ms = time_ms(lib, iters=50)
        b_ms, by = bound(nbytes, flops)
        log(f"  {name} bf16 {where}: kernel {ms:.4f} ms (device {dev_ms} "
            f"ms), plain {plain_ms:.4f} ms, library {lib_ms:.4f} ms, bound "
            f"{b_ms:.4f} ms ({by})")
        if name in out:  # the backward's second shape is logged only
            continue
        out[name] = {"name": name, "route": "cuda",
                     "source": "apex_tpu_torch/csrc/fused_softmax.cu",
                     "replaces": "apex_tpu/" + replaces, "ms": ms,
                     "device_ms": dev_ms, "plain_ms": plain_ms,
                     "library_ms": lib_ms, "bound_ms": b_ms, "bound_by": by}
    return list(out.values())


def gpt345m_param_shapes(dtype=torch.bfloat16):
    """The 345M parameter tree as meta tensors (shapes and dtypes, no
    memory): the layout the packed optimizer sweeps."""
    cfg = gpt345m(dtype, max_pos=1024)
    h, L, v, f = cfg.hidden_size, cfg.num_layers, cfg.vocab_size, \
        cfg.ffn_size

    def m(*shape):
        return torch.empty(shape, dtype=dtype, device="meta")
    return {"embedding": {"word": m(v, h), "position": m(1024, h)},
            "layers": {"input_ln_w": m(L, h), "input_ln_b": m(L, h),
                       "qkv_w": m(L, 3 * h, h), "qkv_b": m(L, 3 * h),
                       "proj_w": m(L, h, h), "proj_b": m(L, h),
                       "post_ln_w": m(L, h), "post_ln_b": m(L, h),
                       "fc1_w": m(L, f, h), "fc1_b": m(L, f),
                       "fc2_w": m(L, h, f), "fc2_b": m(L, h)},
            "final_ln_w": m(h), "final_ln_b": m(h)}


#: packed Adam against its plain version: both round every operation
#: once in the same order, so fp32 state agrees to within an fp32 ulp
#: and the bf16 output to within one bf16 rounding
ADAM_TOL = {torch.float32: (1e-9, 1e-6), torch.bfloat16: (1e-9, 8e-3)}


def packed_adam_checks(dev):
    """The packed Adam sweep over a flat buffer of the 345M PackSpec's
    size: Adam, AdamW with weight decay, noop (outputs equal inputs
    bitwise) and write_mv=False (m and v untouched)."""
    spec = PackSpec(gpt345m_param_shapes())
    n = spec.total
    g = torch.Generator(device=dev).manual_seed(6)
    grad = (torch.randn(n, generator=g, device=dev) * 1e-3).to(
        torch.bfloat16)
    m0 = torch.randn(n, generator=g, device=dev) * 1e-3
    v0 = torch.rand(n, generator=g, device=dev) * 1e-6
    src0 = torch.randn(n, generator=g, device=dev) * 0.02
    hyper = dict(param_dtype=torch.bfloat16,
                 lr=torch.tensor(1e-4, device=dev),
                 bc1=torch.tensor(0.1, device=dev),
                 bc2=torch.tensor(0.001, device=dev),
                 inv_scale=torch.tensor(0.5, device=dev))
    errs = []
    for name, kw in (("adam", {}),
                     ("adamw wd 0.1", dict(wd=0.1)),
                     ("adam l2 wd 0.1", dict(wd=0.1, adam_w_mode=False)),
                     ("noop", dict(noop=torch.tensor(True, device=dev))),
                     ("write_mv=False", dict(write_mv=False,
                                             write_master=False))):
        m, v, src = m0.clone(), v0.clone(), src0.clone()
        ref = packed_adam_reference(grad, m0, v0, src0, **hyper, **{
            k: x for k, x in kw.items() if k not in ("write_mv",
                                                     "write_master")})
        p_out, nm, nv, master = packed_adam_apply(grad, m, v, src, **hyper,
                                                  **kw)
        err = check_close(f"packed_adam {name} p_out", p_out, ref[0],
                          None, ADAM_TOL[torch.bfloat16])
        if name == "noop":
            if not (torch.equal(m, m0) and torch.equal(v, v0)
                    and torch.equal(src, src0)
                    and torch.equal(p_out, src0.to(torch.bfloat16))):
                raise AssertionError("packed_adam noop changed its inputs")
        elif name == "write_mv=False":
            if nm is not None or not (torch.equal(m, m0)
                                      and torch.equal(v, v0)
                                      and torch.equal(src, src0)):
                raise AssertionError("packed_adam write_mv=False wrote m/v")
        else:
            err = max(err, *(check_close(f"packed_adam {name} {sn}", got,
                                         want, None,
                                         ADAM_TOL[torch.float32])
                             for sn, got, want in (("m", m, ref[1]),
                                                   ("v", v, ref[2]),
                                                   ("master", src,
                                                    ref[3]))))
        errs.append(err)
        log(f"  packed_adam {name} over {n} elements: max abs err "
            f"{err:.3e}")
        del ref
    m, v, src = m0.clone(), v0.clone(), src0.clone()

    def run():
        return packed_adam_apply(grad, m, v, src, **hyper)
    ms = time_ms(run, iters=20)
    dev_ms = device_ms(run, "packed_adam_kernel", iters=10)
    plain_ms = time_ms(lambda: packed_adam_reference(grad, m0, v0, src0,
                                                     **hyper), iters=3)
    del m, v, src
    p = torch.nn.Parameter(src0.clone())
    p.grad = grad.float()
    lib_opt = torch.optim.AdamW([p], lr=1e-4, weight_decay=0.0, fused=True)
    lib_ms = time_ms(lib_opt.step, iters=20)
    del p, lib_opt
    # bf16 grad read + bf16 param write + m, v, master read and written
    b_ms, by = bound(n * (2 + 2 + 3 * 8), 16 * n)
    log(f"  packed_adam 345M flat buffer ({n} elements, bf16 grads and "
        f"params): kernel {ms:.4f} ms (device {dev_ms} ms), plain "
        f"{plain_ms:.4f} ms, AdamW(fused=True) {lib_ms:.4f} ms, bound "
        f"{b_ms:.4f} ms ({by})")
    return {"name": "packed_adam", "route": "cuda",
            "source": "apex_tpu_torch/csrc/packed_adam.cu",
            "replaces": "apex_tpu/ops/packed_optimizer.py:152",
            "max_abs_err": max(errs), "ms": ms, "device_ms": dev_ms,
            "plain_ms": plain_ms, "library_ms": lib_ms, "bound_ms": b_ms,
            "bound_by": by}


# ---------------------------------------------------------------------------
# phase 3: full-width serving
# ---------------------------------------------------------------------------

def gpt345m(dtype, max_pos=256):
    return GPTConfig(num_layers=24, hidden_size=HIDDEN,
                     num_attention_heads=N_HEADS, vocab_size=50304,
                     max_position_embeddings=max_pos, compute_dtype=dtype)


SERVING_KERNELS = ("flash_decode", "layer_norm_fwd")
TRAIN_KERNELS = ("layer_norm_fwd", "layer_norm_bwd", "flash_attn_fwd",
                 "flash_attn_bwd", "packed_adam")
FUSED_KERNELS = ("bias_gelu_fwd", "bias_gelu_bwd",
                 "bias_dropout_residual_fwd", "bias_dropout_residual_bwd",
                 "residual_ln_fwd", "residual_ln_bwd")


def serve_345m(dev):
    cfg = gpt345m(torch.bfloat16)
    params = init_gpt_params(
        cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
    eng = ServingEngine(cfg, params, n_slots=SLOTS, prefill_chunk=8,
                        device=dev)
    assert eng.spec.page_size == PAGE and eng.spec.num_pages == POOL_PAGES
    rng = np.random.default_rng(0)
    # warm-up (cuBLAS handles, allocator) outside the measured run
    eng.generate([Request(prompt=[int(t) for t in
                                  rng.integers(0, cfg.vocab_size, 16)],
                          max_new_tokens=4)])
    reqs = [Request(prompt=[int(t) for t in
                            rng.integers(0, cfg.vocab_size, size=128)],
                    max_new_tokens=64, arrival_step=i * 4)
            for i in range(16)]
    torch.cuda.synchronize()
    _device.reset_launch_counts()
    out = eng.generate(reqs)
    torch.cuda.synchronize()
    launches = _device.launch_counts()
    st = eng.last_stats
    for r in reqs:
        toks = out[r.rid]
        if len(toks) != 64 or not all(0 <= t < cfg.vocab_size
                                      for t in toks):
            raise AssertionError(f"request {r.rid}: bad output {toks[:8]}")
    if st["completed"] != len(reqs):
        raise AssertionError(f"only {st['completed']} of 16 completed")
    steps = st["steps"]
    log(f"  345M bf16 serving: {st['generated_tokens']} tokens in "
        f"{st['wall_s']:.3f} s = {st['tokens_per_sec']:.1f} tokens/s; "
        f"{steps} steps, step p50 {st['step_ms']['p50']:.3f} ms p99 "
        f"{st['step_ms']['p99']:.3f} ms; TTFT p50 "
        f"{st['ttft_ms']['p50']:.1f} ms p99 {st['ttft_ms']['p99']:.1f} ms; "
        f"occupancy {st['occupancy']:.4f}; preemptions "
        f"{st['preemptions']}; prefix hits "
        f"{st['prefix_cache']['hits']}")
    log(f"  launches on the serving run: {launches} (per step: "
        f"flash_decode {launches['flash_decode'] / steps:.2f}, "
        f"layer_norm_fwd {launches['layer_norm_fwd'] / steps:.2f})")
    for name in SERVING_KERNELS:
        if launches[name] <= 0:
            raise AssertionError(f"kernel {name} never launched on the path")
    trained = {k: c for k, c in launches.items()
               if k not in SERVING_KERNELS and c}
    if trained:
        # serving runs under no_grad: the forward kernels alone
        raise AssertionError(f"training kernels launched while serving: "
                             f"{trained}")
    log("  serving_json " + json.dumps(
        {k: st[k] for k in ("tokens_per_sec", "step_ms", "ttft_ms",
                            "latency_ms", "occupancy", "steps",
                            "generated_tokens", "wall_s", "step_time_s",
                            "prefill_tokens", "decode_tokens",
                            "preemptions")}))
    profile_steps(eng, rng, cfg)
    return launches


def profiled(run, label: str, top: int) -> None:
    """Print where ``run``'s time goes: device time by kernel from a
    ``torch.profiler`` trace against the run's wall time; the remainder
    is device idle."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = sorted(((e.device_time_total / 1e3, e.count, e.key)
                   for e in prof.key_averages()
                   if e.device_time_total > 0
                   and e.device_type.name == "CUDA"), reverse=True)
    busy = sum(r[0] for r in rows)
    log(f"  profiled {label}: wall {wall_ms:.1f} ms, device busy "
        f"{busy:.1f} ms (idle share {1 - busy / wall_ms:.3f}, profiler on)")
    for dev_ms, count, key in rows[:top]:
        log(f"    {dev_ms:9.3f} ms  x{count:6d}  {key[:90]}")


def profile_steps(eng, rng, cfg) -> None:
    """Where a serving step's time goes, over a short trace (8 requests,
    128 prompt + 16 new tokens)."""
    reqs = [Request(prompt=[int(t) for t in
                            rng.integers(0, cfg.vocab_size, size=128)],
                    max_new_tokens=16) for _ in range(SLOTS)]
    profiled(lambda: eng.generate(reqs), "serving trace", 10)
    log(f"  (the profiled trace ran {eng.last_stats['steps']} steps)")


# ---------------------------------------------------------------------------
# phase 4: token identity against the dense reference
# ---------------------------------------------------------------------------

def token_identity(dev):
    cfg = gpt345m(torch.float32, max_pos=64)
    params = init_gpt_params(
        cfg, torch.Generator(device=dev).manual_seed(1), device=dev)
    params["embedding"]["position"] = params["embedding"]["position"] * 40.0
    rng = np.random.default_rng(1)
    reqs = [Request(prompt=[int(t) for t in
                            rng.integers(0, cfg.vocab_size, size=L)],
                    max_new_tokens=16, arrival_step=i)
            for i, L in enumerate((24, 31))]
    eng = ServingEngine(cfg, params, n_slots=2, prefill_chunk=8,
                        device=dev)
    out = eng.generate(reqs)
    near_ties = 0
    for r in reqs:
        ref = reference_decode(cfg, params, r.prompt, r.max_new_tokens)
        got = out[r.rid]
        if got == ref:
            log(f"  request {r.rid}: 16 tokens identical to reference")
            continue
        j = next(i for i, (a, b) in enumerate(zip(got, ref)) if a != b)
        with torch.no_grad():
            logits = gpt_forward(cfg, params, torch.tensor(
                [list(r.prompt) + ref[:j]], device=dev))[0, -1]
        top2 = torch.topk(logits, 2).values
        gap = float(top2[0] - top2[1])
        if gap < 1e-4 * abs(float(top2[0])):
            near_ties += 1
            log(f"  request {r.rid}: near-tie at token {j} (top-2 gap "
                f"{gap:.3e}); engine {got[j]} vs reference {ref[j]}")
            continue
        raise AssertionError(
            f"request {r.rid}: diverges at token {j} (gap {gap:.3e}): "
            f"engine {got} != reference {ref}")
    return near_ties


# ---------------------------------------------------------------------------
# phase 5: the GPT-2 345M train step
# ---------------------------------------------------------------------------

def train_step_fn(loss_fn, opt):
    """One step as ``bench.py`` runs it: loss and gradients of
    ``loss_fn(params)``, then the optimizer's step."""
    def step(params, state):
        loss, grads = value_and_grad(loss_fn, params)
        params, state = opt.step(grads, state, params)
        return params, state, loss
    return step


#: launches per step of each leg, asserted exactly: the headline fused
#: step (25 LayerNorms: 24 input norms and the final one; the post-attention
#: norm is inside the residual_ln tail), the unfused step, and the step
#: without flash under "selective" recompute (the policy keeps the
#: LayerNorm outputs but not the softmax's probabilities, so the backward
#: replays each layer's softmax forward once: 24 + 24)
HEADLINE_LAUNCHES = {
    "layer_norm_fwd": 25, "layer_norm_bwd": 25, "flash_attn_fwd": 24,
    "flash_attn_bwd": 24, "bias_gelu_fwd": 24, "bias_gelu_bwd": 24,
    "bias_dropout_residual_fwd": 24, "bias_dropout_residual_bwd": 24,
    "residual_ln_fwd": 24, "residual_ln_bwd": 24, "packed_adam": 1,
}
UNFUSED_LAUNCHES = {
    "layer_norm_fwd": 49, "layer_norm_bwd": 49, "flash_attn_fwd": 24,
    "flash_attn_bwd": 24, "packed_adam": 1,
}
NONFLASH_LAUNCHES = {
    "layer_norm_fwd": 49, "layer_norm_bwd": 49, "softmax_fwd": 48,
    "softmax_bwd": 24, "packed_adam": 1,
}


def drive_leg(label: str, expected: dict, timed: int, step, params, state,
              tokens: int):
    """2 warm-up steps, then ``timed`` timed steps of ``step`` with the
    launch counts zeroed before and read after: launches per step
    asserted exactly, every loss finite and the last below the first,
    peak memory, and one profiled step."""
    losses = []
    for _ in range(2):
        params, state, loss = step(params, state)
        losses.append(loss)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _device.reset_launch_counts()
    times = []
    for _ in range(timed):
        t0 = time.perf_counter()
        params, state, loss = step(params, state)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        losses.append(loss)
    launches = _device.launch_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    losses = [float(x) for x in losses]
    per_step = {k: c / timed for k, c in launches.items() if c}
    p50 = float(np.percentile(times, 50))
    p99 = float(np.percentile(times, 99))
    log(f"  {label}: step p50 {p50:.2f} ms p99 {p99:.2f} ms, "
        f"{tokens / (p50 / 1e3):.0f} tokens/s at p50; loss first "
        f"{losses[0]:.4f} last {losses[-1]:.4f}; peak memory "
        f"{peak_gb:.2f} GiB")
    log(f"  launches per step: {per_step}")
    log("  train_json " + json.dumps(
        {"leg": label, "step_ms": times, "losses": losses,
         "peak_gib": peak_gb, "launches_per_step": per_step}))
    if per_step != {k: float(v) for k, v in expected.items()}:
        raise AssertionError(f"{label}: launches per step {per_step}, "
                             f"expected {expected}")
    if not all(np.isfinite(losses)):
        raise AssertionError(f"non-finite loss: {losses}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"loss did not fall: {losses}")
    profiled(lambda: step(params, state), f"{label} step", 14)
    return {"launches": launches, "p50": p50, "p99": p99, "peak": peak_gb}


def train_leg(dev, label: str, expected: dict, timed: int, **cfg_kw):
    """GPT-2 345M at full width and depth, seq 1024, batch 8, bf16
    compute over bf16 params with fp32 masters (O2), packed
    FusedAdam(lr=1e-4), random weights (seed 0) and tokens (seed 1), the
    same batch every step (:func:`drive_leg`)."""
    cfg = GPTConfig(num_layers=24, hidden_size=HIDDEN,
                    num_attention_heads=N_HEADS, vocab_size=50304,
                    max_position_embeddings=1024, hidden_dropout=0.0,
                    attention_dropout=0.0, compute_dtype=torch.bfloat16,
                    **cfg_kw)
    params = init_gpt_params(
        cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
    params = tree_map(lambda p: p.to(torch.bfloat16), params)
    opt = FusedAdam(lr=1e-4, master_weights=True, packed=True)
    tokens = torch.randint(0, cfg.vocab_size, (8, 1024), device=dev,
                           generator=torch.Generator(
                               device=dev).manual_seed(1))
    labels = torch.roll(tokens, -1, dims=1)
    step = train_step_fn(lambda p: gpt_loss(cfg, p, tokens, labels), opt)
    return drive_leg(label, expected, timed, step, params, opt.init(params),
                     tokens.numel())


def train_345m(dev):
    """The headline step (``bench.py``'s default: ``fused_block=True``,
    ``selective_elementwise`` recompute, chunked CE recomputing the chunk
    GEMM), then the unfused step without recompute (saved bf16 CE
    logits) as the second leg, the fused step without recompute as a
    third, which separates the recompute's cost from the fused tails',
    and the step without flash attention as a fourth (``bench.py``'s
    xla-attention leg: ``bench_gpt(..., "selective")`` with flash off,
    the unfused block, the CE recomputing its chunk GEMM), all in this
    one call."""
    legs = {}
    for key, label, expected, timed, kw in (
            ("headline", "345M headline (fused block, "
             "selective_elementwise)", HEADLINE_LAUNCHES, 6,
             dict(fused_block=True,
                  recompute_granularity="selective_elementwise")),
            ("unfused", "345M unfused, no remat", UNFUSED_LAUNCHES, 6,
             dict(ce_save_logits=True)),
            ("fused", "345M fused block, no remat", HEADLINE_LAUNCHES, 6,
             dict(fused_block=True)),
            ("nonflash", "345M non-flash (bench's xla-attention leg)",
             NONFLASH_LAUNCHES, 6,
             dict(use_flash_attention=False,
                  recompute_granularity="selective", fused_block=False,
                  ce_save_logits=False))):
        legs[key] = train_leg(dev, label, expected, timed, **kw)
        torch.cuda.empty_cache()
    log("  legs: " + "; ".join(
        f"{k} p50 {v['p50']:.2f} ms p99 {v['p99']:.2f} ms peak "
        f"{v['peak']:.2f} GiB" for k, v in legs.items()))
    return {k: sum(v["launches"][k] for v in legs.values())
            for k in legs["headline"]["launches"]}


# ---------------------------------------------------------------------------
# phase 6: BERT-large with FusedLAMB
# ---------------------------------------------------------------------------

BERT_VOCAB = 30592
BERT_NONFLASH_LAUNCHES = {
    "layer_norm_fwd": 49, "layer_norm_bwd": 49, "softmax_masked_fwd": 48,
    "softmax_bwd": 24,
}
BERT_FLASH_LAUNCHES = {
    "layer_norm_fwd": 49, "layer_norm_bwd": 49, "flash_attn_fwd": 24,
    "flash_attn_bwd": 24,
}


def bert_mlm_loss(cfg, params, tokens, labels, padding):
    """``bench_bert_lamb``'s loss: the mean over every position of the
    cross entropy of the fp32 MLM logits, 0 where the label is -1."""
    logits, _ = bert_forward(cfg, params, tokens, padding)
    return softmax_cross_entropy_loss(
        logits.reshape(-1, cfg.vocab_size).float(), labels.reshape(-1),
        padding_idx=-1).mean()


def bert_batch(gens, b: int, s: int, vocab: int, dev):
    """Tokens, labels and a [b, s] padding mask (1 = real token) with
    lengths uniform in [s / 2, s]; the labels of pad positions are -1.
    ``gens`` are the generators of tokens, labels and lengths."""
    tokens = torch.randint(0, vocab, (b, s), generator=gens[0], device=dev)
    labels = torch.randint(0, vocab, (b, s), generator=gens[1], device=dev)
    lens = torch.randint(s // 2, s + 1, (b,), generator=gens[2], device=dev)
    padding = (torch.arange(s, device=dev)[None] < lens[:, None]).to(
        torch.int32)
    return tokens, torch.where(padding == 0, -1, labels), padding


def bert_large_leg(dev, label: str, expected: dict, timed: int, **cfg_kw):
    """BERT-large as ``bench_bert_lamb`` runs it: 24 layers, hidden 1024,
    16 heads, vocab 30592, seq 512, batch 16, bf16 compute over fp32
    params, dropout 0, ``selective`` recompute, pytree FusedLAMB(lr=1e-3),
    random weights (seed 0), tokens (seed 1) and labels (seed 2); unlike
    the bench, a padding mask with lengths from seed 3 (the labels of its
    pad positions -1). The same batch every step (:func:`drive_leg`)."""
    cfg_kw.setdefault("recompute_granularity", "selective")
    cfg = GPTConfig(num_layers=24, hidden_size=HIDDEN,
                    num_attention_heads=N_HEADS, vocab_size=BERT_VOCAB,
                    max_position_embeddings=512, hidden_dropout=0.0,
                    attention_dropout=0.0, compute_dtype=torch.bfloat16,
                    **cfg_kw)
    params = init_gpt_params(
        cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
    opt = FusedLAMB(lr=1e-3)
    tokens, labels, padding = bert_batch(
        [torch.Generator(device=dev).manual_seed(i) for i in (1, 2, 3)],
        16, 512, cfg.vocab_size, dev)
    log(f"  real tokens: {int(padding.sum())} of {padding.numel()}")
    step = train_step_fn(
        lambda p: bert_mlm_loss(cfg, p, tokens, labels, padding), opt)
    return drive_leg(label, expected, timed, step, params, opt.init(params),
                     tokens.numel())


def train_bert_large(dev):
    legs = {}
    for key, label, expected, kw in (
            ("nonflash", "BERT-large non-flash (masked fused softmax)",
             BERT_NONFLASH_LAUNCHES, dict(use_flash_attention=False)),
            ("flash", "BERT-large flash", BERT_FLASH_LAUNCHES, {})):
        legs[key] = bert_large_leg(dev, label, expected, 5, **kw)
        torch.cuda.empty_cache()
    log("  legs: " + "; ".join(
        f"{k} p50 {v['p50']:.2f} ms p99 {v['p99']:.2f} ms peak "
        f"{v['peak']:.2f} GiB" for k, v in legs.items()))
    counts = {}
    for v in legs.values():
        for k, c in v["launches"].items():
            counts[k] = counts.get(k, 0) + c
    return counts


def attention_paths(dev):
    """Not run by :func:`main`: the two attention paths under selective
    recompute and without recompute, in one call, to separate the
    attention kernels' device time from the recompute's host time:

        python3 -c "import chip_smoke as c, torch;
            c.attention_paths(torch.device('cuda'))"
    """
    torch.backends.cuda.matmul.allow_tf32 = False
    log(card_line())
    _build.kernels()
    no_remat = {"layer_norm_fwd": 49, "layer_norm_bwd": 49,
                "softmax_fwd": 24, "softmax_bwd": 24, "packed_adam": 1}
    for label, expected, kw in (
            ("345M non-flash, selective", NONFLASH_LAUNCHES,
             dict(use_flash_attention=False,
                  recompute_granularity="selective")),
            ("345M non-flash, no remat", no_remat,
             dict(use_flash_attention=False)),
            ("345M flash, selective", UNFUSED_LAUNCHES,
             dict(recompute_granularity="selective")),
            ("345M flash, no remat", UNFUSED_LAUNCHES, {})):
        train_leg(dev, label, expected, 6, **kw)
        torch.cuda.empty_cache()
    masked = {"layer_norm_fwd": 49, "layer_norm_bwd": 49,
              "softmax_masked_fwd": 24, "softmax_bwd": 24}
    for label, expected, kw in (
            ("BERT-large non-flash, no remat", masked,
             dict(use_flash_attention=False, recompute_granularity=None)),
            ("BERT-large flash, no remat", BERT_FLASH_LAUNCHES,
             dict(recompute_granularity=None))):
        bert_large_leg(dev, label, expected, 5, **kw)
        torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phase 7: training parity, card against CPU
# ---------------------------------------------------------------------------

#: card (kernels) against CPU (plain versions), TF32 off, as (loss rtol
#: at the start and along 3 optimizer steps, each gradient leaf's max
#: error over its largest entry, the parameter updates' error norm over
#: their norm). fp32: summation order only. Adam moves an element whose
#: gradient sits at the rounding level by up to lr either way, so the
#: updates get a norm bound, not an elementwise one. bf16: the GEMMs
#: round at other places in cuBLAS and on the CPU (one bf16 rounding,
#: 2^-8, per activation), so the loss within 2e-3 and each leaf within
#: 5e-2 of its largest entry; Adam's and LAMB's first steps move each
#: element by about lr times the sign of its gradient, and the gradients
#: near zero that change sign under those roundings move by 2 lr. On an
#: H100 80GB HBM3 at 700 W the updates read 2.20e-2 of their norm (GPT, Adam)
#: and 1.87e-2 (BERT, LAMB); a wrong update reads about 1, so the limit
#: is 0.1, some 5 times the readings.
PARITY_TOL = {torch.float32: (1e-5, 1e-4, 1e-3),
              torch.bfloat16: (2e-3, 5e-2, 0.1)}

#: the 2-layer full-width models of the parity runs: seq 256, batch 2
PARITY_SEQ, PARITY_BATCH = 256, 2


def _flat(params) -> torch.Tensor:
    return torch.cat([p.detach().float().reshape(-1)
                      for p in tree_leaves(params)])


def parity_cfg(vocab: int, **cfg_kw) -> GPTConfig:
    return GPTConfig(num_layers=2, hidden_size=HIDDEN,
                     num_attention_heads=N_HEADS, vocab_size=vocab,
                     max_position_embeddings=PARITY_SEQ, hidden_dropout=0.0,
                     attention_dropout=0.0, **cfg_kw)


def gpt_parity(dev, label: str, kernels, **cfg_kw):
    """``gpt_loss`` of the 2-layer 345M-width GPT with packed
    FusedAdam(lr=1e-4, masters), card against CPU."""
    cfg = parity_cfg(50304, **cfg_kw)
    rng = np.random.default_rng(7)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                           (PARITY_BATCH, PARITY_SEQ)))
    labels = torch.roll(tokens, -1, dims=1)
    train_parity(dev, label, kernels, cfg,
                 lambda p, d: gpt_loss(cfg, p, tokens.to(d), labels.to(d)),
                 lambda: FusedAdam(lr=1e-4, master_weights=True, packed=True))


def bert_parity(dev, label: str, kernels, **cfg_kw):
    """``bench_bert_lamb``'s loss of the 2-layer BERT-large-width model
    under a padding mask (lengths 256 and 180) with pytree
    FusedLAMB(lr=1e-3), card against CPU."""
    cfg = parity_cfg(BERT_VOCAB, **cfg_kw)
    rng = np.random.default_rng(7)
    tokens, labels = (torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (PARITY_BATCH, PARITY_SEQ))) for _ in range(2))
    padding = torch.ones(PARITY_BATCH, PARITY_SEQ, dtype=torch.int32)
    padding[1, 180:] = 0
    labels = torch.where(padding == 0, -1, labels)
    train_parity(dev, label, kernels, cfg,
                 lambda p, d: bert_mlm_loss(cfg, p, tokens.to(d),
                                            labels.to(d), padding.to(d)),
                 lambda: FusedLAMB(lr=1e-3))


def train_parity(dev, label: str, kernels, cfg, loss_of, make_opt):
    """Loss, gradients and 3 optimizer steps of ``loss_of(params,
    device)`` on the card (kernels) against the CPU (plain versions), from
    the same fp32 params of ``cfg``; ``make_opt()`` builds each run's
    optimizer. ``kernels`` must each launch on the card run and nothing
    on the CPU run."""
    dt = cfg.compute_dtype
    loss_tol, grad_tol, upd_tol = PARITY_TOL[dt]
    cpu_params = init_gpt_params(cfg, torch.Generator().manual_seed(7))
    runs = {}
    for where in ("cpu", "cuda"):
        d = torch.device("cpu") if where == "cpu" else dev
        params = tree_map(lambda p: p.to(d, copy=True), cpu_params)
        opt = make_opt()
        state = opt.init(params)
        start = _flat(params)
        step = train_step_fn(lambda p: loss_of(p, d), opt)
        _device.reset_launch_counts()
        loss0, grads = value_and_grad(lambda p: loss_of(p, d), params)
        counts = _device.launch_counts()
        losses = []
        for _ in range(3):
            params, state, loss = step(params, state)
            losses.append(float(loss))
        losses.append(float(loss_of(params, d)))
        runs[where] = dict(loss=float(loss0), losses=losses,
                           grads=tree_map(lambda g: g.float().cpu(), grads),
                           update=(_flat(params) - start).cpu(),
                           counts=counts)
    c, g = runs["cpu"], runs["cuda"]
    if any(c["counts"].values()):
        raise AssertionError(f"kernels launched on the CPU run: "
                             f"{c['counts']}")
    for name in kernels:
        if g["counts"][name] <= 0:
            raise AssertionError(f"{name} did not launch on the card run")
    rel = abs(g["loss"] - c["loss"]) / abs(c["loss"])
    worst = 0.0
    for (name, gc), gg in zip(zip(PackSpec(cpu_params).leaf_names(),
                                  tree_leaves(c["grads"])),
                              tree_leaves(g["grads"])):
        err = float((gg - gc).abs().max() / gc.abs().max().clamp_min(1e-30))
        worst = max(worst, err)
        if err > grad_tol:
            raise AssertionError(f"gradient {name}: {err:.3e} of its "
                                 f"largest entry")
    curve = max(abs(a - b) / abs(b) for a, b in zip(g["losses"],
                                                    c["losses"]))
    upd = float((g["update"] - c["update"]).norm() / c["update"].norm())
    upd_max = float((g["update"] - c["update"]).abs().max())
    log(f"  {label} 2-layer full-width {str(dt)[6:]}, seq {PARITY_SEQ}, "
        f"batch {PARITY_BATCH}: "
        f"loss card {g['loss']:.7f} cpu {c['loss']:.7f} (rel {rel:.2e}); "
        f"worst gradient leaf {worst:.2e} of its largest entry; 3 steps: "
        f"losses card {g['losses']} cpu {c['losses']} (max rel "
        f"{curve:.2e}); update rel {upd:.2e}, max abs {upd_max:.2e}; "
        f"card launches {({k: v for k, v in g['counts'].items() if v})}")
    if rel > loss_tol or curve > loss_tol:
        raise AssertionError("loss on the card differs from the CPU's")
    if upd > upd_tol:
        raise AssertionError("parameter updates on the card differ from "
                             "the CPU's")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    log("phase 1: device and build")
    card = card_line()
    log(card)
    log(f"  torch {torch.__version__} cuda {torch.version.cuda} "
        f"{torch.cuda.get_device_name(0)}")
    tb = time.perf_counter()
    _build.kernels()
    log(f"  kernels built and loaded in {time.perf_counter() - tb:.1f} s")

    def phase(title, fn, *args):
        tp = time.perf_counter()
        log(title)
        out = fn(*args)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        log(f"  ({time.perf_counter() - tp:.1f} s)")
        return out

    fd, ln, ln_bwd, (fa_fwd, fa_bwd), adam, fused, softmax = phase(
        "phase 2: kernels against their plain versions",
        lambda: (flash_decode_checks(dev), layer_norm_checks(dev),
                 layer_norm_bwd_checks(dev), flash_attention_checks(dev),
                 packed_adam_checks(dev), fused_block_checks(dev),
                 fused_softmax_checks(dev)))
    serving = phase("phase 3: GPT-2 345M bf16 serving", serve_345m, dev)
    near = phase("phase 4: fp32 token identity", token_identity, dev)
    log(f"  near-ties: {near}")
    train = phase("phase 5: GPT-2 345M bf16 train step: headline, unfused, "
                  "fused and non-flash legs", train_345m, dev)
    bert = phase("phase 6: BERT-large bf16 with FusedLAMB: non-flash and "
                 "flash legs", train_bert_large, dev)
    phase("phase 7: training parity, card against CPU",
          lambda: (gpt_parity(dev, "unfused", TRAIN_KERNELS[:4]),
                   gpt_parity(dev, "fused, selective_elementwise",
                              TRAIN_KERNELS[:4] + FUSED_KERNELS,
                              fused_block=True,
                              recompute_granularity="selective_elementwise"),
                   gpt_parity(dev, "GPT non-flash, causal",
                              ("softmax_fwd", "softmax_bwd",
                               "layer_norm_fwd", "layer_norm_bwd"),
                              compute_dtype=torch.bfloat16,
                              use_flash_attention=False),
                   bert_parity(dev, "BERT non-flash, padding mask",
                               ("softmax_masked_fwd", "softmax_bwd",
                                "layer_norm_fwd", "layer_norm_bwd"),
                               compute_dtype=torch.bfloat16,
                               use_flash_attention=False)))
    fd["launches"] = serving["flash_decode"]
    # launches on the main paths: the serving run, the four GPT legs and
    # the two BERT legs
    ln["launches"] = (serving["layer_norm_fwd"] + train["layer_norm_fwd"]
                      + bert["layer_norm_fwd"])
    for kr in (ln_bwd, fa_fwd, fa_bwd, adam, *fused, *softmax):
        kr["launches"] = train[kr["name"]] + bert.get(kr["name"], 0)
    keys = ("name", "route", "source", "replaces", "launches",
            "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")
    log(f"total {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"kernels": [{k: kr[k] for k in keys}
                                  for kr in (fd, ln, ln_bwd, fa_fwd, fa_bwd,
                                             adam, *fused, *softmax)]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
