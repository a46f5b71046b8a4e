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
   noop and no-update-m/v modes); times of kernel, plain version, one
   PyTorch library call as yardstick, and the least time the card could
   take;
3. full-width serving: GPT-2 345M (24 layers, hidden 1024, 16 heads,
   vocab 50304, bf16, random weights from a seed) through
   ``ServingEngine(n_slots=8, prefill_chunk=8)`` on 16 staggered
   requests of 128 prompt + 64 new tokens, with the kernels' launch
   counts zeroed before and read after;
4. token identity: the same width in fp32 (position table x40) against
   the port's dense ``reference_decode``;
5. the 345M train step (seq 1024, batch 8, bf16 O2, packed FusedAdam):
   2 warm-up and 10 timed steps, launches per step, loss falling, a
   profiled step;
6. training parity: a 2-layer full-width fp32 model, loss, gradients and
   3 packed-Adam steps on the card (kernels) against the CPU (plain
   versions);
7. a ``{"kernels": [...]}`` line, the card line, and last
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
from apex_tpu_torch.multi_tensor_apply.packing import PackSpec
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
from apex_tpu_torch.optimizers import FusedAdam
from apex_tpu_torch.serving import (
    Request,
    ServingEngine,
    reference_decode,
)
from apex_tpu_torch.transformer.testing import (
    GPTConfig,
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
# fp32 results differ only in summation order; a bf16 result may differ
# by one bf16 rounding (2^-8 relative) of values of order 1
TOL = {torch.float32: (2e-5, 1e-5), torch.bfloat16: (2e-2, 1e-2)}


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


def device_ms(fn, match: str, iters: int = 50):
    """Device time of the kernels whose name contains ``match``, per
    call of ``fn``, from a ``torch.profiler`` trace (host overhead
    excluded); None when the trace shows no such kernel."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    total_us = sum(e.device_time_total for e in prof.key_averages()
                   if match in e.key)
    return total_us / 1e3 / iters if total_us else None


def check_close(name, got, want, dtype, tol=None) -> float:
    atol, rtol = TOL[dtype] if tol is None else tol
    got, want = got.float(), want.float()
    if not torch.isfinite(got).all():
        raise AssertionError(f"{name}: kernel output is not finite")
    err = (got - want).abs()
    bad = err > atol + rtol * want.abs()
    if bad.any():
        raise AssertionError(
            f"{name}: {int(bad.sum())} elements outside atol {atol} rtol "
            f"{rtol}; max abs err {float(err.max()):.3e}")
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

def train_step_fn(cfg, opt, tokens, labels):
    """One step as ``bench.py``'s ``bench_gpt`` runs it: loss and
    gradients of ``gpt_loss``, then ``FusedAdam.step``."""
    def step(params, state):
        loss, grads = value_and_grad(
            lambda p: gpt_loss(cfg, p, tokens, labels), params)
        params, state = opt.step(grads, state, params)
        return params, state, loss
    return step


def train_345m(dev):
    """GPT-2 345M at full width and depth, seq 1024, batch 8, bf16
    compute over bf16 params with fp32 masters (O2), the unfused block
    without recompute, saved bf16 CE logits, packed FusedAdam(lr=1e-4):
    2 warm-up steps, then 10 timed steps on the same batch."""
    cfg = GPTConfig(num_layers=24, hidden_size=HIDDEN,
                    num_attention_heads=N_HEADS, vocab_size=50304,
                    max_position_embeddings=1024, hidden_dropout=0.0,
                    attention_dropout=0.0, compute_dtype=torch.bfloat16,
                    ce_save_logits=True)
    params = init_gpt_params(
        cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
    params = tree_map(lambda p: p.to(torch.bfloat16), params)
    opt = FusedAdam(lr=1e-4, master_weights=True, packed=True)
    state = opt.init(params)
    tokens = torch.randint(0, cfg.vocab_size, (8, 1024), device=dev,
                           generator=torch.Generator(
                               device=dev).manual_seed(1))
    labels = torch.roll(tokens, -1, dims=1)
    step = train_step_fn(cfg, opt, tokens, labels)
    losses = []
    for _ in range(2):
        params, state, loss = step(params, state)
        losses.append(loss)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _device.reset_launch_counts()
    times = []
    for _ in range(10):
        t0 = time.perf_counter()
        params, state, loss = step(params, state)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        losses.append(loss)
    launches = _device.launch_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    losses = [float(x) for x in losses]
    per_step = {k: launches[k] / 10 for k in TRAIN_KERNELS}
    p50 = float(np.percentile(times, 50))
    p99 = float(np.percentile(times, 99))
    log(f"  345M train step (b 8, s 1024, bf16 O2, unfused, no remat): "
        f"step p50 {p50:.2f} ms p99 {p99:.2f} ms, "
        f"{8 * 1024 / (p50 / 1e3):.0f} tokens/s at p50; loss first "
        f"{losses[0]:.4f} last {losses[-1]:.4f}; peak memory "
        f"{peak_gb:.2f} GiB")
    log(f"  launches per step: {per_step}")
    log("  train_json " + json.dumps(
        {"step_ms": times, "losses": losses, "peak_gib": peak_gb,
         "launches_per_step": per_step}))
    for name in TRAIN_KERNELS:
        if launches[name] <= 0:
            raise AssertionError(f"kernel {name} never launched in the "
                                 f"train step")
    if launches["flash_decode"]:
        raise AssertionError("flash_decode launched in the train step")
    if not all(np.isfinite(losses)):
        raise AssertionError(f"non-finite loss: {losses}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"loss did not fall: {losses}")
    profiled(lambda: step(params, state), "train step", 12)
    return launches


# ---------------------------------------------------------------------------
# phase 6: training parity, card against CPU
# ---------------------------------------------------------------------------

#: card (kernels) against CPU (plain versions), fp32 with TF32 off: the
#: loss within 1e-5 relative, each gradient leaf within 1e-4 of its
#: largest entry; after 3 packed-Adam steps the losses within 1e-5
#: relative and the master updates (masters minus their start) within
#: 1e-3 of their norm (Adam moves an element whose gradient sits at the
#: rounding level by up to lr either way, so no elementwise bound)
PARITY_LOSS_RTOL = 1e-5
PARITY_GRAD_TOL = 1e-4
PARITY_UPDATE_TOL = 1e-3


def train_parity(dev):
    cfg = GPTConfig(num_layers=2, hidden_size=HIDDEN,
                    num_attention_heads=N_HEADS, vocab_size=50304,
                    max_position_embeddings=256, hidden_dropout=0.0,
                    attention_dropout=0.0)
    cpu_params = init_gpt_params(cfg, torch.Generator().manual_seed(7))
    rng = np.random.default_rng(7)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 256)))
    labels = torch.roll(tokens, -1, dims=1)
    runs = {}
    for where in ("cpu", "cuda"):
        d = torch.device("cpu") if where == "cpu" else dev
        params = tree_map(lambda p: p.to(d, copy=True), cpu_params)
        opt = FusedAdam(lr=1e-4, master_weights=True, packed=True)
        state = opt.init(params)
        master0 = state.master_params.clone()
        step = train_step_fn(cfg, opt, tokens.to(d), labels.to(d))
        _device.reset_launch_counts()
        loss0, grads = value_and_grad(
            lambda p: gpt_loss(cfg, p, tokens.to(d), labels.to(d)), params)
        counts = _device.launch_counts()
        losses = []
        for _ in range(3):
            params, state, loss = step(params, state)
            losses.append(float(loss))
        losses.append(float(gpt_loss(cfg, params, tokens.to(d),
                                     labels.to(d))))
        runs[where] = dict(loss=float(loss0), losses=losses,
                           grads=tree_map(lambda g: g.cpu(), grads),
                           update=(state.master_params - master0).cpu(),
                           counts=counts)
    c, g = runs["cpu"], runs["cuda"]
    if any(c["counts"].values()):
        raise AssertionError(f"kernels launched on the CPU run: "
                             f"{c['counts']}")
    for name in ("layer_norm_fwd", "layer_norm_bwd", "flash_attn_fwd",
                 "flash_attn_bwd"):
        if g["counts"][name] <= 0:
            raise AssertionError(f"{name} did not launch on the card run")
    rel = abs(g["loss"] - c["loss"]) / abs(c["loss"])
    worst = 0.0
    for (name, gc), gg in zip(zip(PackSpec(cpu_params).leaf_names(),
                                  tree_leaves(c["grads"])),
                              tree_leaves(g["grads"])):
        err = float((gg - gc).abs().max() / gc.abs().max().clamp_min(1e-30))
        worst = max(worst, err)
        if err > PARITY_GRAD_TOL:
            raise AssertionError(f"gradient {name}: {err:.3e} of its "
                                 f"largest entry")
    curve = max(abs(a - b) / abs(b) for a, b in zip(g["losses"],
                                                    c["losses"]))
    upd = float((g["update"] - c["update"]).norm() / c["update"].norm())
    upd_max = float((g["update"] - c["update"]).abs().max())
    log(f"  2-layer full-width fp32, seq 256, batch 2: loss card "
        f"{g['loss']:.7f} cpu {c['loss']:.7f} (rel {rel:.2e}); worst "
        f"gradient leaf {worst:.2e} of its largest entry; 3 Adam steps: "
        f"losses card {g['losses']} cpu {c['losses']} (max rel "
        f"{curve:.2e}); master update rel {upd:.2e}, max abs {upd_max:.2e}")
    if rel > PARITY_LOSS_RTOL or curve > PARITY_LOSS_RTOL:
        raise AssertionError("loss on the card differs from the CPU's")
    if upd > PARITY_UPDATE_TOL:
        raise AssertionError("master updates on the card differ from the "
                             "CPU's")


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

    fd, ln, ln_bwd, (fa_fwd, fa_bwd), adam = phase(
        "phase 2: kernels against their plain versions",
        lambda: (flash_decode_checks(dev), layer_norm_checks(dev),
                 layer_norm_bwd_checks(dev), flash_attention_checks(dev),
                 packed_adam_checks(dev)))
    serving = phase("phase 3: GPT-2 345M bf16 serving", serve_345m, dev)
    near = phase("phase 4: fp32 token identity", token_identity, dev)
    log(f"  near-ties: {near}")
    train = phase("phase 5: GPT-2 345M bf16 train step", train_345m, dev)
    phase("phase 6: training parity, card against CPU", train_parity, dev)
    fd["launches"] = serving["flash_decode"]
    # on both main paths: the serving run's launches plus the train run's
    ln["launches"] = serving["layer_norm_fwd"] + train["layer_norm_fwd"]
    for kr in (ln_bwd, fa_fwd, fa_bwd, adam):
        kr["launches"] = train[kr["name"]]
    keys = ("name", "route", "source", "replaces", "launches",
            "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")
    log(f"total {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"kernels": [{k: kr[k] for k in keys}
                                  for kr in (fd, ln, ln_bwd, fa_fwd, fa_bwd,
                                             adam)]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
