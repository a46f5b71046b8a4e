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
   general mask holding a fully masked row, sk 1000, 999 and 16384; the
   three packed LAMB kernels over BERT-large's flat buffer, fp32 as on
   the path and bf16, with and without decay, L2 mode and noop; the
   packed SGD kernel over the 345M buffer: momentum 0 and 0.9, nesterov,
   decay after the momentum, the first run and noop; flash attention at
   head dims 32, 96, 128 and 256, and bf16 (the tensor-core kernels) at
   every head dim with lengths 1000 and 17, causal 320x1000, a fully
   masked row at d 256 and dropout at d 128, the bf16 backward twice
   bitwise equal; the fused tails at widths 5120, 8192,
   16384 and 1000; the flat scale (bf16 -> fp32, fp32 -> fp32, fp32 ->
   bf16, per-row flags naming planted inf, nan and overflow rows, a
   ragged length) and axpby over the 345M buffer; packed NovoGrad over
   BERT-large's buffer with L2 and inf-norm denominators, decay inside
   and outside the moment, and noop; the LayerNorm forward and backward
   at hidden 32768 and 65536; the RMSNorm forward and backward at the
   345M's rows [8192, 1024] in fp32 and bf16, affine and not, at [4096,
   4096] and [2048, 8192] bf16, widths 1000 and 32768, and its
   memory-efficient backward; the numerics monitor's row statistics over
   the 345M buffer in bf16 and fp32 and at a ragged length, with inf and
   nan planted in known rows; both norm backwards on either side of
   their register tier and wide, widths 1, 31, 1000, 1024, 4096, 8192,
   8193, 32768 and 65536 at 1, 7 and 8192 rows, every dtype pair and the
   x-hat form; the split decode at lengths on and beside split
   boundaries under the card's plan and under splits that end mid-page,
   every slot empty, and 8 and 64 slots at kv_len 1024; the redesigned
   kernels each run twice, bit for bit);
   times of kernel, plain version, one PyTorch library call as
   yardstick (the device time of SDPA, of ``F.layer_norm``'s and
   ``F.rms_norm``'s backward kernels), and the least time the card could
   take;
3. full-width serving: GPT-2 345M (24 layers, hidden 1024, 16 heads,
   vocab 50304, bf16, random weights from a seed) through
   ``ServingEngine(n_slots=8, prefill_chunk=8)`` on 16 staggered
   requests of 128 prompt + 64 new tokens, with the kernels' launch
   counts zeroed before and read after;
   3b. serving under overload (``bench.py``'s ``serving_overload``): the
   same model, 8 slots, 24 requests of 128 + 64 tokens arriving every 12
   steps (twice the rate the slots drain), seeded priorities, latency
   and TTFT budgets scaled from a calibration trace's step p50, bounded
   queue admission (16, watermarks 0.75 / 0.375) and shedding after 3
   pressured boundaries: goodput, SLO attainment, terminal states, TTFT,
   queue depth and a profiled stretch; every request in exactly one
   terminal state, the queue bound, the scheduler's invariants, no page
   leaked, both serving kernels launched and no training kernel. The
   storm's queue stays below the high watermark on the card, so the
   watermark's refusal and shedding do not run here; a deadline, or a
   refusal on the TTFT bound, runs only when steps are slower than the
   calibration trace's. All are held against the JAX engine on the CPU
   under ``VirtualClock`` (``tests/test_torch_serving_robustness.py``);
   3c. speculative decoding A/B (``bench.py``'s ``spec_decode``): the
   same storm with ``prefill_chunk=8`` at ``spec_k`` 0 and 4 (2-gram
   drafts), the same checks, drafts asserted, no gain asserted; the
   decode kernel timed at the speculative step's 64 query rows;
   3d. chaos on the fp32 configuration of phase 4: a poisoned request
   quarantined with the others' tokens bitwise those of a clean run, an
   engine kill recovered with ``recover_from``, a wedged fetch caught by
   ``HangWatchdog`` within its timeout and recovered, a transient poison
   retried to completion, and a traced run with the metrics drain into a
   JSONL file (one terminal span per request, rooted trees, TTFT
   attribution summing to the TTFT, one metrics record per 4 steps, one
   ``serving_summary``);
4. token identity: the same width in fp32 (position table x40) against
   the port's dense ``reference_decode``, plain and with ``spec_k=4``,
   then ``spec_k=4`` with the position table x1, where drafts are
   accepted (asserted) and rejected;
5. the 345M train step (seq 1024, batch 8, bf16 O2, packed FusedAdam):
   the headline step (``fused_block=True``, ``selective_elementwise``
   recompute), 2 warm-up and 6 timed steps, then the unfused step
   without recompute, the fused step without recompute, the step
   without flash attention (``bench.py``'s xla-attention leg: the fused
   softmax kernels under ``selective`` recompute), the unfused step
   with packed FusedSGD (momentum 0.9, weight decay 1e-4, fp32 masters)
   and the unfused step with dynamic loss scaling and clipping to norm 1
   over the flat gradient buffer as further legs (2 + 6 steps each); for
   each, launches per step asserted exactly, loss falling, peak memory,
   a profiled step; then one step of the loss-scaled leg with an inf in
   a gradient, which must be skipped bit for bit and halve the scale;
   then two monitored legs (2 + 4 steps): the headline step with the
   numerics monitor over the gradient tree (``bench.py``'s
   ``numerics_overhead`` leg, its p50 logged against the headline's), and
   the loss-scaled leg with the monitor over the packed gradients
   (``packed_row_stats``), the scaler's ``metrics=``/``numerics=`` hooks
   and both drains into a JSONL file: one step under
   ``set_sync_debug_mode("error")``, then an inf in one leaf's gradient,
   which must be skipped and yield exactly one ``nonfinite_grads`` record
   naming that leaf;
6. the BERT-large step with FusedLAMB (``bench.py``'s
   ``bench_bert_lamb``: 24 x 1024 x 16, vocab 30592, seq 512, batch 16,
   bf16 over fp32 params), with a padding mask: pytree LAMB under
   ``selective`` without flash (the masked fused softmax) and with
   flash, then without recompute or flash, with pytree and with packed
   LAMB and with packed NovoGrad (2 + 5 steps each), checked as the GPT
   legs, and the optimizer's step alone timed in each;
7. ``FusedRMSNorm`` and ``MixedFusedRMSNorm`` on ``[8, 1024, 4096]`` bf16
   with and without ``memory_efficient``, and ``FusedLayerNorm(32768)``,
   forward and backward; a 2-layer full-width GPT under
   ``activation_watch`` (the layers' taps, packed Adam's ``tap_flat``, a
   planted inf named alike); training parity, card (kernels) against CPU
   (plain versions), on 2-layer full-width models: fp32 unfused and fused under
   ``selective_elementwise`` (3 packed-Adam steps), bf16 GPT without
   flash (3 packed-Adam steps), bf16 BERT without flash under a
   padding mask (3 pytree LAMB steps), fp32 GPT with packed SGD, and
   BERT without flash with packed LAMB in fp32 and bf16: loss, every
   gradient, the steps; then packed against pytree LAMB on the card;
   the fp32 GPT with the loss-scaled, clipped step (3 steps and a forced
   overflow), BERT with packed NovoGrad (fp32 L2 and inf norm, bf16),
   GPTs at head dim 128 (flash) and 80 (no flash kernel: the fused
   softmax) with the default attention choice, and 1-layer fused-block
   GPTs at hidden 5120 and 8192 (loss and gradients);
8. a ``{"kernels": [...]}`` line (25 kernels, the decode kernel's and
   the LayerNorm forward's launches counted over the serving runs of
   phases 3-3c; every one launched on a
   main path except ``axpby_flat``, which no path of the JAX package
   calls, and the RMSNorm pair, which no model of it runs: their
   launches are the norm modules' of phase 7), the card line, and last
   ``{"ok": true, "device": {...}}``.

Exits non-zero when no CUDA device is present.
"""
from __future__ import annotations

import functools
import importlib
import json
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
import torch.nn.functional as F

from apex_tpu_torch import _build, _device, telemetry
from apex_tpu_torch._tree import tree_leaves, tree_map, value_and_grad
from apex_tpu_torch.amp import LossScaler
from apex_tpu_torch.contrib.clip_grad import clip_grad_norm_flat
from apex_tpu_torch.contrib.xentropy import softmax_cross_entropy_loss
from apex_tpu_torch.multi_tensor_apply.packing import PackSpec
from apex_tpu_torch.normalization import (
    FusedLayerNorm,
    FusedRMSNorm,
    MixedFusedRMSNorm,
)
from apex_tpu_torch.ops import fused_block as fb
from apex_tpu_torch.ops.flash_attention import (
    flash_attention_bwd,
    flash_attention_bwd_reference,
    flash_attention_fwd,
    flash_attention_fwd_reference,
)
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
from apex_tpu_torch.optimizers import (
    FusedAdam,
    FusedLAMB,
    FusedNovoGrad,
    FusedSGD,
)
from apex_tpu_torch.optimizers.fused_novograd import (
    leaf_norms_sq,
    row_denominators,
)
from apex_tpu_torch.resilience import (
    ChaosError,
    HangError,
    HangWatchdog,
    RetryPolicy,
    ServingChaos,
)
from apex_tpu_torch.serving import (
    AdmissionConfig,
    DegradationPolicy,
    Request,
    RequestStatus,
    ServingEngine,
    is_terminal,
    reference_decode,
)
from apex_tpu_torch.telemetry.numerics import NumericsMonitor
from apex_tpu_torch.transformer.functional import fused_softmax as fs
from apex_tpu_torch.transformer.testing import (
    GPTConfig,
    bert_forward,
    gpt_forward,
    gpt_loss,
    init_gpt_params,
)

# the modules (the package re-exports functions of the same names)
fd_mod = importlib.import_module("apex_tpu_torch.ops.flash_decode")
ln_mod = importlib.import_module("apex_tpu_torch.ops.layer_norm")

#: H100 SXM data-sheet peaks (dense): HBM bytes/s, fp32 (non-tensor-core)
#: flop/s — the kernels here but bf16 flash attention do their arithmetic
#: in fp32 on CUDA cores — and the bf16 tensor-core rate, the least time
#: any attention kernel could take for its products
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


def device_ms(fn, match, iters: int = 50, tries: int = 3):
    """Device time of the kernels whose name contains ``match`` (a
    string, or a tuple of strings for a call that issues several
    kernels; "" matches every kernel of the call), per call of ``fn``,
    from a ``torch.profiler`` trace (host overhead excluded); None when
    ``tries`` traces show no such kernel (a trace now and then records
    no device activity)."""
    from torch.profiler import ProfilerActivity, profile

    matches = (match,) if isinstance(match, str) else tuple(match)
    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        total_us = sum(e.device_time_total for e in prof.key_averages()
                       if any(m in e.key for m in matches))
        if total_us:
            return total_us / 1e3 / iters
    return None


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

def _page_case(g, dev, lens, dtype, q_dtype, n_pools=1, rows_per_slot=1):
    """Random pools and a page table over ``lens``; entries past a
    slot's length point at the garbage page 0. Rows ``b`` with one
    ``b // rows_per_slot`` are the query columns of one slot of a chunked
    step, and read that slot's pages, as the engine's flattened chunk
    does."""
    B = len(lens)
    pools = [(torch.randn(POOL_PAGES, N_HEADS, PAGE, HEAD_DIM, generator=g,
                          device=dev).to(dtype),
              torch.randn(POOL_PAGES, N_HEADS, PAGE, HEAD_DIM, generator=g,
                          device=dev).to(dtype))
             for _ in range(n_pools)]
    q = torch.randn(B, N_HEADS, HEAD_DIM, generator=g, device=dev).to(q_dtype)
    # distinct pages per slot
    perm = torch.randperm(POOL_PAGES - 1, generator=g, device=dev) + 1
    pt = torch.zeros(B, MP, dtype=torch.int32, device=dev)
    for b, L in enumerate(lens):
        used = -(-L // PAGE)
        s = (b // rows_per_slot) * MP
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
        q, pools, pt, kl = _page_case(g, dev, lens, kv_dt, q_dt,
                                      rows_per_slot=len(lens) // SLOTS)
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
    t = _decode_timing(dev, q, pools, pt, kl, "decode bf16 [8,16,64]")
    # the chunk shape is timed too, for PERF.md
    qc, pc, ptc, klc = _page_case(g, dev, chunk_lens, torch.bfloat16,
                                  torch.bfloat16, n_pools=8, rows_per_slot=8)
    nxtc = _rotating(pc)
    ms_c = time_ms(lambda: flash_decode(qc, *nxtc(), ptc, klc))
    dev_c = device_ms(lambda: flash_decode(qc, *nxtc(), ptc, klc),
                      "flash_decode_")
    log(f"  flash_decode chunk bf16 [64,16,64] over {int(klc.sum())} "
        f"tokens: kernel {ms_c:.4f} ms, device time {dev_c} ms")
    errs.append(flash_decode_split_checks(dev, g))
    return {"name": "flash_decode", "route": "cuda",
            "source": "apex_tpu_torch/csrc/flash_decode.cu",
            "replaces": "apex_tpu/ops/flash_decode.py:147",
            "max_abs_err": max(errs), **t}


def _decode_timing(dev, q, pools, pt, kl, label):
    """Call and device ms of the decode kernel over ``pools`` in turn (more
    than the 50 MB L2 together, or as many as fit the call's pool sizes),
    its plain version's ms, the device ms of SDPA over the already
    gathered dense K/V (the gather itself untimed) as the library
    yardstick, and the bound: the K/V rows of every distinct live page
    once (the rows of a chunked slot read one page list; each page up to
    the longest length that reaches into it), q, out, the live page-table
    entries and the lengths, over the HBM rate; the operations count
    every row's tokens."""
    b, n, d = q.shape
    mp = pt.shape[1]
    ps = pools[0][0].shape[2]
    nxt = _rotating(pools)
    ms = time_ms(lambda: flash_decode(q, *nxt(), pt, kl))
    dev_ms = device_ms(lambda: flash_decode(q, *nxt(), pt, kl),
                       "flash_decode_")
    plain_ms = time_ms(lambda: paged_decode_reference(q, *nxt(), pt, kl),
                       iters=5)
    kd = pools[0][0][pt.long()].permute(0, 2, 1, 3, 4).reshape(
        b, n, mp * ps, d)
    vd = pools[0][1][pt.long()].permute(0, 2, 1, 3, 4).reshape(
        b, n, mp * ps, d)
    mask = (torch.arange(mp * ps, device=dev)[None, :]
            < kl[:, None]).reshape(b, 1, 1, mp * ps)

    def sdpa():
        return F.scaled_dot_product_attention(q[:, :, None, :], kd, vd,
                                              attn_mask=mask)
    lib_call = time_ms(sdpa)
    lib_ms = device_ms(sdpa, "")
    tokens = int(kl.sum())
    live = {}
    for row, L in zip(pt.tolist(), kl.tolist()):
        for i in range(-(-L // ps)):
            live[row[i]] = max(live.get(row[i], 0), min(ps, L - i * ps))
    kv_tokens = sum(live.values())
    elem = pools[0][0].element_size()
    nbytes = (2 * kv_tokens * n * d * elem                 # K and V rows
              + 2 * q.numel() * q.element_size()           # q in, out
              + sum(-(-int(L) // ps) for L in kl) * 4      # page-table reads
              + kl.numel() * 4)
    b_ms, by = bound(nbytes, 4 * tokens * n * d)
    log(f"  flash_decode {label} over {tokens} tokens ({kv_tokens} "
        f"distinct K/V rows): kernel {ms:.4f} ms "
        f"(device {dev_ms} ms), plain "
        f"{plain_ms:.4f} ms, sdpa over gathered K/V {lib_call:.4f} ms "
        f"(device {lib_ms} ms), bound {b_ms:.5f} ms ({by}), share of bound "
        f"{b_ms / dev_ms if dev_ms else None}")
    return {"ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
            "bound_by": by, "library_ms": lib_ms, "device_ms": dev_ms}


def flash_decode_split_checks(dev, g):
    """The split decode (split-K over the token axis, the splits of a
    (slot, head) one thread block cluster merging in shared memory):
    lengths at the first split boundaries and one either side under the
    card's plan and under 8 splits of 36 tokens that end mid-page, every
    slot empty (zeros), two runs bit for bit; then 8 and 64 slots each at
    kv_len 1024 (the 345M's whole context, 128 pages of 8), checked and
    timed. Returns the largest error (``TOL`` of q's dtype)."""
    mp = 128
    t_max = mp * PAGE
    errs = []
    for name, kv_dt, q_dt in (("bf16", torch.bfloat16, torch.bfloat16),
                              ("f32", torch.float32, torch.float32),
                              ("f32 q / bf16 pages", torch.bfloat16,
                               torch.float32)):
        plan = decode_plan(SLOTS, N_HEADS, PAGE, MP,
                           _build.sm_count(dev.index))
        for p in (plan, DecodePlan(-(-MP * PAGE // 36), 36)):
            S = p.split_len
            lens = [0, S - 1, S, S + 1, 2 * S - 1, 2 * S + 1,
                    min(3 * S, MP * PAGE) - 1, MP * PAGE]
            q, pools, pt, kl = _page_case(g, dev, lens, kv_dt, q_dt)
            k, v = pools[0]
            got = fd_mod._launch(q, k, v, pt, kl, HEAD_DIM ** -0.5, p)
            again = fd_mod._launch(q, k, v, pt, kl, HEAD_DIM ** -0.5, p)
            want = paged_decode_reference(q, k, v, pt, kl)
            err = check_close(f"flash_decode split {p} {name}", got, want,
                              q_dt)
            if not torch.equal(got, again):
                raise AssertionError(f"flash_decode {p} {name}: two runs "
                                     f"differ")
            if got[0].abs().max() != 0:
                raise AssertionError("flash_decode: kv_len == 0 not zero")
            empty = fd_mod._launch(q, k, v, pt, torch.zeros_like(kl),
                                   HEAD_DIM ** -0.5, p)
            if empty.abs().max() != 0:
                raise AssertionError(f"flash_decode {p}: every split empty "
                                     f"but the output is not zero")
            errs.append(err)
            log(f"  flash_decode {name} {p} lens {lens}: max abs err "
                f"{err:.3e}; twice bitwise equal; all-empty zeros")
    for slots, n_pools in ((8, 4), (64, 2)):
        pages = slots * mp + 1
        pools = [tuple(torch.randn(pages, N_HEADS, PAGE, HEAD_DIM,
                                   generator=g, device=dev).to(
                                       torch.bfloat16) for _ in range(2))
                 for _ in range(n_pools)]
        q = torch.randn(slots, N_HEADS, HEAD_DIM, generator=g,
                        device=dev).to(torch.bfloat16)
        pt = (torch.randperm(pages - 1, generator=g, device=dev)[
            :slots * mp] + 1).reshape(slots, mp).to(torch.int32)
        plan = decode_plan(slots, N_HEADS, PAGE, mp,
                           _build.sm_count(dev.index))
        S = plan.split_len
        for lens in ([t_max] * slots,
                     [(S + (i % 3) - 1) if i % 2 else min(t_max, 2 * S + 1)
                      for i in range(slots)]):
            kl = torch.tensor(lens, dtype=torch.int32, device=dev)
            got = flash_decode(q, *pools[0], pt, kl)
            again = flash_decode(q, *pools[0], pt, kl)
            err = check_close(f"flash_decode [{slots},16,64] x {t_max}", got,
                              paged_decode_reference(q, *pools[0], pt, kl),
                              torch.bfloat16)
            if not torch.equal(got, again):
                raise AssertionError("flash_decode: two runs differ")
            errs.append(err)
        log(f"  flash_decode [{slots},16,64] bf16 {plan}, kv_len {t_max} and "
            f"at the split boundaries: max abs err {max(errs[-2:]):.3e}; "
            f"twice bitwise equal")
        kl = torch.full((slots,), t_max, dtype=torch.int32, device=dev)
        _decode_timing(dev, q, pools, pt, kl,
                       f"bf16 [{slots},16,64] x {t_max}")
        del pools
        torch.cuda.empty_cache()
    return max(errs)


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


#: PyTorch's LayerNorm backward kernels (aten/src/ATen/native/cuda/
#: layer_norm_kernel.cu) by name: the library yardstick of #3 is their
#: device time, not the host's autograd call around them
LN_BWD_LIBRARY = ("layer_norm", "LayerNorm", "GammaBeta", "gamma_beta",
                  "ComputeInternalGradients", "ComputeGradientFusedParams")


def _library_bwd_ms(fn, match, label):
    """Call ms of a library backward (``torch.autograd.grad`` over a
    retained graph) and the device ms of its kernels named by ``match``;
    every kernel of the call is logged by name with its device ms."""
    from torch.profiler import ProfilerActivity, profile

    call = time_ms(fn, iters=20)
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(20):
            fn()
        torch.cuda.synchronize()
    names = {e.key: e.device_time_total / 1e3 / 20
             for e in prof.key_averages() if e.device_time_total > 0}
    log(f"  {label}: kernels {json.dumps(names)}")
    return call, device_ms(fn, match, iters=20)


def norm_bwd_tier_checks(dev):
    """Both norm backwards (#3, #5) against their plain versions on either
    side of the team kernel's register tier (widths 1, 31, 1000, 1024,
    4096, 8192 and 8193) and wide (32768, 65536: the block-a-row kernel),
    at 1, 7 and 8192 rows, every dtype pair of x and dy and the x-hat
    form, each on the same statistics as its plain version: dx within
    ``TOL`` of dy's dtype, the parameter gradients within ``SUM_TOL``; a
    second run bit for bit. Returns the largest LayerNorm and RMSNorm
    errors."""
    g = torch.Generator(device=dev).manual_seed(23)
    errs = {"layer_norm": [], "rms_norm": []}
    pairs = ((torch.float32, torch.float32), (torch.float32, torch.bfloat16),
             (torch.bfloat16, torch.bfloat16), (torch.bfloat16, torch.float32))
    for hidden in (1, 31, 1000, 1024, 4096, 8192, 8193, 32768, 65536):
        for rows in (1, 7, 8192):
            x0 = torch.randn(rows, hidden, generator=g, device=dev) * 3 + 1
            dy0 = torch.randn(rows, hidden, generator=g, device=dev)
            w = torch.randn(hidden, generator=g, device=dev)
            for norm, (x_dt, dy_dt) in ((n, p) for n in errs for p in pairs):
                x, dy = x0.to(x_dt), dy0.to(dy_dt)
                if norm == "layer_norm":
                    _, mu, rstd = layer_norm_reference(
                        x, w, torch.zeros_like(w), 1e-5)
                    xhat = (x.float() - mu) * rstd

                    def kern(xin, is_xhat):
                        return layer_norm_bwd(dy, xin, mu, rstd, w, is_xhat)

                    def plain(xin, is_xhat):
                        return layer_norm_bwd_reference(dy, xin, mu, rstd, w,
                                                        is_xhat)
                else:
                    _, rstd = rms_norm_reference(x, w, 1e-5)
                    xhat = x.float() * rstd

                    def kern(xin, is_xhat):
                        return rms_norm_bwd(dy, xin, rstd, w, is_xhat)

                    def plain(xin, is_xhat):
                        return rms_norm_bwd_reference(dy, xin, rstd, w,
                                                      is_xhat)
                for xin, is_xhat in ((x, False), (xhat, True)):
                    got, again = kern(xin, is_xhat), kern(xin, is_xhat)
                    want = plain(xin, is_xhat)
                    what = (f"{norm}_bwd [{rows},{hidden}] x {x_dt} dy "
                            f"{dy_dt}{' x-hat' if is_xhat else ''}")
                    if got[0].dtype != dy_dt:
                        raise AssertionError(f"{what}: dx {got[0].dtype}")
                    err = max([check_close(what, got[0], want[0], dy_dt)]
                              + [check_close(what + " parameter gradient",
                                             a, c, None, SUM_TOL)
                                 for a, c in zip(got[1:], want[1:])])
                    if not all(torch.equal(a, c) for a, c in zip(got, again)):
                        raise AssertionError(f"{what}: two runs differ")
                    errs[norm].append(err)
            del x0, dy0, x, dy, xhat
            torch.cuda.empty_cache()
        log(f"  norm backwards at hidden {hidden}, rows 1/7/8192, 4 dtype "
            f"pairs, x and x-hat: max abs err LayerNorm "
            f"{max(errs['layer_norm']):.3e}, RMSNorm "
            f"{max(errs['rms_norm']):.3e}; twice bitwise equal")
    return max(errs["layer_norm"]), max(errs["rms_norm"])


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
            dev_ms = device_ms(run, "norm_bwd_")
            split = [device_ms(run, m) for m in ("norm_bwd_team_kernel",
                                                 "norm_bwd_cols_kernel")]
            plain_ms = time_ms(
                lambda: layer_norm_bwd_reference(dy, x, mu, rstd, w),
                iters=20)
            xl, wl, bl = (t.clone().requires_grad_(True) for t in (x, w, b))
            yl = F.layer_norm(xl, (HIDDEN,), wl, bl, 1e-5)
            lib_call, lib_ms = _library_bwd_ms(
                lambda: torch.autograd.grad(yl, (xl, wl, bl), dy,
                                            retain_graph=True),
                LN_BWD_LIBRARY, "F.layer_norm backward")
            nbytes = 3 * x.numel() * 4 + 2 * rows * 4 + 3 * HIDDEN * 4
            b_ms, by = bound(nbytes, 12 * x.numel())
            timing = {"ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
                      "device_ms": dev_ms, "bound_ms": b_ms, "bound_by": by}
            log(f"  layer_norm_bwd [{rows},{HIDDEN}] f32: kernel {ms:.4f} "
                f"ms, plain {plain_ms:.4f} ms, F.layer_norm backward "
                f"{lib_call:.4f} ms (device {lib_ms} ms), bound {b_ms:.4f} "
                f"ms ({by}); kernel device time {dev_ms} ms (rows pass "
                f"{split[0]}, column pass {split[1]}), share of bound "
                f"{b_ms / dev_ms if dev_ms else None}")
    return {"name": "layer_norm_bwd", "route": "cuda",
            "source": "apex_tpu_torch/csrc/layer_norm.cu",
            "replaces": "apex_tpu/ops/layer_norm.py:210",
            "max_abs_err": max(errs), **timing}


def layer_norm_width_checks(dev):
    """The LayerNorm forward and backward at rows wider than a block's
    shared memory holds (hidden 32768 and 65536: the backward keeps its
    column partials in device memory), against their plain versions with
    fp32 x, fp32 and bf16 dy. Returns the largest forward and backward
    errors."""
    g = torch.Generator(device=dev).manual_seed(21)
    fwd, bwd = [], []
    for hidden, rows, dy_dt in ((32768, 256, torch.bfloat16),
                                (65536, 128, torch.float32)):
        x = torch.randn(rows, hidden, generator=g, device=dev) * 3 + 1
        w = torch.randn(hidden, generator=g, device=dev)
        b = torch.randn(hidden, generator=g, device=dev)
        dy = torch.randn(rows, hidden, generator=g, device=dev).to(dy_dt)
        y, mu, rstd = layer_norm_fwd(x, w, b, eps=1e-5)
        ry, rmu, rrstd = layer_norm_reference(x, w, b, 1e-5)
        fwd.append(max(check_close(f"layer_norm y hidden {hidden}", y, ry,
                                   torch.float32),
                       check_close("layer_norm rstd", rstd, rrstd,
                                   torch.float32)))
        dx, dw, db = layer_norm_bwd(dy, x, mu, rstd, w)
        rdx, rdw, rdb = layer_norm_bwd_reference(dy, x, mu, rstd, w)
        bwd.append(max(check_close(f"layer_norm_bwd dx hidden {hidden}", dx,
                                   rdx, dy_dt),
                       check_close("layer_norm_bwd dgamma", dw, rdw, None,
                                   SUM_TOL),
                       check_close("layer_norm_bwd dbeta", db, rdb, None,
                                   SUM_TOL)))
        t = time_ms(lambda: layer_norm_bwd(dy, x, mu, rstd, w), iters=10)
        log(f"  layer_norm [{rows},{hidden}] fwd/bwd (dy {dy_dt}): max abs "
            f"err {fwd[-1]:.3e} / {bwd[-1]:.3e}; backward {t:.4f} ms")
    return max(fwd), max(bwd)


#: the memory-efficient backward (x-hat rebuilt in fp32 from y) against
#: the plain backward given the same fp32 x-hat, norm-relative: dx within
#: one rounding of its dtype (1e-5 fp32, 2^-8 bf16); the fp32 parameter
#: gradients, column sums in another order, within 1e-5. An x-hat rounded
#: to bf16 moves each product dy * x-hat by up to a bf16 half-ulp (2^-9),
#: ~2e-3 of dgamma's norm: that planted fault must fail the 1e-5 limit
XHAT_DX_TOL = {torch.float32: 1e-5, torch.bfloat16: 2.0 ** -8}
XHAT_PARAM_TOL = 1e-5
#: the memory-efficient backward against the plain one (which keeps x):
#: x-hat from y carries y's rounding, an fp32 or a bf16 ulp of y an
#: element over |w| >= 0.5; norm-relative
ME_PLAIN_TOL = {torch.float32: 1e-5, torch.bfloat16: 8e-3}


def _rel(a, c):
    return float((a.float() - c.float()).norm() / c.float().norm())


def memory_efficient_checks(dev, g):
    """Both norms' ``memory_efficient`` backward through the autograd
    Functions at [8192, 1024] fp32 and bf16 (the kernels on the card):
    against the plain backward given the fp32 x-hat rebuilt here from the
    forward's y (``XHAT_*_TOL``), with an x-hat rounded to
    bf16 planted to show the limit catches it, and against the plain
    backward that keeps x (``ME_PLAIN_TOL``)."""
    x0 = torch.randn(8, 1024, 1024, generator=g, device=dev)
    w0 = torch.rand(1024, generator=g, device=dev) + 0.5
    w0[3] = -0.75
    b0 = torch.randn(1024, generator=g, device=dev)
    dy0 = torch.randn(8, 1024, 1024, generator=g, device=dev)
    for norm, dt in ((n, d) for n in ("layer_norm", "rms_norm")
                     for d in (torch.float32, torch.bfloat16)):
        x2, dy = x0.to(dt).reshape(-1, 1024), dy0.to(dt)
        if norm == "layer_norm":
            y, mu, rstd = layer_norm_fwd(x2, w0, b0)
            xhat = (y.float() - b0) / w0  # |w0| >= 0.5: no clamp

            def ref(xh):
                return layer_norm_bwd_reference(dy.reshape(-1, 1024), xh, mu,
                                                rstd, w0, x_is_xhat=True)
        else:
            y, rstd = rms_norm_fwd(x2, w0)
            xhat = y.float() / w0

            def ref(xh):
                return rms_norm_bwd_reference(dy.reshape(-1, 1024), xh, rstd,
                                              w0, x_is_xhat=True)
        grads = []
        for me in (True, False):
            x = x0.to(dt, copy=True).requires_grad_(True)
            w, b = (t.clone().requires_grad_(True) for t in (w0, b0))
            if norm == "layer_norm":
                layer_norm(x, w, b, memory_efficient=me).backward(dy)
                grads.append((x.grad, w.grad, b.grad))
            else:
                rms_norm(x, w, memory_efficient=me).backward(dy)
                grads.append((x.grad, w.grad))
        want = ref(xhat)
        bad = ref(xhat.to(torch.bfloat16).float())
        dx_rel = _rel(grads[0][0].reshape(-1, 1024), want[0])
        p_rel = max(_rel(a, c) for a, c in zip(grads[0][1:], want[1:]))
        planted = max(_rel(a, c) for a, c in zip(bad[1:], want[1:]))
        plain = max(_rel(a, c) for a, c in zip(*grads))
        name = f"{norm} memory_efficient {str(dt)[6:]}"
        if dx_rel > XHAT_DX_TOL[dt] or p_rel > XHAT_PARAM_TOL:
            raise AssertionError(f"{name}: dx {dx_rel:.3e}, parameter "
                                 f"gradients {p_rel:.3e} of their norm from "
                                 f"the plain backward on the same x-hat")
        if planted <= XHAT_PARAM_TOL:
            raise AssertionError(f"{name}: an x-hat rounded to bf16 "
                                 f"({planted:.3e}) passes the check")
        if plain > ME_PLAIN_TOL[dt]:
            raise AssertionError(f"{name}: gradients {plain:.3e} of their "
                                 f"norm from the plain backward's")
        log(f"  {name} [8192,1024]: against the same fp32 x-hat dx "
            f"{dx_rel:.3e} (limit {XHAT_DX_TOL[dt]:.1e}), parameter "
            f"gradients {p_rel:.3e} (limit {XHAT_PARAM_TOL:.0e}); x-hat "
            f"rounded to bf16 {planted:.3e}; against the plain backward "
            f"{plain:.3e} (limit {ME_PLAIN_TOL[dt]:.0e}), of their norms")


def rms_norm_checks(dev):
    """The RMSNorm forward (#4) and backward (#5) against their plain
    versions: the 345M's rows [8192, 1024] in fp32 and bf16, affine and
    not; the widths of RMSNorm's users, [4096, 4096] and [2048, 8192] in
    bf16; an unaligned width (1000) and a wide one (32768, column partials
    in device memory); the memory-efficient backward of both norms
    (:func:`memory_efficient_checks`). Then each
    timed at [8192, 1024] with its bound, the plain version and the
    library call (``F.rms_norm``; for the backward ``F.rms_norm``'s
    forward and autograd backward together)."""
    g = torch.Generator(device=dev).manual_seed(22)
    errs = {"rms_norm_fwd": [], "rms_norm_bwd": []}
    for rows, hidden, dt, affine in (
            (8192, 1024, torch.float32, True),
            (8192, 1024, torch.bfloat16, True),
            (8192, 1024, torch.float32, False),
            (8192, 1024, torch.bfloat16, False),
            (4096, 4096, torch.bfloat16, True),
            (2048, 8192, torch.bfloat16, True),
            (1000, 1000, torch.float32, True),
            (64, 32768, torch.bfloat16, True)):
        x = (torch.randn(rows, hidden, generator=g, device=dev) * 2
             + 0.5).to(dt)
        w = (torch.randn(hidden, generator=g, device=dev) if affine
             else torch.ones(hidden, device=dev))
        dy = torch.randn(rows, hidden, generator=g, device=dev).to(dt)
        y, rstd = rms_norm_fwd(x, w)
        ry, rrstd = rms_norm_reference(x, w, 1e-5)
        errs["rms_norm_fwd"].append(max(
            check_close(f"rms_norm y [{rows},{hidden}] {dt}", y, ry, dt),
            check_close("rms_norm rstd", rstd, rrstd, torch.float32)))
        dx, dw = rms_norm_bwd(dy, x, rstd, w)
        rdx, rdw = rms_norm_bwd_reference(dy, x, rstd, w)
        errs["rms_norm_bwd"].append(max(
            check_close(f"rms_norm_bwd dx [{rows},{hidden}] {dt}", dx, rdx,
                        dt),
            check_close("rms_norm_bwd dgamma", dw, rdw, None, SUM_TOL)))
        log(f"  rms_norm [{rows},{hidden}] {str(dt)[6:]} "
            f"{'affine' if affine else 'non-affine'}: max abs err "
            f"{errs['rms_norm_fwd'][-1]:.3e} / {errs['rms_norm_bwd'][-1]:.3e}")
    memory_efficient_checks(dev, g)
    rows, hidden = 8192, 1024
    out = []
    for dt in (torch.bfloat16, torch.float32):
        x = torch.randn(rows, hidden, generator=g, device=dev).to(dt)
        w = torch.randn(hidden, generator=g, device=dev)
        dy = torch.randn(rows, hidden, generator=g, device=dev).to(dt)
        _, rstd = rms_norm_fwd(x, w)
        es = x.element_size()
        xl = x.clone().requires_grad_(True)
        wl = w.to(dt).requires_grad_(True)
        yl = F.rms_norm(xl, (hidden,), wl, 1e-5)

        def lib_bwd():
            return torch.autograd.grad(yl, (xl, wl), dy, retain_graph=True)
        fwd = _kernel_timing(
            lambda: rms_norm_fwd(x, w), lambda: rms_norm_reference(x, w,
                                                                   1e-5),
            lambda: F.rms_norm(x, (hidden,), w.to(dt), 1e-5),
            "rms_fwd_kernel", 2 * x.numel() * es + hidden * 4 + rows * 4,
            4 * x.numel())
        bwd = _kernel_timing(
            lambda: rms_norm_bwd(dy, x, rstd, w),
            lambda: rms_norm_bwd_reference(dy, x, rstd, w), None,
            "norm_bwd_", 3 * x.numel() * es + rows * 4 + 2 * hidden * 4,
            10 * x.numel())
        # the library yardstick of the backward: the device time of every
        # kernel of F.rms_norm's backward (a retained graph)
        lib_call, bwd["library_ms"] = _library_bwd_ms(
            lib_bwd, "", f"F.rms_norm backward {str(dt)[6:]}")
        for name, t in (("rms_norm_fwd", fwd), ("rms_norm_bwd", bwd)):
            lib = (f"{t['library_ms']:.4f} ms" if name == "rms_norm_fwd"
                   else f"backward {lib_call:.4f} ms (device "
                        f"{t['library_ms']} ms)")
            log(f"  {name} [{rows},{hidden}] {str(dt)[6:]}: kernel "
                f"{t['ms']:.4f} ms (device {t['device_ms']} ms), plain "
                f"{t['plain_ms']:.4f} ms, F.rms_norm {lib}, bound "
                f"{t['bound_ms']:.4f} ms ({t['bound_by']})")
        if dt == torch.bfloat16:
            out = [{"name": "rms_norm_fwd", "route": "cuda",
                    "source": "apex_tpu_torch/csrc/layer_norm.cu",
                    "replaces": "apex_tpu/ops/layer_norm.py:240",
                    "max_abs_err": max(errs["rms_norm_fwd"]), **fwd},
                   {"name": "rms_norm_bwd", "route": "cuda",
                    "source": "apex_tpu_torch/csrc/layer_norm.cu",
                    "replaces": "apex_tpu/ops/layer_norm.py:261",
                    "max_abs_err": max(errs["rms_norm_bwd"]), **bwd}]
    return out


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
    345M training shape in bf16 (the tensor-core kernels) and fp32 (the
    CUDA-core kernels), a key-padding mask with a fully masked batch row,
    hash dropout 0.1, a length that is not a whole number of tiles, and a
    non-causal cross shape; the bf16 backward run twice must give the same
    bits (two launches, no atomics); both timed at the 345M shape."""
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
            again = flash_attention_bwd(q, k, v, o, lse, do, **kw)
            if not all(torch.equal(x, y) for x, y in zip((dq, dk, dv),
                                                          again)):
                raise AssertionError("flash_bwd: two runs on the same "
                                     "inputs differ")
            log("  flash_bwd 345M bf16: two runs bitwise equal")
            timing = _flash_timing(q, k, v, do, o, lse, causal)
    # the main path runs bf16: the tensor-core kernels
    return ({"name": "flash_attn_fwd", "route": "cuda",
             "source": "apex_tpu_torch/csrc/flash_attention_bf16.cu",
             "replaces": "apex_tpu/ops/flash_attention.py:390",
             "max_abs_err": max(fwd_errs), **timing["fwd"]},
            {"name": "flash_attn_bwd", "route": "cuda",
             "source": "apex_tpu_torch/csrc/flash_attention_bf16.cu",
             "replaces": "apex_tpu/ops/flash_attention.py:673",
             "max_abs_err": max(bwd_errs), **timing["bwd"]})


#: flash attention at the other instantiated head dims, and the bf16
#: tensor-core kernels' ragged, cross, masked and dropout tiles at every
#: head dim: (name, b, n, s_q, s_k, d, dtype, causal, masked, dropout p).
#: [8, 8, 1024, 128] is a GPT of hidden 1024 with 8 heads, [8, 32, 1024,
#: 32] one with 32 heads
FLASH_HEAD_DIM_CASES = (
    ("d 128 bf16 causal", 8, 8, 1024, 1024, 128, torch.bfloat16, True,
     False, 0.0),
    ("d 32 bf16 causal", 8, 32, 1024, 1024, 32, torch.bfloat16, True,
     False, 0.0),
    ("d 128 bf16 kv_mask, dead row", 2, 8, 512, 512, 128, torch.bfloat16,
     False, True, 0.0),
    ("d 32 bf16 causal kv_mask", 2, 32, 512, 512, 32, torch.bfloat16, True,
     True, 0.0),
    ("d 96 f32 causal, s 1000", 2, 8, 1000, 1000, 96, torch.float32, True,
     False, 0.0),
    ("d 256 bf16 causal", 4, 4, 1024, 1024, 256, torch.bfloat16, True,
     False, 0.0),
    ("d 256 f32 kv_mask, dead row, s 300", 2, 4, 300, 300, 256,
     torch.float32, False, True, 0.0),
    *((f"d {d} bf16 causal, s {s}", 2, 4, s, s, d, torch.bfloat16, True,
       False, 0.0) for d in (32, 64, 96, 128, 256) for s in (1000, 17)),
    ("d 64 bf16 causal cross 320x1000", 2, 4, 320, 1000, 64,
     torch.bfloat16, True, False, 0.0),
    ("d 128 bf16 causal cross 320x1000", 2, 4, 320, 1000, 128,
     torch.bfloat16, True, False, 0.0),
    ("d 256 bf16 kv_mask, dead row, s 300", 2, 4, 300, 300, 256,
     torch.bfloat16, False, True, 0.0),
    ("d 128 bf16 causal, dropout 0.1", 2, 8, 1024, 1024, 128,
     torch.bfloat16, True, False, 0.1),
)


def flash_head_dim_checks(dev):
    """Forward and backward kernels against their plain versions at every
    head dim (``FLASH_HEAD_DIM_CASES``), with a fully masked batch row
    under each key-padding mask (o, dq, dk, dv exactly 0, lse exactly
    -1e30); then both timed at ``[8, 8, 1024, 128]`` bf16 causal. Returns
    the worst forward and backward errors."""
    g = torch.Generator(device=dev).manual_seed(12)
    fwd_errs, bwd_errs = [], []
    for name, b, n, s_q, s_k, d, dt, causal, masked, p in \
            FLASH_HEAD_DIM_CASES:
        q, k, v, do = _attn_case(g, dev, b, n, s_q, s_k, d, dt)
        kv_mask = None
        if masked:
            kv_mask = torch.ones(b, s_k, dtype=torch.bool, device=dev)
            kv_mask[0, s_k // 2:] = False
            kv_mask[1, :] = False
        kw = dict(causal=causal, kv_mask=kv_mask, dropout_p=p,
                  dropout_seed=-4321 if p else None)
        o, lse = flash_attention_fwd(q, k, v, **kw)
        dq, dk, dv = flash_attention_bwd(q, k, v, o, lse, do, **kw)
        ro, rlse = flash_attention_fwd_reference(q, k, v, **kw)
        rdq, rdk, rdv = flash_attention_bwd_reference(q, k, v, ro, rlse, do,
                                                      **kw)
        fe = max(check_close(f"flash_fwd {name} o", o, ro, dt),
                 check_close(f"flash_fwd {name} lse", lse, rlse,
                             torch.float32))
        be = max(check_close(f"flash_bwd {name} {gname}", got, want, dt)
                 for gname, got, want in (("dq", dq, rdq), ("dk", dk, rdk),
                                          ("dv", dv, rdv)))
        if masked and (any(float(x[1].abs().max()) != 0.0
                           for x in (o, dq, dk, dv))
                       or not bool((lse[1] == -1e30).all())):
            raise AssertionError(f"flash {name}: the fully masked row is "
                                 f"not zero")
        fwd_errs.append(fe)
        bwd_errs.append(be)
        log(f"  flash {name} [{b},{n},{s_q}x{s_k},{d}]: fwd max abs err "
            f"{fe:.3e}, bwd {be:.3e}")
        if name == "d 128 bf16 causal":
            _flash_timing(q, k, v, do, o, lse, causal)
        del q, k, v, do, o, lse, dq, dk, dv, ro, rlse, rdq, rdk, rdv
    return max(fwd_errs), max(bwd_errs)


def _flash_timing(q, k, v, do, o, lse, causal):
    """Forward and backward at the given inputs: call and device time of
    the kernels, call time of their plain versions, call and device time
    of SDPA's forward and of its backward alone (a retained graph,
    ``torch.autograd.grad`` only inside the timed call; its forward and
    backward together are printed beside it), the bound and the share of
    it reached. The library time is SDPA's device time: the host's
    autograd call around its backward takes longer than the card does,
    so the call time measures the host."""
    b, n, s, d = q.shape
    elem = q.element_size()
    flops = _attn_flops(b, n, s, s, d, causal)
    kw = dict(causal=causal)
    tc = q.dtype == torch.bfloat16  # the tensor-core kernels' names
    fwd_match = "flash_fwd_tc_kernel" if tc else "flash_fwd_kernel"
    bwd_match = (("flash_bwd_dq_tc_kernel", "flash_bwd_dkv_tc_kernel") if tc
                 else ("flash_bwd_dq_kernel", "flash_bwd_dkv_kernel"))
    fwd_ms = time_ms(lambda: flash_attention_fwd(q, k, v, **kw), iters=20)
    fwd_dev = device_ms(lambda: flash_attention_fwd(q, k, v, **kw),
                        fwd_match, iters=10)
    fwd_plain = time_ms(
        lambda: flash_attention_fwd_reference(q, k, v, **kw), iters=5)
    def sdpa_fwd():
        return F.scaled_dot_product_attention(q, k, v, is_causal=causal)
    fwd_lib = time_ms(sdpa_fwd, iters=20)
    fwd_lib_dev = device_ms(sdpa_fwd, "", iters=10)
    fb, fby = bound(4 * q.numel() * elem + b * n * s * 4, flops,
                    BF16_TC_FLOPS)

    def bwd():
        return flash_attention_bwd(q, k, v, o, lse, do, **kw)
    bwd_ms = time_ms(bwd, iters=10)
    bwd_dev = device_ms(bwd, bwd_match, iters=5)
    split = [device_ms(bwd, m, iters=5) for m in bwd_match]
    bwd_plain = time_ms(lambda: flash_attention_bwd_reference(
        q, k, v, o, lse, do, **kw), iters=3)
    ql, kl, vl = (t.clone().requires_grad_(True) for t in (q, k, v))

    def sdpa_fwd_bwd():
        out = F.scaled_dot_product_attention(ql, kl, vl, is_causal=causal)
        return torch.autograd.grad(out, (ql, kl, vl), do)
    sdpa_fb = time_ms(sdpa_fwd_bwd, iters=10)
    out = F.scaled_dot_product_attention(ql, kl, vl, is_causal=causal)

    def sdpa_bwd():
        return torch.autograd.grad(out, (ql, kl, vl), do, retain_graph=True)
    sdpa_b = time_ms(sdpa_bwd, iters=10)
    sdpa_b_dev = device_ms(sdpa_bwd, "", iters=10)
    del out
    # backward: 5 products per pair (s, dp, dv, dk, dq) against the
    # forward's 2; reads q, k, v, o, do, lse, writes dq, dk, dv
    bb, bby = bound(8 * q.numel() * elem + b * n * s * 4, flops * 5 / 2,
                    BF16_TC_FLOPS)
    fshare = fb / fwd_dev if fwd_dev else None
    bshare = bb / bwd_dev if bwd_dev else None
    log(f"  flash [{b},{n},{s},{d}] {str(q.dtype)[6:]} causal={causal}: fwd "
        f"kernel {fwd_ms:.4f} ms (device {fwd_dev} ms), plain "
        f"{fwd_plain:.4f} ms, sdpa fwd {fwd_lib:.4f} ms (device "
        f"{fwd_lib_dev} ms), bound {fb:.4f} ms "
        f"({fby}), share of bound {fshare}; bwd kernel {bwd_ms:.4f} ms "
        f"(device {bwd_dev} ms: dq {split[0]}, dk/dv {split[1]}), plain "
        f"{bwd_plain:.4f} ms, sdpa bwd {sdpa_b:.4f} ms (device "
        f"{sdpa_b_dev} ms; fwd+bwd {sdpa_fb:.4f} ms), bound {bb:.4f} ms "
        f"({bby}), share of bound {bshare}")
    return {"fwd": {"ms": fwd_ms, "device_ms": fwd_dev,
                    "plain_ms": fwd_plain, "library_ms": fwd_lib_dev,
                    "bound_ms": fb, "bound_by": fby},
            "bwd": {"ms": bwd_ms, "device_ms": bwd_dev,
                    "plain_ms": bwd_plain, "library_ms": sdpa_b_dev,
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
    # name, rows, hidden, fc1 width, dtype, dropout p, seed
    ("345M bf16", 8192, HIDDEN, 4 * HIDDEN, torch.bfloat16, 0.0, None),
    ("345M f32", 8192, HIDDEN, 4 * HIDDEN, torch.float32, 0.0, None),
    ("345M bf16 dropout 0.1, negative seed", 8192, HIDDEN, 4 * HIDDEN,
     torch.bfloat16, 0.1, -1234567),
    ("1000 rows f32 dropout 0.1", 1000, HIDDEN, 4 * HIDDEN, torch.float32,
     0.1, 99),
    # widths past one block's span (the hidden sizes of 13B- and
    # 70B-parameter decoders, 5120 and 8192, and 16384) and a width that is
    # not a multiple of 8
    ("width 5120 bf16", 2048, 5120, 5120, torch.bfloat16, 0.0, None),
    ("width 8192 bf16 dropout 0.1", 1024, 8192, 8192, torch.bfloat16, 0.1,
     77),
    ("width 8192 f32", 1024, 8192, 8192, torch.float32, 0.0, None),
    ("width 16384 f32", 256, 16384, 16384, torch.float32, 0.0, None),
    ("width 1000 bf16", 512, 1000, 1000, torch.bfloat16, 0.0, None),
    ("width 1000 f32 dropout 0.1, 999 rows", 999, 1000, 1000, torch.float32,
     0.1, -5),
)


def fused_block_checks(dev):
    """The six fused-tail kernels (#8-#13) against their plain versions
    at the 345M train shapes: bias-GeLU at ``[8192, 4096]`` (the fc1
    output), bias-dropout-residual and residual-add-LayerNorm at
    ``[8192, 1024]``; fp32 and bf16, dropout 0 and 0.1 with a negative
    seed, a row count no block size divides; at widths 5120 to 16384 and
    1000 (``FUSED_CASES``); then each kernel timed at the bf16 headline
    shape (dropout 0)."""
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

    for name, rows, H, F4, dt, p, seed in FUSED_CASES:
        # bias-GeLU at the fc1 width
        x, dy = t(rows, F4, dt), t(rows, F4, dt)
        b = vec(F4, 0.1)
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
        x, r, dy, ds = (t(rows, H, dt) for _ in range(4))
        b, lb, w = vec(H, 0.1), vec(H, 0.1), vec(H, 0.2, 1.0)
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
        log(f"  fused block {name} [{rows},{H}] / [{rows},{F4}]: max abs "
            f"err " + ", ".join(
                f"{k} {v[-1]:.3e}" for k, v in errs.items()))
        del x, r, dy, ds, out, dx, rout, rdx, s_, y_, ref, got, want
    rows_out = []
    for rec in _fused_timing(dev, g):
        rec["max_abs_err"] = max(errs[rec["name"]])
        rows_out.append(rec)
    return rows_out


def _fused_timing(dev, g, R: int = 8192):
    """Call, device, plain and (for the GeLU and the LayerNorm tails,
    partial) library times of the six kernels at the bf16 headline shapes
    (``R`` rows), each beside its byte bound: every input read once, every
    output written once."""
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

    # partial yardsticks: the GeLU of a biased input and its backward
    # without the bias gradient's column sum (the bias added beforehand);
    # F.layer_norm of a sum added beforehand for the LayerNorm tail (the
    # add and the dropout are not timed)
    biased = _rotating([(x + b4, dy) for x, dy in [ge() for _ in range(2)]])
    sums = _rotating([x + r for x, r, _, _ in [hs() for _ in range(4)]])
    xl = (hs()[0] + hs()[1]).requires_grad_(True)
    wl, bl = (v.clone().requires_grad_(True) for v in (w1, lb1))
    yl = F.layer_norm(xl, (H,), wl, bl, 1e-5)
    dyl = hs()[2]
    table = [
        ("bias_gelu_fwd", lambda: fb._bias_gelu_fwd_impl(ge()[0], b4),
         lambda: fb.bias_gelu_reference(ge()[0], b4),
         "bias_gelu_fwd_kernel",
         lambda: F.gelu(biased()[0], approximate="tanh"),
         2 * R * F4 * e + F4 * e,
         20 * R * F4, "ops/fused_block.py:193"),
        ("bias_gelu_bwd", lambda: fb._bias_gelu_bwd(*ge()[::-1], b4),
         lambda: fb.bias_gelu_bwd_reference(*ge()[::-1], b4),
         ("bias_gelu_bwd_kernel", "col_sum_kernel"),
         lambda: torch.ops.aten.gelu_backward(*biased()[::-1],
                                              approximate="tanh"),
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


def param_shapes(vocab: int, max_pos: int, dtype):
    """The 24 x 1024 parameter tree (16 leaves) as meta tensors (shapes
    and dtypes, no memory): the layout the packed optimizers sweep."""
    cfg = GPTConfig(num_layers=24, hidden_size=HIDDEN,
                    num_attention_heads=N_HEADS, vocab_size=vocab,
                    max_position_embeddings=max_pos)
    h, L, v, f = cfg.hidden_size, cfg.num_layers, cfg.vocab_size, \
        cfg.ffn_size

    def m(*shape):
        return torch.empty(shape, dtype=dtype, device="meta")
    return {"embedding": {"word": m(v, h), "position": m(max_pos, h)},
            "layers": {"input_ln_w": m(L, h), "input_ln_b": m(L, h),
                       "qkv_w": m(L, 3 * h, h), "qkv_b": m(L, 3 * h),
                       "proj_w": m(L, h, h), "proj_b": m(L, h),
                       "post_ln_w": m(L, h), "post_ln_b": m(L, h),
                       "fc1_w": m(L, f, h), "fc1_b": m(L, f),
                       "fc2_w": m(L, h, f), "fc2_b": m(L, h)},
            "final_ln_w": m(h), "final_ln_b": m(h)}


def gpt345m_param_shapes(dtype=torch.bfloat16):
    """GPT-2 345M's tree: what the packed Adam and SGD sweeps update."""
    return param_shapes(50304, 1024, dtype)


def bert_large_param_shapes(dtype=torch.float32):
    """BERT-large's tree as the BERT legs train it (no binary head):
    what the packed LAMB sweeps update."""
    return param_shapes(BERT_VOCAB, 512, dtype)


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


#: the row sums of the packed LAMB kernels against their plain versions:
#: 1024 terms summed in another order move a sum by ~1e-7 relative; one
#: term missing moves it by ~1e-3, a wrong row by far more. Their
#: elementwise results are held to ``ADAM_TOL``: products and sums round
#: as the plain versions' do, bit for bit, but PyTorch's CUDA division
#: may put LAMB's quotients an ulp apart (H100 80GB HBM3, 700 W: up to
#: 1e-6 relative where beta1 * m + beta3 * g cancels)
ROW_SUM_TOL = (0.0, 1e-5)


def _kernel_timing(run, plain, library, match, nbytes, flops):
    """Call ms (CUDA events), device ms (profiler), plain ms, library ms
    (or None) and the bound of one sweep."""
    b_ms, by = bound(nbytes, flops)
    return {"ms": time_ms(run, iters=20), "device_ms": device_ms(
        run, match, iters=10), "plain_ms": time_ms(plain, iters=3),
        "library_ms": None if library is None else time_ms(library,
                                                           iters=20),
        "bound_ms": b_ms, "bound_by": by}


def packed_lamb_checks(dev):
    """The three packed LAMB kernels over a flat buffer of BERT-large's
    PackSpec, fp32 gradients and params as on the path (no masters):
    the row reduce in ``sqsum`` and ``maxabs`` over fp32 and bf16; stage
    1 with AdamW decay (the path), without decay, in L2 mode, over bf16
    gradients and under ``noop`` (m and v bitwise unchanged); the scale
    update as on the path, into bf16 params with an fp32 master, and
    under ``noop``. Then each timed as on the path."""
    spec = PackSpec(bert_large_param_shapes())
    n, rows = spec.total, spec.n_rows
    g = torch.Generator(device=dev).manual_seed(8)
    grad = torch.randn(n, generator=g, device=dev) * 1e-3
    m0 = torch.randn(n, generator=g, device=dev) * 1e-4
    v0 = torch.rand(n, generator=g, device=dev) * 1e-8
    src0 = torch.randn(n, generator=g, device=dev) * 0.02
    coef = torch.rand(rows, generator=g, device=dev) * 2
    inv = torch.tensor(0.5, device=dev)
    lr = torch.tensor(1e-3, device=dev)
    noop = torch.tensor(True, device=dev)
    errs = {"packed_row_reduce": [], "packed_lamb_stage1": [],
            "packed_scale_update": []}
    for op in ("sqsum", "maxabs"):
        for dt in (torch.float32, torch.bfloat16):
            x = grad.to(dt)
            got = packed_row_reduce(x, op=op, inv_scale=inv)
            want = packed_row_reduce_reference(x, op=op, inv_scale=inv)
            if op == "maxabs":
                if not torch.equal(got, want):
                    raise AssertionError(f"packed_row_reduce maxabs {dt}: "
                                         f"not the plain version's bits")
                err = 0.0
            else:
                err = check_close(f"packed_row_reduce {op} {dt}", got, want,
                                  None, ROW_SUM_TOL)
            errs["packed_row_reduce"].append(err)
            log(f"  packed_row_reduce {op} {dt} over {n} elements: max abs "
                f"err {err:.3e}")
    hyper = dict(clip=torch.tensor(1.3, device=dev),
                 bc1=torch.tensor(0.19, device=dev),
                 bc2=torch.tensor(0.002, device=dev), inv_scale=inv,
                 beta1=0.9, beta2=0.999, beta3=0.1, eps=1e-6)
    path = dict(wd=0.01)
    for name, kw, dt in (("adamw wd 0.01 (the path)", path, torch.float32),
                         ("no weight decay", dict(wd=0.0), torch.float32),
                         ("adam l2 wd 0.01", dict(wd=0.01,
                                                  adam_w_mode=False),
                          torch.float32),
                         ("bf16 grads", path, torch.bfloat16),
                         ("noop", dict(wd=0.01, noop=noop), torch.float32)):
        m, v = m0.clone(), v0.clone()
        x = grad.to(dt)
        u, _, _, ru, rp = packed_lamb_stage1(x, m, v, src0, **hyper, **kw)
        ref = packed_lamb_stage1_reference(x, m0, v0, src0, **hyper, **kw)
        f32 = ADAM_TOL[torch.float32]
        err = check_close(f"packed_lamb_stage1 {name} u", u, ref[0], None,
                          f32)
        if name == "noop":
            if not (torch.equal(m, m0) and torch.equal(v, v0)):
                raise AssertionError("packed_lamb_stage1 noop wrote m/v")
        else:
            err = max(err, check_close(f"packed_lamb_stage1 {name} m", m,
                                       ref[1], None, f32),
                      check_close(f"packed_lamb_stage1 {name} v", v, ref[2],
                                  None, f32))
        err = max(err, check_close(f"packed_lamb_stage1 {name} row u^2", ru,
                                   ref[3], None, ROW_SUM_TOL),
                  check_close(f"packed_lamb_stage1 {name} row p^2", rp,
                              ref[4], None, ROW_SUM_TOL))
        errs["packed_lamb_stage1"].append(err)
        log(f"  packed_lamb_stage1 {name} over {n} elements: max abs err "
            f"{err:.3e}")
        del ref, m, v
    u = packed_lamb_stage1_reference(grad, m0, v0, src0, **hyper,
                                     **path)[0]
    for name, dt, master, nf in (
            ("fp32 params, no master (the path)", torch.float32, False,
             None),
            ("bf16 params, fp32 master", torch.bfloat16, True, None),
            ("noop", torch.bfloat16, True, noop)):
        src = src0.clone()
        p_out, _ = packed_scale_update(u, src, coef, param_dtype=dt, lr=lr,
                                       noop=nf, write_master=master)
        want_p, want_m = packed_scale_update_reference(
            u, src0, coef, param_dtype=dt, lr=lr, noop=nf)
        err = check_close(f"packed_scale_update {name} p_out", p_out,
                          want_p, None, ADAM_TOL[dt])
        if master and nf is None:
            err = max(err, check_close(f"packed_scale_update {name} master",
                                       src, want_m, None,
                                       ADAM_TOL[torch.float32]))
        elif not torch.equal(src, src0):
            raise AssertionError(f"packed_scale_update {name} wrote the "
                                 f"master")
        if nf is not None and not torch.equal(p_out, src0.to(dt)):
            raise AssertionError("packed_scale_update noop: p_out is not "
                                 "the recast source")
        errs["packed_scale_update"].append(err)
        log(f"  packed_scale_update {name} over {n} elements: max abs err "
            f"{err:.3e}")
        del src, p_out, want_p, want_m
    m, v = m0.clone(), v0.clone()
    timings = {
        # fp32 gradient read, one fp32 partial a row written
        "packed_row_reduce": _kernel_timing(
            lambda: packed_row_reduce(grad, inv_scale=inv),
            lambda: packed_row_reduce_reference(grad, inv_scale=inv),
            lambda: torch.linalg.vector_norm(grad.view(-1, 1024), dim=1),
            "row_reduce_kernel", 4 * n + 4 * rows, 3 * n),
        # g, m, v, src read; u, m, v written; two partials a row
        "packed_lamb_stage1": _kernel_timing(
            lambda: packed_lamb_stage1(grad, m, v, src0, **hyper, **path),
            lambda: packed_lamb_stage1_reference(grad, m0, v0, src0,
                                                 **hyper, **path),
            None, "lamb_stage1_kernel", 28 * n + 8 * rows, 20 * n),
        # u, src and a coefficient a row read; fp32 params written
        "packed_scale_update": _kernel_timing(
            lambda: packed_scale_update(u, src0, coef,
                                        param_dtype=torch.float32, lr=lr,
                                        write_master=False),
            lambda: packed_scale_update_reference(
                u, src0, coef, param_dtype=torch.float32, lr=lr),
            # one call of the same product and order: src + (-lr * c) * u
            lambda: torch.addcmul(src0.view(-1, 1024), coef[:, None],
                                  u.view(-1, 1024), value=-1e-3),
            "scale_update_kernel", 12 * n + 4 * rows, 2 * n)}
    out = []
    for name, line in (("packed_row_reduce", 611), ("packed_lamb_stage1", 395),
                       ("packed_scale_update", 479)):
        t = timings[name]
        log(f"  {name} BERT-large flat buffer ({n} elements, fp32): kernel "
            f"{t['ms']:.4f} ms (device {t['device_ms']} ms), plain "
            f"{t['plain_ms']:.4f} ms, library {t['library_ms']} ms, bound "
            f"{t['bound_ms']:.4f} ms ({t['bound_by']})")
        out.append({"name": name, "route": "cuda",
                    "source": "apex_tpu_torch/csrc/packed_lamb.cu",
                    "replaces": f"apex_tpu/ops/packed_optimizer.py:{line}",
                    "max_abs_err": max(errs[name]), **t})
    log(f"  sum of the three kernels' bounds: "
        f"{sum(t['bound_ms'] for t in timings.values()):.4f} ms; of their "
        f"device times: {sum(t['device_ms'] or 0 for t in timings.values())}"
        f" ms")
    return out


def packed_sgd_checks(dev):
    """The packed SGD sweep over a flat buffer of the 345M PackSpec's
    size, bf16 gradients and params over fp32 masters as on the path:
    momentum 0 and 0.9 with weight decay (the path), nesterov, decay
    after the momentum with dampening, the first run (the buffer becomes
    the gradient) and noop (every state buffer bitwise unchanged)."""
    spec = PackSpec(gpt345m_param_shapes())
    n = spec.total
    g = torch.Generator(device=dev).manual_seed(9)
    grad = (torch.randn(n, generator=g, device=dev) * 1e-3).to(
        torch.bfloat16)
    buf0 = torch.randn(n, generator=g, device=dev) * 1e-3
    src0 = torch.randn(n, generator=g, device=dev) * 0.02
    hyper = dict(param_dtype=torch.bfloat16,
                 lr=torch.tensor(SGD_LR, device=dev),
                 inv_scale=torch.tensor(0.5, device=dev))
    no, yes = (torch.tensor(b, device=dev) for b in (False, True))
    path = dict(momentum=0.9, wd=1e-4, first_run=no)
    errs = []
    for name, kw in (("momentum 0", dict(first_run=no)),
                     ("momentum 0.9, wd 1e-4 (the path)", path),
                     ("nesterov", dict(path, nesterov=True)),
                     ("wd after momentum, dampening 0.1",
                      dict(path, dampening=0.1, wd_after_momentum=True)),
                     ("first run", dict(path, first_run=yes)),
                     ("noop", dict(path, noop=yes))):
        buf, src = buf0.clone(), src0.clone()
        p_out, _, _ = packed_sgd_apply(grad, buf, src, **hyper, **kw)
        want_p, want_b, want_m = packed_sgd_reference(grad, buf0, src0,
                                                      **hyper, **kw)
        err = check_close(f"packed_sgd {name} p_out", p_out, want_p, None,
                          ADAM_TOL[torch.bfloat16])
        if name == "noop":
            if not (torch.equal(buf, buf0) and torch.equal(src, src0)
                    and torch.equal(p_out, src0.to(torch.bfloat16))):
                raise AssertionError("packed_sgd noop changed its inputs")
        else:
            err = max(err, *(check_close(f"packed_sgd {name} {sn}", got,
                                         want, None, ADAM_TOL[torch.float32])
                             for sn, got, want in (("buf", buf, want_b),
                                                   ("master", src, want_m))))
        errs.append(err)
        log(f"  packed_sgd {name} over {n} elements: max abs err {err:.3e}")
        del buf, src, p_out, want_p, want_b, want_m
    buf, src = buf0.clone(), src0.clone()
    p = torch.nn.Parameter(src0.clone())
    p.grad = grad.float()
    lib_opt = torch.optim.SGD([p], lr=SGD_LR, momentum=0.9,
                              weight_decay=1e-4, fused=True)
    # bf16 grad read + bf16 param write + buffer and master read and
    # written
    t = _kernel_timing(
        lambda: packed_sgd_apply(grad, buf, src, **hyper, **path),
        lambda: packed_sgd_reference(grad, buf0, src0, **hyper, **path),
        lib_opt.step, "packed_sgd_kernel", n * (2 + 2 + 2 * 8), 8 * n)
    del p, lib_opt, buf, src
    log(f"  packed_sgd 345M flat buffer ({n} elements, bf16 grads and "
        f"params): kernel {t['ms']:.4f} ms (device {t['device_ms']} ms), "
        f"plain {t['plain_ms']:.4f} ms, SGD(fused=True) "
        f"{t['library_ms']:.4f} ms, bound {t['bound_ms']:.4f} ms "
        f"({t['bound_by']})")
    return {"name": "packed_sgd", "route": "cuda",
            "source": "apex_tpu_torch/csrc/packed_sgd.cu",
            "replaces": "apex_tpu/ops/packed_optimizer.py:292",
            "max_abs_err": max(errs), **t}


def packed_flat_checks(dev):
    """``multi_tensor_scale_flat`` (#24) and ``multi_tensor_axpby_flat``
    (#25) over a flat buffer of the 345M PackSpec's size: the scale
    bf16 -> fp32 with per-row flags (the loss scaler's unscale on the
    path), fp32 -> fp32 and fp32 -> bf16; per-row flags with an inf, a
    nan and an overflow of the product planted in three known rows, which
    the flags must name exactly; a length that is not a whole number of
    rows; axpby in fp32 and bf16 with and without a planted inf. The
    scale is one fp32 multiply and one cast in both versions, so it is
    held bit for bit; axpby rounds its products and sum one by one
    (``__fmul_rn``/``__fadd_rn`` against three PyTorch ops), held to
    ``ADAM_TOL``. Then each timed, with its bound and one library
    call."""
    spec = PackSpec(gpt345m_param_shapes())
    n, rows = spec.total, spec.n_rows
    g = torch.Generator(device=dev).manual_seed(13)
    x32 = torch.randn(n, generator=g, device=dev) * 1e3
    inv = torch.tensor(1.0 / 1024, device=dev)
    errs = {"scale_flat": [0.0], "axpby_flat": []}
    for name, x, out_dt, rowf in (
            ("bf16 -> fp32, row flags (the path)", x32.to(torch.bfloat16),
             torch.float32, True),
            ("fp32 -> fp32", x32, torch.float32, False),
            ("fp32 -> bf16, row flags", x32, torch.bfloat16, True),
            ("ragged length, bf16 -> fp32", x32[:n - 1000 - 3].to(
                torch.bfloat16), torch.float32, True)):
        got = multi_tensor_scale_flat(x, inv, out_dt, per_row_flags=rowf)
        want = multi_tensor_scale_flat_reference(x, inv, out_dt,
                                                 per_row_flags=rowf)
        if not torch.equal(got[0], want[0]) or got[0].dtype != out_dt:
            raise AssertionError(f"scale_flat {name}: not the plain "
                                 f"version's bits")
        if bool(got[1]) or bool(want[1]):
            raise AssertionError(f"scale_flat {name}: a finite buffer "
                                 f"flagged")
        if rowf and not (torch.equal(got[2], want[2])
                         and got[2].shape == (-(-x.numel() // 1024),)):
            raise AssertionError(f"scale_flat {name}: row flags differ")
        log(f"  scale_flat {name} over {x.numel()} elements: bit for bit")
        del got, want, x
    bad_rows = [7, rows // 2, rows - 1]
    xp = x32.to(torch.bfloat16)
    xp[bad_rows[0] * 1024 + 5] = float("inf")
    xp[bad_rows[1] * 1024 + 1000] = float("nan")
    xp[bad_rows[2] * 1024 + 3] = 3e38  # finite; 4 x 3e38 is not
    out, found, row_bad = multi_tensor_scale_flat(xp, 4.0, torch.float32,
                                                  per_row_flags=True)
    named = torch.nonzero(row_bad).flatten().tolist()
    if named != bad_rows or not bool(found):
        raise AssertionError(f"scale_flat row flags name rows {named}, "
                             f"planted {bad_rows}")
    _, found = multi_tensor_scale_flat(xp, 4.0)
    if not bool(found):
        raise AssertionError("scale_flat: found_inf not set")
    log(f"  scale_flat planted inf, nan, overflow: the flags name rows "
        f"{named} exactly")
    del xp, out, row_bad
    y32 = torch.randn(n, generator=g, device=dev)
    a = torch.tensor(0.5, device=dev)
    for dt in (torch.float32, torch.bfloat16):
        x, y = x32.to(dt), y32.to(dt, copy=True)  # y gets an inf below
        out, found = multi_tensor_axpby_flat(a, -2.0, x, y)
        want, wfound = multi_tensor_axpby_flat_reference(a, -2.0, x, y)
        err = check_close(f"axpby_flat {dt}", out, want, None, ADAM_TOL[dt])
        if bool(found) or bool(wfound):
            raise AssertionError(f"axpby_flat {dt}: a finite sum flagged")
        y[n - 1] = float("inf")
        _, found = multi_tensor_axpby_flat(a, -2.0, x, y)
        if not bool(found):
            raise AssertionError(f"axpby_flat {dt}: the planted inf missed")
        errs["axpby_flat"].append(err)
        log(f"  axpby_flat {dt} over {n} elements: max abs err {err:.3e}, "
            f"planted inf flagged")
        del x, y, out, want
    xb = x32.to(torch.bfloat16)
    lib_buf = x32.clone()
    lib_found = torch.zeros(1, device=dev)
    one = torch.ones(1, device=dev)
    timings = {
        # bf16 read, fp32 written, a flag byte a row
        "scale_flat": _kernel_timing(
            lambda: multi_tensor_scale_flat(xb, inv, torch.float32,
                                            per_row_flags=True),
            lambda: multi_tensor_scale_flat_reference(
                xb, inv, torch.float32, per_row_flags=True),
            # in place on the fp32 buffer; scale 1 keeps its values over
            # the repeated calls
            lambda: torch._amp_foreach_non_finite_check_and_unscale_(
                [lib_buf], lib_found, one),
            "flat_kernel", 6 * n + rows, 2 * n),
        # x, y read and out written in fp32
        "axpby_flat": _kernel_timing(
            lambda: multi_tensor_axpby_flat(a, -2.0, x32, y32),
            lambda: multi_tensor_axpby_flat_reference(a, -2.0, x32, y32),
            lambda: torch.add(y32, x32, alpha=0.5),  # partial: no flag
            "flat_kernel", 12 * n, 4 * n)}
    f32 = time_ms(lambda: multi_tensor_scale_flat(x32, inv), iters=20)
    f32_bound = bound(8 * n, 2 * n)[0]
    bf = x32.to(torch.bfloat16), y32.to(torch.bfloat16)
    axb = time_ms(lambda: multi_tensor_axpby_flat(a, -2.0, *bf), iters=20)
    axb_bound = bound(6 * n, 4 * n)[0]
    out = []
    for name, line in (("scale_flat", 739), ("axpby_flat", 813)):
        t = timings[name]
        log(f"  {name} 345M flat buffer ({n} elements, "
            f"{'bf16 -> fp32' if name == 'scale_flat' else 'fp32'}): kernel "
            f"{t['ms']:.4f} ms (device {t['device_ms']} ms), plain "
            f"{t['plain_ms']:.4f} ms, library {t['library_ms']:.4f} ms, "
            f"bound {t['bound_ms']:.4f} ms ({t['bound_by']})")
        out.append({"name": name, "route": "cuda",
                    "source": "apex_tpu_torch/csrc/packed_flat.cu",
                    "replaces": f"apex_tpu/ops/packed_optimizer.py:{line}",
                    "max_abs_err": max(errs[name]), **t})
    log(f"  scale_flat fp32 -> fp32: kernel {f32:.4f} ms, bound "
        f"{f32_bound:.4f} ms; axpby_flat bf16: kernel {axb:.4f} ms, bound "
        f"{axb_bound:.4f} ms")
    return out


def packed_row_stats_checks(dev):
    """``packed_row_stats`` (#23) over a flat buffer of the 345M
    PackSpec's size: bf16 with ``inv_scale`` a device scalar (the
    monitored leg's observation of the packed gradients), fp32, and a
    length that is not a whole number of rows; an inf, a nan and a -inf
    planted in three known rows, where the counts must be exact (0
    elsewhere) and the sums and maxima inf or nan. The maxima and counts
    are held bit for bit, the sums (another order of the same fp32 adds)
    rtol ``ROW_SUM_TOL``. Then timed, with its bound and one partial
    library call (``torch.linalg.vector_norm`` of the rows, as for
    #22)."""
    spec = PackSpec(gpt345m_param_shapes())
    n, rows = spec.total, spec.n_rows
    g = torch.Generator(device=dev).manual_seed(23)
    x32 = torch.randn(n, generator=g, device=dev) * 30
    inv = torch.tensor(1.0 / 1024, device=dev)
    planted = {7: float("inf"), rows // 2: float("nan"),
               rows - 1: float("-inf")}
    err = 0.0
    for name, x in (("bf16 (the path)", x32.to(torch.bfloat16)),
                    ("fp32", x32),
                    ("ragged length, bf16", x32[:n - 1000 - 3].to(
                        torch.bfloat16))):
        x = x.clone()
        r = -(-x.numel() // 1024)
        bad = {row if row < r else r - 1: v for row, v in planted.items()}
        for row, v in bad.items():
            x[row * 1024 + 3] = v
        sq, ma, nf = packed_row_stats(x, inv_scale=inv)
        wsq, wma, wnf = packed_row_stats_reference(x, inv_scale=inv)
        want_nf = torch.zeros(r, device=dev)
        want_nf[list(bad)] = 1.0
        if not (torch.equal(nf, want_nf) and torch.equal(wnf, want_nf)):
            raise AssertionError(f"packed_row_stats {name}: counts at "
                                 f"{torch.nonzero(nf).flatten().tolist()}, "
                                 f"planted {sorted(bad)}")
        for row, v in bad.items():
            kind = torch.isnan if v != v else torch.isinf
            if not (bool(kind(sq[row])) and bool(kind(ma[row]))):
                raise AssertionError(f"packed_row_stats {name}: row {row} "
                                     f"sum {float(sq[row])} max "
                                     f"{float(ma[row])}")
        if not torch.equal(ma.nan_to_num(), wma.nan_to_num()):
            raise AssertionError(f"packed_row_stats {name}: maxima differ")
        ok = torch.isfinite(wsq)
        err = max(err, check_close(f"packed_row_stats {name} sums", sq[ok],
                                   wsq[ok], None, ROW_SUM_TOL))
        log(f"  packed_row_stats {name} over {x.numel()} elements: counts "
            f"exact at rows {sorted(bad)}, nan/inf there; sums max abs err "
            f"{err:.3e}")
        del x, sq, ma, nf, wsq, wma, wnf
    xb = x32.to(torch.bfloat16)
    t = _kernel_timing(
        lambda: packed_row_stats(xb, inv_scale=inv),
        lambda: packed_row_stats_reference(xb, inv_scale=inv),
        lambda: torch.linalg.vector_norm(xb.view(rows, 1024), dim=1,
                                         dtype=torch.float32),
        "row_stats_kernel", 2 * n + 12 * rows, 4 * n)
    f32 = time_ms(lambda: packed_row_stats(x32, inv_scale=inv), iters=20)
    f32_bound = bound(4 * n + 12 * rows, 4 * n)[0]
    log(f"  packed_row_stats 345M flat buffer ({n} elements, bf16): kernel "
        f"{t['ms']:.4f} ms (device {t['device_ms']} ms), plain "
        f"{t['plain_ms']:.4f} ms, vector_norm of the rows (partial) "
        f"{t['library_ms']:.4f} ms, bound {t['bound_ms']:.4f} ms "
        f"({t['bound_by']}); fp32: kernel {f32:.4f} ms, bound "
        f"{f32_bound:.4f} ms")
    return {"name": "packed_row_stats", "route": "cuda",
            "source": "apex_tpu_torch/csrc/packed_row_stats.cu",
            "replaces": "apex_tpu/ops/packed_optimizer.py:654",
            "max_abs_err": err, **t}


#: NovoGrad's lr on the BERT-large leg and in its parity runs. apex's
#: default, 1e-3, moves each layer by lr times its unit-norm gradient
#: direction, a step too small to show in 7 steps of a bf16 loss; at 1e-2
#: the leg's loss falls from the first step (the leg asserts that it
#: falls)
NOVOGRAD_LR = 1e-2


def packed_novograd():
    return FusedNovoGrad(lr=NOVOGRAD_LR, packed=True)


def packed_novograd_checks(dev):
    """The packed NovoGrad sweep (#21) over a flat buffer of BERT-large's
    PackSpec, fp32 gradients and params as on the path: the L2 and the
    inf-norm denominators from the row reduce, weight decay outside and
    inside the moment, bf16 gradients into bf16 params, and noop (the
    moment and the recast source bitwise unchanged). Then timed."""
    spec = PackSpec(bert_large_param_shapes())
    n, rows = spec.total, spec.n_rows
    g = torch.Generator(device=dev).manual_seed(14)
    grad = torch.randn(n, generator=g, device=dev) * 1e-3
    m0 = torch.randn(n, generator=g, device=dev) * 1e-4
    src0 = torch.randn(n, generator=g, device=dev) * 0.02
    # the denominators of a first step (v = the squared norm), L2 and inf
    l2, inf = (row_denominators(leaf_norms_sq(grad, spec, nt), spec, 1e-8)
               for nt in (2, 0))
    hyper = dict(lr=torch.tensor(NOVOGRAD_LR, device=dev),
                 bc1=torch.tensor(0.05, device=dev),
                 inv_scale=torch.tensor(0.5, device=dev), beta1=0.95,
                 beta3=0.05)
    errs = []
    for name, denom, kw, dt in (
            ("L2 (the path)", l2, {}, torch.float32),
            ("inf norm", inf, {}, torch.float32),
            ("wd 0.01 outside the moment", l2, dict(wd=0.01),
             torch.float32),
            ("wd 0.01 inside the moment", l2,
             dict(wd=0.01, reg_inside_moment=True), torch.float32),
            ("bf16 grads and params", l2, {}, torch.bfloat16),
            ("noop", l2, dict(noop=torch.tensor(True, device=dev)),
             torch.float32)):
        m = m0.clone()
        x = grad.to(dt)
        p_out, _ = packed_novograd_apply(x, m, src0, denom, param_dtype=dt,
                                         **hyper, **kw)
        want_p, want_m = packed_novograd_reference(x, m0, src0, denom,
                                                   param_dtype=dt, **hyper,
                                                   **kw)
        err = check_close(f"packed_novograd {name} p_out", p_out, want_p,
                          None, ADAM_TOL[dt])
        if name == "noop":
            if not (torch.equal(m, m0) and torch.equal(p_out, src0)):
                raise AssertionError("packed_novograd noop changed its "
                                     "inputs")
        else:
            err = max(err, check_close(f"packed_novograd {name} m", m,
                                       want_m, None,
                                       ADAM_TOL[torch.float32]))
        errs.append(err)
        log(f"  packed_novograd {name} over {n} elements: max abs err "
            f"{err:.3e}")
        del m, x, p_out, want_p, want_m
    m = m0.clone()
    t = _kernel_timing(
        lambda: packed_novograd_apply(grad, m, src0, l2,
                                      param_dtype=torch.float32, **hyper),
        lambda: packed_novograd_reference(grad, m0, src0, l2,
                                          param_dtype=torch.float32,
                                          **hyper),
        # g, m, src read; m, p written; a denominator a row
        None, "packed_novograd_kernel", 20 * n + 4 * rows, 8 * n)
    log(f"  packed_novograd BERT-large flat buffer ({n} elements, fp32): "
        f"kernel {t['ms']:.4f} ms (device {t['device_ms']} ms), plain "
        f"{t['plain_ms']:.4f} ms, library {t['library_ms']}, bound "
        f"{t['bound_ms']:.4f} ms ({t['bound_by']})")
    return {"name": "packed_novograd", "route": "cuda",
            "source": "apex_tpu_torch/csrc/packed_novograd.cu",
            "replaces": "apex_tpu/ops/packed_optimizer.py:537",
            "max_abs_err": max(errs), **t}


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
# phase 3b: serving under overload (bench.py's serving_overload)
# ---------------------------------------------------------------------------

#: the overload storm: 24 requests of 128 + 64 tokens at twice the rate 8
#: slots drain (one request needs 192 slot-steps: a sustainable interval
#: of 192 // 8 = 24 steps, halved)
OVERLOAD_REQUESTS, OVERLOAD_PROMPT, OVERLOAD_NEW = 24, 128, 64
OVERLOAD_FACTOR = 2.0
SERVICE_STEPS = OVERLOAD_PROMPT + OVERLOAD_NEW
OVERLOAD_INTERVAL = max(1, int((SERVICE_STEPS // SLOTS) / OVERLOAD_FACTOR))


def overload_engine(cfg, params, dev, sink, **kw):
    return ServingEngine(
        cfg, params, n_slots=SLOTS, device=dev, sink=sink,
        admission=AdmissionConfig(max_queue=2 * SLOTS, high_watermark=0.75,
                                  low_watermark=0.375),
        degradation=DegradationPolicy(shed_after=3), **kw)


def overload_trace(cfg, rng, interval, budget_ms=None, ttft_ms=None,
                   n=OVERLOAD_REQUESTS, priorities=True):
    """The bench's storm: prompts (and priorities) drawn from ``rng``."""
    return [Request(
        prompt=[int(t) for t in rng.integers(0, cfg.vocab_size,
                                             size=OVERLOAD_PROMPT)],
        max_new_tokens=OVERLOAD_NEW, arrival_step=i * interval,
        latency_budget_ms=budget_ms, ttft_budget_ms=ttft_ms,
        priority=int(rng.integers(0, 3)) if priorities else 0)
        for i in range(n)]


def overload_budgets(step_ms: float):
    """(latency, TTFT) budgets scaled from a calibration step p50 as the
    bench scales them: generous for an engine that is not overloaded,
    tight against unbounded queueing."""
    return SERVICE_STEPS * step_ms * 3.0, OVERLOAD_PROMPT * step_ms * 4.0


def check_storm(eng, reqs, ring, label):
    """The overload contract: every request in exactly one terminal
    state (one request_end record each), the queue bound held, the
    scheduler's invariants, no page leaked."""
    ends = {}
    for e in ring.events("request_end"):
        ends[e["rid"]] = ends.get(e["rid"], 0) + 1
    for r in reqs:
        if not is_terminal(r.status) or ends.get(r.rid) != 1:
            raise AssertionError(
                f"{label}: request {r.rid} is {r.status.value} with "
                f"{ends.get(r.rid, 0)} request_end records")
    st = eng.last_stats
    if st["max_queue_depth"] > 2 * SLOTS:
        raise AssertionError(f"{label}: queue depth {st['max_queue_depth']}"
                             f" over its bound {2 * SLOTS}")
    eng.scheduler.check_invariants()
    leaks = eng.scheduler.allocator.used_count
    if leaks:
        raise AssertionError(f"{label}: {leaks} pages leaked")


def check_serving_launches(launches, label):
    for name in SERVING_KERNELS:
        if launches[name] <= 0:
            raise AssertionError(f"{label}: kernel {name} never launched")
    trained = {k: c for k, c in launches.items()
               if k not in SERVING_KERNELS and c}
    if trained:
        raise AssertionError(f"{label}: training kernels launched while "
                             f"serving: {trained}")


def serve_overload(dev):
    cfg = gpt345m(torch.bfloat16)
    params = init_gpt_params(
        cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
    ring = telemetry.RingBufferRecorder(capacity=100000)
    eng = overload_engine(cfg, params, dev, ring)
    # calibration: a short saturated trace warms the engine and primes
    # the admission controller's step-time estimate; the storm's prompts
    # come next from the same rng (bench.py's order)
    rng = np.random.default_rng(0)
    eng.generate(overload_trace(cfg, rng, 0, n=4, priorities=False))
    step_ms = eng.last_stats["step_ms"]["p50"]
    budget_ms, ttft_ms = overload_budgets(step_ms)
    reqs = overload_trace(cfg, rng, OVERLOAD_INTERVAL, budget_ms, ttft_ms)
    ring.records.clear()
    torch.cuda.synchronize()
    _device.reset_launch_counts()
    eng.generate(reqs, max_steps=SERVICE_STEPS * OVERLOAD_REQUESTS + 1000)
    torch.cuda.synchronize()
    launches = _device.launch_counts()
    check_storm(eng, reqs, ring, "overload")
    check_serving_launches(launches, "overload")
    st = eng.last_stats
    counts = ring.counts_by_event()
    log(f"  345M bf16 overload x{OVERLOAD_FACTOR}: {OVERLOAD_REQUESTS} "
        f"requests every {OVERLOAD_INTERVAL} steps, calibration step p50 "
        f"{step_ms:.3f} ms, budgets latency {budget_ms:.1f} ms TTFT "
        f"{ttft_ms:.1f} ms")
    log(f"  goodput {st['goodput_tokens_per_sec']:.1f} tokens/s "
        f"(all tokens {st['tokens_per_sec']:.1f}/s), SLO attainment "
        f"{st['slo_attainment']:.4f} ({st['slo_attained']} of "
        f"{st['n_requests']}), by_status {st['by_status']}, TTFT p50 "
        f"{st['ttft_ms'].get('p50')} ms p99 {st['ttft_ms'].get('p99')} ms, "
        f"max queue depth {st['max_queue_depth']} (bound {2 * SLOTS}), "
        f"{st['steps']} steps, step p50 {st['step_ms']['p50']:.3f} ms, "
        f"reject/shed/degrade records {counts.get('reject', 0)}/"
        f"{counts.get('shed', 0)}/{counts.get('degrade', 0)}, page leaks 0")
    log("  overload_json " + json.dumps(
        {k: st[k] for k in ("goodput_tokens_per_sec", "tokens_per_sec",
                            "slo_attainment", "slo_attained", "by_status",
                            "ttft_ms", "latency_ms", "step_ms",
                            "max_queue_depth", "steps", "occupancy",
                            "preemptions", "wall_s")}))
    # a profiled stretch of the same engine under the same budgets: 12
    # requests at once (8 slots busy, 4 queued through admission, which
    # refuses one whose TTFT lower bound exceeds its budget), 16 steps
    # profiled (a trace of every op of a whole storm would take minutes
    # to gather), then the rest drained unprofiled
    stretch = overload_trace(cfg, rng, 0, budget_ms, ttft_ms, n=SLOTS + 4)
    refused = 0
    for r in stretch:
        r.max_new_tokens = 16
        refused += eng.try_submit(r) is not None
    profiled(lambda: [eng.run_step() for _ in range(16)],
             f"overload stretch, 16 steps, {refused} refused at intake", 8)
    eng.generate([])
    check_storm(eng, stretch, ring, "overload stretch")
    return launches


# ---------------------------------------------------------------------------
# phase 3c: speculative decoding A/B (bench.py's spec_decode)
# ---------------------------------------------------------------------------

SPEC_K, SPEC_NGRAM, SPEC_CHUNK = 4, 2, 8


def spec_ab(dev):
    cfg = gpt345m(torch.bfloat16)
    params = init_gpt_params(
        cfg, torch.Generator(device=dev).manual_seed(0), device=dev)

    def engine(k, ring):
        return overload_engine(cfg, params, dev, ring,
                               prefill_chunk=SPEC_CHUNK, spec_k=k,
                               spec_ngram=SPEC_NGRAM)

    # calibration on a baseline engine of its own (its prefix cache
    # leaves with it): one budget set for both sides; each side's storm
    # is drawn anew from the same seed (bench.py's order)
    calib = engine(0, None)
    calib.generate(overload_trace(cfg, np.random.default_rng(0), 0, n=4))
    step_ms = calib.last_stats["step_ms"]["p50"]
    del calib
    budget_ms, ttft_ms = overload_budgets(step_ms)
    out, launches = {}, {}
    for k in (0, SPEC_K):
        ring = telemetry.RingBufferRecorder(capacity=100000)
        eng = engine(k, ring)
        reqs = overload_trace(cfg, np.random.default_rng(0),
                              OVERLOAD_INTERVAL, budget_ms, ttft_ms)
        torch.cuda.synchronize()
        _device.reset_launch_counts()
        eng.generate(reqs, max_steps=SERVICE_STEPS * OVERLOAD_REQUESTS + 1000)
        torch.cuda.synchronize()
        launches[k] = _device.launch_counts()
        check_storm(eng, reqs, ring, f"spec_k={k}")
        check_serving_launches(launches[k], f"spec_k={k}")
        st = eng.last_stats
        out[k] = st
        log(f"  spec_k={k}: goodput {st['goodput_tokens_per_sec']:.1f} "
            f"tokens/s, SLO attainment {st['slo_attainment']:.4f}, "
            f"by_status {st['by_status']}, drafted {st['drafted_tokens']}, "
            f"accepted {st['accepted_tokens']}, accept_rate "
            f"{st['accept_rate']}, tokens_per_step {st['tokens_per_step']}, "
            f"{st['steps']} steps, step p50 {st['step_ms']['p50']:.3f} ms, "
            f"TTFT p99 {st['ttft_ms'].get('p99')} ms, page leaks 0")
    spec = out[SPEC_K]
    if spec["drafted_tokens"] <= 0:
        raise AssertionError("spec_k=4 drafted nothing")
    base_g = out[0]["goodput_tokens_per_sec"]
    log(f"  goodput ratio spec/base "
        f"{spec['goodput_tokens_per_sec'] / base_g if base_g else None}")
    log("  spec_json " + json.dumps({str(k): {
        key: st[key] for key in (
            "goodput_tokens_per_sec", "tokens_per_sec", "slo_attainment",
            "by_status", "drafted_tokens", "accepted_tokens", "accept_rate",
            "tokens_per_step", "steps", "step_ms", "wall_s")}
        for k, st in out.items()}))
    # the decode kernel at the spec step's query rows: 8 slots x 8
    # columns, each decode slot verifying 1 + 4 positions near the end
    # of its 192-token context
    g = torch.Generator(device=dev).manual_seed(3)
    rng = np.random.default_rng(3)
    C = max(SPEC_CHUNK, SPEC_K + 1)
    lens = []
    for _ in range(SLOTS):
        pos = int(rng.integers(OVERLOAD_PROMPT, SERVICE_STEPS - C))
        lens += [pos + j + 1 if j < SPEC_K + 1 else 0 for j in range(C)]
    q, pools, pt, kl = _page_case(g, dev, lens, torch.bfloat16,
                                  torch.bfloat16, n_pools=8, rows_per_slot=C)
    t = _decode_timing(dev, q, pools, pt, kl,
                       f"spec step bf16 [{len(lens)},16,64]")
    return {k: launches[k] for k in launches}, t


# ---------------------------------------------------------------------------
# phase 3d: chaos, the watchdog, recovery and tracing on the card
# ---------------------------------------------------------------------------

def identity_cfg(dev, position_scale=40.0):
    """Phase 4's fp32 configuration: 345M width, max positions 64, the
    position table x40 so continuations depend on position. At x1 the
    random model greedy-decodes into repeating runs, so speculative
    drafts are proposed and accepted."""
    cfg = gpt345m(torch.float32, max_pos=64)
    params = init_gpt_params(
        cfg, torch.Generator(device=dev).manual_seed(1), device=dev)
    params["embedding"]["position"] = (params["embedding"]["position"]
                                       * position_scale)
    return cfg, params


def same_or_near_tie(cfg, params, prompt, got, ref, label, dev):
    """Token identity with phase 4's rule: equal, or first apart where
    the dense model's top-2 logits lie within 1e-4 of the top one (a
    near-tie fp32 summation order can flip). Returns 1 for a near-tie,
    0 for identity; raises otherwise."""
    if got == ref:
        return 0
    j = next((i for i, (a, b) in enumerate(zip(got, ref)) if a != b),
             min(len(got), len(ref)))
    if j >= min(len(got), len(ref)):
        raise AssertionError(f"{label}: lengths differ {len(got)} "
                             f"!= {len(ref)}")
    with torch.no_grad():
        logits = gpt_forward(cfg, params, torch.tensor(
            [list(prompt) + ref[:j]], device=dev))[0, -1]
    top2 = torch.topk(logits, 2).values
    gap = float(top2[0] - top2[1])
    if gap < 1e-4 * abs(float(top2[0])):
        log(f"  {label}: near-tie at token {j} (top-2 gap {gap:.3e}); "
            f"{got[j]} vs {ref[j]}")
        return 1
    raise AssertionError(f"{label}: diverges at token {j} (gap "
                         f"{gap:.3e}): {got} != {ref}")


def chaos_trace(cfg):
    rng = np.random.default_rng(5)
    return [Request(prompt=[int(t) for t in
                            rng.integers(0, cfg.vocab_size, size=L)],
                    max_new_tokens=12, arrival_step=2 * i, rid=100 + i)
            for i, L in enumerate((14, 21, 9, 17))]


def chaos_checks(dev):
    cfg, params = identity_cfg(dev)
    kw = dict(n_slots=2, prefill_chunk=8, device=dev)
    near = 0
    clean_reqs = chaos_trace(cfg)
    clean = ServingEngine(cfg, params, **kw).generate(clean_reqs)
    # (a) poison quarantine: the victim FAILED, the others bit for bit
    reqs = chaos_trace(cfg)
    chaos = ServingChaos().poison_request(101, at_step=8)
    eng = ServingEngine(cfg, params, chaos=chaos, **kw)
    out = eng.generate(reqs)
    if chaos.faults_fired != [("poison", 101, 8)]:
        raise AssertionError(f"poison fired {chaos.faults_fired}")
    for r in reqs:
        if r.rid == 101:
            if r.status is not RequestStatus.FAILED:
                raise AssertionError(f"poisoned request is {r.status}")
        elif out[r.rid] != clean[r.rid]:
            raise AssertionError(f"request {r.rid}: tokens differ from the "
                                 f"clean run under a poisoned neighbour")
    if eng.scheduler.allocator.used_count:
        raise AssertionError("poisoned run leaked pages")
    log("  poison: request 101 FAILED (nonfinite_logits at step 8), the "
        "other 3 requests' tokens bitwise equal to the clean run")
    # (b) kill mid-flight, recover onto a fresh engine
    reqs = chaos_trace(cfg)
    eng = ServingEngine(cfg, params,
                        chaos=ServingChaos().kill_engine_at(10), **kw)
    try:
        eng.generate(reqs)
        raise AssertionError("the injected kill did not fire")
    except ChaosError:
        pass
    eng2, survivors = ServingEngine.recover_from(eng, chaos=None)
    eng2.generate(survivors)
    for r in reqs:
        near += same_or_near_tie(cfg, params, r.prompt, list(r.out_tokens),
                                 clean[r.rid], f"recover {r.rid}", dev)
    log(f"  kill at step 10: {len(survivors)} survivors recovered, tokens "
        f"equal to the uninterrupted run (near-ties {near})")
    # (c) a wedged fetch under the watchdog
    reqs = chaos_trace(cfg)
    ring = telemetry.RingBufferRecorder()
    wd = HangWatchdog(timeout_s=0.5, poll_s=0.02, sink=ring)
    eng = ServingEngine(cfg, params, watchdog=wd, sink=ring,
                        chaos=ServingChaos().wedge_step_at(6, stall_s=30.0),
                        **kw)
    t0 = time.perf_counter()
    try:
        eng.generate(reqs)
        raise AssertionError("the wedge was not caught")
    except HangError:
        waited = time.perf_counter() - t0
    wd.close()
    hang = ring.events("hang")
    if len(hang) != 1 or hang[0]["step"] != 6:
        raise AssertionError(f"hang records {hang}")
    # steps 0-5 run in well under a second; the 30 s stall is cut short
    if waited > 0.5 + 2.0:
        raise AssertionError(f"HangError after {waited:.2f} s")
    eng2, survivors = ServingEngine.recover_from(eng, watchdog=None,
                                                 chaos=None)
    eng2.generate(survivors)
    n_near = near
    for r in reqs:
        near += same_or_near_tie(cfg, params, r.prompt, list(r.out_tokens),
                                 clean[r.rid], f"wedge {r.rid}", dev)
    log(f"  wedge at step 6: HangError {waited:.3f} s into the trace "
        f"(timeout 0.5 s), hang record with all-thread stacks; the "
        f"recovered engine completed the trace (near-ties {near - n_near})")
    # (d) request-level retry after a transient poison
    reqs = chaos_trace(cfg)
    eng = ServingEngine(cfg, params,
                        chaos=ServingChaos().poison_request(102),
                        **kw)
    eng.generate(reqs, retry_failed=RetryPolicy(attempts=3, deadline=60.0))
    if eng.last_stats["retries"] != 1 or any(
            r.status is not RequestStatus.COMPLETED for r in reqs):
        raise AssertionError(f"retry: {eng.last_stats['by_status']}")
    n_near = near
    for r in reqs:
        near += same_or_near_tie(cfg, params, r.prompt, list(r.out_tokens),
                                 clean[r.rid], f"retry {r.rid}", dev)
    log(f"  retry_failed: the poisoned request retried once and completed "
        f"(near-ties {near - n_near})")
    # (e) tracing, the metrics drain and the summary record into a JSONL
    with tempfile.TemporaryDirectory() as tmp:
        path = f"{tmp}/trace.jsonl"
        sink = telemetry.JsonlRecorder(path)
        reqs = chaos_trace(cfg)
        eng = ServingEngine(cfg, params, trace=True, telemetry_every=4,
                            sink=sink, **kw)
        eng.generate(reqs)
        sink.close()
        recs = telemetry.read_jsonl(path)
    check_trace_records(recs, reqs, eng.last_stats["steps"])
    return near


def check_trace_records(recs, reqs, steps):
    spans = [r for r in recs if r.get("event") == "span"]
    terminal = [r for r in spans if r["terminal"]]
    if sorted(r["rid"] for r in terminal) != sorted(q.rid for q in reqs):
        raise AssertionError("not one terminal span per request")
    roots = {r["span_id"]: r["trace_id"] for r in terminal}
    for r in spans:
        if not r["terminal"] and roots.get(r["parent_id"]) != r["trace_id"]:
            raise AssertionError(f"span without its root: {r}")
    worst = 0.0
    for q in reqs:
        measured = q.t_first_token - q.t_arrival
        worst = max(worst, abs(sum(q.attr_ttft.values()) - measured)
                    / measured)
    if worst > 0.01:
        raise AssertionError(f"TTFT attribution off by {worst:.3e}")
    metrics = [r for r in recs if r.get("event") == "metrics"
               and r.get("tag") == "serving"]
    if len(metrics) != steps // 4:
        raise AssertionError(f"{len(metrics)} serving metrics records for "
                             f"{steps} steps")
    summaries = [r for r in recs if r.get("event") == "serving_summary"]
    if len(summaries) != 1:
        raise AssertionError(f"{len(summaries)} serving_summary records")
    log(f"  trace: {len(spans)} spans, {len(terminal)} terminal (one per "
        f"request), every tree rooted, TTFT attribution within "
        f"{worst:.2e} of the measured TTFT, {len(metrics)} serving metrics "
        f"records for {steps} steps, 1 serving_summary")


# ---------------------------------------------------------------------------
# phase 4: token identity against the dense reference
# ---------------------------------------------------------------------------

def token_identity(dev):
    """fp32 tokens of the engine against the dense reference, plain and
    with speculative decoding (``spec_k=4``); the position table x40
    drafts nothing, so a third leg runs ``spec_k=4`` at x1, where drafts
    are accepted and rejected. Returns the near-ties."""
    near_ties = 0
    spec = dict(spec_k=SPEC_K, spec_ngram=SPEC_NGRAM)
    for label, scale, kw, new in (
            ("plain", 40.0, {}, 16), ("spec_k=4", 40.0, spec, 16),
            ("spec_k=4, position table x1", 1.0, spec, 24)):
        cfg, params = identity_cfg(dev, scale)
        rng = np.random.default_rng(1)
        reqs = [Request(prompt=[int(t) for t in
                                rng.integers(0, cfg.vocab_size, size=L)],
                        max_new_tokens=new, arrival_step=i)
                for i, L in enumerate((24, 31))]
        eng = ServingEngine(cfg, params, n_slots=2, prefill_chunk=8,
                            device=dev, **kw)
        out = eng.generate(reqs)
        for r in reqs:
            ref = reference_decode(cfg, params, r.prompt, r.max_new_tokens)
            tie = same_or_near_tie(cfg, params, r.prompt, out[r.rid], ref,
                                   f"{label} request {r.rid}", dev)
            near_ties += tie
            if not tie:
                log(f"  {label} request {r.rid}: {new} tokens identical "
                    f"to reference")
        if kw:
            st = eng.last_stats
            leaks = eng.scheduler.allocator.used_count
            log(f"  {label}: drafted {st['drafted_tokens']}, accepted "
                f"{st['accepted_tokens']}, page leaks {leaks}")
            if leaks:
                raise AssertionError(f"{label}: {leaks} pages leaked")
            if scale == 1.0 and not (st["drafted_tokens"] > 0
                                     and st["accepted_tokens"] > 0):
                raise AssertionError(f"{label}: no draft was accepted")
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
#: the unfused step with packed FusedSGD in place of packed FusedAdam
SGD_LAUNCHES = {**{k: c for k, c in UNFUSED_LAUNCHES.items()
                   if k != "packed_adam"}, "packed_sgd": 1}

#: FusedSGD of the SGD leg: momentum and weight decay of ``bench.py``'s
#: ``bench_resnet_o2`` (:533), bf16 params over fp32 masters. Its lr 0.1
#: is ResNet's; the GPT's tied word embedding takes large gradients, and
#: with momentum 0.9 the loss of the leg's fixed batch falls from the
#: first step at 0.01 (the leg asserts that it falls)
SGD_LR = 0.01


def packed_sgd():
    return FusedSGD(lr=SGD_LR, momentum=0.9, weight_decay=1e-4,
                    packed=True, master_weights=True)


#: the unfused step with the flat gradient lifecycle: the loss scaler's
#: unscale and the clip's scale (#24, twice) and the clip's norm (#22)
SCALED_LAUNCHES = {**UNFUSED_LAUNCHES, "scale_flat": 2,
                   "packed_row_reduce": 1}
#: ... with the numerics monitor's observation of the packed gradients
#: (#23); the headline step's monitor observes the gradient tree in plain
#: PyTorch, so that leg launches HEADLINE_LAUNCHES
MONITORED_LAUNCHES = {**SCALED_LAUNCHES, "packed_row_stats": 1}


def scaled_step_fn(loss_fn, opt, scaler, poison=None, max_norm=1.0,
                   monitor=None):
    """The JAX package's flat gradient lifecycle (``bench.py:1750-1900``)
    with Megatron's GPT-2 recipe, dynamic loss scaling and ``--clip-grad
    1.0``: the scaled loss's gradients, packed in their dtype, unscaled
    into fp32 in one sweep that flags overflows per row
    (``unscale_flat``), clipped by the global norm (``clip_grad_norm_flat``),
    then the packed optimizer on the flat buffer with the scaler's
    ``found_inf`` and the scale's update. The state is ``(optimizer
    state, scaler state)``; the loss returned is the unscaled one. While
    ``poison["on"]``, one gradient element (of the first leaf) is set to
    inf before the packing.

    ``monitor=(NumericsMonitor over the optimizer's spec, sink, tokens)``
    adds the telemetry of ``bench.py``'s numerics leg: the monitor observes
    the packed gradients (``packed_row_stats``, ``inv_scale`` 1 / scale),
    ``update_scale`` feeds the metrics and numerics states, the metrics
    window takes the loss and the tokens and drains every 2 steps, and the
    numerics state drains every step; the state is then ``(optimizer
    state, scaler state, metrics state, numerics state)``."""
    def step(params, state):
        ostate, ss = state[:2]
        loss, grads = value_and_grad(
            lambda p: scaler.scale_loss(ss, loss_fn(p)), params)
        if poison is not None and poison["on"]:
            tree_leaves(grads)[0].view(-1)[0] = float("inf")
        flat = ostate.spec.pack(grads)
        if monitor is not None:
            mon, sink, tokens = monitor
            ns = mon.observe(state[3], flat_grads=flat,
                             inv_scale=1.0 / ss.loss_scale)
        flat, ss = scaler.unscale_flat(ss, flat, out_dtype=torch.float32)
        flat, _ = clip_grad_norm_flat(flat, max_norm)
        params, ostate = opt.step(flat, ostate, params,
                                  found_inf=ss.found_inf)
        loss = loss / ss.loss_scale
        if monitor is None:
            return params, (ostate, scaler.update_scale(ss)), loss
        ss, m, ns = scaler.update_scale(ss, metrics=state[2], numerics=ns)
        m = telemetry.drain(telemetry.accumulate(m, loss=loss,
                                                 tokens=tokens),
                            sink, every_n=2)
        return params, (ostate, ss, m, mon.drain(ns, sink)), loss
    return step


def check_overflow_skip(step, params, state, poison, label):
    """One step with an inf in a gradient: the step is skipped (params and
    fp32 masters bit for bit, the step count kept), the scale halves and
    the run of skips is 1. Returns the step's params and state."""
    ostate, ss = state[:2]
    before = [p.clone() for p in tree_leaves(params)]
    masters, count = ostate.master_params.clone(), int(ostate.step)
    scale = float(ss.loss_scale)
    poison["on"] = True
    params, state, _ = step(params, state)
    poison["on"] = False
    torch.cuda.synchronize()
    ostate, ss2 = state[:2]
    if not (torch.equal(ostate.master_params, masters)
            and all(torch.equal(a, b)
                    for a, b in zip(before, tree_leaves(params)))):
        raise AssertionError(f"{label}: the overflow step changed the "
                             f"params or masters")
    if int(ostate.step) != count:
        raise AssertionError(f"{label}: the overflow step advanced the step "
                             f"count")
    if float(ss2.loss_scale) != scale / 2 or int(ss2.consecutive_skips) != 1:
        raise AssertionError(
            f"{label}: after the overflow scale {float(ss2.loss_scale)} "
            f"(was {scale}), consecutive skips {int(ss2.consecutive_skips)}")
    log(f"  {label}: an inf in one gradient skipped the step bit for bit, "
        f"scale {scale:g} -> {float(ss2.loss_scale):g}, consecutive skips "
        f"1")
    return params, state


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
    out = {}

    def run():  # a packed step consumes the state: keep what it returns
        out["params"], out["state"], _ = step(params, state)
    profiled(run, f"{label} step", 14)
    return {"launches": launches, "p50": p50, "p99": p99, "peak": peak_gb,
            **out}


def numerics_step_fn(loss_fn, opt, mon, sink):
    """``bench.py``'s numerics leg (``bench_gpt(numerics=True)``): the
    step with the numerics monitor observing every step's gradient tree
    (per-leaf sums of squares and maxima, plain PyTorch as they are XLA in
    the JAX package) and the numerics drain. The state is ``(optimizer
    state, numerics state)``."""
    def step(params, state):
        ostate, ns = state
        loss, grads = value_and_grad(loss_fn, params)
        ns = mon.observe(ns, grads=grads)
        params, ostate = opt.step(grads, ostate, params)
        return params, (ostate, mon.drain(ns, sink)), loss
    return step


def check_monitored_run(step, params, state, poison, label, path, sink):
    """The monitored loss-scaled leg after its timed steps: one step under
    ``set_sync_debug_mode("error")`` (the monitor and both drains add no
    host sync), one step with an inf in the first leaf's gradient (skipped
    bit for bit, the scale halved), one healthy step; then after
    ``telemetry.flush()`` the JSONL must hold exactly one anomaly, a
    ``nonfinite_grads`` naming that leaf alone with the poisoned step as
    ``first_bad_step``, and metrics records with finite losses and the
    window's tokens."""
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        params, state, _ = step(params, state)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    log(f"  {label}: a monitored step under set_sync_debug_mode('error') "
        f"made no host sync")
    bad_step = state[3].step + 1
    leaf = PackSpec(params).leaf_names()[0]
    params, state = check_overflow_skip(step, params, state, poison, label)
    params, state, _ = step(params, state)
    healthy = state[3].step - 1
    telemetry.flush()
    sink.close()
    records = telemetry.read_jsonl(path)
    anomalies = [r for r in records if r.get("event") == "anomaly"]
    metrics = [r for r in records if r.get("event") == "metrics"]
    if [(a["kind"], a["step"], a["first_bad_step"]) for a in anomalies] \
            != [("nonfinite_grads", bad_step, bad_step)]:
        raise AssertionError(f"{label}: anomalies {anomalies}, expected one "
                             f"nonfinite_grads at step {bad_step}")
    named = [entry["name"] for entry in anomalies[0]["leaves"]]
    if named != [leaf]:
        raise AssertionError(f"{label}: the anomaly names {named}, the inf "
                             f"was in {leaf}")
    if not metrics or not all(
            np.isfinite(r["loss"]) and r["tokens"] == 2 * 8192
            and r["step"] % 2 == 0 for r in metrics):
        raise AssertionError(f"{label}: metrics records {metrics}")
    log(f"  {label}: after flush() the JSONL holds one nonfinite_grads "
        f"anomaly naming {leaf} at step {bad_step}, none for the "
        f"{healthy} healthy steps around it, and "
        f"{len(metrics)} metrics records (losses "
        f"{[round(r['loss'], 4) for r in metrics]}, 16384 tokens each, "
        f"overflow skips {metrics[-1]['overflow_skips']})")


def train_leg(dev, label: str, expected: dict, timed: int, make_opt=None,
              scaled: bool = False, numerics: bool = False, **cfg_kw):
    """GPT-2 345M at full width and depth, seq 1024, batch 8, bf16
    compute over bf16 params with fp32 masters (O2), packed
    FusedAdam(lr=1e-4) or ``make_opt()``, random weights (seed 0) and
    tokens (seed 1), the same batch every step (:func:`drive_leg`).
    ``scaled``: the loss-scaled, clipped step (:func:`scaled_step_fn`,
    ``LossScaler("dynamic")``), then the overflow check
    (:func:`check_overflow_skip`). ``numerics``: with ``scaled`` the
    monitored flat lifecycle (``scaled_step_fn(monitor=...)``, then
    :func:`check_monitored_run`), else ``bench.py``'s numerics leg
    (:func:`numerics_step_fn`); records go to a JSONL file."""
    cfg = GPTConfig(num_layers=24, hidden_size=HIDDEN,
                    num_attention_heads=N_HEADS, vocab_size=50304,
                    max_position_embeddings=1024, hidden_dropout=0.0,
                    attention_dropout=0.0, compute_dtype=torch.bfloat16,
                    **cfg_kw)
    params = init_gpt_params(
        cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
    params = tree_map(lambda p: p.to(torch.bfloat16), params)
    opt = (make_opt() if make_opt else
           FusedAdam(lr=1e-4, master_weights=True, packed=True))
    tokens = torch.randint(0, cfg.vocab_size, (8, 1024), device=dev,
                           generator=torch.Generator(
                               device=dev).manual_seed(1))
    labels = torch.roll(tokens, -1, dims=1)
    loss_fn = functools.partial(gpt_loss, cfg, tokens=tokens, labels=labels)
    state = opt.init(params)
    with tempfile.TemporaryDirectory() as tmp:
        path = f"{tmp}/run.jsonl"
        sink = telemetry.JsonlRecorder(path) if numerics else None
        if scaled:
            scaler, poison = LossScaler("dynamic"), {"on": False}
            monitor = None
            state = (state, scaler.init_state(dev))
            if numerics:
                mon = NumericsMonitor(spec=state[0].spec, tag="gpt_numerics")
                monitor = (mon, sink, tokens.numel())
                state += (telemetry.init_metrics(dev), mon.init(dev))
            step = scaled_step_fn(loss_fn, opt, scaler, poison,
                                  monitor=monitor)
        elif numerics:
            mon = NumericsMonitor(params, tag="gpt_numerics")
            step = numerics_step_fn(loss_fn, opt, mon, sink)
            state = (state, mon.init(dev))
        else:
            step = train_step_fn(loss_fn, opt)
        leg = drive_leg(label, expected, timed, step, params, state,
                        tokens.numel())
        if scaled and numerics:
            check_monitored_run(step, leg["params"], leg["state"], poison,
                                label, path, sink)
        elif scaled:
            check_overflow_skip(step, leg["params"], leg["state"], poison,
                                label)
        elif numerics:
            telemetry.flush()
            sink.close()
            if telemetry.read_jsonl(path):
                raise AssertionError(f"{label}: healthy steps wrote records")
    del leg["params"], leg["state"]
    return leg


def train_345m(dev):
    """The headline step (``bench.py``'s default: ``fused_block=True``,
    ``selective_elementwise`` recompute, chunked CE recomputing the chunk
    GEMM), then the unfused step without recompute (saved bf16 CE
    logits) as the second leg, the fused step without recompute as a
    third, which separates the recompute's cost from the fused tails',
    the step without flash attention as a fourth (``bench.py``'s
    xla-attention leg: ``bench_gpt(..., "selective")`` with flash off,
    the unfused block, the CE recomputing its chunk GEMM), and the
    unfused step with packed FusedSGD as a fifth, and the unfused step
    with dynamic loss scaling and gradient clipping over the flat
    gradient buffer as a sixth (then its forced overflow), all in this
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
                  ce_save_logits=False)),
            ("sgd", "345M unfused, no remat, packed FusedSGD",
             SGD_LAUNCHES, 6, dict(ce_save_logits=True,
                                   make_opt=packed_sgd)),
            ("scaled", "345M unfused, no remat, loss-scaled, clipped",
             SCALED_LAUNCHES, 6, dict(ce_save_logits=True, scaled=True)),
            ("numerics", "345M headline, numerics monitor",
             HEADLINE_LAUNCHES, 4,
             dict(fused_block=True, numerics=True,
                  recompute_granularity="selective_elementwise")),
            ("monitored", "345M unfused, loss-scaled, clipped, monitored",
             MONITORED_LAUNCHES, 4, dict(ce_save_logits=True, scaled=True,
                                         numerics=True))):
        legs[key] = train_leg(dev, label, expected, timed, **kw)
        torch.cuda.empty_cache()
    log(f"  numerics monitor overhead on the headline step (p50, this "
        f"call): {legs['numerics']['p50']:.2f} against "
        f"{legs['headline']['p50']:.2f} ms, "
        f"{(legs['numerics']['p50'] / legs['headline']['p50'] - 1) * 100:+.2f}"
        f" %; the monitored loss-scaled leg {legs['monitored']['p50']:.2f} "
        f"against {legs['scaled']['p50']:.2f} ms")
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
#: without recompute the masked softmax forward runs once a layer
BERT_NOREMAT_LAUNCHES = {
    "layer_norm_fwd": 49, "layer_norm_bwd": 49, "softmax_masked_fwd": 24,
    "softmax_bwd": 24,
}
#: a packed FusedLAMB step: the gradient's row sums, stage 1, stage 2
LAMB_LAUNCHES = {"packed_row_reduce": 1, "packed_lamb_stage1": 1,
                 "packed_scale_update": 1}
LAMB_KERNELS = tuple(LAMB_LAUNCHES)
#: a packed FusedNovoGrad step: the gradient's row sums, the elementwise
#: stage
NOVOGRAD_LAUNCHES = {"packed_row_reduce": 1, "packed_novograd": 1}
NOVOGRAD_KERNELS = tuple(NOVOGRAD_LAUNCHES)


def packed_lamb():
    return FusedLAMB(lr=1e-3, packed=True)


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


def _ms_list(times):
    return "[" + ", ".join(f"{t:.3f}" for t in times) + "]"


def optimizer_time(opt, loss_fn, params, state, iters: int = 5):
    """The optimizer step alone, on one set of gradients, over ``iters``
    chained steps after a warm-up step: (call ms per step from CUDA
    events over the chain, the host's ms to enqueue each step as a list,
    so that one slow enqueue shows, device ms per step from a
    ``torch.profiler`` trace, and for a packed state the bound of one
    step from ``PackedState.sweep_bytes`` or None)."""
    from torch.profiler import ProfilerActivity, profile

    _, grads = value_and_grad(loss_fn, params)
    params, state = opt.step(grads, state, params)  # warm-up
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    host_ms = []
    start.record()
    for _ in range(iters):
        t0 = time.perf_counter()
        params, state = opt.step(grads, state, params)
        host_ms.append((time.perf_counter() - t0) * 1e3)
    end.record()
    end.synchronize()
    bound_ms = (bound(state.sweep_bytes(), 0)[0]
                if hasattr(state, "sweep_bytes") else None)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            params, state = opt.step(grads, state, params)
        torch.cuda.synchronize()
    busy = sum(e.device_time_total for e in prof.key_averages()
               if e.device_time_total > 0 and e.device_type.name == "CUDA")
    return (start.elapsed_time(end) / iters, host_ms, busy / 1e3 / iters,
            bound_ms)


def bert_large_leg(dev, label: str, expected: dict, timed: int,
                   make_opt=None, **cfg_kw):
    """BERT-large as ``bench_bert_lamb`` runs it: 24 layers, hidden 1024,
    16 heads, vocab 30592, seq 512, batch 16, bf16 compute over fp32
    params, dropout 0, ``selective`` recompute (unless ``cfg_kw`` says
    otherwise), pytree FusedLAMB(lr=1e-3) or ``make_opt()``, random
    weights (seed 0), tokens (seed 1) and labels (seed 2); unlike the
    bench, a padding mask with lengths from seed 3 (the labels of its
    pad positions -1). The same batch every step (:func:`drive_leg`),
    then the optimizer's step alone timed (:func:`optimizer_time`)."""
    cfg_kw.setdefault("recompute_granularity", "selective")
    cfg = GPTConfig(num_layers=24, hidden_size=HIDDEN,
                    num_attention_heads=N_HEADS, vocab_size=BERT_VOCAB,
                    max_position_embeddings=512, hidden_dropout=0.0,
                    attention_dropout=0.0, compute_dtype=torch.bfloat16,
                    **cfg_kw)
    params = init_gpt_params(
        cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
    opt = make_opt() if make_opt else FusedLAMB(lr=1e-3)
    tokens, labels, padding = bert_batch(
        [torch.Generator(device=dev).manual_seed(i) for i in (1, 2, 3)],
        16, 512, cfg.vocab_size, dev)
    log(f"  real tokens: {int(padding.sum())} of {padding.numel()}")

    def loss_fn(p):
        return bert_mlm_loss(cfg, p, tokens, labels, padding)
    leg = drive_leg(label, expected, timed, train_step_fn(loss_fn, opt),
                    params, opt.init(params), tokens.numel())
    (leg["opt_ms"], leg["opt_host_ms"], leg["opt_device_ms"],
     leg["opt_bound_ms"]) = optimizer_time(opt, loss_fn, leg.pop("params"),
                                           leg.pop("state"))
    log(f"  the optimizer's step alone: call {leg['opt_ms']:.3f} ms, host "
        f"{_ms_list(leg['opt_host_ms'])} ms a step, device "
        f"{leg['opt_device_ms']:.3f} ms, bound {leg['opt_bound_ms']} ms")
    return leg


def train_bert_large(dev):
    """The two ``selective`` legs with pytree FusedLAMB (non-flash and
    flash), then the non-flash step without recompute (the configuration
    that is not host-bound) with pytree and with packed FusedLAMB, which
    compares the two optimizers on one card, and with packed
    FusedNovoGrad."""
    legs = {}
    noremat = dict(use_flash_attention=False, recompute_granularity=None)
    for key, label, expected, kw in (
            ("nonflash", "BERT-large non-flash (masked fused softmax)",
             BERT_NONFLASH_LAUNCHES, dict(use_flash_attention=False)),
            ("flash", "BERT-large flash", BERT_FLASH_LAUNCHES, {}),
            ("pytree", "BERT-large non-flash, no remat, pytree LAMB",
             BERT_NOREMAT_LAUNCHES, noremat),
            ("packed", "BERT-large non-flash, no remat, packed LAMB",
             {**BERT_NOREMAT_LAUNCHES, **LAMB_LAUNCHES},
             dict(noremat, make_opt=packed_lamb)),
            ("novograd", "BERT-large non-flash, no remat, packed NovoGrad",
             {**BERT_NOREMAT_LAUNCHES, **NOVOGRAD_LAUNCHES},
             dict(noremat, make_opt=packed_novograd))):
        legs[key] = bert_large_leg(dev, label, expected, 5, **kw)
        torch.cuda.empty_cache()
    log("  legs: " + "; ".join(
        f"{k} p50 {v['p50']:.2f} ms p99 {v['p99']:.2f} ms peak "
        f"{v['peak']:.2f} GiB" for k, v in legs.items()))
    pt, pk, nv = legs["pytree"], legs["packed"], legs["novograd"]
    log(f"  NovoGrad on BERT-large, the step alone: call {nv['opt_ms']:.3f} "
        f"ms host {_ms_list(nv['opt_host_ms'])} ms device "
        f"{nv['opt_device_ms']:.3f} ms bound {nv['opt_bound_ms']} ms; "
        f"train step p50 {nv['p50']:.2f} ms, peak {nv['peak']:.2f} GiB")
    log(f"  LAMB on BERT-large, the step alone: pytree call "
        f"{pt['opt_ms']:.3f} ms host {_ms_list(pt['opt_host_ms'])} ms "
        f"device {pt['opt_device_ms']:.3f} ms; packed call "
        f"{pk['opt_ms']:.3f} ms host {_ms_list(pk['opt_host_ms'])} ms "
        f"device {pk['opt_device_ms']:.3f} ms bound {pk['opt_bound_ms']} "
        f"ms; "
        f"train step p50 {pt['p50']:.2f} -> {pk['p50']:.2f} ms, peak "
        f"{pt['peak']:.2f} -> {pk['peak']:.2f} GiB")
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
    kw = dict(num_layers=2, hidden_size=HIDDEN, num_attention_heads=N_HEADS,
              vocab_size=vocab, max_position_embeddings=PARITY_SEQ,
              hidden_dropout=0.0, attention_dropout=0.0)
    return GPTConfig(**{**kw, **cfg_kw})


def gpt_parity(dev, label: str, kernels, make_opt=None, absent=(),
               scaled=False, **cfg_kw):
    """``gpt_loss`` of the 2-layer 345M-width GPT with packed
    FusedAdam(lr=1e-4, masters) or ``make_opt()``, card against CPU;
    ``scaled``: the loss-scaled, clipped step, then one forced
    overflow."""
    cfg = parity_cfg(50304, **cfg_kw)
    rng = np.random.default_rng(7)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                           (PARITY_BATCH, PARITY_SEQ)))
    labels = torch.roll(tokens, -1, dims=1)
    train_parity(dev, label, kernels, cfg,
                 lambda p, d: gpt_loss(cfg, p, tokens.to(d), labels.to(d)),
                 make_opt or (lambda: FusedAdam(lr=1e-4, master_weights=True,
                                                packed=True)),
                 absent=absent, scaled=scaled)


def bert_parity(dev, label: str, kernels, make_opt=None, absent=(),
                **cfg_kw):
    """``bench_bert_lamb``'s loss of the 2-layer BERT-large-width model
    under a padding mask (lengths 256 and 180) with pytree
    FusedLAMB(lr=1e-3) or ``make_opt()``, card against CPU."""
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
                 make_opt or (lambda: FusedLAMB(lr=1e-3)), absent=absent)


def train_parity(dev, label: str, kernels, cfg, loss_of, make_opt,
                 absent=(), scaled=False):
    """Loss, gradients and 3 optimizer steps of ``loss_of(params,
    device)`` on the card (kernels) against the CPU (plain versions), from
    the same fp32 params of ``cfg``; ``make_opt()`` builds each run's
    optimizer. ``kernels`` must each launch on the card run (the loss,
    gradients and steps), ``absent`` none, and nothing on the CPU run.
    ``scaled``: each step is :func:`scaled_step_fn` (dynamic loss
    scaling, the flat unscale, clipping to norm 1), and a fourth step
    with an inf in a gradient must be skipped on both runs
    (:func:`check_overflow_skip`)."""
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
        if scaled:
            scaler, poison = LossScaler("dynamic"), {"on": False}
            step = scaled_step_fn(lambda p: loss_of(p, d), opt, scaler,
                                  poison)
            state = (state, scaler.init_state(d))
        else:
            step = train_step_fn(lambda p: loss_of(p, d), opt)
        _device.reset_launch_counts()
        loss0, grads = value_and_grad(lambda p: loss_of(p, d), params)
        losses = []
        for _ in range(3):
            params, state, loss = step(params, state)
            losses.append(float(loss))
        losses.append(float(loss_of(params, d)))
        counts = _device.launch_counts()
        if scaled:
            check_overflow_skip(step, params, state, poison,
                                f"{label} ({where})")
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
    for name in absent:
        if g["counts"][name]:
            raise AssertionError(f"{name} launched on the card run")
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


def fused_width_parity(dev):
    """``fused_block=True`` at the widths the tails used to refuse: a
    1-layer fp32 GPT at hidden 5120 (40 heads) and 8192 (64 heads), head
    dim 128, seq 64, batch 2, vocab 512, loss and every gradient on the
    card (the fused tails at those widths, flash at head dim 128)
    against the CPU, within ``PARITY_TOL``'s fp32 loss and gradient
    limits. No optimizer step: the point is the tails' path."""
    loss_tol, grad_tol, _ = PARITY_TOL[torch.float32]
    kernels = FUSED_KERNELS + ("flash_attn_fwd", "flash_attn_bwd")
    rng = np.random.default_rng(11)
    tokens = torch.from_numpy(rng.integers(0, 512, (2, 64)))
    labels = torch.roll(tokens, -1, dims=1)
    for hidden in (5120, 8192):
        cfg = GPTConfig(num_layers=1, hidden_size=hidden,
                        num_attention_heads=hidden // 128, vocab_size=512,
                        max_position_embeddings=64, hidden_dropout=0.0,
                        attention_dropout=0.0, fused_block=True)
        cpu_params = init_gpt_params(cfg, torch.Generator().manual_seed(11))
        out = []
        for d in (torch.device("cpu"), dev):
            params = tree_map(lambda p: p.to(d, copy=True), cpu_params)
            _device.reset_launch_counts()
            loss, grads = value_and_grad(lambda p: gpt_loss(
                cfg, p, tokens.to(d), labels.to(d)), params)
            out.append((float(loss), [g.cpu() for g in tree_leaves(grads)],
                        _device.launch_counts()))
            del params, grads
        (lc, gc, cc), (lg, gg, cg) = out
        if any(cc.values()) or any(cg[k] <= 0 for k in kernels):
            raise AssertionError(f"hidden {hidden}: launches card {cg}, "
                                 f"cpu {cc}")
        rel = abs(lg - lc) / abs(lc)
        worst = max(float((b - a).abs().max() / a.abs().max().clamp_min(
            1e-30)) for a, b in zip(gc, gg))
        log(f"  fused block, 1 layer, hidden {hidden} fp32: loss card "
            f"{lg:.7f} cpu {lc:.7f} (rel {rel:.2e}); worst gradient leaf "
            f"{worst:.2e} of its largest entry; card launches "
            f"{({k: v for k, v in cg.items() if v})}")
        if rel > loss_tol or worst > grad_tol:
            raise AssertionError(f"hidden {hidden}: the card differs from "
                                 f"the CPU")
        del out, cpu_params


def watch_parity(dev):
    """A 2-layer full-width fp32 GPT under ``activation_watch``, card
    against CPU from the same params: the loss and gradients, then a
    packed-Adam step whose flat gradients pass ``tap_flat`` (#23 on the
    card). The per-layer ``attn`` and ``mlp`` records agree within
    ``PARITY_TOL``'s fp32 gradient limit (maxima and norms), counts
    exactly; then an inf planted in one leaf's gradient: the tap names
    that leaf, and the same one, on both."""
    cfg = parity_cfg(50304)
    rng = np.random.default_rng(12)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                           (PARITY_BATCH, PARITY_SEQ)))
    labels = torch.roll(tokens, -1, dims=1)
    cpu_params = init_gpt_params(cfg, torch.Generator().manual_seed(12))
    tol = PARITY_TOL[torch.float32][1]
    runs = {}
    for where in ("cpu", "cuda"):
        d = torch.device("cpu") if where == "cpu" else dev
        params = tree_map(lambda p: p.to(d, copy=True), cpu_params)
        opt = FusedAdam(lr=1e-4, master_weights=True, packed=True)
        state = opt.init(params)
        ring = telemetry.RingBufferRecorder()
        _device.reset_launch_counts()
        with telemetry.numerics.activation_watch(ring):
            _, grads = value_and_grad(lambda p: gpt_loss(
                cfg, p, tokens.to(d), labels.to(d)), params)
            tree_leaves(grads)[3].view(-1)[17] = float("inf")
            opt.step(grads, state, params)
        telemetry.flush()
        runs[where] = (list(ring.records), _device.launch_counts())
    (crec, ccount), (grec, gcount) = runs["cpu"], runs["cuda"]
    if any(ccount.values()) or gcount["packed_row_stats"] != 1:
        raise AssertionError(f"watch launches: card {gcount}, cpu {ccount}")
    if [(r["name"], r.get("layer")) for r in crec] != [
            (r["name"], r.get("layer")) for r in grec] or len(crec) != 5:
        raise AssertionError(f"tap records differ: {crec} vs {grec}")
    worst = 0.0
    for c, g in zip(crec[:4], grec[:4]):
        if c["nonfinite"] != g["nonfinite"]:
            raise AssertionError(f"tap {c['name']}: counts differ")
        for k in ("maxabs", "norm"):
            worst = max(worst, abs(g[k] - c[k]) / abs(c[k]))
    if worst > tol:
        raise AssertionError(f"tap statistics {worst:.3e} apart")
    leaf = PackSpec(cpu_params).leaf_names()[3]
    named = [[entry["name"] for entry in r["leaves"]] for r in (crec[4],
                                                                 grec[4])]
    if named != [[leaf], [leaf]]:
        raise AssertionError(f"tap_flat names {named}, the inf was in "
                             f"{leaf}")
    log(f"  activation watch, 2-layer full-width GPT fp32: 4 layer taps "
        f"within {worst:.2e} (maxima, norms), counts equal; packed Adam's "
        f"tap_flat (packed_row_stats x{gcount['packed_row_stats']}) names "
        f"{leaf} on both")


#: the norm modules, card against CPU: bf16 outputs and dx within one
#: bf16 rounding (TOL); the fp32 weight gradients, column sums over 8192
#: rows of the same products in another order, within 1e-4 of their norm
NORM_GRAD_TOL = 1e-4


def norm_module_parity(dev):
    """``FusedRMSNorm`` and ``MixedFusedRMSNorm`` on ``[8, 1024, 4096]``
    bf16 (random fp32 weights), forward and backward, with and without
    ``memory_efficient``, and ``FusedLayerNorm(32768)`` fp32 on ``[2, 64,
    32768]`` forward and backward: the card (the kernels) against the CPU
    (the plain versions). Returns the launch counts of the card runs
    (the RMSNorm kernels' launches in the kernels line)."""
    g = torch.Generator().manual_seed(13)
    cases = []
    for cls in (FusedRMSNorm, MixedFusedRMSNorm):
        for me in (False, True):
            cases.append((f"{cls.__name__}(4096, memory_efficient={me})",
                          lambda d, cls=cls, me=me: cls(
                              4096, memory_efficient=me, device=d),
                          (8, 1024, 4096), torch.bfloat16))
    cases.append(("FusedLayerNorm(32768)",
                  lambda d: FusedLayerNorm(32768, device=d),
                  (2, 64, 32768), torch.float32))
    total = {k: 0 for k in _device.LAUNCHES}
    for label, make, shape, dt in cases:
        x0 = (torch.randn(*shape, generator=g) * 2 + 0.5).to(dt)
        dy = torch.randn(*shape, generator=g).to(dt)
        mod0 = make("cpu")
        with torch.no_grad():
            for p in mod0.parameters():
                p.copy_(torch.rand(p.shape, generator=g) + 0.5)
        out = []
        for d in (torch.device("cpu"), dev):
            # no device named: the modules build on the card by default
            mod = make(d if d.type == "cpu" else None)
            if {p.device for p in mod.parameters()} != {d}:
                raise AssertionError(f"{label}: parameters not on {d}")
            mod.load_state_dict(mod0.state_dict())
            x = x0.to(d, copy=True).requires_grad_(True)
            _device.reset_launch_counts()
            y = mod(x)
            y.backward(dy.to(d))
            out.append((y.detach().cpu(), x.grad.cpu(),
                        [p.grad.cpu() for p in mod.parameters()],
                        _device.launch_counts()))
        (yc, dxc, pc, cc), (yg, dxg, pg, cg) = out
        kernels = (("rms_norm_fwd", "rms_norm_bwd") if "RMS" in label
                   else ("layer_norm_fwd", "layer_norm_bwd"))
        if any(cc.values()) or any(cg[k] != 1 for k in kernels):
            raise AssertionError(f"{label}: launches card {cg}, cpu {cc}")
        err = max(check_close(f"{label} y", yg, yc, dt),
                  check_close(f"{label} dx", dxg, dxc, dt))
        rel = max(float((a - b).norm() / b.norm()) for a, b in zip(pg, pc))
        if rel > NORM_GRAD_TOL:
            raise AssertionError(f"{label}: weight gradients {rel:.3e} of "
                                 f"their norm apart")
        for k, v in cg.items():
            total[k] += v
        log(f"  {label} on {list(shape)} {str(dt)[6:]}: card against cpu y, "
            f"dx max abs err {err:.3e}, weight gradients {rel:.2e} of their "
            f"norm")
        del x0, dy, out
    return total


#: packed against pytree LAMB on the card: the two compute u, m and v
#: with the same rounded operations and differ only in the order of the
#: trust ratios' sums (~1e-6 of a ratio), so each leaf's 3-step update
#: agrees with the other's to ~1e-4 of its largest entry (an fp32 ulp of
#: the params against steps of lr * ratio * |u|); a wrong trust ratio
#: moves a leaf by a factor, a wrong segment several leaves
PACKED_LAMB_TOL = 1e-3


def lamb_packed_against_pytree(dev):
    """3 FusedLAMB(lr=1e-3) steps, packed and pytree, on the card from the
    same fp32 params of the 2-layer BERT-large-width model and the same
    3 sets of gradients (seeded): each leaf's update, packed against
    pytree, within ``PACKED_LAMB_TOL`` of its largest entry."""
    cfg = parity_cfg(BERT_VOCAB)
    params = init_gpt_params(cfg, torch.Generator(device=dev).manual_seed(9),
                             device=dev)
    gen = torch.Generator(device=dev).manual_seed(10)
    grads = [tree_map(lambda p: torch.randn(p.shape, generator=gen,
                                            device=dev) * 1e-3, params)
             for _ in range(3)]
    updates = {}
    for name, opt in (("pytree", FusedLAMB(lr=1e-3)),
                      ("packed", packed_lamb())):
        p = tree_map(lambda x: x.clone(), params)
        state = opt.init(p)
        for g in grads:
            p, state = opt.step(g, state, p)
        updates[name] = [a - b for a, b in zip(tree_leaves(p),
                                               tree_leaves(params))]
    worst = 0.0
    for leaf, a, b in zip(PackSpec(params).leaf_names(), updates["pytree"],
                          updates["packed"]):
        rel = float((b - a).abs().max() / a.abs().max().clamp_min(1e-30))
        worst = max(worst, rel)
        if rel > PACKED_LAMB_TOL:
            raise AssertionError(f"packed LAMB update of {leaf}: {rel:.3e} "
                                 f"of the pytree update's largest entry")
    log(f"  packed against pytree LAMB, 2-layer BERT-large width, 3 steps: "
        f"worst leaf update {worst:.3e} of its largest entry (limit "
        f"{PACKED_LAMB_TOL})")


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

    (fd, ln, ln_bwd, ln_wide_errs, rms, tier_errs, (fa_fwd, fa_bwd),
     head_dim_errs, adam, fused, softmax, lamb, sgd, flat, row_stats,
     novograd) = phase(
        "phase 2: kernels against their plain versions",
        lambda: (flash_decode_checks(dev), layer_norm_checks(dev),
                 layer_norm_bwd_checks(dev), layer_norm_width_checks(dev),
                 rms_norm_checks(dev), norm_bwd_tier_checks(dev),
                 flash_attention_checks(dev),
                 flash_head_dim_checks(dev), packed_adam_checks(dev),
                 fused_block_checks(dev), fused_softmax_checks(dev),
                 packed_lamb_checks(dev), packed_sgd_checks(dev),
                 packed_flat_checks(dev), packed_row_stats_checks(dev),
                 packed_novograd_checks(dev)))
    fa_fwd["max_abs_err"] = max(fa_fwd["max_abs_err"], head_dim_errs[0])
    fa_bwd["max_abs_err"] = max(fa_bwd["max_abs_err"], head_dim_errs[1])
    ln["max_abs_err"] = max(ln["max_abs_err"], ln_wide_errs[0])
    ln_bwd["max_abs_err"] = max(ln_bwd["max_abs_err"], ln_wide_errs[1],
                                tier_errs[0])
    rms[1]["max_abs_err"] = max(rms[1]["max_abs_err"], tier_errs[1])
    serving = phase("phase 3: GPT-2 345M bf16 serving", serve_345m, dev)
    overload = phase("phase 3b: GPT-2 345M bf16 serving under a 2x overload "
                     "storm (admission, deadlines, degradation armed)",
                     serve_overload, dev)
    spec_launches, spec_fd = phase(
        "phase 3c: speculative decoding A/B on the storm (spec_k 0 and 4)",
        spec_ab, dev)
    chaos_near = phase("phase 3d: chaos, the watchdog, recovery and "
                       "tracing (fp32)", chaos_checks, dev)
    near = phase("phase 4: fp32 token identity, plain and spec_k=4",
                 token_identity, dev)
    log(f"  near-ties: {near} (phase 3d: {chaos_near})")
    train = phase("phase 5: GPT-2 345M bf16 train step: headline, unfused, "
                  "fused, non-flash, packed-SGD, loss-scaled clipped and "
                  "two monitored legs", train_345m, dev)
    bert = phase("phase 6: BERT-large bf16: non-flash and flash legs with "
                 "FusedLAMB, then pytree and packed LAMB and packed "
                 "NovoGrad without recompute", train_bert_large, dev)
    norms = phase("phase 7: the norm modules and the activation watch, card "
                  "against CPU", lambda: (norm_module_parity(dev),
                                          watch_parity(dev)))[0]
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
                               use_flash_attention=False),
                   gpt_parity(dev, "unfused, packed FusedSGD",
                              TRAIN_KERNELS[:4] + ("packed_sgd",),
                              make_opt=packed_sgd),
                   bert_parity(dev, "BERT non-flash fp32, packed LAMB",
                               ("layer_norm_fwd", "layer_norm_bwd")
                               + LAMB_KERNELS, make_opt=packed_lamb,
                               use_flash_attention=False),
                   bert_parity(dev, "BERT non-flash, padding mask, packed "
                               "LAMB",
                               ("softmax_masked_fwd", "softmax_bwd",
                                "layer_norm_fwd", "layer_norm_bwd")
                               + LAMB_KERNELS, make_opt=packed_lamb,
                               compute_dtype=torch.bfloat16,
                               use_flash_attention=False),
                   lamb_packed_against_pytree(dev),
                   gpt_parity(dev, "unfused, loss-scaled, clipped",
                              TRAIN_KERNELS[:4] + ("packed_adam",
                                                   "scale_flat",
                                                   "packed_row_reduce"),
                              scaled=True),
                   bert_parity(dev, "BERT non-flash fp32, packed NovoGrad",
                               ("layer_norm_fwd", "layer_norm_bwd")
                               + NOVOGRAD_KERNELS,
                               make_opt=packed_novograd,
                               use_flash_attention=False),
                   bert_parity(dev, "BERT non-flash fp32, packed NovoGrad "
                               "inf norm",
                               ("layer_norm_fwd", "layer_norm_bwd")
                               + NOVOGRAD_KERNELS,
                               make_opt=lambda: FusedNovoGrad(
                                   lr=NOVOGRAD_LR, norm_type=0, packed=True),
                               use_flash_attention=False),
                   bert_parity(dev, "BERT non-flash, padding mask, packed "
                               "NovoGrad",
                               ("softmax_masked_fwd", "softmax_bwd",
                                "layer_norm_fwd", "layer_norm_bwd")
                               + NOVOGRAD_KERNELS,
                               make_opt=packed_novograd,
                               compute_dtype=torch.bfloat16,
                               use_flash_attention=False),
                   gpt_parity(dev, "head dim 128 (8 heads), flash by default",
                              TRAIN_KERNELS[:4], num_attention_heads=8),
                   fused_width_parity(dev),
                   gpt_parity(dev, "head dim 80 (hidden 1280), no flash "
                              "kernel: fused softmax",
                              ("softmax_fwd", "softmax_bwd",
                               "layer_norm_fwd", "layer_norm_bwd"),
                              absent=("flash_attn_fwd", "flash_attn_bwd"),
                              hidden_size=1280,
                              compute_dtype=torch.bfloat16)))
    # the serving runs: phase 3, the overload storm and both sides of the
    # speculative A/B
    served = [serving, overload, *spec_launches.values()]
    fd["launches"] = sum(c["flash_decode"] for c in served)
    # launches on the main paths: the serving runs, the eight GPT legs and
    # the five BERT legs
    ln["launches"] = (sum(c["layer_norm_fwd"] for c in served)
                      + train["layer_norm_fwd"] + bert["layer_norm_fwd"])
    log(f"  flash_decode at the spec step's 64 query rows: "
        f"{json.dumps(spec_fd)}")
    kernels = (fd, ln, ln_bwd, *rms, fa_fwd, fa_bwd, adam, *fused,
               *softmax, *lamb, sgd, *flat, row_stats, novograd)
    for kr in kernels[2:]:
        kr["launches"] = train.get(kr["name"], 0) + bert.get(kr["name"], 0)
    # no model of the JAX package normalises with RMSNorm: its kernels'
    # launches are those of the norm-module parity runs of phase 7
    for kr in rms:
        kr["launches"] = norms[kr["name"]]
    # multi_tensor_axpby_flat has no caller in the JAX package outside its
    # own module and tests, and no model of it normalises with RMSNorm, so
    # no main path launches these three: axpby_flat is checked and timed in
    # phase 2 only, the RMSNorm kernels also through the modules (phase 7)
    exempt = ("axpby_flat", "rms_norm_fwd", "rms_norm_bwd")
    idle = [kr["name"] for kr in kernels
            if kr["launches"] <= 0 and kr["name"] not in exempt]
    if idle:
        raise AssertionError(f"kernels never launched on a main path: "
                             f"{idle}")
    keys = ("name", "route", "source", "replaces", "launches",
            "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")
    log(f"total {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"kernels": [{k: kr[k] for k in keys}
                                  for kr in kernels]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
