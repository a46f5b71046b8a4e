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
   bitwise equal; at head dims 48, 80 and 160 (no kernel of their own:
   the next one's on zero-padded operands) in fp32 and bf16, causal, a
   dead row, dropout and a cross shape; the fused tails at widths 5120, 8192,
   16384 and 1000; the flat scale (bf16 -> fp32, fp32 -> fp32, fp32 ->
   bf16, per-row flags naming planted inf, nan and overflow rows, a
   ragged length) and axpby over the 345M buffer; packed NovoGrad over
   BERT-large's buffer with L2 and inf-norm denominators, decay inside
   and outside the moment, and noop; the LayerNorm forward and backward
   at hidden 32768 and 65536; both norm forwards at every branch of
   their plan (the team kernels at widths 1000-8192, a block a row with
   the row staged in shared memory, and past it) in fp32, bf16 and fp16
   at 1, 7 and 8192 rows, from 16-byte aligned pointers and from views
   one element off; the RMSNorm forward and backward at the
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
   kernels each run twice, bit for bit; flash attention's additive bias,
   every broadcast shape, with and without its gradient, a -1e30 folded
   into it masking whole rows, and its segment ids from cu_seqlens, in
   fp32, bf16 and fp16, the bf16 backward with dbias and with segments
   twice bit for bit, both timed at the openfold MSA shape and the packed
   fmha shape against SDPA with the equivalent mask; the fp16
   instantiation of every kernel that took bf16 only before: decode, the
   norms, the fused tails, the packed sweeps, the flat ops, the row
   statistics);
   times of kernel, plain version, one PyTorch library call as
   yardstick (the device time of SDPA, of ``F.layer_norm``'s and
   ``F.rms_norm``'s backward kernels, and of their forwards
   at [8192, 1024] fp32 and bf16 beside each call's time, warm and with
   the inputs rotated past the L2), and the least time the card could
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
   GPTs at head dim 128 (flash), 80 (flash on zero-padded operands) and
   320 (past flash's 256: the fused softmax) with the default attention
   choice, and 1-layer fused-block
   GPTs at hidden 5120 and 8192 (loss and gradients), and an fp16 GPT
   with the fused tails and flash against the plain versions on the card
   (the host's fp16 GEMMs are too slow to serve as the reference);
8. the attention contribs at full width, forward and backward, the
   kernels against their plain versions on the card (loss and every
   gradient), with each leg's device time and peak memory: ``FMHA`` at
   BERT-large's geometry over 32 packed sequences of 64-512 tokens with
   dropout 0.1, fp16 and bf16 (segment ids); ``SelfMultiheadAttn`` at
   Transformer-big's (1024, 16 heads, s 256, b 16, ragged lengths) fp16
   with an additive key-padding mask (the bias, ``bias_grad=False``) and
   with ``include_norm_add`` and a boolean padding mask;
   ``EncdecMultiheadAttn`` fp16, 256 queries over 200 keys; openfold's
   MSA row attention [1, 128, 8, 256, 32] bf16 with a key mask and a pair
   bias with its gradient, and triangle attention [1, 256, 4, 256, 32]
   with its bias; at head dim 48 (the head-dim-64 kernels on zero-padded
   operands), ``FMHA`` (768, 16 heads) over the same packed sequences and
   MSA row attention [1, 64, 8, 256, 48], bf16;
9. ResNet-50 with amp (BASELINE config #1; no kernel of the port on its
   path: cuDNN's convolutions, cuBLAS's classifier, plain PyTorch
   BatchNorm and pytree FusedSGD): 224 px, 1000 classes, random weights
   from a seed, one synthetic uint8 batch of 256 staged on the card,
   through ``main_amp.make_train_step``: O2 bf16 (2 + 6 steps: p50 / p99,
   images/s, peak memory, a profiled step's busy and idle share, its
   device ops and any NCHW/NHWC transposes, the dtypes ``initialize``
   gives each leaf), the overflow step (an input of 1e30, skipped bit for
   bit, the scale halved), O2 fp16 with the dynamic scale (skips
   counted), O0, O1 (inside its ``autocast`` context: a conv sees bf16,
   ``log_softmax`` fp32) and O3 (1 + 3 steps each), every loss finite and
   falling and no port kernel launched; card against CPU at batch 8 with
   TF32 off in fp64, fp32 and bf16 (``RESNET_PARITY``); and
   ``main_amp.main`` as a user runs it (O2, batch 256, 3 steps, a
   checkpoint in a temporary directory);
10. fp8 (``fused_dense.fp8``) and the other modules of A5.2-A5.4, none
   with a kernel of its own: (a) the fp8 GEMM route (``torch._scaled_mm``
   on the fp8 tensor cores, e4m3 x e4m3, the dequantization folded in)
   against its plain version over the same fp8 bytes at the 345M's four
   projection shapes and at padded ones ([8192, 1000] x [1000, 1000],
   7 rows), bf16, fp16 and fp32 out; the quantizers' bytes against the
   CPU's and their saturation; the device time of one ``_scaled_mm``
   and one bf16 ``F.linear`` a shape against their bounds (1979 and 989
   TFLOP/s) and of the quantize passes; (b) ``bench.py``'s
   ``bench_fp8_gemm`` chain of 8 GEMMs at [8192, 4096] x [4096, 4096],
   bf16 against ``fp8_fused_dense`` with its state update, the ratio;
   (c) ``bench_gpt_fp8``: the 345M unfused step with the four
   projections of every layer on the fp8 recipe (2 + 6 steps, launches
   exact with 96 fp8 GEMMs a step, a profiled step holding 96 of the
   GEMM's op, loss falling, every layer's states calibrated, p50 beside
   phase 5's bf16 unfused leg); (d) the 2-layer full-width fp8 GPT, card
   against CPU, unfused and fused under ``selective_elementwise``, 3
   steps in lockstep (``FP8_PARITY_TOL``: the gradients held to the
   recipe's own error, since its e5m2 backward is chaotic);
   (e) ``fused_dense_gelu_dense`` at the 345M's MLP, bf16, against the
   plain versions (the bias-GeLU kernels launched); (f) ``MLP`` at the
   upstream test's sizes, relu, sigmoid and none, card against CPU; (g)
   ``fused_rope``'s four layouts at Llama-2-7B's attention shape, ragged
   ``thd`` and a 32 x 32 image, card against CPU, forward and backward;
   (h) ``FusedAdamSWA`` over the 345M's tree in its three math modes,
   3 steps, card against CPU on each leaf's first 65536 elements;
11. the single-device contribs of A5.5 and ``RNN/`` at full width, no
   kernel of the port on their paths (the launch counts read zero after
   the phase), each leg forward and backward, timed, with its peak memory
   and a byte or operation bound where the work is clean, and held
   against the CPU on a slice or a small batch (``CONTRIB_TOL``): (a)
   ``focal_loss`` at EfficientDet-D0's 49,104 anchors an image, 16 images,
   96 classes (90 real), fp16, smoothing 0 and 0.1; (b) NHWC GroupNorm +
   swish at the Stable Diffusion 1.5 UNet's four widths, bf16 and fp16;
   (c) ``BatchNorm2d_NHWC`` at ``[256, 56, 56, 256]`` bf16, add + ReLU and
   ReLU, two training steps and one in evaluation; (d) the four
   ``conv_bias_relu`` functions at ResNet-50's 3x3 and strided 1x1 shapes,
   bf16; (e) the ``Bottleneck`` at ResNet-50's stage-1 and stage-2 first
   blocks, batch 256, bf16 input computed in fp32; (f) ``index_mul_2d``
   at 524,288 gathered rows of 128, fp32, fp16 and bf16, forward,
   backward and double backward; (g) ``ASP`` over the 345M's tree (masks
   bit for bit), three masked ``FusedAdam`` steps, ``channel_swap_search``
   on a ``[1024, 1024]`` weight; (h) the RNN-T joint and loss at the
   MLPerf reference's widths (hidden 512, vocab 1024, batch 8, T 200, U
   80), dense and packed, fp16; (i) the legacy contrib ``FusedAdam``
   (scale 1024, clipped, both epsilon modes, bf16 output copies) and
   ``FusedSGD`` over the 345M's tree; (j) sentiment-discovery's mLSTM
   (hidden 4096, seq 256, batch 32) and the stacked bidirectional LSTM,
   GRU, ReLU and Tanh (hidden 1024); a ``{"phase11": [...]}`` line of the
   legs;
12. the rest of the single-device library (A5.6) and ``parallel_state``
   (A6.1) at the 345M's full width (``a56_phase``): (a)
   ``multi_tensor_applier`` over ``packed_adam_apply`` and the four flat
   ops on the 345M's flat buffer at chunks 65536 and 4096, bit for bit
   against the direct calls, and the six optimizers
   ``FusedOptimizer``s; (b) ``hostio`` write and read of the 345M's fp32
   tree from and into card tensors (~1.4 GB, GB/s) and ``flatten`` /
   ``unflatten``, bit for bit; (c) ``GDSFile`` of a bf16 and an fp32 card
   tensor, the file their bytes, ``load_data`` in place; (d)
   ``checkpoint`` of the 345M unfused leg's state after 2 steps, saved
   from and loaded onto the card, every leaf and the next step bit for
   bit, a truncation raising ``CheckpointCorruptError``, a dead writer's
   staging tree swept; (e) ``gpt_model_provider`` with ``cpu_offload``
   off and on, the 345M unfused step, losses bit for bit, p50, peak (the
   offload's lower) and idle share, then ``gpt_scaling_test`` at 24 x
   1024 both ways; (f) NCCL at world 1 over a ``file://`` store: the
   345M fp8 step with ``fp8_amax_reduction_axes`` bit for bit against
   the step without (100 all-reduces a step), and ``GradScaler``
   skipping a poisoned step; a ``{"phase12": [...]}`` line of the legs;
13. data parallelism (A6.2, A6.3) on NCCL at world 1 over a ``file://``
   store (``ddp_phase``; one card: the collectives' path and cost, not a
   reduction across cards): (a) the 345M unfused step (no recompute, bf16
   over fp32 masters) on ``DistributedDataParallel(bucket_cap_mb=25)``,
   ``reduce_flat`` -> ``unscale_flat`` -> ``clip_grad_norm_flat`` ->
   ``FusedAdam(packed_spec=buckets.spec)``: launches exact, one
   all-reduce a bucket, p50 / p99, peak, idle share, 3 steps bit for bit
   against the step without the all-reduce, the host's top operations
   with and without it, and ``sync_gradients`` (one all-reduce a leaf)
   timed against the bucketed reduction; (b) ``bench_grad_lifecycle``'s
   A/B at 64 Mi bf16 parameters in 24 leaves, 4 MB buckets, chunk 8192:
   steps/s of the per-leaf step and of the fused flat lifecycle
   (``reduce_flat(concat=False)`` -> ``found_inf_flat`` -> ``step_flat``),
   the latter's ``sweep_bytes`` rate; (c) ``FusedSGD(packed_spec=...)``
   on the reduced buffer bit for bit against the tree; (d) BASELINE
   config #2, ResNet-50 O2 bf16 with DDP + SyncBatchNorm + FusedAdam at
   batch 256 through ``main_amp.make_train_step`` (p50, images/s, peak,
   idle share, all-reduces a step, beside phase 9's O2 bf16 p50), then
   card (NCCL) against CPU (a gloo group) at batch 8 under phase 9's
   gates; (e) ``LARC(FusedSGD)`` over the ResNet-50 tree, step ms, card
   against CPU; (f) the simple DDP example's CLI, 50 steps, its loss
   falling; a ``{"phase13": [...]}`` line of the legs;
14. tensor and sequence parallelism (A6.4) and the two single-device
   examples (A5.7.1) (``tp_phase``), on two transports of the one card:
   (a) NCCL at world 1 over a ``file://`` store (the collectives' path
   and cost): the 345M unfused step (batch 8, bf16 over fp32 masters,
   packed FusedAdam) through ``axis_name="tensor"``, 3 steps, its losses
   against the dense step's within phase 5's bf16 loss parity, p50, peak,
   the collectives a step; (b)-(d) gloo worlds of 2 and 8 processes that
   share the card (NCCL refuses two ranks on one device: the kernels run
   at the shard shapes, the collectives travel through the host), after
   a probe of which collectives gloo takes on CUDA tensors: (b) TP 2, the
   345M fused at batch 4 with sequence parallelism off and, where gloo
   takes its collectives, on: one step a rank on ``shard_gpt_params``'
   shards, the loss equal on both ranks, the loss and five leaves'
   gathered gradients against the dense fused step on the card; (c)
   BASELINE config #4, TP 8 with the fused tails and packed FusedAdam on
   each shard, 2 + 3 steps: the loss falling and equal on every rank,
   p50, every rank's peak, the collectives a step, rank 0's profiled
   step and its kernels' device time a launch beside their bounds at the
   shard shapes; (d) the microbatch calculator driving (b)'s step over 4
   microbatches through ``accumulate_main_grads``, the fp32
   ``main_grad`` against the one-batch gradient; (e) the ``fp8_training``
   and ``dcgan`` examples' CLIs, 20 steps each; a ``{"phase14": [...]}``
   line of the legs;
15. (phase 16) the rest of A6 (``a6_phase``): (a) ZeRO
   ``DistributedFusedAdam(distributed_size=1)`` on NCCL at world 1, the
   345M unfused step (6 of 24 layers) 3 steps against pytree
   ``FusedAdam(master_weights=True)``; then two gloo worlds of processes
   sharing the card, side by side: a world of 4 runs (b) ZeRO-2 on the
   345M (6 layers, batch 2 a rank, 2 + 3 steps: the loss equal on every
   rank and falling, the first step's reduced gradient shard against
   (a)'s dense gradient leaf by leaf, with two planted faults that must
   fail the same limit, the optimizer state a rank 1/4 of the dense one,
   p50, peaks, the reduce-scatter's and all-gather's bytes), (d)
   ``SpatialBottleneck`` at ResNet-50's conv2_x (batch 32, 56 x 56, bf16,
   14 rows a rank) forward against the dense ``Bottleneck``, the
   gradients in fp64 and, by norm, at the timed dtype (with lost halos
   as the planted fault), with the four exchangers' halos, and (e) the
   345M's width at 2 layers served at TP 4 over phase 3's trace, plain
   and with ``spec_k=4`` and sampled rows; a world of 2 runs (c)
   BERT-large (6 layers) with ``DistributedFusedLAMB`` (3 steps against
   pytree ``FusedLAMB`` over the same gradient) and (e) at TP 2.
   (e) holds every rank's tokens equal, and each request's against the TP
   1 engine's: equal, or first apart at a near-tie (``P16_TIE_GAP``);
   ``psum_per_program`` all 3s, 2L + 1 all-reduce sums a step, a rank's
   pool 1/tp of TP 1's, the launches a step a rank, rank 0's profiled
   decode step; #1 at the shard shapes (8 and 4 heads) against its plain
   version twice bit for bit, timed against its bound; a
   ``{"phase16": [...]}`` line of the legs;
16. a ``{"kernels": [...]}`` line (25 kernels, the decode kernel's and
   the LayerNorm forward's launches counted over the serving runs of
   phases 3-3c; every one launched on a
   main path (flash attention's also over phase 8's legs, the norms',
   flash's and packed Adam's also over phases 10, 12, 13 and 14's 345M
   steps (phase 14's on every rank), the fused tails' also over phase
   14's fused steps, bias-GeLU's also over ``fused_dense_gelu_dense``, packed Adam's,
   the row statistics', the row reduce's and the flat scale's and axpby's
   also over phase 12's applier, the row reduce's and the flat scale's
   over phase 13's clipped DDP step, packed SGD's over phase 13's (c);
   phases 15 and 16 add their main paths' launches on every rank)
   except the RMSNorm pair, which no model
   of the JAX package runs: their launches are the norm modules' of
   phase 7), the card line, and last ``{"ok": true, "device":
   {...}}``.

Exits non-zero when no CUDA device is present.
"""
from __future__ import annotations

import concurrent.futures
import contextlib
import copy
import dataclasses
import functools
import importlib
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
import unittest.mock

import numpy as np
import torch
import torch.nn.functional as F

from apex_tpu_torch import _build, _device, telemetry
from apex_tpu_torch import amp
from apex_tpu_torch._tree import (
    leaf_paths,
    tree_flatten,
    tree_leaves,
    tree_map,
    tree_unflatten,
    value_and_grad,
)
from apex_tpu_torch.amp import LossScaler
from apex_tpu_torch.checkpoint import (
    CheckpointCorruptError,
    load_checkpoint,
    save_checkpoint,
)
from apex_tpu_torch.contrib.clip_grad import clip_grad_norm_flat
from apex_tpu_torch.contrib.fmha import FMHA
from apex_tpu_torch.contrib.gpu_direct_storage import GDSFile
from apex_tpu_torch.contrib.multihead_attn import (
    EncdecMultiheadAttn,
    SelfMultiheadAttn,
)
from apex_tpu_torch.contrib.openfold import (
    AdamMathType,
    FusedAdamSWA,
    attention_core,
)
from apex_tpu_torch.contrib.xentropy import (
    lm_head_cross_entropy,
    softmax_cross_entropy_loss,
)
from apex_tpu_torch.examples.gpt import gpt_scaling_test
from apex_tpu_torch.examples.imagenet import main_amp, resnet
from apex_tpu_torch.fused_dense import fp8, fused_dense_gelu_dense
from apex_tpu_torch.mlp import MLP
from apex_tpu_torch.multi_tensor_apply import MultiTensorApply, PackSpec
from apex_tpu_torch.normalization import (
    FusedLayerNorm,
    FusedRMSNorm,
    MixedFusedRMSNorm,
)
from apex_tpu_torch.ops import fused_block as fb
from apex_tpu_torch.ops import hostio
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
    multi_tensor_l2norm_flat,
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
    FusedAdagrad,
    FusedAdam,
    FusedLAMB,
    FusedMixedPrecisionLamb,
    FusedNovoGrad,
    FusedOptimizer,
    FusedSGD,
)
from apex_tpu_torch.optimizers.fused_novograd import (
    leaf_norms_sq,
    row_denominators,
)
from apex_tpu_torch.parallel import (
    LARC,
    DistributedDataParallel,
    GradBuckets,
    sync_gradients,
)
from apex_tpu_torch.resilience import (
    ChaosError,
    ChaosMonkey,
    CheckpointManager,
    ElasticCheckpointManager,
    HangError,
    HangWatchdog,
    IndexedBatches,
    RetryPolicy,
    RewindController,
    ServingChaos,
    Supervisor,
    grad_buckets_for_world,
    poison_grads,
)
from apex_tpu_torch.resilience import capture as rcapture
from apex_tpu_torch.resilience import resume_or_init as rresume_or_init
from apex_tpu_torch.resilience import state as rstate
from apex_tpu_torch.resilience.state import tree_leaves as res_tree_leaves
from apex_tpu_torch.serving import sampling
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
from apex_tpu_torch.transformer import parallel_state
from apex_tpu_torch.transformer.amp import GradScaler
from apex_tpu_torch.transformer.functional import fused_softmax as fs
from apex_tpu_torch.transformer.functional import (
    fused_apply_rotary_pos_emb,
    fused_apply_rotary_pos_emb_2d,
    fused_apply_rotary_pos_emb_cached,
    fused_apply_rotary_pos_emb_thd,
)
from apex_tpu_torch.transformer.microbatches import (
    build_num_microbatches_calculator,
)
from apex_tpu_torch.transformer.pipeline_parallel import (
    get_forward_backward_func,
)
from apex_tpu_torch.transformer.tensor_parallel import (
    accumulate_main_grads,
    vocab_parallel_cross_entropy,
)
from apex_tpu_torch.transformer.testing import (
    FP8_GEMM_NAMES,
    GPTConfig,
    bert_forward,
    gpt_forward,
    gpt_loss,
    gpt_model_provider,
    gpt_partition_specs,
    init_gpt_fp8_carriers,
    init_gpt_fp8_states,
    init_gpt_params,
    gpt_embed,
    pipeline_stage_layers,
    record_gpt_grad_amaxes,
    shard_gpt_params,
    transformer_block,
)
from apex_tpu_torch.transformer.testing.standalone_transformer_lm import (
    _lm_head,
    ln_fp32,
)

# the modules (the package re-exports functions of the same names)
fd_mod = importlib.import_module("apex_tpu_torch.ops.flash_decode")
fa_mod = importlib.import_module("apex_tpu_torch.ops.flash_attention")
ln_mod = importlib.import_module("apex_tpu_torch.ops.layer_norm")
cp_mod = importlib.import_module("apex_tpu_torch.transformer.context_parallel")
pp_p2p = importlib.import_module(
    "apex_tpu_torch.transformer.pipeline_parallel.p2p_communication")
pp_schedules = importlib.import_module(
    "apex_tpu_torch.transformer.pipeline_parallel.schedules")
pp_utils = importlib.import_module(
    "apex_tpu_torch.transformer.pipeline_parallel.utils")
mha_reference = fa_mod.mha_reference

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


def device_split(fn, match: str, iters: int = 5):
    """``(all kernels', matching kernels')`` device ms per call of ``fn``
    from one ``torch.profiler`` trace, so the share and the whole come
    from the same calls; None when the trace shows no device activity."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    events = prof.key_averages()
    total = sum(e.device_time_total for e in events)
    part = sum(e.device_time_total for e in events if match in e.key)
    if not total:
        return None
    return total / 1e3 / iters, part / 1e3 / iters


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
                               "::ln_fwd_")
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
                              "::ln_fwd_")
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


#: the forward norms' plan branches (``ln_mod.norm_fwd_plan``) by width:
#: the team kernels (vector widths, ragged 1025, and 1000, a whole number
#: of vectors in fp32 but not in 16 bits; up to 8192), a block a row
#: staging the row in shared memory (8193, 32768; 65536 in 16 bits) and
#: past it, the row swept from L1/L2 (65536 fp32, 131072 in 16 bits);
#: each at the rows given
NORM_FWD_WIDTHS = ((1024, (1, 7, 8192)), (1000, (7,)), (1025, (1, 7, 8192)),
                   (8192, (7, 8192)), (8193, (7, 8192)), (32768, (1, 7)),
                   (65536, (1, 7)), (131072, (1, 7)))


def _fwd_branch(rows: int, hidden: int, dt, dev) -> str:
    """The kernel the forward plan runs: "team", "staged" or "swept"."""
    es = torch.tensor([], dtype=dt).element_size()
    plan = ln_mod.norm_fwd_plan(rows, hidden, _build.sm_count(dev.index), es)
    if plan.warps_per_row:
        return "team"
    optin = torch.cuda.get_device_properties(
        dev.index).shared_memory_per_block_optin
    # the staged row in 16-byte vectors beside the block's static array
    return "staged" if -(-hidden * es // 16) * 16 + 64 <= optin else "swept"


def norm_fwd_branch_checks(dev):
    """Both forwards (#2, #4) against their plain versions at every branch
    of their plan (``NORM_FWD_WIDTHS``) in fp32, bf16 and fp16, rows 1, 7
    and 8192, each also from a view at an element offset of 1 of a flat
    buffer (a pointer that is not 16-byte aligned: the element-by-element
    path): y at its dtype's tolerance, mu and rstd at fp32's, one launch a
    call. Returns the worst LayerNorm and RMSNorm errors."""
    g = torch.Generator(device=dev).manual_seed(31)
    errs = {"layer_norm_fwd": [], "rms_norm_fwd": []}
    seen = set()
    for dt in (torch.float32, torch.bfloat16, torch.float16):
        for hidden, rows_list in NORM_FWD_WIDTHS:
            w = torch.randn(hidden, generator=g, device=dev)
            b = torch.randn(hidden, generator=g, device=dev)
            for rows in rows_list:
                flat = (torch.randn(rows * hidden + 1, generator=g,
                                    device=dev) * 3 + 1).to(dt)
                branch = _fwd_branch(rows, hidden, dt, dev)
                for name, x in (("aligned", flat[:-1].view(rows, hidden)),
                                ("offset 1", flat[1:].view(rows, hidden))):
                    label = (f"[{rows},{hidden}] {str(dt)[6:]} {branch} "
                             f"{name}")
                    _device.reset_launch_counts()
                    y, mu, rstd = layer_norm_fwd(x, w, b, eps=1e-5)
                    ys, rs = rms_norm_fwd(x, w)
                    counts = _device.launch_counts()
                    if (counts["layer_norm_fwd"],
                            counts["rms_norm_fwd"]) != (1, 1):
                        raise AssertionError(f"norm forwards {label}: "
                                             f"launches {counts}")
                    ry, rmu, rrstd = layer_norm_reference(x, w, b, 1e-5)
                    rys, rrs = rms_norm_reference(x, w, 1e-5)
                    errs["layer_norm_fwd"].append(max(
                        check_close(f"layer_norm y {label}", y, ry, dt),
                        check_close(f"layer_norm mu {label}", mu, rmu,
                                    torch.float32),
                        check_close(f"layer_norm rstd {label}", rstd, rrstd,
                                    torch.float32)))
                    errs["rms_norm_fwd"].append(max(
                        check_close(f"rms_norm y {label}", ys, rys, dt),
                        check_close(f"rms_norm rstd {label}", rs, rrs,
                                    torch.float32)))
                    seen.add((str(dt)[6:], branch))
                del flat
        torch.cuda.empty_cache()
    missing = {(d, b) for d in ("float32", "bfloat16", "float16")
               for b in ("team", "staged", "swept")} - seen
    if missing:
        raise AssertionError(f"norm forward branches not run: {missing}")
    log(f"  norm forwards at every plan branch (team, staged, swept), "
        f"aligned and at offset 1, fp32/bf16/fp16, rows 1, 7, 8192: max "
        f"abs err LayerNorm {max(errs['layer_norm_fwd']):.3e}, RMSNorm "
        f"{max(errs['rms_norm_fwd']):.3e}")
    return max(errs["layer_norm_fwd"]), max(errs["rms_norm_fwd"])


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
            "::rms_fwd_", 2 * x.numel() * es + hidden * 4 + rows * 4,
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


def norm_fwd_library_times(dev):
    """The library yardstick of rows 2 and 4 as device time: the
    LayerNorm (#2) and RMSNorm (#4) forward kernels against
    ``F.layer_norm``'s and ``F.rms_norm``'s forward at [8192, 1024] fp32
    and bf16, each call timed too (CUDA events) and device-timed
    (profiler, every kernel of the call), so a call-time gap can be told
    apart as host cost (call minus device). Warm: one input set, which
    with its output fits the 50 MB L2; cold: input sets rotated past 50
    MB (3 in fp32, 4 in bf16), so each call reads device memory."""
    g = torch.Generator(device=dev).manual_seed(23)
    rows, hidden = 8192, 1024
    out = {}
    for dt in (torch.float32, torch.bfloat16):
        xs = [(torch.randn(rows, hidden, generator=g, device=dev) * 2
               + 0.5).to(dt) for _ in range(3 if dt == torch.float32 else 4)]
        x, nxt = xs[0], _rotating(xs)
        w = torch.randn(hidden, generator=g, device=dev)
        b = torch.randn(hidden, generator=g, device=dev)
        wl, bl = w.to(dt), b.to(dt)
        cases = {
            "layer_norm_fwd": (lambda x: layer_norm_fwd(x, w, b, eps=1e-5),
                               "::ln_fwd_"),
            "F.layer_norm": (lambda x: F.layer_norm(x, (hidden,), wl, bl,
                                                    1e-5), ""),
            "rms_norm_fwd": (lambda x: rms_norm_fwd(x, w), "::rms_fwd_"),
            "F.rms_norm": (lambda x: F.rms_norm(x, (hidden,), wl, 1e-5), ""),
        }
        res = {}
        for name, (fn, match) in cases.items():
            call = time_ms(lambda: fn(x), iters=50)
            dev_ms = device_ms(lambda: fn(x), match, iters=20)
            cold = device_ms(lambda: fn(nxt()), match, iters=20)
            res[name] = {"call_ms": call, "device_ms": dev_ms,
                         "cold_device_ms": cold,
                         "host_ms": None if dev_ms is None
                         else call - dev_ms}
        out[str(dt)[6:]] = res
        log(f"  norm forwards [{rows},{hidden}] {str(dt)[6:]}: "
            + "; ".join(f"{n} call {r['call_ms']:.4f} device "
                        f"{r['device_ms']} cold {r['cold_device_ms']} ms"
                        for n, r in res.items()))
        del xs, x
    log("  norm_fwd_json " + json.dumps(out))
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
    # head dims no kernel is instantiated for: zero-padded to the next
    ("d 48 bf16 causal, s 1000 (padded to 64)", 2, 4, 1000, 1000, 48,
     torch.bfloat16, True, False, 0.0),
    ("d 48 f32 kv_mask, dead row, s 300 (padded to 64)", 2, 4, 300, 300,
     48, torch.float32, False, True, 0.0),
    ("d 80 bf16 kv_mask, dead row, s 300 (padded to 96)", 2, 4, 300, 300,
     80, torch.bfloat16, False, True, 0.0),
    ("d 80 f32 causal, s 1000 (padded to 96)", 2, 4, 1000, 1000, 80,
     torch.float32, True, False, 0.0),
    ("d 80 bf16 causal, dropout 0.1 (padded to 96)", 2, 8, 1024, 1024, 80,
     torch.bfloat16, True, False, 0.1),
    ("d 160 bf16 causal cross 320x1000 (padded to 256)", 2, 4, 320, 1000,
     160, torch.bfloat16, True, False, 0.0),
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


# ---------------------------------------------------------------------------
# phase 2: flash attention's bias and segment ids, fp16 at every C3 site
# ---------------------------------------------------------------------------

#: flash attention in fp16 against its plain version: the kernels round p
#: to fp16 against each tile's running max, the plain version against the
#: row's, so values of order 1 may differ by a few fp16 roundings (2^-11)
FLASH_F16_TOL = (5e-3, 5e-3)


def _flash_tol(dtype):
    return FLASH_F16_TOL if dtype == torch.float16 else TOL[dtype]


def _bias_case(g, dev, shape, fold_row=False):
    """A bias of order 1 in ``shape``; ``fold_row`` folds -1e30 into the
    keys past three quarters of batch row 0 and into all of batch row 1."""
    bias = 0.5 * torch.randn(shape, generator=g, device=dev)
    if fold_row:
        bias[0, ..., (3 * shape[-1]) // 4:] = -1e30
        bias[1] = -1e30
    return bias


def _packed_lengths(seed: int, count: int, lo: int, hi: int):
    """``count`` sequence lengths seeded uniform in [lo, hi] and their
    int32 ``cu_seqlens``."""
    lens = np.random.default_rng(seed).integers(lo, hi + 1, count)
    return [int(x) for x in lens], np.concatenate(
        [[0], np.cumsum(lens)]).astype(np.int32)


#: the bias cases: (name, dtype, b, n, s_q, s_k, d, bias shape, causal,
#: bias_grad, folded -1e30 rows)
FLASH_BIAS_CASES = (
    ("full bias, grad, causal f32", torch.float32, 2, 4, 300, 300, 64,
     (2, 4, 300, 300), True, True, False),
    ("batch-1 bias, grad bf16", torch.bfloat16, 2, 4, 320, 1000, 64,
     (1, 4, 320, 1000), False, True, False),
    ("key-padding bias, -1e30 rows, f16", torch.float16, 2, 4, 256, 256,
     64, (2, 1, 1, 256), False, False, True),
    ("key-padding bias, -1e30 rows, bf16", torch.bfloat16, 2, 4, 1000,
     1000, 128, (2, 1, 1, 1000), False, False, True),
    ("shared bias, grad, causal f16", torch.float16, 2, 4, 1000, 1000,
     128, (1, 1, 1000, 1000), True, True, False),
    ("openfold MSA pair bias, grad bf16 d 32", torch.bfloat16, 16, 8, 256,
     256, 32, (1, 8, 256, 256), False, True, False),
    ("pair bias, grad f32 d 256", torch.float32, 2, 2, 200, 200, 256,
     (1, 2, 200, 200), False, True, False),
    ("pair bias, grad f16 d 96", torch.float16, 2, 4, 300, 300, 96,
     (1, 4, 300, 300), True, True, False),
)


def flash_bias_segment_checks(dev):
    """The bias and segment inputs of #6/#7 against their plain versions in
    fp32, bf16 and fp16 (``FLASH_BIAS_CASES``; segments from cu_seqlens at
    head dims 64 and 128, causal and not, a one-token sequence and a
    trailing padding segment), a -1e30 folded into the bias giving o = 0,
    lse = -1e30 and zero gradients for the masked batch row; the bf16
    backward with a bias gradient and with segments twice bit for bit; then
    both timed at the openfold MSA and fmha shapes. Returns the worst
    forward and backward errors."""
    g = torch.Generator(device=dev).manual_seed(31)
    fwd_errs, bwd_errs = [], []

    def check(name, dt, q, k, v, do, kw, bwd_kw, dead_row=False):
        o, lse = flash_attention_fwd(q, k, v, **kw)
        got = flash_attention_bwd(q, k, v, o, lse, do, **kw, **bwd_kw)
        ro, rlse = flash_attention_fwd_reference(q, k, v, **kw)
        want = flash_attention_bwd_reference(q, k, v, ro, rlse, do, **kw,
                                             **bwd_kw)
        tol = _flash_tol(dt)
        fe = max(check_close(f"flash_fwd {name} o", o, ro, dt, tol),
                 check_close(f"flash_fwd {name} lse", lse, rlse,
                             torch.float32))
        be = max(check_close(f"flash_bwd {name} {i}", a, e, dt, tol)
                 for i, (a, e) in enumerate(zip(got, want)))
        if dead_row and (not bool((lse[1] == -1e30).all())
                         or any(bool(x[1].any()) for x in (o, *got[:3]))):
            raise AssertionError(f"flash {name}: the row masked by the "
                                 f"bias is not zero")
        fwd_errs.append(fe)
        bwd_errs.append(be)
        log(f"  flash {name} [{q.shape[0]},{q.shape[1]},{q.shape[2]}x"
            f"{k.shape[2]},{q.shape[3]}]: fwd max abs err {fe:.3e}, bwd "
            f"{be:.3e}")
        return o, lse, got

    for (name, dt, b, n, s_q, s_k, d, shape, causal, bias_grad,
         fold) in FLASH_BIAS_CASES:
        q, k, v, do = _attn_case(g, dev, b, n, s_q, s_k, d, dt)
        bias = _bias_case(g, dev, shape, fold)
        kw = dict(causal=causal, bias=bias)
        o, lse, got = check(name, dt, q, k, v, do, kw,
                            dict(bias_grad=bias_grad), dead_row=fold)
        if name.startswith("batch-1 bias"):
            again = flash_attention_bwd(q, k, v, o, lse, do, **kw,
                                        bias_grad=True)
            if not all(torch.equal(x, y) for x, y in zip(got, again)):
                raise AssertionError("flash_bwd with dbias: two runs "
                                     "differ")
            log("  flash_bwd bf16 with dbias: two runs bitwise equal")
    lens, cu = _packed_lengths(33, 12, 1, 200)
    lens[3] = 1
    total = sum(lens) + 37  # a trailing padding segment
    cu = np.concatenate([[0], np.cumsum(lens)]).astype(np.int32)
    segs = fa_mod.segment_ids_from_cu_seqlens(
        torch.from_numpy(cu).to(dev), total)
    for dt in (torch.float32, torch.bfloat16, torch.float16):
        for d, causal in ((64, False), (128, True)):
            q, k, v, do = _attn_case(g, dev, 1, 4, total, total, d, dt)
            kw = dict(causal=causal, seg_q=segs, seg_k=segs)
            name = (f"segments x{len(lens)} + padding "
                    f"{'causal ' if causal else ''}{str(dt)[6:]}")
            o, lse, got = check(name, dt, q, k, v, do, kw, {})
            if dt == torch.bfloat16 and d == 64:
                again = flash_attention_bwd(q, k, v, o, lse, do, **kw)
                if not all(torch.equal(x, y) for x, y in zip(got, again)):
                    raise AssertionError("flash_bwd with segments: two "
                                         "runs differ")
                log("  flash_bwd bf16 with segments: two runs bitwise equal")
    flash_extra_timing(dev, g)
    return max(fwd_errs), max(bwd_errs)


def _sdpa_fwd_bwd(q, k, v, do, mask):
    """SDPA's forward and its backward alone (a retained graph) with
    ``attn_mask=mask`` (a float mask that requires grad gets its
    gradient), as device ms each."""
    ql, kl, vl = (t.clone().requires_grad_(True) for t in (q, k, v))
    leaves = (ql, kl, vl) + ((mask,) if mask.requires_grad else ())
    fwd = device_ms(lambda: F.scaled_dot_product_attention(
        ql, kl, vl, attn_mask=mask), "", iters=5)
    out = F.scaled_dot_product_attention(ql, kl, vl, attn_mask=mask)
    bwd = device_ms(lambda: torch.autograd.grad(out, leaves, do,
                                                retain_graph=True), "",
                    iters=5)
    return fwd, bwd


def _extra_timing(label, q, k, v, do, kw, bwd_kw, pairs, extra_bytes,
                  sdpa_mask):
    """#6 and #7 with a bias or segments: call and device ms of the
    kernels, plain ms, SDPA's device ms with the equivalent mask, and the
    bound (``pairs``: the (q, k) pairs of every head that this run's
    masks leave; ``extra_bytes``: what the bias adds to the forward's and
    the backward's bytes)."""
    b, n, s_q, d = q.shape
    elem = q.element_size()
    o, lse = flash_attention_fwd(q, k, v, **kw)

    def fwd():
        return flash_attention_fwd(q, k, v, **kw)

    def bwd():
        return flash_attention_bwd(q, k, v, o, lse, do, **kw, **bwd_kw)
    res = {}
    for side, fn, plain, match, nbytes, flops in (
            ("fwd", fwd, lambda: flash_attention_fwd_reference(q, k, v,
                                                               **kw),
             "flash_fwd_tc_kernel",
             4 * q.numel() * elem + b * n * s_q * 4 + extra_bytes[0],
             4 * n * pairs * d),
            ("bwd", bwd, lambda: flash_attention_bwd_reference(
                q, k, v, o, lse, do, **kw, **bwd_kw),
             ("flash_bwd_dq_tc_kernel", "flash_bwd_dkv_tc_kernel"),
             8 * q.numel() * elem + b * n * s_q * 4 + extra_bytes[1],
             10 * n * pairs * d)):
        b_ms, by = bound(nbytes, flops, BF16_TC_FLOPS)
        res[side] = {"ms": time_ms(fn, iters=5, warmup=2),
                     "device_ms": device_ms(fn, match, iters=5),
                     "plain_ms": time_ms(plain, iters=2, warmup=1),
                     "bound_ms": b_ms, "bound_by": by}
    lib = _sdpa_fwd_bwd(q, k, v, do, sdpa_mask)
    res["fwd"]["library_ms"], res["bwd"]["library_ms"] = lib
    for side in ("fwd", "bwd"):
        r = res[side]
        share = r["bound_ms"] / r["device_ms"] if r["device_ms"] else None
        log(f"  flash {label} {side}: kernel {r['ms']:.4f} ms (device "
            f"{r['device_ms']} ms), plain {r['plain_ms']:.4f} ms, SDPA "
            f"device {r['library_ms']} ms, bound {r['bound_ms']:.4f} ms "
            f"({r['bound_by']}), share of bound {share}")
    log(f"  flash_extra_json {json.dumps({'case': label, **res})}")
    return res


def flash_extra_timing(dev, g):
    """#6/#7 timed with a bias at the openfold MSA row attention's shape
    ([128, 8, 256, 32] bf16, a [1, 8, 256, 256] pair bias with its
    gradient; SDPA with the bias as a float attn_mask that requires grad)
    and with segments at the fmha leg's shape (32 BERT sequences of
    64-512 tokens packed, 16 heads of 64, fp16; SDPA over the
    block-diagonal boolean mask of the same batch)."""
    q, k, v, do = _attn_case(g, dev, 128, 8, 256, 256, 32, torch.bfloat16)
    bias = _bias_case(g, dev, (1, 8, 256, 256)).to(torch.bfloat16)
    _extra_timing("bias [128,8,256,32] bf16, pair bias + dbias", q, k, v,
                  do, dict(bias=bias), dict(bias_grad=True),
                  128 * 256 * 256,
                  # the bias read; the backward also writes the full fp32
                  # dbias that flash_attention_bwd returns
                  (bias.numel() * 2, bias.numel() * 2 + q.shape[0]
                   * q.shape[1] * 256 * 256 * 4),
                  bias.clone().requires_grad_(True))
    del q, k, v, do
    lens, cu = _packed_lengths(34, 32, 64, 512)
    total = int(cu[-1])
    segs = fa_mod.segment_ids_from_cu_seqlens(
        torch.from_numpy(cu).to(dev), total)
    q, k, v, do = _attn_case(g, dev, 1, 16, total, total, 64,
                             torch.float16)
    block = segs[:, None] == segs[None, :]
    _extra_timing(f"segments x32 [1,16,{total},64] f16 (pairs "
                  f"{sum(x * x for x in lens)} of {total * total})", q, k,
                  v, do, dict(seg_q=segs, seg_k=segs), {},
                  sum(x * x for x in lens), (2 * total * 4, 2 * total * 4),
                  block)


#: the fused tails' fp16 rows: the residual sum is rounded to fp16 before
#: the LayerNorm (as the TPU kernel stores and reloads it), so a sum that
#: rounds the other way on the two sides (one ulp, 2^-10 relative, of
#: sums up to 8) reaches y through rstd * w (about 1), beside y's own
#: rounding
FUSED_F16_TOL = (1e-2, 2e-3)


def fp16_site_checks(dev):
    """The fp16 instantiations of every kernel that took bf16 only before
    (fault C3) against their plain versions at the 345M main-path shapes:
    decode over fp16 pools (and an fp32 q over them), the LayerNorm and
    RMSNorm forward and backward, the six fused tails, packed Adam, SGD,
    NovoGrad and LAMB with fp16 gradients and model copy, the flat scale
    and axpby, the row statistics. Returns the worst error per kernel
    name."""
    g = torch.Generator(device=dev).manual_seed(41)
    f16 = torch.float16
    errs = {}

    def note(name, err):
        errs[name] = max(errs.get(name, 0.0), err)

    for q_dt in (f16, torch.float32):
        q, pools, pt, kl = _page_case(g, dev, [0, 1, 8, 9, 100, 255, 256,
                                               31], f16, q_dt)
        kp, vp = pools[0]
        got = flash_decode(q, kp, vp, pt, kl)
        note("flash_decode", check_close(
            f"flash_decode f16 pools, {q_dt} q", got,
            paged_decode_reference(q, kp, vp, pt, kl), q_dt))
    x = (torch.randn(8192, HIDDEN, generator=g, device=dev) * 3 + 1).to(f16)
    w, b = (torch.randn(HIDDEN, generator=g, device=dev) for _ in range(2))
    dy = torch.randn(8192, HIDDEN, generator=g, device=dev).to(f16)
    y, mu, rstd = layer_norm_fwd(x, w, b, eps=1e-5)
    ry, rmu, rrstd = layer_norm_reference(x, w, b, 1e-5)
    note("layer_norm_fwd", max(check_close("layer_norm f16 y", y, ry, f16),
                               check_close("layer_norm f16 rstd", rstd,
                                           rrstd, torch.float32)))
    got = layer_norm_bwd(dy, x, mu, rstd, w)
    want = layer_norm_bwd_reference(dy, x, mu, rstd, w)
    note("layer_norm_bwd", max(
        check_close("layer_norm_bwd f16 dx", got[0], want[0], f16),
        *(check_close(f"layer_norm_bwd f16 {n_}", a, e, torch.float32,
                      SUM_TOL)
          for n_, a, e in zip(("dw", "db"), got[1:], want[1:]))))
    y, rstd = rms_norm_fwd(x, w)
    ry, _ = rms_norm_reference(x, w, 1e-5)
    note("rms_norm_fwd", check_close("rms_norm f16 y", y, ry, f16))
    got = rms_norm_bwd(dy, x, rstd, w)
    want = rms_norm_bwd_reference(dy, x, rstd, w)
    note("rms_norm_bwd", max(
        check_close("rms_norm_bwd f16 dx", got[0], want[0], f16),
        check_close("rms_norm_bwd f16 dw", got[1], want[1], torch.float32,
                    SUM_TOL)))
    x4 = torch.randn(8192, 4 * HIDDEN, generator=g, device=dev).to(f16)
    b4 = 0.1 * torch.randn(4 * HIDDEN, generator=g, device=dev)
    dy4 = torch.randn(8192, 4 * HIDDEN, generator=g, device=dev).to(f16)
    r, dyh, ds = (torch.randn(8192, HIDDEN, generator=g,
                              device=dev).to(f16) for _ in range(3))
    lb = 0.1 * torch.randn(HIDDEN, generator=g, device=dev)
    wn = 0.2 * torch.randn(HIDDEN, generator=g, device=dev) + 1.0
    seed, p = -1234567, 0.1
    s_, _, mu, rstd = fb._raln_fwd_impl(x, b, r, wn, lb, seed, 1e-5, p)
    pairs = {
        "bias_gelu_fwd": ((fb._bias_gelu_fwd_impl(x4, b4),),
                          (fb.bias_gelu_reference(x4, b4),)),
        "bias_gelu_bwd": (fb._bias_gelu_bwd(dy4, x4, b4),
                          fb.bias_gelu_bwd_reference(dy4, x4, b4)),
        "bias_dropout_residual_fwd": (
            (fb._bdr_fwd_impl(x, b, r, seed, p),),
            (fb.bias_dropout_residual_reference(x, b, r, seed, p),)),
        "bias_dropout_residual_bwd": (
            fb._bdr_bwd(dyh, seed, p, f16),
            fb.bias_dropout_residual_bwd_reference(dyh, seed, p, f16)),
        "residual_ln_fwd": (fb._raln_fwd_impl(x, b, r, wn, lb, seed, 1e-5,
                                              p),
                            fb.residual_ln_reference(x, b, r, wn, lb, seed,
                                                     1e-5, p)),
        "residual_ln_bwd": (fb._raln_bwd(ds, dyh, s_, mu, rstd, wn, seed,
                                         p),
                            fb.residual_ln_bwd_reference(ds, dyh, s_, mu,
                                                         rstd, wn, seed,
                                                         p)),
    }
    for name, (got, want) in pairs.items():
        note(name, max(check_close(
            f"{name} f16 output {i}", a, e,
            f16 if a.dtype == f16 else torch.float32,
            SUM_TOL if a.dim() == 1 else (
                FUSED_F16_TOL if a.dtype == f16 else None))
            for i, (a, e) in enumerate(zip(got, want))))
    n = 1024 * 1024
    gr = (1e-2 * torch.randn(n, generator=g, device=dev)).to(f16)
    m0, v0 = (1e-3 * torch.randn(n, generator=g, device=dev),
              1e-5 * torch.rand(n, generator=g, device=dev))
    src = 0.05 * torch.randn(n, generator=g, device=dev)
    hyper = dict(param_dtype=f16, lr=1e-4,
                 bc1=torch.tensor(0.1, device=dev),
                 bc2=torch.tensor(0.001, device=dev))
    m, v, s2 = m0.clone(), v0.clone(), src.clone()
    p_out, *_ = packed_adam_apply(gr, m, v, s2, **hyper)
    rp, rm, rv, rs = packed_adam_reference(gr, m0, v0, src, **hyper)
    note("packed_adam", max(check_close("packed_adam f16 p", p_out, rp,
                                        f16),
                            check_close("packed_adam f16 m", m, rm,
                                        torch.float32)))
    hyper = dict(param_dtype=f16, lr=torch.tensor(0.1, device=dev),
                 first_run=torch.tensor(False, device=dev),
                 inv_scale=torch.tensor(0.5, device=dev), momentum=0.9)
    buf, s2 = m0.clone(), src.clone()
    p_out, _, _ = packed_sgd_apply(gr, buf, s2, **hyper)
    rp, rb, _ = packed_sgd_reference(gr, m0, src, **hyper)
    note("packed_sgd", max(check_close("packed_sgd f16 p", p_out, rp, f16),
                           check_close("packed_sgd f16 buf", buf, rb,
                                       torch.float32)))
    rows = n // 1024
    denom = torch.rand(rows, generator=g, device=dev) + 0.5
    hyper = dict(param_dtype=f16, lr=torch.tensor(1e-3, device=dev),
                 bc1=torch.tensor(0.05, device=dev),
                 inv_scale=torch.tensor(0.5, device=dev), beta1=0.95,
                 beta3=0.05, wd=0.0, reg_inside_moment=False)
    m = m0.clone()
    p_out, _ = packed_novograd_apply(gr, m, src, denom, **hyper)
    rp, rm = packed_novograd_reference(gr, m0, src, denom, **hyper)
    note("packed_novograd", max(
        check_close("packed_novograd f16 p", p_out, rp, f16),
        check_close("packed_novograd f16 m", m, rm, torch.float32)))
    inv = torch.tensor(0.25, device=dev)
    note("packed_row_reduce", check_close(
        "packed_row_reduce f16", packed_row_reduce(gr, op="sqsum",
                                                   inv_scale=inv),
        packed_row_reduce_reference(gr, op="sqsum", inv_scale=inv),
        torch.float32, (0.0, 1e-5)))
    hyper = dict(clip=torch.tensor(1.7, device=dev),
                 bc1=torch.tensor(0.19, device=dev),
                 bc2=torch.tensor(0.002, device=dev), inv_scale=inv,
                 wd=0.01)
    m, v = m0.clone(), v0.clone()
    u, *_ = packed_lamb_stage1(gr, m, v, src, **hyper)
    wu, *_ = packed_lamb_stage1_reference(gr, m0, v0, src, **hyper)
    note("packed_lamb_stage1", check_close("packed_lamb_stage1 f16 u", u,
                                           wu, torch.float32))
    coef = torch.linspace(0.0, 3.0, rows, device=dev)
    p_out, _ = packed_scale_update(u, src.clone(), coef, param_dtype=f16,
                                   lr=torch.tensor(1e-2, device=dev),
                                   write_master=False)
    rp, _ = packed_scale_update_reference(u, src, coef, param_dtype=f16,
                                          lr=1e-2, noop=None)
    note("packed_scale_update", check_close("packed_scale_update f16",
                                            p_out, rp, f16))
    out, _ = multi_tensor_scale_flat(gr, 4.0, f16)
    want, _ = multi_tensor_scale_flat_reference(gr, 4.0, f16)
    note("scale_flat", check_close("scale_flat f16", out, want, f16,
                                   (0.0, 0.0)))
    out, _ = multi_tensor_axpby_flat(0.25, 1.5, gr, gr, f16)
    want, _ = multi_tensor_axpby_flat_reference(0.25, 1.5, gr, gr, f16)
    note("axpby_flat", check_close("axpby_flat f16", out, want, f16,
                                   (0.0, 0.0)))
    sq, ma, nf = packed_row_stats(gr, inv_scale=inv)
    wsq, wma, wnf = packed_row_stats_reference(gr, inv_scale=inv)
    note("packed_row_stats", max(check_close("packed_row_stats f16 sq", sq,
                                             wsq, torch.float32,
                                             (0.0, 1e-5)),
                                 check_close("packed_row_stats f16 max", ma,
                                             wma, torch.float32,
                                             (0.0, 0.0))))
    log(f"  fp16 sites: max abs err {json.dumps(errs)}")
    return errs


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
    sampler_cost(dev, cfg.vocab_size, st["step_ms"]["p50"])
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


def sampler_cost(dev, vocab: int, step_p50: float) -> None:
    """The device time a sampled serving step adds: the top-k / top-p
    filters over ``[SLOTS, vocab]`` fp32 logits, whose full sort runs on
    every sampled step (selected per row on the device, no host read),
    beside the greedy trace's step p50."""
    g = torch.Generator(device=dev).manual_seed(1)
    logits = torch.randn(SLOTS, vocab, generator=g, device=dev)
    temps = torch.full((SLOTS,), 0.8, device=dev)
    top_ks = torch.zeros(SLOTS, dtype=torch.int32, device=dev)
    top_ps = torch.full((SLOTS,), 0.9, device=dev)
    filt = device_ms(lambda: sampling._filtered_logits(
        logits, temps, top_ks, top_ps), "", iters=20)
    sort = device_ms(lambda: torch.sort(logits, dim=-1, descending=True),
                     "", iters=20)
    log(f"  the sampler's filters on [{SLOTS}, {vocab}] fp32 (each sampled "
        f"step): device {filt} ms, the full sort alone {sort} ms, beside "
        f"the greedy step p50 {step_p50:.3f} ms")


def profiled(run, label: str, top: int) -> dict:
    """Print where ``run``'s time goes: device time by kernel from a
    ``torch.profiler`` trace against the run's wall time; the remainder
    is device idle. Returns the wall and busy ms, the count of device ops,
    the ``(device ms, count, name)`` rows and ``ops``: every event's name
    (host ops too) to its ``(count, device ms)``."""
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
    ops = {e.key: (e.count, e.device_time_total / 1e3)
           for e in prof.key_averages()}
    return {"wall_ms": wall_ms, "busy_ms": busy,
            "device_ops": sum(r[1] for r in rows), "rows": rows, "ops": ops}


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
    if masters.is_cuda:  # the parity worker sees no card
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
    peak memory, and one profiled step (returned as ``profile``)."""
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
    prof = profiled(run, f"{label} step", 14)
    return {"launches": launches, "p50": p50, "p99": p99, "peak": peak_gb,
            "profile": prof, **out}


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
    (:func:`numerics_step_fn`); records go to a JSONL file. ``fp8=True``
    (a ``GPTConfig`` field): :func:`fp8_step_fn`, then every layer's fp8
    states checked calibrated (:func:`check_fp8_calibrated`)."""
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
        elif cfg.fp8:
            step = fp8_step_fn(cfg, loss_fn, opt, dev)
            state = (state, init_gpt_fp8_states(cfg, dev))
        else:
            step = train_step_fn(loss_fn, opt)
        leg = drive_leg(label, expected, timed, step, params, state,
                        tokens.numel())
        if cfg.fp8:  # 2 warm-up, the timed and the profiled steps
            check_fp8_calibrated(label, leg["state"][1], timed + 3)
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
    one call. Returns the legs' summed launches and each leg's p50."""
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
    return ({k: sum(v["launches"][k] for v in legs.values())
             for k in legs["headline"]["launches"]},
            {k: v["p50"] for k, v in legs.items()})


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
              torch.bfloat16: (2e-3, 5e-2, 0.1),
              # fp16 rounds at 2^-11, finer than bf16's 2^-8; the roundings
              # fall at other places on the two sides all the same, so
              # bf16's limits
              torch.float16: (2e-3, 5e-2, 0.1)}

#: the 2-layer full-width models of the parity runs: seq 256, batch 2
PARITY_SEQ, PARITY_BATCH = 256, 2


@contextlib.contextmanager
def plain_kernels():
    """Every kernel wrapper routes CUDA tensors to its plain version: the
    comparison side of a run on the card (no kernel launches, none
    counted)."""
    route = _device.kernel_route
    _device.kernel_route = lambda *tensors: False
    try:
        yield
    finally:
        _device.kernel_route = route


def _flat(params) -> torch.Tensor:
    return torch.cat([p.detach().float().reshape(-1)
                      for p in tree_leaves(params)])


def parity_cfg(vocab: int, **cfg_kw) -> GPTConfig:
    kw = dict(num_layers=2, hidden_size=HIDDEN, num_attention_heads=N_HEADS,
              vocab_size=vocab, max_position_embeddings=PARITY_SEQ,
              hidden_dropout=0.0, attention_dropout=0.0)
    return GPTConfig(**{**kw, **cfg_kw})


def gpt_parity(dev, label: str, kernels, make_opt=None, absent=(),
               scaled=False, reference="cpu", **cfg_kw):
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
                 absent=absent, scaled=scaled, reference=reference)


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


#: phase 7's parity legs across two processes (A7.0): ``mode`` None runs
#: both halves of a leg here; "card" runs the card half here and takes the
#: CPU half from the worker (:func:`parity_worker`), whose results land in
#: ``dir`` one file a leg and are checked by :func:`parity_drain`; "cpu"
#: is the worker: the CPU halves alone
_PARITY = {"mode": None, "dir": None, "pending": [], "n": 0}


def train_parity(dev, label: str, kernels, cfg, loss_of, make_opt,
                 absent=(), scaled=False, reference="cpu"):
    """Loss, gradients and 3 optimizer steps of ``loss_of(params,
    device)`` on the card (kernels) against the CPU (plain versions), from
    the same fp32 params of ``cfg``; ``make_opt()`` builds each run's
    optimizer. ``kernels`` must each launch on the card run (the loss,
    gradients and steps), ``absent`` none, and nothing on the CPU run.
    ``scaled``: each step is :func:`scaled_step_fn` (dynamic loss
    scaling, the flat unscale, clipping to norm 1), and a fourth step
    with an inf in a gradient must be skipped on both runs
    (:func:`check_overflow_skip`). ``reference="plain"``: the reference
    run is on the card too, every kernel wrapper taking its plain version
    (:func:`plain_kernels`), for dtypes whose CPU GEMMs are too slow to
    serve as the reference (fp16: 0.4 GFLOP/s on the card's host,
    measured beside 533 fp32).

    Under :data:`_PARITY` mode "card" a CPU reference is the worker's: the
    card half runs here and its check waits in ``_PARITY["pending"]``;
    under mode "cpu" (the worker) only the CPU half runs, the assertion
    that it launched nothing is made here, on this process's counts, and
    the run is written for the card's process."""
    cpu_params = init_gpt_params(cfg, torch.Generator().manual_seed(7))
    check = functools.partial(_parity_check, label, kernels, absent,
                              cfg.compute_dtype, reference,
                              PackSpec(cpu_params).leaf_names())

    def run(where):
        return _parity_run(dev, label, where, cfg, loss_of, make_opt,
                           cpu_params, scaled, reference)

    if reference != "cpu":  # both halves on the card, in its process
        if _PARITY["mode"] != "cpu":
            check(run("cpu"), run("cuda"))
        return

    def cpu_run():
        c = run("cpu")
        if any(c["counts"].values()):  # this process's own counts
            raise AssertionError(f"{label}: kernels launched on the CPU "
                                 f"run: {c['counts']}")
        return c

    _parity_split(label, cpu_run, lambda: run("cuda"), check)


def _parity_split(label, cpu_run, card_run, check):
    """One card-against-CPU check, ``check(cpu result, card result)``,
    across :data:`_PARITY`'s processes: mode None runs both here; the
    worker ("cpu") runs ``cpu_run`` alone and writes its result for the
    card's process; the card's process ("card") runs ``card_run`` and
    leaves the check pending until :func:`parity_drain` finds the
    worker's result. Each call takes the next index in both processes."""
    mode = _PARITY["mode"]
    index = _PARITY["n"]
    _PARITY["n"] += 1
    t0 = time.perf_counter()
    if mode == "cpu":
        c = cpu_run()
        path = os.path.join(_PARITY["dir"], f"{index:02d}.pt")
        torch.save({"label": label, "run": c}, path + ".tmp")
        os.replace(path + ".tmp", path)
        log(f"  {label}: CPU half {time.perf_counter() - t0:.1f} s")
    elif mode == "card":
        g = card_run()
        log(f"  {label}: card half {time.perf_counter() - t0:.1f} s (its "
            f"CPU half in the worker)")
        _PARITY["pending"].append((index, label, g, check))
    else:
        check(cpu_run(), card_run())


def _parity_run(dev, label, where, cfg, loss_of, make_opt, cpu_params,
                scaled, reference):
    """One side of :func:`train_parity`: the loss, gradients, 3 steps
    (and the forced overflow when ``scaled``) on the CPU or the card."""
    d = torch.device("cpu") if where == "cpu" else dev
    plain = where == "cpu" and reference == "plain"
    if plain:
        d = dev
    route = plain_kernels() if plain else contextlib.nullcontext()
    with route:
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
        return dict(loss=float(loss0), losses=losses,
                    grads=tree_map(lambda g: g.float().cpu(), grads),
                    update=(_flat(params) - start).cpu(), counts=counts)


def _parity_check(label, kernels, absent, dt, reference, names, c, g):
    """:func:`train_parity`'s gates: the CPU (or card plain) run ``c``
    against the card run ``g``."""
    loss_tol, grad_tol, upd_tol = PARITY_TOL[dt]
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
    for (name, gc), gg in zip(zip(names, tree_leaves(c["grads"])),
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
    ref = "cpu" if reference == "cpu" else "card plain"
    log(f"  {label} 2-layer full-width {str(dt)[6:]}, seq {PARITY_SEQ}, "
        f"batch {PARITY_BATCH}: "
        f"loss card {g['loss']:.7f} {ref} {c['loss']:.7f} (rel {rel:.2e}); "
        f"worst gradient leaf {worst:.2e} of its largest entry; 3 steps: "
        f"losses card {g['losses']} cpu {c['losses']} (max rel "
        f"{curve:.2e}); update rel {upd:.2e}, max abs {upd_max:.2e}; "
        f"card launches {({k: v for k, v in g['counts'].items() if v})}")
    if rel > loss_tol or curve > loss_tol:
        raise AssertionError("loss on the card differs from the CPU's")
    if upd > upd_tol:
        raise AssertionError("parameter updates on the card differ from "
                             "the CPU's")


def parity_legs(dev):
    """Phase 7's training-parity legs, in order. In the parity worker the
    legs that do not go through :func:`train_parity` return at once: they
    hold the card against the CPU in the card's process."""
    return [
        lambda: gpt_parity(dev, "unfused", TRAIN_KERNELS[:4]),
        lambda: gpt_parity(dev, "fused, selective_elementwise",
                           TRAIN_KERNELS[:4] + FUSED_KERNELS,
                           fused_block=True,
                           recompute_granularity="selective_elementwise"),
        lambda: gpt_parity(dev, "GPT non-flash, causal",
                           ("softmax_fwd", "softmax_bwd",
                            "layer_norm_fwd", "layer_norm_bwd"),
                           compute_dtype=torch.bfloat16,
                           use_flash_attention=False),
        lambda: bert_parity(dev, "BERT non-flash, padding mask",
                            ("softmax_masked_fwd", "softmax_bwd",
                             "layer_norm_fwd", "layer_norm_bwd"),
                            compute_dtype=torch.bfloat16,
                            use_flash_attention=False),
        lambda: gpt_parity(dev, "unfused, packed FusedSGD",
                           TRAIN_KERNELS[:4] + ("packed_sgd",),
                           make_opt=packed_sgd),
        lambda: bert_parity(dev, "BERT non-flash fp32, packed LAMB",
                            ("layer_norm_fwd", "layer_norm_bwd")
                            + LAMB_KERNELS, make_opt=packed_lamb,
                            use_flash_attention=False),
        lambda: bert_parity(dev, "BERT non-flash, padding mask, packed "
                            "LAMB",
                            ("softmax_masked_fwd", "softmax_bwd",
                             "layer_norm_fwd", "layer_norm_bwd")
                            + LAMB_KERNELS, make_opt=packed_lamb,
                            compute_dtype=torch.bfloat16,
                            use_flash_attention=False),
        lambda: lamb_packed_against_pytree(dev),
        lambda: gpt_parity(dev, "unfused, loss-scaled, clipped",
                           TRAIN_KERNELS[:4] + ("packed_adam",
                                                "scale_flat",
                                                "packed_row_reduce"),
                           scaled=True),
        lambda: bert_parity(dev, "BERT non-flash fp32, packed NovoGrad",
                            ("layer_norm_fwd", "layer_norm_bwd")
                            + NOVOGRAD_KERNELS,
                            make_opt=packed_novograd,
                            use_flash_attention=False),
        lambda: bert_parity(dev, "BERT non-flash fp32, packed NovoGrad "
                            "inf norm",
                            ("layer_norm_fwd", "layer_norm_bwd")
                            + NOVOGRAD_KERNELS,
                            make_opt=lambda: FusedNovoGrad(
                                lr=NOVOGRAD_LR, norm_type=0, packed=True),
                            use_flash_attention=False),
        lambda: bert_parity(dev, "BERT non-flash, padding mask, packed "
                            "NovoGrad",
                            ("softmax_masked_fwd", "softmax_bwd",
                             "layer_norm_fwd", "layer_norm_bwd")
                            + NOVOGRAD_KERNELS,
                            make_opt=packed_novograd,
                            compute_dtype=torch.bfloat16,
                            use_flash_attention=False),
        lambda: gpt_parity(dev, "head dim 128 (8 heads), flash by default",
                           TRAIN_KERNELS[:4], num_attention_heads=8),
        lambda: fused_width_parity(dev),
        lambda: gpt_parity(dev, "head dim 80 (hidden 1280), flash "
                           "padded to head dim 96",
                           TRAIN_KERNELS[:4],
                           absent=("softmax_fwd", "softmax_bwd"),
                           hidden_size=1280,
                           compute_dtype=torch.bfloat16),
        lambda: gpt_parity(dev, "head dim 320 (hidden 1280, 4 heads), "
                           "past flash's 256: fused softmax",
                           ("softmax_fwd", "softmax_bwd",
                            "layer_norm_fwd", "layer_norm_bwd"),
                           absent=("flash_attn_fwd", "flash_attn_bwd"),
                           hidden_size=1280, num_attention_heads=4,
                           compute_dtype=torch.bfloat16),
        lambda: gpt_parity(dev, "fp16 GPT, fused, flash (reference: the "
                           "plain versions on the card)",
                           TRAIN_KERNELS + FUSED_KERNELS,
                           reference="plain", compute_dtype=torch.float16,
                           fused_block=True,
                           apply_query_key_layer_scaling=False,
                           use_flash_attention=True),
    ]


#: the parity worker's CPU threads: the card's host has 8 cores; the
#: card's process keeps its own threads for phases 7-13's CPU references
PARITY_THREADS = 4
#: the longest the card's process waits for the worker at the join
PARITY_JOIN_S = 900


def parity_worker(out_dir: str, threads: int) -> None:
    """The CPU halves of phase 7's activation watch and parity legs (the
    legs of :func:`parity_legs` whose reference is the CPU) and of phase
    9's ResNet-50 parity, in the card process's order, in a process of
    their own beside the card's, each written to ``out_dir`` as it
    ends."""
    torch.set_num_threads(threads)
    _PARITY.update(mode="cpu", dir=out_dir, n=0)
    log(f"parity worker: {torch.get_num_threads()} threads, pid "
        f"{os.getpid()}")
    t0 = time.perf_counter()
    cpu = torch.device("cpu")
    for leg in ([lambda: watch_parity(cpu)] + parity_legs(cpu)
                + [lambda: resnet_parity(cpu)]):
        leg()
    log(f"parity worker: all CPU halves in {time.perf_counter() - t0:.1f} s")


def parity_start(tmp: str):
    """Start :func:`parity_worker` in a process that sees no card, its
    results and its log under ``tmp``; the card's process then runs the
    card halves (mode "card")."""
    out = os.path.join(tmp, "parity")
    os.makedirs(out, exist_ok=True)
    here = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="",
               OMP_NUM_THREADS=str(PARITY_THREADS),
               PYTHONPATH=here + os.pathsep + os.environ.get("PYTHONPATH",
                                                             ""))
    logf = open(os.path.join(out, "worker.log"), "w")
    proc = subprocess.Popen(
        [sys.executable, "-c", "import sys, chip_smoke; chip_smoke."
         "parity_worker(sys.argv[1], int(sys.argv[2]))", out,
         str(PARITY_THREADS)], env=env, cwd=here, stdout=logf,
        stderr=subprocess.STDOUT)
    _PARITY.update(mode="card", dir=out, pending=[], n=0, proc=proc,
                   log=logf, t0=time.perf_counter())
    log(f"  parity worker started (pid {proc.pid}, {PARITY_THREADS} "
        f"threads, no card)")


def parity_drain(block: bool = False) -> None:
    """Check every pending leg whose CPU half the worker has written, in
    order (each file removed once read); with ``block``, wait for the
    worker to end (at most ``PARITY_JOIN_S``), check the rest, and fail
    if it failed or a leg is missing."""
    pending = _PARITY["pending"]
    proc = _PARITY.get("proc")
    if proc is None:
        return
    deadline = time.monotonic() + PARITY_JOIN_S
    while pending:
        index, label, g, check = pending[0]
        path = os.path.join(_PARITY["dir"], f"{index:02d}.pt")
        if not os.path.exists(path):
            if not block:
                return
            if proc.poll() is not None or time.monotonic() > deadline:
                break
            time.sleep(0.2)
            continue
        got = torch.load(path)
        os.remove(path)
        if got["label"] != label:
            raise AssertionError(f"parity worker wrote {got['label']!r} "
                                 f"where {label!r} was expected")
        check(got["run"], g)
        pending.pop(0)
    if not block:
        return
    try:
        rc = proc.wait(timeout=max(1.0, deadline - time.monotonic()))
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()
        rc = "killed at the join's time limit"
    _PARITY["log"].close()
    with open(os.path.join(_PARITY["dir"], "worker.log")) as f:
        for line in f.read().splitlines():
            log(f"  | {line}")
    log(f"  parity worker joined {time.perf_counter() - _PARITY['t0']:.1f} "
        f"s after its start")
    _PARITY.update(mode=None, proc=None)
    if rc != 0 or pending:
        raise AssertionError(f"parity worker ended {rc} with "
                             f"{[p[1] for p in pending]} unchecked")


def fused_width_parity(dev):
    """``fused_block=True`` at the widths the tails used to refuse: a
    1-layer fp32 GPT at hidden 5120 (40 heads) and 8192 (64 heads), head
    dim 128, seq 64, batch 2, vocab 512, loss and every gradient on the
    card (the fused tails at those widths, flash at head dim 128)
    against the CPU, within ``PARITY_TOL``'s fp32 loss and gradient
    limits. No optimizer step: the point is the tails' path."""
    if _PARITY["mode"] == "cpu":
        return  # both halves run in the card's process
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

    def run(d):
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
        return list(ring.records), _device.launch_counts()

    _parity_split("activation watch", lambda: run(torch.device("cpu")),
                  lambda: run(dev), functools.partial(
                      _watch_check, PackSpec(cpu_params).leaf_names()[3]))


def _watch_check(leaf, cpu_run, card_run):
    """:func:`watch_parity`'s gates: the CPU's tap records against the
    card's."""
    (crec, ccount), (grec, gcount) = cpu_run, card_run
    tol = PARITY_TOL[torch.float32][1]
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
    if _PARITY["mode"] == "cpu":
        return  # the card's process runs it
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


# ---------------------------------------------------------------------------
# phase 8: the attention contribs over the flash kernels' bias and segments
# ---------------------------------------------------------------------------

#: a leg's kernels against their plain versions on the card: (loss rtol,
#: each gradient leaf's max error over its largest entry). Both runs
#: compute in the leg's dtype and differ where the kernels round p to it
#: against a tile's running max (the plain version against the row's) and
#: in the order of the sums: one rounding, 2^-8 in bf16 and 2^-11 in fp16,
#: of values of order 1, so phase 7's bf16 limits, and a quarter of the
#: gradient limit in fp16
LEG_TOL = {torch.bfloat16: (2e-3, 5e-2), torch.float16: (1e-3, 1.25e-2)}




def contrib_leg(dev, label: str, dtype, run, leaves, out_seed: int):
    """One leg: ``loss = sum(run() * w)`` (w fixed, fp32) and its
    gradients in every tensor of ``leaves`` (a dict), through the kernels
    then through the plain versions on the card. Checks the flash kernels
    launched on the kernel run, the loss within ``LEG_TOL`` of the sum of
    its terms' magnitudes (its terms cancel: the loss itself sits far
    below that sum) and each gradient within ``LEG_TOL`` of its largest
    entry; logs the step's device time (all kernels, and the flash
    kernels' share) and the kernel run's peak memory. Returns the kernel
    run's launch counts."""
    loss_tol, grad_tol = LEG_TOL[dtype]
    w = {}

    def step():
        out = run()
        if "w" not in w:
            w["w"] = torch.randn(out.shape, device=dev, dtype=torch.float32,
                                 generator=torch.Generator(
                                     device=dev).manual_seed(out_seed))
        terms = out.float() * w["w"]
        loss = terms.sum()
        grads = torch.autograd.grad(loss, list(leaves.values()))
        return loss.detach(), terms.detach().abs().sum(), grads

    step()  # warm: shapes, the weight
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    _device.reset_launch_counts()
    loss_k, _, grads_k = step()
    torch.cuda.synchronize()
    counts = _device.launch_counts()
    peak = (torch.cuda.max_memory_allocated() - base) / 2 ** 30
    for name in ("flash_attn_fwd", "flash_attn_bwd"):
        if counts[name] <= 0:
            raise AssertionError(f"{label}: {name} did not launch")
    total_ms, flash_ms = device_split(step, "flash_") or (None, None)
    with plain_kernels():
        _device.reset_launch_counts()
        loss_p, mag, grads_p = step()
        torch.cuda.synchronize()
        plain_counts = _device.launch_counts()
    if plain_counts["flash_attn_fwd"] or plain_counts["flash_attn_bwd"]:
        raise AssertionError(f"{label}: the plain run launched flash")
    rel = abs(float(loss_k) - float(loss_p)) / float(mag)
    worst = {}
    for name, gk, gp in zip(leaves, grads_k, grads_p):
        if not torch.isfinite(gk).all():
            raise AssertionError(f"{label}: gradient {name} not finite")
        worst[name] = float((gk.float() - gp.float()).abs().max()
                            / gp.float().abs().max().clamp_min(1e-30))
    log(f"  {label}: loss kernels {float(loss_k):.6f} plain "
        f"{float(loss_p):.6f} (difference {rel:.2e} of the sum of its "
        f"terms' magnitudes, {float(mag):.1f}); gradient errors over their "
        f"largest entries {json.dumps(worst)}; step device time "
        f"{total_ms} ms (flash kernels {flash_ms} ms); peak memory "
        f"{peak:.3f} GiB above the inputs; launches "
        f"{({k: v for k, v in counts.items() if v})}")
    if rel > loss_tol:
        raise AssertionError(f"{label}: loss differs from the plain run's")
    bad = {k: e for k, e in worst.items() if e > grad_tol}
    if bad:
        raise AssertionError(f"{label}: gradients off {bad}")
    return counts


def _leaf(t):
    return t.detach().clone().requires_grad_(True)


def _ragged_pad(g, dev, b, s, lo):
    """A [b, s] key-padding mask, 1 = masked out: each row keeps a length
    seeded uniform in [lo, s]."""
    lens = torch.randint(lo, s + 1, (b,), generator=g, device=dev)
    return (torch.arange(s, device=dev)[None, :] >= lens[:, None]).to(
        torch.int32)


def attention_contribs(dev):
    """The three attention contribs at full width, forward and backward,
    kernels against plain versions (``contrib_leg``): fmha at BERT-large's
    geometry (hidden 1024, 16 heads, 32 packed sequences of 64-512 tokens,
    dropout 0.1) in fp16 and bf16; multihead_attn at Transformer-big's
    (1024, 16 heads, s 256, b 16, ragged lengths) with an additive [b, s]
    key-padding mask (the bias path, ``bias_grad=False``) and with
    ``include_norm_add`` and a boolean padding mask (the key mask), and
    encoder-decoder at s_q 256 over s_k 200, fp16; openfold's AlphaFold 2
    Evoformer attention in bf16: MSA row attention [1, 128, 8, 256, 32]
    with a key mask and a [1, 1, 8, 256, 256] pair bias with its gradient,
    and triangle attention [1, 256, 4, 256, 32] with its own bias. Returns
    the flash kernels' launches over the legs."""
    g = torch.Generator(device=dev).manual_seed(51)
    launches = {"flash_attn_fwd": 0, "flash_attn_bwd": 0}

    def add(counts):
        for k in launches:
            launches[k] += counts[k]

    lens, cu = _packed_lengths(52, 32, 64, 512)
    total = int(cu[-1])
    cu_t = torch.from_numpy(cu).to(dev)
    fmha = FMHA(hidden_size=1024, num_attention_heads=16,
                attention_probs_dropout_prob=0.1)
    log(f"  fmha: 32 sequences, {total} tokens (lengths {min(lens)}-"
        f"{max(lens)})")
    for dt in (torch.float16, torch.bfloat16):
        qkv = _leaf(torch.randn(total, 3 * 1024, generator=g, device=dev)
                    .to(dt))
        add(contrib_leg(dev, f"fmha BERT-large {str(dt)[6:]}", dt,
                        lambda: fmha(qkv, cu_t, dropout_seed=1234),
                        {"qkv": qkv}, 53))
        del qkv
    f16, s, b = torch.float16, 256, 16
    x = _leaf(torch.randn(s, b, 1024, generator=g, device=dev).to(f16))
    pad = _ragged_pad(g, dev, b, s, 64)
    for label, kw, mask in (
            ("multihead_attn self, additive key padding", dict(
                mask_additive=True, bias=True),
             torch.where(pad != 0, -1e30, 0.0)),
            ("multihead_attn self, norm_add, padding mask", dict(
                include_norm_add=True, bias=True), pad)):
        mod = SelfMultiheadAttn(1024, 16, dropout=0.1, **kw)
        params = {k: _leaf(v) for k, v in mod.init(
            torch.Generator(device=dev).manual_seed(54), device=dev,
            dtype=f16).items()}

        def run(mod=mod, params=params, mask=mask):
            gen = torch.Generator(device=dev).manual_seed(55)
            return mod(params, x, key_padding_mask=mask, dropout_seed=99,
                       generator=gen)[0]
        add(contrib_leg(dev, f"{label} fp16 [256,16,1024]", f16, run,
                        {"x": x, **params}, 56))
    mem = _leaf(torch.randn(200, b, 1024, generator=g, device=dev).to(f16))
    enc_pad = _ragged_pad(g, dev, b, 200, 50)
    mod = EncdecMultiheadAttn(1024, 16, dropout=0.1, bias=True)
    params = {k: _leaf(v) for k, v in mod.init(
        torch.Generator(device=dev).manual_seed(57), device=dev,
        dtype=f16).items()}
    add(contrib_leg(
        dev, "multihead_attn encdec fp16 256 over 200", f16,
        lambda: mod(params, x, mem, key_padding_mask=enc_pad,
                    dropout_seed=98)[0],
        {"x": x, "mem": mem, **params}, 58))
    del x, mem, params
    bf = torch.bfloat16
    q, k, v = (_leaf(torch.randn(1, 128, 8, 256, 32, generator=g,
                                 device=dev).to(bf)) for _ in range(3))
    msa_mask = torch.ones(1, 128, 1, 1, 256, device=dev)
    msa_mask[..., 236:] = 0.0  # padded residues
    pair = _leaf((0.5 * torch.randn(1, 1, 8, 256, 256, generator=g,
                                    device=dev)).to(bf))
    add(contrib_leg(dev, "openfold MSA row attention + pair bias bf16", bf,
                    lambda: attention_core(q, k, v, msa_mask, pair),
                    {"q": q, "k": k, "v": v, "pair_bias": pair}, 59))
    del q, k, v, pair
    q, k, v = (_leaf(torch.randn(1, 256, 4, 256, 32, generator=g,
                                 device=dev).to(bf)) for _ in range(3))
    tri = _leaf((0.5 * torch.randn(1, 1, 4, 256, 256, generator=g,
                                   device=dev)).to(bf))
    add(contrib_leg(dev, "openfold triangle attention (starting node) bf16",
                    bf, lambda: attention_core(q, k, v, None, tri),
                    {"q": q, "k": k, "v": v, "tri_bias": tri}, 60))
    del q, k, v, tri
    # head dim 48, which no kernel is instantiated for: the head-dim-64
    # kernels on zero-padded operands
    fmha48 = FMHA(hidden_size=768, num_attention_heads=16,
                  attention_probs_dropout_prob=0.1)
    qkv = _leaf(torch.randn(total, 3 * 768, generator=g, device=dev).to(bf))
    add(contrib_leg(dev, "fmha head dim 48 (768, 16 heads) bf16, padded "
                    "to 64", bf, lambda: fmha48(qkv, cu_t, dropout_seed=1234),
                    {"qkv": qkv}, 61))
    del qkv
    q, k, v = (_leaf(torch.randn(1, 64, 8, 256, 48, generator=g,
                                 device=dev).to(bf)) for _ in range(3))
    pair = _leaf((0.5 * torch.randn(1, 1, 8, 256, 256, generator=g,
                                    device=dev)).to(bf))
    add(contrib_leg(dev, "openfold MSA row attention + pair bias, head dim "
                    "48, bf16, padded to 64", bf,
                    lambda: attention_core(q, k, v, msa_mask[:, :64], pair),
                    {"q": q, "k": k, "v": v, "pair_bias": pair}, 62))
    return launches


# ---------------------------------------------------------------------------
# phase 9: ResNet-50 with amp and FusedSGD (BASELINE config #1)
# ---------------------------------------------------------------------------

#: ``bench.py``'s ResNet-50 leg (``bench_resnet_o2``, :515-573) and the
#: reference example's defaults: 224 px, 1000 classes, batch 256 (the
#: example's default and the largest point of the bench's sweep), SGD
#: momentum 0.9, weight decay 1e-4, lr 0.1 scaled by batch / 256
RESNET_BATCH, RESNET_SIZE, RESNET_CLASSES = 256, 224, 1000
#: RESNET_PARITY: card against CPU, one step of ResNet-50 at batch 8, TF32
#: off. fp64 (the model in fp64 throughout: the same function in both
#: places, free of fp32's cancellation): the loss within 1e-12 relative,
#: every gradient leaf and running statistic within 1e-8 of its largest
#: entry. fp32: the loss within 1e-4 relative, every running statistic
#: within 1e-3 of its largest entry, and the card's gradients no farther
#: from the fp64 step's than the CPU's: the whole tree in L2 within 4
#: times the CPU's distance, each leaf within ``F32_LEAF_K`` times the
#: CPU's distance plus ``F32_LEAF_FLOOR`` (both over the leaf's largest
#: entry). Card against CPU directly is not held to 1e-3 a leaf: at this
#: shape fp32 itself moves leaves summed from cancelling terms (the
#: zero-initialised blocks' BatchNorm parameters, the downsample kernels)
#: by up to 6e-2 of their largest entry from the fp64 result, on the card
#: and on the CPU alike, each by its own rounding. bf16 (O2): the loss
#: within 3e-2, each leaf within 3e-2 of its largest entry plus 5 times
#: the CPU's own bf16 distance of that leaf from the fp64 result, each
#: tree within twice that distance in L2
#: (``tests/test_torch_resnet_train.py``)
RESNET_PARITY_BATCH = 8
#: the fp32 per-leaf gate: each gradient leaf's distance from the fp64
#: step (over the leaf's largest entry) on the card at most
#: ``F32_LEAF_K`` times the CPU's plus ``F32_LEAF_FLOOR``; the card's
#: worst leaf measured 3.6 times the CPU's distance (1.36e-2 against
#: 3.75e-3, a zero-initialised block's BatchNorm scale; H100 80GB HBM3,
#: 700 W), so K is twice that, and a fault confined to one leaf (an
#: error of the order of the leaf) still fails it
F32_LEAF_K = 8.0
F32_LEAF_FLOOR = 1e-4


def _resnet_batch(dev, batch=RESNET_BATCH, seed=0):
    """One synthetic uint8 NHWC batch and its labels, staged on ``dev``
    (``--reuse-batches 1``): the same bytes as the JAX example's."""
    x, y = next(main_amp.synthetic_batches(np.random.default_rng(seed), 1,
                                           batch, RESNET_SIZE,
                                           RESNET_CLASSES))
    return torch.from_numpy(x).to(dev), torch.from_numpy(y).to(dev)


def _resnet_setup(dev, level, half, batch=RESNET_BATCH, seed=0):
    """ResNet-50 weights from ``seed``, ``amp.initialize`` at ``level``,
    FusedSGD, and ``main_amp.make_train_step``: ``(step, state,
    amp_state)``."""
    model = resnet.build_model("resnet50", num_classes=RESNET_CLASSES)
    params, bstats = model.init(torch.Generator(device=dev).manual_seed(seed))
    opt = FusedSGD(lr=0.1 * batch / 256, momentum=0.9, weight_decay=1e-4)
    params, opt, st = amp.initialize(params, opt, opt_level=level,
                                     half_dtype=half)
    cast = st.opt_properties.cast_model_type not in (None, torch.float32)
    step = main_amp.make_train_step(model, opt, st.scaler(0), half, cast)
    return step, (params, bstats, opt.init(params), st.scaler_state(0)), st


def _check_o2_dtypes(label, state, half):
    """JAX's ``initialize`` at O2: batchnorm leaves fp32, the rest in the
    half dtype; the optimizer's masters fp32."""
    params, _, ostate, _ = state
    leaves, treedef = tree_flatten(params)
    for path, leaf in zip(leaf_paths(treedef), leaves):
        want = (torch.float32 if any(m in path.lower() for m in
                                     ("batchnorm", "bn")) else half)
        if leaf.dtype != want:
            raise AssertionError(f"{label}: {path} is {leaf.dtype}, "
                                 f"expected {want}")
    if not all(m.dtype == torch.float32
               for m in tree_leaves(ostate.master_params)):
        raise AssertionError(f"{label}: masters not fp32")


def resnet_leg(dev, label, level, half, warm, timed, x, y, profile=False):
    """``warm`` + ``timed`` steps of ResNet-50 on one staged batch through
    ``make_train_step`` (the O1 leg inside its ``autocast`` context):
    step p50 / p99, images/s, peak memory, skipped steps and the scale;
    every loss finite, the last below the first; no kernel of the port
    launched; the dtypes the convs, the BatchNorms, the classifier and
    log_softmax see on the first step are flax's (:func:`expected_dtypes`).
    """
    t_leg = time.perf_counter()
    step, state, st = _resnet_setup(dev, level, half)
    if level == "O2":
        _check_o2_dtypes(label, state, half)
    lr = 0.1 * RESNET_BATCH / 256
    seen = {}
    box = {"state": state}

    def run():
        with st.autocast():
            out = step(*box["state"], x, y, lr)
        box["state"] = out[:4]
        return out

    losses, times = [], []
    for i in range(warm + timed):
        if i == warm:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            _device.reset_launch_counts()
        if i == 0:
            with _dtype_spies(seen):
                out = run()
        else:
            t0 = time.perf_counter()
            out = run()
            torch.cuda.synchronize()
            if i >= warm:
                times.append((time.perf_counter() - t0) * 1e3)
        losses.append(out[4])
    launches = {k: c for k, c in _device.launch_counts().items() if c}
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    losses = [float(v) for v in losses]
    ostate, sstate = box["state"][2], box["state"][3]
    skips = warm + timed - int(ostate.step)
    p50, p99 = (float(np.percentile(times, q)) for q in (50, 99))
    res = {"leg": label, "p50_ms": p50, "p99_ms": p99,
           "images_per_s": RESNET_BATCH / (p50 / 1e3), "peak_gib": peak,
           "losses": losses, "step_ms": times, "skipped": skips,
           "loss_scale": float(sstate.loss_scale), "port_launches": launches}
    res["dtypes"] = seen
    if profile:
        prof = profiled(run, f"ResNet-50 {label} step", 12)
        res.update(busy_ms=prof["busy_ms"], wall_ms=prof["wall_ms"],
                   idle=1 - prof["busy_ms"] / prof["wall_ms"],
                   device_ops=prof["device_ops"],
                   layout_transposes=[
                       (r[2][:80], r[1], r[0]) for r in prof["rows"]
                       if "nchwToNhwc" in r[2] or "nhwcToNchw" in r[2]
                       or "NchwToNhwc" in r[2] or "NhwcToNchw" in r[2]],
                   top=[(r[2][:80], r[1], round(r[0], 3))
                        for r in prof["rows"][:8]])
    res["leg_s"] = time.perf_counter() - t_leg
    log(f"  {label}: step p50 {p50:.2f} ms p99 {p99:.2f} ms, "
        f"{res['images_per_s']:.0f} images/s at p50; loss first "
        f"{losses[0]:.4f} last {losses[-1]:.4f}; peak {peak:.2f} GiB; "
        f"skipped {skips}, scale {res['loss_scale']:g}; the leg "
        f"{res['leg_s']:.1f} s")
    log("  resnet_json " + json.dumps(res))
    if launches:
        raise AssertionError(f"{label}: port kernels launched on the "
                             f"ResNet path: {launches}")
    if seen != expected_dtypes(level, half):
        raise AssertionError(f"{label}: dtypes {seen}, expected "
                             f"{expected_dtypes(level, half)}")
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"{label}: losses {losses}")
    return res, box["state"], step, st


@contextlib.contextmanager
def _dtype_spies(seen):
    """Record the dtypes the ResNet's ops receive and give: the input and
    the kernel of every F.conv2d, the input of F.linear and F.log_softmax,
    the output of every BatchNorm. Installed before ``autocast`` patches,
    so the spies see the casted arguments."""
    saved = {(F, n): getattr(F, n) for n in ("conv2d", "linear",
                                             "log_softmax")}
    saved[(resnet, "_batch_norm")] = resnet._batch_norm

    def note(name, t):
        seen.setdefault(name, set()).add(str(t.dtype))

    def spy(mod, name):
        orig = saved[(mod, name)]

        def fn(t, *a, **k):
            if mod is resnet:
                out = orig(t, *a, **k)
                note("batch_norm", out)
                return out
            note(name, t)
            if name == "conv2d":
                note("conv2d.weight", a[0])
            return orig(t, *a, **k)
        return fn

    for mod, n in saved:
        setattr(mod, n, spy(mod, n))
    try:
        yield
    finally:
        for (mod, n), f in saved.items():
            setattr(mod, n, f)
        for n in seen:
            seen[n] = sorted(seen[n])


def expected_dtypes(level, half):
    """The dtypes flax's flow gives at ``level``: the convs compute in the
    half dtype over half kernels (O0: fp32), every BatchNorm outputs fp32,
    the classifier takes fp32 (O1: its autocast casts it to the half
    dtype), log_softmax fp32."""
    conv = "torch.float32" if level == "O0" else str(half)
    return {"conv2d": [conv], "conv2d.weight": [conv],
            "batch_norm": ["torch.float32"],
            "linear": [str(half) if level == "O1" else "torch.float32"],
            "log_softmax": ["torch.float32"]}


def resnet_overflow(label, step, state, st, x):
    """One step on an input of 1e30 (``tests/test_examples.py:66``'s
    overflow): params, running statistics and optimizer state bit for
    bit, the step count kept, the scale halved."""
    before = [t.clone() for t in tree_leaves(state[:3])]
    scale = float(state[3].loss_scale)
    big = torch.full(x.shape, 1e30, device=x.device)
    y0 = torch.zeros(x.shape[0], dtype=torch.int32, device=x.device)
    out = step(*state, big, y0, 0.1)
    torch.cuda.synchronize()
    after = tree_leaves(out[:3])
    if not all(a.dtype == b.dtype and torch.equal(a, b)
               for a, b in zip(before, after)):
        raise AssertionError(f"{label}: the overflow step changed the "
                             f"state")
    if float(out[3].loss_scale) != scale / 2:
        raise AssertionError(f"{label}: scale {float(out[3].loss_scale)} "
                             f"after the overflow, was {scale}")
    log(f"  {label}: an input of 1e30 skipped the step bit for bit "
        f"({len(before)} tensors), scale {scale:g} -> "
        f"{float(out[3].loss_scale):g}")


@contextlib.contextmanager
def tf32_off():
    """TF32 off for cuDNN and matmul inside, the settings restored after;
    both logged."""
    saved = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    log(f"  TF32 before: cudnn {saved[0]}, matmul {saved[1]}; off inside")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = saved
        log(f"  TF32 restored: cudnn {saved[0]}, matmul {saved[1]}")


def _resnet_grads(dev, level, half, params_cpu, bstats_cpu, x, y,
                  cast_model_type=None):
    """Loss, gradients and new running statistics of one ResNet-50
    forward and backward at ``level`` on ``dev``, from the same weights."""
    model = resnet.build_model("resnet50", num_classes=RESNET_CLASSES)
    params = tree_map(lambda t: t.to(dev), params_cpu)
    bstats = tree_map(lambda t: t.to(dev, half if half == torch.float64
                                     else torch.float32), bstats_cpu)
    params, _, st = amp.initialize(params, None, opt_level=level,
                                   half_dtype=half,
                                   cast_model_type=cast_model_type)
    cast = st.opt_properties.cast_model_type not in (None, torch.float32)
    xx = main_amp._normalize(x.to(dev), half, cast)
    out = {}

    def loss_fn(p):
        logits, out["new"] = model.apply(p, bstats, xx, train=True)
        return main_amp._loss(logits, y.to(dev))

    # no loss scale (its unscale would round fp64 gradients through fp32)
    loss, grads = value_and_grad(loss_fn, params)
    return (float(loss), tree_map(lambda t: t.double().cpu(), grads),
            tree_map(lambda t: t.double().cpu(), out["new"]))


def _leaf_gaps(got, want):
    """Each leaf's max error over its largest entry (0-entry leaves: the
    max error itself), with the leaves' paths."""
    leaves, treedef = tree_flatten(want)
    out = []
    for path, a, b in zip(leaf_paths(treedef), tree_leaves(got), leaves):
        scale = float(b.abs().max())
        out.append((float((a - b).abs().max()) / (scale if scale else 1.0),
                    path))
    return out


def _tree_rel(got, want):
    a = torch.cat([t.reshape(-1) for t in tree_leaves(got)])
    b = torch.cat([t.reshape(-1) for t in tree_leaves(want)])
    return float((a - b).norm() / b.norm())


def resnet_parity(dev):
    """ResNet-50 at full width, batch 8, 224 px, one step, card against
    CPU, TF32 off: fp64, fp32 (O0) and bf16 (O2)."""
    params, bstats = resnet.init_params(
        "resnet50", torch.Generator().manual_seed(3),
        num_classes=RESNET_CLASSES)
    x, y = _resnet_batch("cpu", RESNET_PARITY_BATCH, seed=4)

    def run(d):
        with tf32_off():
            return {key: _resnet_grads(d, level, half, params, bstats, x, y,
                                       cmt)
                    for key, level, half, cmt in (
                        ("f64", "O0", torch.float64, torch.float64),
                        ("f32", "O0", torch.float32, None),
                        ("bf16", "O2", torch.bfloat16, None))}

    _parity_split("ResNet-50 parity", lambda: run("cpu"), lambda: run(dev),
                  _resnet_parity_check)


def _resnet_parity_check(cpu, card):
    """:func:`resnet_parity`'s gates: each level's CPU run against the
    card's."""
    runs = {key: (card[key], cpu[key]) for key in card}
    summary = {}
    ref = runs["f64"][0]
    for key, loss_tol in (("f64", 1e-12), ("f32", 1e-4)):
        card, cpu = runs[key]
        rel = abs(card[0] - cpu[0]) / abs(cpu[0])
        grads, stats = _leaf_gaps(card[1], cpu[1]), _leaf_gaps(card[2],
                                                               cpu[2])
        worst = sorted(grads, reverse=True)[:4]
        summary[key] = {"loss_rel": rel, "grad_tree_rel": _tree_rel(
            card[1], cpu[1]), "grad_worst": worst[0][0],
            "grad_worst_leaf": worst[0][1], "stats_worst": max(stats)[0],
            # how far each side's gradients lie from the fp64 step's
            "card_vs_f64_tree": _tree_rel(card[1], ref[1]),
            "cpu_vs_f64_tree": _tree_rel(cpu[1], ref[1]),
            "card_vs_f64_worst": max(_leaf_gaps(card[1], ref[1]))[0],
            "cpu_vs_f64_worst": max(_leaf_gaps(cpu[1], ref[1]))[0]}
        log(f"  {key} parity: loss {card[0]:.8f} vs {cpu[0]:.8f} (rel "
            f"{rel:.2e}); worst gradient leaves "
            f"{[(f'{g:.2e}', p) for g, p in worst]}; "
            + ", ".join(f"{k} {v:.2e}" for k, v in summary[key].items()
                        if isinstance(v, float)))
        bad = rel > loss_tol or max(stats)[0] > (1e-8 if key == "f64"
                                                 else 1e-3)
        if key == "f64":
            bad |= worst[0][0] > 1e-8
        else:  # the card's fp32 rounding no coarser than the CPU's
            bad |= summary[key]["card_vs_f64_tree"] > max(
                4 * summary[key]["cpu_vs_f64_tree"], 1e-6)
            # and so leaf by leaf: each leaf's distance from the fp64
            # step over the CPU's, the worst logged with the gate's margin
            pairs = [(c, u, p) for (c, p), (u, _) in zip(
                _leaf_gaps(card[1], ref[1]), _leaf_gaps(cpu[1], ref[1]))]
            over = [(c / (F32_LEAF_K * u + F32_LEAF_FLOOR), c, u, p)
                    for c, u, p in pairs]
            summary[key]["leaf_gate_worst"] = max(over)[0]
            log(f"  f32 leaves against fp64 (card, CPU, gate share), the "
                f"worst 6: {[(f'{c:.2e}', f'{u:.2e}', f'{r:.2f}', p) for r, c, u, p in sorted(over, reverse=True)[:6]]}")
            bad |= max(over)[0] > 1
        if bad:
            raise AssertionError(f"ResNet-50 {key} card against CPU out of "
                                 f"tolerance")
    card16, cpu16 = runs["bf16"]
    rel16 = abs(card16[0] - cpu16[0]) / abs(cpu16[0])
    worst_leaf, worst_ratio = 0.0, 0.0
    for tree_i in (1, 2):
        got, want, floor_ref = (tree_leaves(t[tree_i])
                                for t in (card16, cpu16, ref))
        for a, b, r in zip(got, want, floor_ref):
            err, m = float((a - b).abs().max()), float(b.abs().max())
            limit = 3e-2 * m + 5 * float((b - r).abs().max())
            worst_leaf = max(worst_leaf, err / max(m, 1e-30))
            if err > limit:
                raise AssertionError(f"ResNet-50 bf16 leaf: {err:.3e} over "
                                     f"{limit:.3e}")
        ga = torch.cat([t.reshape(-1) for t in got])
        gb = torch.cat([t.reshape(-1) for t in want])
        gr = torch.cat([t.reshape(-1) for t in floor_ref])
        ratio = float((ga - gb).norm() / (gb - gr).norm())
        worst_ratio = max(worst_ratio, ratio)
        if ratio > 2:
            raise AssertionError(f"ResNet-50 bf16 tree: L2 {ratio:.2f} of "
                                 f"the bf16 floor")
    log(f"  bf16 O2 parity: loss {card16[0]:.6f} vs {cpu16[0]:.6f} (rel "
        f"{rel16:.2e}); worst leaf {worst_leaf:.2e} of its largest entry, "
        f"worst tree L2 {worst_ratio:.2f} of the CPU's bf16 distance from "
        f"fp64")
    if rel16 > 3e-2:
        raise AssertionError("ResNet-50 bf16 loss out of tolerance")
    summary["bf16"] = {"loss_rel": rel16, "leaf_worst": worst_leaf,
                       "tree_l2_ratio_worst": worst_ratio}
    log("  resnet_parity_json " + json.dumps(summary))


def resnet_cli():
    """``main_amp.main`` as a user runs it, in a temporary directory:
    ResNet-50 O2, batch 256, 3 steps, ``--deterministic``."""
    import io
    import os

    argv = ["--synthetic", "--arch", "resnet50", "--opt-level", "O2", "-b",
            "256", "--epochs", "1", "--steps-per-epoch", "3",
            "--deterministic", "--print-freq", "1"]
    saved = (torch.backends.cudnn.benchmark,
             torch.backends.cudnn.deterministic)
    cwd = os.getcwd()
    buf = io.StringIO()
    with tempfile.TemporaryDirectory() as tmp:
        os.chdir(tmp)
        try:
            with contextlib.redirect_stdout(buf):
                main_amp.main(main_amp.parse(argv))
            written = os.path.exists("checkpoint.pkl")
        finally:
            os.chdir(cwd)
            (torch.backends.cudnn.benchmark,
             torch.backends.cudnn.deterministic) = saved
    text = buf.getvalue()
    for line in text.splitlines():
        log(f"  | {line}")
    if "Epoch: [0][2/3]" not in text or "Speed" not in text or not written:
        raise AssertionError("main_amp: no Epoch [0][2/3] / Speed line or "
                             "no checkpoint.pkl")


def resnet_phase(dev):
    """Phase 9: ResNet-50 at 224 px, 1000 classes, random weights from a
    seed, one synthetic batch staged on the card: the O2 bf16 headline
    (2 + 6 steps, profiled), O2 fp16 with the dynamic scale, O0, O1 (in
    its autocast context, the dtypes a conv and log_softmax see asserted)
    and O3 (1 + 3 steps each), the overflow step, card-against-CPU parity
    and the example's CLI. cudnn.benchmark stays off (the default): on, its
    autotuning of each leg's convolutions took ~110 s of the phase and
    moved no step time (H100 80GB HBM3, 700 W)."""
    log(f"  cudnn.benchmark {torch.backends.cudnn.benchmark}, "
        f"cudnn.allow_tf32 {torch.backends.cudnn.allow_tf32}, "
        f"matmul.allow_tf32 {torch.backends.cuda.matmul.allow_tf32}")
    x, y = _resnet_batch(dev)
    o2, state, step, st = resnet_leg(dev, "O2 bf16", "O2", torch.bfloat16,
                                     2, 6, x, y, profile=True)
    resnet_overflow("O2 bf16", step, state, st, x)
    del state
    resnet_leg(dev, "O2 fp16", "O2", torch.float16, 2, 6, x, y)
    for level in ("O0", "O1", "O3"):
        resnet_leg(dev, level, level, torch.bfloat16, 1, 3, x, y)
    torch.cuda.empty_cache()
    resnet_parity(dev)
    resnet_cli()
    return o2


# ---------------------------------------------------------------------------
# phase 10: fp8 (fused_dense), fused_dense_gelu_dense, mlp, fused_rope and
# FusedAdamSWA
# ---------------------------------------------------------------------------

#: the H100 SXM data sheet's dense fp8 tensor-core rate
FP8_TC_FLOPS = 1979e12
#: the 345M's four projection GEMMs a layer (rows, in, out): qkv, proj,
#: fc1, fc2; then shapes cuBLASLt does not take as they are (padded to
#: multiples of 16 and cut back)
FP8_SHAPES = ((8192, 1024, 3072), (8192, 1024, 1024), (8192, 1024, 4096),
              (8192, 4096, 1024))
FP8_PADDED_SHAPES = ((8192, 1000, 1000), (7, 1000, 1000))
#: the fp8 GEMM route (the dequantization folded into the call) against
#: its plain version (an fp32 product of the same fp8 values divided by
#: ``scale_x * scale_w``): the fp8 products are exact in fp32, so the two
#: differ in the order and the precision of the sums and in a few fp32
#: roundings of the folded scales, bounded by 2^-13 of the sum of
#: |products| (Hopper's fp8 tensor cores keep fewer bits than fp32 in
#: their partial sums between promotions to fp32), and then in the
#: output's rounding: one ulp of the output dtype (two nearby values
#: rounded once each)
FP8_SUM_TOL = 2.0 ** -13
FP8_OUT_ULP = {torch.float32: 0.0, torch.bfloat16: 2.0 ** -7,
               torch.float16: 2.0 ** -10}


def _scaled(x, fp8_max=448.0):
    """A per-tensor quantization scale that maps ``max|x|`` to
    ``fp8_max`` (fp32, 0-d)."""
    return torch.full((), fp8_max, device=x.device) / x.abs().amax().float()


def fp8_gemm_checks(dev):
    """(a) The fp8 GEMM route (``fused_dense.fp8.fp8_gemm``:
    ``torch._scaled_mm`` on the fp8 tensor cores) against its plain
    version on the same fp8 bytes, at the 345M's projection shapes and
    at padded ones, with bf16, fp16 and fp32 outputs; the quantizers'
    bytes on the card against the CPU's and their saturation; the device
    time of one ``_scaled_mm`` and of one bf16 ``F.linear`` at each
    projection shape against their bounds, and of the quantize passes."""
    schema = str(torch.ops.aten._scaled_mm.default._schema)
    probe = torch.ones(16, 16, device=dev).to(torch.float8_e4m3fn)
    one = torch.ones((), device=dev)
    ret = torch._scaled_mm(probe, probe.t(), one, one,
                           out_dtype=torch.bfloat16)
    log(f"  torch {torch.__version__}: {schema}; returns "
        f"{type(ret).__name__}")
    g = torch.Generator(device=dev).manual_seed(10)
    worst = 0.0
    for m, k, n in FP8_SHAPES + FP8_PADDED_SHAPES:
        x = torch.randn(m, k, generator=g, device=dev)
        w = torch.randn(n, k, generator=g, device=dev) * 0.02
        sx, sw = _scaled(x), _scaled(w)
        qx, qw = fp8.quantize_e4m3(x, sx), fp8.quantize_e4m3(w, sw)
        for q, src, s in ((qx, x, sx), (qw, w, sw)):
            cpu = fp8.quantize_e4m3(src.cpu(), s.cpu())
            if not torch.equal(q.view(torch.uint8).cpu(),
                               cpu.view(torch.uint8)):
                raise AssertionError(f"e4m3 bytes at {(m, k, n)}: the card "
                                     f"differs from the CPU")
        mag = (qx.float().abs() @ qw.float().abs().t()) / (sx * sw)
        for dt in (torch.bfloat16, torch.float16, torch.float32):
            before = _device.LAUNCHES["fp8_gemm"]
            got = fp8.fp8_gemm(qx, qw, sx, sw, dt)
            if _device.LAUNCHES["fp8_gemm"] != before + 1:
                raise AssertionError("fp8_gemm did not count its call")
            want = fp8.fp8_gemm_reference(qx, qw, sx, sw, dt).float()
            if got.shape != (m, n) or got.dtype != dt:
                raise AssertionError(f"fp8_gemm gave {got.dtype} "
                                     f"{tuple(got.shape)}")
            err = (got.float() - want).abs()
            over = err - FP8_OUT_ULP[dt] * want.abs()
            ratio = float((over / mag.clamp_min(1e-30)).max())
            worst = max(worst, ratio)
            if ratio > FP8_SUM_TOL:
                raise AssertionError(
                    f"fp8 GEMM {(m, k, n)} -> {dt}: error {ratio:.3e} of "
                    f"the sum of |products| beyond one output rounding "
                    f"(limit {FP8_SUM_TOL:.3e}); max abs err "
                    f"{float(err.max()):.3e}")
        del mag, got, want, err, over
    log(f"  fp8 GEMM against its plain version at "
        f"{FP8_SHAPES + FP8_PADDED_SHAPES} (rows, in, out), bf16/fp16/fp32 "
        f"out: worst error beyond one "
        f"output rounding {worst:.3e} of the sum of |products| (limit "
        f"2^-13 = {FP8_SUM_TOL:.3e})")
    # saturation, and the e5m2 bytes over 2^-20 .. 2^20 and past the max
    edge = torch.tensor([1e9, -1e9, 500.0, 448.0, -3.0], device=dev)
    if fp8.quantize_e4m3(edge, one).float().tolist() != [448.0, -448.0,
                                                          448.0, 448.0,
                                                          -3.0]:
        raise AssertionError("e4m3 does not saturate at 448")
    if fp8.quantize_e5m2(edge * 1e3, one).float().tolist()[:3] != [
            57344.0, -57344.0, 57344.0]:
        raise AssertionError("e5m2 does not saturate at 57344")
    wide = torch.randn(1 << 20, generator=g, device=dev) * torch.exp2(
        torch.randint(-20, 21, (1 << 20,), generator=g, device=dev).float())
    for fn in (fp8.quantize_e4m3, fp8.quantize_e5m2):
        s = torch.full((), 3.7, device=dev)
        if not torch.equal(fn(wide, s).view(torch.uint8).cpu(),
                           fn(wide.cpu(), s.cpu()).view(torch.uint8)):
            raise AssertionError(f"{fn.__name__}: card bytes differ from "
                                 f"the CPU's")
    log("  quantizers: e4m3 and e5m2 bytes on the card equal the CPU's "
        "(2^20 values over 2^-20..2^20, the projection operands); "
        "saturation at 448 and 57344")
    times = []
    for m, k, n in FP8_SHAPES + ((8192, 4096, 4096),):
        x = torch.randn(m, k, generator=g, device=dev, dtype=torch.bfloat16)
        w = (torch.randn(n, k, generator=g, device=dev) * 0.02).to(
            torch.bfloat16)
        sx, sw = _scaled(x), _scaled(w)
        qx, qw = fp8.quantize_e4m3(x, sx), fp8.quantize_e4m3(w, sw)
        ix, iw = sx.reciprocal(), sw.reciprocal()
        ms8 = device_ms(lambda: torch._scaled_mm(
            qx, qw.t(), ix, iw, out_dtype=torch.bfloat16,
            use_fast_accum=False), "")
        msb = device_ms(lambda: F.linear(x, w), "")
        msq = device_ms(lambda: fp8.quantize_e4m3(x, sx), "")
        msa = device_ms(lambda: x.abs().amax(), "")
        flops = 2.0 * m * k * n
        b8 = max(flops / FP8_TC_FLOPS, (m * k + n * k + 2 * m * n)
                 / HBM_BYTES_PER_S) * 1e3
        bb = max(flops / BF16_TC_FLOPS, 2 * (m * k + n * k + m * n)
                 / HBM_BYTES_PER_S) * 1e3
        bq = 3 * m * k / HBM_BYTES_PER_S * 1e3
        ba = 2 * m * k / HBM_BYTES_PER_S * 1e3
        row = {"shape": [m, k, n], "scaled_mm_ms": ms8, "fp8_bound_ms": b8,
               "linear_bf16_ms": msb, "bf16_bound_ms": bb,
               "quantize_e4m3_ms": msq, "quantize_bound_ms": bq,
               "amax_ms": msa, "amax_bound_ms": ba}
        times.append(row)
        log(f"  [{m}, {k}] x [{k}, {n}]: _scaled_mm e4m3 -> bf16 device "
            f"{ms8:.4f} ms (bound {b8:.4f}, 1979 TFLOP/s), F.linear bf16 "
            f"{msb:.4f} ms (bound {bb:.4f}, 989 TFLOP/s); quantize_e4m3 of "
            f"x {msq:.4f} ms (bound {bq:.4f}), max|x| {msa:.4f} ms (bound "
            f"{ba:.4f})")
    log("  fp8_gemm_json " + json.dumps(times))


def fp8_gemm_chain(dev, iters: int = 20):
    """(b) ``bench.py``'s ``bench_fp8_gemm``: a chain of 8 GEMMs at m 8192,
    k 4096, n 4096 in bf16 (``F.linear``, fp32 accumulation, bf16 out)
    and through ``fp8_fused_dense`` with its state update (each chain
    from the initial state, as the JAX leg passes it), CUDA-event ms a
    chain; the ratio bf16 / fp8 (> 1: fp8 faster) and both chains'
    device ms."""
    m, k, n = 8192, 4096, 4096
    g = torch.Generator(device=dev).manual_seed(11)
    x = torch.randn(m, k, generator=g, device=dev).to(torch.bfloat16)
    w = (torch.randn(n, k, generator=g, device=dev) * 0.05).to(
        torch.bfloat16)
    state0 = fp8.init_fp8_dense_state(device=dev)

    def chain_bf16():
        y = x
        for _ in range(8):
            y = F.linear(y, w)
        return y

    def chain_fp8():
        y, st = x, state0
        for _ in range(8):
            y, st = fp8.fp8_fused_dense(y, w, None, st)
            y = y.to(torch.bfloat16)
        return y

    t_bf16 = time_ms(chain_bf16, iters, 3)
    t_fp8 = time_ms(chain_fp8, iters, 3)
    d_bf16 = device_ms(chain_bf16, "", iters=5)
    d_fp8 = device_ms(chain_fp8, "", iters=5)
    out = {"bf16_ms": t_bf16, "fp8_ms": t_fp8, "ratio": t_bf16 / t_fp8,
           "bf16_device_ms": d_bf16, "fp8_device_ms": d_fp8}
    log(f"  8-GEMM chain [{m}, {k}] x [{k}, {n}]: bf16 {t_bf16:.3f} ms, "
        f"fp8 with delayed scaling {t_fp8:.3f} ms a chain (CUDA events), "
        f"ratio bf16/fp8 {t_bf16 / t_fp8:.3f}; device {d_bf16:.3f} "
        f"against {d_fp8:.3f} ms")
    log("  fp8_chain_json " + json.dumps(out))


#: the unfused 345M step with the four projections of every layer on the
#: fp8 GEMM (``_device.LAUNCHES["fp8_gemm"]`` counts the library calls)
FP8_STEP_LAUNCHES = {**UNFUSED_LAUNCHES, "fp8_gemm": 96}


def fp8_loss_grads(cfg, loss_fn, params, states, dev):
    """The fp8 loss at ``params`` with ``states`` and fresh zero carriers,
    its gradients with respect to the params and the carriers, and the
    carriers' gradients folded into the g metas: ``(loss, grads, new
    states)``."""
    box = {}

    def f(tree):
        loss, box["states"] = loss_fn(tree[0], fp8_states=states,
                                      fp8_carriers=tree[1])
        return loss
    loss, (grads, amaxes) = value_and_grad(
        f, (params, init_gpt_fp8_carriers(cfg, dev)))
    return loss, grads, record_gpt_grad_amaxes(cfg, box["states"], amaxes)


def fp8_step_fn(cfg, loss_fn, opt, dev):
    """``bench.py``'s fp8 train step (``bench_gpt(fp8=True)``):
    :func:`fp8_loss_grads`, then the optimizer's step. The state is
    ``(optimizer state, fp8 states)``."""
    def step(params, state):
        ostate, states = state
        loss, grads, states = fp8_loss_grads(cfg, loss_fn, params, states,
                                             dev)
        params, ostate = opt.step(grads, ostate, params)
        return params, (ostate, states), loss
    return step


def check_fp8_calibrated(label, states, steps):
    """Every layer's x, w and g histories hold ``steps`` positive amaxes
    (the newest first) and every g scale has moved off 1."""
    for name in FP8_GEMM_NAMES:
        for meta in states[name]:
            filled = meta.amax_history[:, :steps]
            if not bool((filled > 0).all()):
                raise AssertionError(f"{label}: {name} history not filled "
                                     f"over {steps} steps")
        if not bool((states[name].g.scale != 1.0).all()):
            raise AssertionError(f"{label}: a {name} g scale is still 1")
    log(f"  {label}: after {steps} steps every layer's x, w and g amax "
        f"histories hold {steps} positive entries and every g scale moved "
        f"off 1 (qkv g scales {states['qkv'].g.scale[:4].tolist()} ...)")


def fp8_345m(dev, unfused_p50: float):
    """(c) The 345M fp8 train step (``bench_gpt_fp8``): 24 x 1024, seq
    1024, batch 8, unfused, no recompute, ``ce_save_logits``, bf16 over
    fp32 masters, packed FusedAdam, the four projections of every layer
    on the fp8 GEMM: 2 + 6 steps, launches asserted exactly (96 fp8
    GEMMs a step among them), a profiled step that must hold 96
    ``aten::_scaled_mm``, its p50 beside the bf16 unfused leg's of phase
    5, and the states calibrated. Returns the leg's launches."""
    leg = train_leg(dev, "345M fp8 unfused, no remat", FP8_STEP_LAUNCHES, 6,
                    ce_save_logits=True, fp8=True)
    ops = leg["profile"]["ops"]
    counts = {name: ops.get(name, (0, 0.0)) for name in (fp8.FP8_GEMM,
                                                          "aten::_scaled_mm")}
    if [c for c, _ in counts.values()] != [96, 96]:
        raise AssertionError(f"the profiled fp8 step holds {counts}, "
                             f"expected 96 of each")
    sgemm = sum(ms for ms, _, key in leg["profile"]["rows"]
                if "sgemm" in key or "f32f32" in key)
    gemms = [(round(ms, 3), c, key[:90]) for ms, c, key in
             leg["profile"]["rows"] if "sgemm" not in key
             and "f32f32" not in key and any(
                 t in key.lower() for t in ("gemm", "nvjet", "sm90", "e4m3"))]
    log(f"  profiled fp8 step: (count, device ms) {counts}; the fp32 "
        f"backward GEMMs {sgemm:.2f} ms of {leg['profile']['busy_ms']:.1f} "
        f"busy; other GEMM kernels {gemms}")
    log(f"  fp8 step p50 {leg['p50']:.2f} ms against the bf16 unfused "
        f"leg's {unfused_p50:.2f} ms (phase 5, this run): "
        f"{leg['p50'] / unfused_p50:.3f}x; busy "
        f"{leg['profile']['busy_ms']:.1f} of "
        f"{leg['profile']['wall_ms']:.1f} ms profiled")
    return leg["launches"]


#: fp8 card against CPU (2 layers, full width, fp32 compute), step by
#: step from the same params and states. The fp8 GEMM's sums differ
#: (``FP8_SUM_TOL``), so an operand near an e4m3 or e5m2 rounding boundary
#: rounds the other way on the two sides, by one ulp of that element
#: (2^-3 in e4m3, 2^-2 in e5m2). The forward moves little from that; the
#: backward is chaotic: each layer's e5m2 dY carries the flips of the
#: layers above into its own roundings, so below the top layer the two
#: sides round nearly independently (on the CPU alone, the word embedding
#: scaled by 1 + 1e-6 moves the gradients by 0.5-0.9 of the recipe's own
#: error). So the gradients are held to the recipe's own error, the CPU's
#: fp8 gradients against the exact model's (fp8 off) at the same params:
#: two independent draws of that noise stand sqrt(2) of one apart. Limits:
#: the loss rel; each gradient leaf's distance from the CPU's over the CPU
#: fp8 leaf's distance from the exact one (norms); the forward metas (x,
#: w: the newest amax and the scale) rel, one e4m3 ulp (an operand of the
#: largest output rounded the other way); the g metas rel, one e5m2 ulp;
#: packed Adam's masters from the same gradients (one rounding a step, as
#: phase 2's check)
FP8_PARITY_TOL = {"loss": 1e-3, "grad share": 2.0 ** 0.5,
                  "x/w state": 2.0 ** -3, "g state": 2.0 ** -2, "adam": 1e-6}


def _state_rel(a, b):
    """Largest relative gap between two fp8 state trees' newest amaxes
    and scales, by field name (``qkv.g.scale``)."""
    out = {}
    for name in FP8_GEMM_NAMES:
        for kind, ma, mb in zip("xwg", a[name], b[name]):
            for field, ta, tb in ((f"{name}.{kind}.amax", ma.amax_history[
                    :, 0], mb.amax_history[:, 0]), (f"{name}.{kind}.scale",
                                                     ma.scale, mb.scale)):
                ta, tb = ta.float().cpu(), tb.float().cpu()
                out[field] = float(((ta - tb).abs()
                                    / tb.abs().clamp_min(1e-30)).max())
    return out


def _norm_gap(a, b):
    return float((a.float().cpu() - b.float().cpu()).norm()
                 / b.float().cpu().norm().clamp_min(1e-30))


def fp8_parity(dev, label: str, kernels, nudge=False, **cfg_kw):
    """The 2-layer 345M-width fp8 GPT (fp32 compute), 3 steps in
    lockstep: from the CPU run's params and fp8 states, the loss, every
    gradient and the rolled states on the card (the kernels and the fp8
    GEMM) against the CPU (the plain versions), each gradient leaf's gap
    held to the recipe's own error (the CPU's fp8 gradients against the
    exact model's); then packed FusedAdam(lr=1e-4, masters) steps the
    card's copy with the CPU's gradients against the CPU's step. Limits
    ``FP8_PARITY_TOL``; the card's states calibrated after 3 steps.
    ``nudge``: also log how far a 1e-6 change of the input moves the CPU's
    own fp8 gradients (the chaos of the e5m2 backward)."""
    cfg = parity_cfg(50304, fp8=True, **cfg_kw)
    exact = parity_cfg(50304, **cfg_kw)
    rng = np.random.default_rng(7)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                           (PARITY_BATCH, PARITY_SEQ)))
    labels = torch.roll(tokens, -1, dims=1)
    cpu = torch.device("cpu")

    def loss_fn(d):
        return functools.partial(gpt_loss, cfg, tokens=tokens.to(d),
                                 labels=labels.to(d))

    def to(tree, d):
        return tree_map(lambda t: t.to(d, copy=True), tree)
    params = init_gpt_params(cfg, torch.Generator().manual_seed(7))
    states = init_gpt_fp8_states(cfg, cpu)
    opts = [FusedAdam(lr=1e-4, master_weights=True, packed=True)
            for _ in range(2)]
    ostate = opts[0].init(params)
    card_ostate = opts[1].init(to(params, dev))
    launches = {}
    worst = dict.fromkeys(FP8_PARITY_TOL, 0.0)
    for k in range(3):
        _device.reset_launch_counts()
        lc, gc, sc = fp8_loss_grads(cfg, loss_fn(cpu), params, states, cpu)
        if any(_device.launch_counts().values()):
            raise AssertionError(f"launches on the CPU run: "
                                 f"{_device.launch_counts()}")
        lg, gg, sg = fp8_loss_grads(cfg, loss_fn(dev), to(params, dev),
                                    to(states, dev), dev)
        card_params, card_ostate = opts[1].step(to(gc, dev), card_ostate,
                                                to(params, dev))
        for key, n in _device.launch_counts().items():
            launches[key] = launches.get(key, 0) + n
        lr_, gr = value_and_grad(lambda p: gpt_loss(
            exact, p, tokens, labels), params)
        stepped, ostate = opts[0].step(gc, ostate, params)
        lc, lg, lr_ = float(lc), float(lg), float(lr_)
        loss_gap = abs(lg - lc) / abs(lc)
        shares = {n: _norm_gap(b, a) / max(_norm_gap(a, r), 1e-30)
                  for n, a, b, r in zip(
                      PackSpec(params).leaf_names(), tree_leaves(gc),
                      tree_leaves(gg), tree_leaves(gr))}
        grad_name = max(shares, key=shares.get)
        if nudge and k == 1:  # the chaos on the CPU alone
            nudged = dict(params, embedding=dict(
                params["embedding"],
                word=params["embedding"]["word"] * (1.0 + 1e-6)))
            _, gn, _ = fp8_loss_grads(cfg, loss_fn(cpu), nudged, states, cpu)
            nudge = [_norm_gap(b, a) / max(_norm_gap(a, r), 1e-30)
                     for a, b, r in zip(tree_leaves(gc), tree_leaves(gn),
                                        tree_leaves(gr))]
            log(f"  fp8 {label}: on the CPU alone, the word embedding x "
                f"(1 + 1e-6) moves the fp8 gradients by {min(nudge):.3f}-"
                f"{max(nudge):.3f} (median {float(np.median(nudge)):.3f}) of "
                f"the recipe's own error")
        srel = _state_rel(sg, sc)
        fwd = {n: v for n, v in srel.items() if ".g." not in n}
        bwd = {n: v for n, v in srel.items() if ".g." in n}
        fwd_name, bwd_name = max(fwd, key=fwd.get), max(bwd, key=bwd.get)
        adam = max(_leaf_rel(b, a) for a, b in zip(
            tree_leaves(stepped), tree_leaves(card_params)))
        log(f"  fp8 {label} step {k + 1}: loss card {lg:.7f} cpu {lc:.7f} "
            f"(rel {loss_gap:.2e}; exact model {lr_:.7f}); gradient gap "
            f"card-cpu over fp8-exact, worst leaf {grad_name} "
            f"{shares[grad_name]:.3f} (median "
            f"{float(np.median(list(shares.values()))):.3f}); forward metas "
            f"worst {fwd_name} rel {fwd[fwd_name]:.2e}, g metas worst "
            f"{bwd_name} rel {bwd[bwd_name]:.2e}; packed Adam on the card "
            f"from the CPU's gradients {adam:.2e} of a leaf's largest entry")
        for key, val in (("loss", loss_gap), ("grad share", shares[grad_name]),
                         ("x/w state", fwd[fwd_name]),
                         ("g state", bwd[bwd_name]), ("adam", adam)):
            worst[key] = max(worst[key], val)
        params, states = stepped, sc
    missing = [n for n in kernels + ("fp8_gemm", "packed_adam")
               if launches.get(n, 0) <= 0]
    if missing:
        raise AssertionError(f"{label}: {missing} did not launch on the card")
    check_fp8_calibrated(f"fp8 {label} (card)", sg, 3)
    log(f"  fp8 {label}: worst over 3 steps {worst}; limits "
        f"{FP8_PARITY_TOL}; card launches "
        f"{({k: v for k, v in launches.items() if v})}")
    if any(worst[k] > FP8_PARITY_TOL[k] for k in worst):
        raise AssertionError(f"fp8 {label}: the card differs from the CPU "
                             f"beyond {FP8_PARITY_TOL}")


def fused_dense_leg(dev):
    """(e) ``fused_dense_gelu_dense`` at the 345M's MLP (8192 tokens, 1024
    -> 4096 -> 1024, bf16), forward and backward: the bias-GeLU kernels
    launched once each, the output and every gradient against the plain
    versions on the card, fwd + bwd device ms. Returns the launches."""
    g = torch.Generator(device=dev).manual_seed(12)

    def r(*shape, s=1.0):
        return (torch.randn(*shape, generator=g, device=dev) * s).to(
            torch.bfloat16)
    args = (r(8192, HIDDEN), r(4 * HIDDEN, HIDDEN, s=0.02), r(4 * HIDDEN),
            r(HIDDEN, 4 * HIDDEN, s=0.02), r(HIDDEN))
    dy = r(8192, HIDDEN)

    def run():
        xs = [a.clone().requires_grad_(True) for a in args]
        y = fused_dense_gelu_dense(*xs)
        y.backward(dy)
        return [y] + [a.grad for a in xs]
    _device.reset_launch_counts()
    got = run()
    launches = _device.launch_counts()
    if {k: v for k, v in launches.items() if v} != {"bias_gelu_fwd": 1,
                                                     "bias_gelu_bwd": 1}:
        raise AssertionError(f"fused_dense_gelu_dense launches {launches}")
    with plain_kernels():
        want = run()
    margins = [check_close(f"fused_dense_gelu_dense {n}", a.detach(),
                           b.detach(), torch.bfloat16, margin=True)[1]
               for n, a, b in zip(("y", "dx", "dw1", "db1", "dw2", "db2"),
                                  got, want)]
    ms = device_ms(run, "", iters=10)
    flops = 3 * 2 * 2 * 8192 * HIDDEN * 4 * HIDDEN
    log(f"  fused_dense_gelu_dense [8192, 1024] -> 4096 -> 1024 bf16: "
        f"bias-GeLU forward and backward launched once each; against the "
        f"plain versions (y, dx, dw1, db1, dw2, db2) at most "
        f"{max(margins):.3f} of the bf16 limit; forward + backward device "
        f"{ms:.3f} ms (GEMM bound {flops / BF16_TC_FLOPS * 1e3:.3f} ms)")
    return launches


#: fp32 on the card (TF32 off) against the CPU: summation order only
F32_LEAF_TOL = 1e-5


def _leaf_rel(a, b):
    """max |a - b| over max |b|."""
    a, b = a.detach().float().cpu(), b.detach().float().cpu()
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))


def mlp_leg(dev):
    """(f) ``MLP`` at the upstream apex test's sizes ([480, 1024, 1024,
    512, 256, 1], batch 1024, fp32) with relu, sigmoid and none, forward
    and backward, card against CPU from the same params (no kernel of the
    port: cuBLAS GEMMs), each output and gradient within
    ``F32_LEAF_TOL`` of its largest entry; fwd + bwd device ms."""
    sizes = [480, 1024, 1024, 512, 256, 1]
    x = torch.randn(1024, 480, generator=torch.Generator().manual_seed(13))
    for act in ("relu", "sigmoid", "none"):
        ref = MLP(sizes, activation=act, device="cpu",
                  generator=torch.Generator().manual_seed(14))
        card = MLP(sizes, activation=act, device=dev)
        card.load_state_dict(ref.state_dict())
        outs = []
        for mod, d in ((ref, "cpu"), (card, dev)):
            xi = x.to(d, copy=True).requires_grad_(True)
            y = mod(xi)
            y.backward(torch.ones_like(y))
            outs.append([y, xi.grad] + [p.grad for p in mod.parameters()])
        worst = max(_leaf_rel(b, a) for a, b in zip(*outs))
        if worst > F32_LEAF_TOL:
            raise AssertionError(f"MLP {act}: card differs from the CPU by "
                                 f"{worst:.3e} of a result's largest entry")

        def run():
            xi = x.to(dev, copy=True).requires_grad_(True)
            card(xi).sum().backward()
        ms = device_ms(run, "", iters=10)
        log(f"  MLP {sizes} batch 1024 fp32 {act}: card against CPU "
            f"{worst:.2e} of a result's largest entry; forward + backward "
            f"device {ms:.3f} ms")


#: fused_rope card against CPU, plain PyTorch on both: the fp32 results
#: differ by the two libraries' cos and sin (an ulp or two) and the
#: gradients of freqs, cos and sin by their sums' order, each within
#: ``F32_LEAF_TOL`` of its largest entry; the bf16 output by one bf16
#: rounding of those (rtol 2^-7, atol 1e-5 for values the fp32 difference
#: moves across zero); the bf16 gradient of t is the bf16 sum of two
#: bf16-rounded terms (the cos and the rotated sin paths), which may
#: cancel: within one bf16 rounding of the largest entry
ROPE_BF16_TOL = (1e-5, 2.0 ** -7)


def _rope_case(dev, label, fn, arrays, grads_of):
    """``fn(*arrays)`` forward and backward (one fixed draw of dy) on the
    CPU and on the card; the output and the gradient of each argument in
    ``grads_of`` compared."""
    res, dy = [], None
    for d in ("cpu", dev):
        xs = [a.to(d, copy=True).requires_grad_(i in grads_of)
              if a.is_floating_point() else a.to(d)
              for i, a in enumerate(arrays)]
        y = fn(*xs)
        if dy is None:
            dy = torch.randn(y.shape, generator=torch.Generator().manual_seed(
                15)).to(y.dtype)
        y.backward(dy.to(d))
        res.append([y] + [xs[i].grad for i in grads_of])
    worst = {torch.float32: 0.0, torch.bfloat16: 0.0}
    for name, a, b in zip(["out"] + [f"d{i}" for i in grads_of], *res):
        if name == "out":
            check_close(f"rope {label} out", b.detach().cpu(), a.detach(),
                        b.dtype, tol=ROPE_BF16_TOL)
            continue
        rel = _leaf_rel(b, a)
        worst[b.dtype] = max(worst[b.dtype], rel)
        limit = F32_LEAF_TOL if b.dtype == torch.float32 else 2.0 ** -7
        if rel > limit:
            raise AssertionError(f"rope {label} {name}: {rel:.3e} of its "
                                 f"largest entry")
    log(f"  fused_rope {label}: card against CPU, the output within one "
        f"rounding; gradients of t (bf16) {worst[torch.bfloat16]:.2e}, of "
        f"the fp32 inputs {worst[torch.float32]:.2e} of their largest "
        f"entry")


def rope_leg(dev):
    """(g) ``fused_rope``'s four layouts, forward and backward, card
    against CPU: sbhd and cached cos/sin at Llama-2-7B's attention shape
    (s 4096, b 1, 32 heads, d 128, bf16; NeoX frequencies, theta 10000)
    with d2 128 and 64; thd over ragged cu_seqlens (4096 tokens in four
    sequences); 2-D over a 32 x 32 image (b 2, 12 heads, d 64)."""
    gen = torch.Generator().manual_seed(16)
    s, h, d = 4096, 32, 128
    t = torch.randn(s, 1, h, d, generator=gen).to(torch.bfloat16)

    def neox(n, d2):
        inv = 1.0 / 10000.0 ** (torch.arange(0, d2, 2).float() / d2)
        f = torch.outer(torch.arange(n).float(), inv)
        return torch.cat([f, f], dim=-1)

    for d2 in (128, 64):
        f = neox(s, d2)[:, None, None, :]
        _rope_case(dev, f"sbhd [4096, 1, 32, 128] bf16 d2 {d2}",
                   fused_apply_rotary_pos_emb, [t, f], (0, 1))
        _rope_case(dev, f"cached cos/sin d2 {d2}",
                   fused_apply_rotary_pos_emb_cached,
                   [t, torch.cos(f), torch.sin(f)], (0, 1, 2))
    lens = [1000, 17, 2048, 1031]
    cu = torch.tensor([0] + np.cumsum(lens).tolist(), dtype=torch.int32)
    _rope_case(dev, f"thd {lens}",
               lambda x, c, f: fused_apply_rotary_pos_emb_thd(x, c, f),
               [t[:, 0], cu, neox(max(lens), d)[:, None, None, :]], (0, 2))
    img = torch.randn(2, 32 * 32, 12, 64, generator=gen).to(torch.bfloat16)
    fh = neox(32, 32)[None, :, None, :]
    _rope_case(dev, "2-D 32 x 32 image [2, 1024, 12, 64]",
               lambda x, ch, sh, cw, sw: fused_apply_rotary_pos_emb_2d(
                   x, 32, 32, ch, sh, cw, sw),
               [img, torch.cos(fh), torch.sin(fh), torch.cos(fh),
                torch.sin(fh)], (0, 1, 2, 3, 4))


#: FusedAdamSWA card against CPU: every operation rounded once in fp32 in
#: the same order on both, but CUDA's and the CPU's fp32 pow may round
#: beta2**t an ulp apart, and the bias correction 1 - beta2**t cancels
#: (0.999: an ulp of it is up to 6e-5 of 1 - 0.999**t at t <= 3; the
#: square root halves it): the masters and SWA averages within 1e-6 of
#: themselves plus 1e-4 of the leaf's largest 3-step update, the bf16
#: compute copies within one bf16 rounding of that; the moments take no
#: pow, but the weight decay carries the masters' gap into them: within
#: 1e-6 of themselves plus 1e-6 of the leaf's largest
SWA_TOL = {"rel": 1e-6, "update": 1e-4, "bf16": 2.0 ** -7}
#: elements of each leaf the CPU reference updates: the step is elementwise,
#: so each element's update is that of the whole tree's
SWA_SLICE = 1 << 16


def adam_swa_leg(dev):
    """(h) ``FusedAdamSWA`` over the 345M's parameter tree (354,877,440
    elements): fp32 masters, bf16 compute copies and fp32 SWA averages,
    bf16 gradients, each math mode 3 steps on the card; the CPU runs the
    same steps on each leaf's first ``SWA_SLICE`` elements (the update is
    elementwise), compared within ``SWA_TOL``; the card's step device
    ms."""
    shapes = gpt345m_param_shapes(torch.float32)
    g = torch.Generator(device=dev).manual_seed(17)

    def draw(scale):
        return tree_map(lambda m: torch.randn(
            m.shape, generator=g, device=dev) * scale, shapes)

    def head(tree):
        return tree_map(lambda t: t.reshape(-1)[:SWA_SLICE].cpu(), tree)

    masters = draw(0.02)
    grads = [tree_map(lambda t: t.to(torch.bfloat16), draw(1e-3))
             for _ in range(3)]
    for mode in AdamMathType:
        opt = FusedAdamSWA(swa_decay_rate=0.9, lr=1e-3, weight_decay=0.01,
                           adam_math_mode=mode)
        banks = {}
        for d in ("cuda", "cpu"):
            p = masters if d == "cuda" else head(masters)
            cp = tree_map(lambda t: t.to(torch.bfloat16), p)
            sp = tree_map(torch.zeros_like, p)
            st = opt.init(p)
            for i in range(3):
                gi = grads[i] if d == "cuda" else head(grads[i])
                p, cp, sp, st = opt.step(gi, st, p, cp, sp)
            banks[d] = (p, cp, sp, st.exp_avg, st.exp_avg_sq)
            if d == "cuda":
                ms = device_ms(lambda: opt.step(grads[0], st, p, cp, sp), "",
                               iters=2)
                banks[d] = tuple(head(b) for b in banks[d])
        margins = []
        updates = [float((p - p0).abs().max()) for p, p0 in zip(
            tree_leaves(banks["cpu"][0]), tree_leaves(head(masters)))]
        for name, a, b in zip(("masters", "compute", "swa", "m", "v"),
                              banks["cuda"], banks["cpu"]):
            for x, y, upd in zip(tree_leaves(a), tree_leaves(b), updates):
                atol = (SWA_TOL["rel"] * float(y.abs().max())
                        if name in ("m", "v") else SWA_TOL["update"] * upd)
                rtol = SWA_TOL["bf16"] if y.dtype == torch.bfloat16 \
                    else SWA_TOL["rel"]
                margins.append(check_close(
                    f"FusedAdamSWA {mode.name} {name}", x, y, y.dtype,
                    tol=(atol, rtol), margin=True)[1])
        log(f"  FusedAdamSWA {mode.name} over the 345M tree, 3 steps: card "
            f"against CPU at most {max(margins):.3f} of the limits; a step's "
            f"device {ms:.3f} ms")


def fp8_and_friends_phase(dev, unfused_p50: float):
    """Phase 10: (a) the fp8 GEMM route, (b) the fp8 GEMM chain, (c) the
    345M fp8 train step, (d) fp8 card against CPU, (e)
    ``fused_dense_gelu_dense``, (f) ``MLP``, (g) ``fused_rope``, (h)
    ``FusedAdamSWA``. Returns the main paths' launches ((c) and (e))."""
    parts = {}

    def part(key, fn, *args, **kw):
        t0 = time.perf_counter()
        out = fn(*args, **kw)
        torch.cuda.empty_cache()
        parts[key] = round(time.perf_counter() - t0, 1)
        return out
    part("a", fp8_gemm_checks, dev)
    part("b", fp8_gemm_chain, dev)
    launches = part("c", fp8_345m, dev, unfused_p50)
    part("d unfused", fp8_parity, dev, "unfused", TRAIN_KERNELS[:4],
         nudge=True)
    part("d fused", fp8_parity, dev, "fused block, selective_elementwise",
         TRAIN_KERNELS[:4] + FUSED_KERNELS, fused_block=True,
         recompute_granularity="selective_elementwise")
    fd_launches = part("e", fused_dense_leg, dev)
    part("f", mlp_leg, dev)
    part("g", rope_leg, dev)
    part("h", adam_swa_leg, dev)
    log(f"  phase 10 parts (s): {parts}")
    return {k: launches.get(k, 0) + fd_launches.get(k, 0) for k in launches}


# ---------------------------------------------------------------------------
# phase 11: the single-device contribs of A5.5 (focal_loss, group_norm,
# groupbn, conv_bias_relu, bottleneck, index_mul_2d, sparsity, transducer,
# the legacy contrib optimizers) and RNN/ at full width. No kernel of the
# port sits on these paths (plain PyTorch over cuDNN and cuBLAS): the
# launch counts must read zero after the phase.
# ---------------------------------------------------------------------------

#: card against CPU on phase 11's legs (the CPU on a slice or a small batch
#: of the leg's inputs, the same function on the same values): fp32 (TF32
#: off) within 1e-5 of each result's largest entry (summation order); a
#: bf16 or fp16 result also within one rounding to its dtype of the
#: largest (the fp32 value before the cast may fall either side of a
#: rounding boundary); a bf16 convolution's output within two bf16
#: roundings (2^-7: the conv's, then the bias add's); index_mul's forward
#: and the 2:4 masks bit for bit; the legacy optimizers as ``SWA_TOL``.
#: The gradients of the convs, the Bottleneck and the RNNs are held in
#: fp64, within 1e-8 (fp64 sums in the libraries' orders, through the
#: BatchNorm's E[x^2] - E[x]^2, which cancels: the Bottleneck's read
#: 1.9e-10): a ReLU's gradient jumps where its input crosses 0,
#: and in fp32 the card's and the CPU's pre-activations, a few ulps apart,
#: put ~0.5 of 401,408 conv outputs on opposite sides of it (one such
#: flip moved the 3x3 conv's input gradient by 6.1e-2 of its largest
#: entry; H100 80GB HBM3 at 700 W), where fp64 puts none
CONTRIB_TOL = {torch.float32: 1e-5, torch.bfloat16: 2.0 ** -8 + 1e-5,
               torch.float16: 2.0 ** -11 + 1e-5, torch.float64: 1e-8}
CONV_BF16_TOL = 2.0 ** -7


def _gap(name, got, want, tol):
    """``max |got - want| / max |want|``; raises above ``tol``."""
    got, want = got.detach().float().cpu(), want.detach().float().cpu()
    if got.shape != want.shape:
        raise AssertionError(f"{name}: shape {tuple(got.shape)} against "
                             f"{tuple(want.shape)}")
    if not torch.isfinite(got).all():
        raise AssertionError(f"{name}: not finite")
    gap = float((got - want).abs().max()) / max(
        float(want.abs().max()), 1e-30)
    if gap > tol:
        raise AssertionError(f"{name}: card against CPU {gap:.3e} of the "
                             f"largest entry, limit {tol:.1e}")
    return gap


def _both_devices(dev, fn, arrays, grad=(), dy_seed=0):
    """``fn`` over ``arrays`` (CPU tensors) on the CPU and on ``dev``:
    ``{"cpu": (outputs, grads), "card": ...}``, the gradients those of
    ``sum(outputs[0] * dy)`` for the arrays at positions ``grad``."""
    out = {}
    for side, d in (("cpu", torch.device("cpu")), ("card", dev)):
        xs = [a.to(d).requires_grad_() if i in grad else a.to(d)
              for i, a in enumerate(arrays)]
        res = fn(*xs)
        res = res if isinstance(res, tuple) else (res,)
        gs = ()
        if grad:
            dy = torch.randn(res[0].shape, generator=torch.Generator()
                             .manual_seed(dy_seed)).to(d)
            gs = torch.autograd.grad((res[0].float() * dy).sum(),
                                     [xs[i] for i in grad])
        out[side] = (res, gs)
    return out


def _hold_pair(label, pair, tols):
    """Every output and gradient of ``_both_devices`` within its
    ``tols`` entry (a dtype -> limit map, or a limit); the largest gap."""
    gaps = []
    card, cpu = pair["card"], pair["cpu"]
    for kind, a_list, c_list in (("out", card[0], cpu[0]),
                                 ("grad", card[1], cpu[1])):
        for i, (a, c) in enumerate(zip(a_list, c_list)):
            tol = tols[c.dtype] if isinstance(tols, dict) else tols
            gaps.append(_gap(f"{label} {kind} {i}", a, c, tol))
    return max(gaps)


def _leg(rows, name, fn, nbytes=0.0, flops=0.0, peak=FP32_FLOPS, gap=None,
         iters=3, warmup=1, **extra):
    """Times ``fn`` (CUDA-event ms a call over ``iters`` calls), reads the
    peak memory it took, logs and records the leg."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ms = time_ms(fn, iters=iters, warmup=warmup)
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    row = {"leg": name, "ms": round(ms, 4), "peak_gib": round(peak_gib, 3)}
    if nbytes or flops:
        b_ms, by = bound(nbytes, flops, peak)
        row.update(bound_ms=round(b_ms, 4), bound_by=by)
    if gap is not None:
        row["card_cpu_gap"] = float(f"{gap:.3e}")
    row.update(extra)
    rows.append(row)
    log(f"  {name}: {ms:.3f} ms"
        + (f" (bound {row['bound_ms']:.4f} by {row['bound_by']})"
           if "bound_ms" in row else "")
        + f", peak {peak_gib:.2f} GiB"
        + (f", card against CPU {gap:.2e}" if gap is not None else ""))
    return row


#: EfficientDet-D0 at 512 px (``efficientdet-d0``: min_level 3, max_level
#: 7, num_scales 3 x aspect_ratios 3 = 9 anchors a location, 90 COCO
#: classes, the focal loss's alpha 0.25 and gamma 1.5; the apex kernel
#: takes the classes padded to a multiple of 8): 49,104 anchors an image
FOCAL_LEVELS = (64, 32, 16, 8, 4)
FOCAL_ANCHORS = 9 * sum(s * s for s in FOCAL_LEVELS)
FOCAL_BATCH = 16


def focal_leg(dev, rows):
    """(a) ``focal_loss`` over a batch of 16 images' anchors, fp16
    logits, ~1 % positive, ~4 % ignored (-2), the rest all-negative (-1);
    label smoothing 0 and 0.1; forward and backward."""
    from apex_tpu_torch.contrib.focal_loss import focal_loss

    b, c, real = FOCAL_BATCH, 96, 90
    g = torch.Generator(device=dev).manual_seed(41)
    logits = (torch.randn(b, FOCAL_ANCHORS, c, generator=g, device=dev)
              * 3).half()
    cls = torch.randint(0, real, (b, FOCAL_ANCHORS), generator=g,
                        device=dev)
    u = torch.rand(b, FOCAL_ANCHORS, generator=g, device=dev)
    y = torch.where(u < 0.01, cls, torch.where(u < 0.05, -2, -1))
    npos = (y >= 0).sum().float()
    for s in (0.0, 0.1):
        def run(p, y, n, s=s):
            return focal_loss(p, y, n, real, 0.25, 1.5, s)

        def step():
            p = logits.detach().requires_grad_()
            return torch.autograd.grad(run(p, y, npos), p)
        loss = run(logits, y, npos)
        if not torch.isfinite(loss):
            raise AssertionError("focal loss not finite")
        pair = _both_devices(dev, run, [logits[:1].cpu(), y[:1].cpu(),
                                        npos.cpu()], grad=(0,))
        gap = _hold_pair(f"focal s={s}", pair, CONTRIB_TOL)
        n = logits.numel()
        _leg(rows, f"(a) focal_loss [{b}, {FOCAL_ANCHORS}, 96] fp16, "
             f"smoothing {s}: fwd+bwd", step,
             nbytes=n * 2 * 2 + y.numel() * 8, gap=gap,
             loss=round(float(loss), 6))


#: the Stable Diffusion 1.5 UNet at 512 px (``runwayml/stable-diffusion-v1-5``
#: ``unet/config.json``: block_out_channels 320, 640, 1280, 1280,
#: norm_num_groups 32, norm_eps 1e-5, SiLU; latent 64 x 64), batch 8
GN_SHAPES = ((8, 64, 64, 320), (8, 32, 32, 640), (8, 16, 16, 1280),
             (8, 8, 8, 1280))


def group_norm_leg(dev, rows):
    """(b) ``group_norm_nhwc`` with swish at the UNet's four widths, bf16
    and fp16, forward and backward."""
    from apex_tpu_torch.contrib.group_norm import group_norm_nhwc

    g = torch.Generator(device=dev).manual_seed(42)
    for shape in GN_SHAPES:
        c = shape[-1]
        w = 1 + 0.1 * torch.randn(c, generator=g, device=dev)
        bias = 0.1 * torch.randn(c, generator=g, device=dev)
        for dt in (torch.bfloat16, torch.float16):
            x = torch.randn(shape, generator=g, device=dev).to(dt)
            dy = torch.randn(shape, generator=g, device=dev).to(dt)

            def run(x, w, b):
                return group_norm_nhwc(x, 32, w, b, 1e-5, "swish")

            def step():
                xs, ws, bs = (t.detach().requires_grad_()
                              for t in (x, w, bias))
                return torch.autograd.grad(run(xs, ws, bs), (xs, ws, bs), dy)
            pair = _both_devices(dev, run, [x[:1].cpu(), w.cpu(),
                                            bias.cpu()], grad=(0, 1, 2))
            gap = _hold_pair("group_norm", pair, CONTRIB_TOL)
            _leg(rows, f"(b) group_norm+swish {list(shape)} "
                 f"{str(dt)[6:]}: fwd+bwd", step, nbytes=x.numel() * 2 * 5,
                 gap=gap)


#: ResNet-50's stage-1 tail at batch 256 (torchvision ``resnet50``)
GROUPBN_SHAPE = (256, 56, 56, 256)


def groupbn_leg(dev, rows):
    """(c) ``BatchNorm2d_NHWC`` at ResNet-50's stage-1 tail, ``[256, 56,
    56, 256]`` bf16: with a residual ``z`` (add + ReLU) and with
    ``fuse_relu`` alone; two training steps (the running statistics
    move), then one in evaluation."""
    from apex_tpu_torch.contrib.groupbn import BatchNorm2d_NHWC

    g = torch.Generator(device=dev).manual_seed(43)
    shape = GROUPBN_SHAPE
    c = shape[-1]
    x = torch.randn(shape, generator=g, device=dev).bfloat16()
    z = torch.randn(shape, generator=g, device=dev).bfloat16()
    for label, bn, zz in (("add+ReLU", BatchNorm2d_NHWC(c), z),
                          ("fuse_relu", BatchNorm2d_NHWC(c, fuse_relu=True),
                           None)):
        params, state = bn.init(device=dev)
        params = {k: (v + 0.1 * torch.randn(v.shape, generator=g,
                                            device=dev)).requires_grad_()
                  for k, v in params.items()}
        box = {"state": state}

        def step(bn=bn, params=params, zz=zz):
            y, box["state"] = bn.apply(params, box["state"], x, zz)
            return torch.autograd.grad(y.float().sum(),
                                       (params["weight"], params["bias"]))
        step()
        step()
        moved = float((box["state"]["running_mean"]).abs().max())
        if not moved > 0:
            raise AssertionError("groupbn: running mean did not move")
        y_eval, same = bn.apply(params, box["state"], x, zz, training=False)
        if same["running_mean"] is not box["state"]["running_mean"]:
            raise AssertionError("groupbn: evaluation moved the statistics")

        def run(x, *rest, bn=bn, with_z=zz is not None):
            p = {"weight": rest[-2], "bias": rest[-1]}
            _, st = bn.init(device=x.device)
            y, st = bn.apply(p, st, x, rest[0] if with_z else None)
            return y, st["running_mean"], st["running_var"]
        arrays = [x[:8].cpu()] + ([z[:8].cpu()] if zz is not None else []) \
            + [params["weight"].detach().cpu(), params["bias"].detach().cpu()]
        grad = tuple(range(len(arrays)))
        pair = _both_devices(dev, run, arrays, grad=grad)
        gap = _hold_pair("groupbn", pair, CONTRIB_TOL)
        n = x.numel()
        _leg(rows, f"(c) BatchNorm2d_NHWC {label} {list(shape)} bf16: "
             "train fwd+bwd", step, nbytes=n * 2 * (6 if zz is not None
                                                    else 5), gap=gap,
             eval_finite=bool(torch.isfinite(y_eval).all()))


#: ResNet-50's shapes at batch 256 (torchvision ``resnet50``): stage 1's
#: 3x3 conv (64 -> 64 at 56 x 56, padding 1) and stage 2's strided 1x1
#: downsample (256 -> 512, stride 2)
CONV_CASES = (("3x3 [256, 56, 56, 64] -> 64, pad 1", (256, 56, 56, 64), 64,
               3, 1, 1),
              ("1x1 [256, 56, 56, 256] -> 512, stride 2", (256, 56, 56, 256),
               512, 1, 0, 2))


def conv_bias_relu_leg(dev, rows):
    """(d) the four ``conv_bias_relu`` functions at both shapes, bf16,
    forward and backward (the frozen scale's bias and scale take none)."""
    from apex_tpu_torch.contrib import conv_bias_relu as cbr

    g = torch.Generator(device=dev).manual_seed(44)
    for label, shape, cout, k, pad, stride in CONV_CASES:
        n, h, w_, cin = shape
        x = torch.randn(shape, generator=g, device=dev).bfloat16()
        w = (torch.randn(cout, cin, k, k, generator=g, device=dev)
             * (k * k * cin) ** -0.5).bfloat16().contiguous(
                 memory_format=torch.channels_last)
        b = 0.1 * torch.randn(cout, generator=g, device=dev)
        s = 1 + 0.1 * torch.rand(cout, generator=g, device=dev)
        ho = (h + 2 * pad - k) // stride + 1
        mask = (torch.rand(n, ho, ho, cout, generator=g, device=dev)
                > 0.2).bfloat16()
        fns = {
            "ConvBiasReLU": lambda x, w, b, m, s: cbr.ConvBiasReLU(
                x, w, b, pad, stride),
            "ConvBiasMaskReLU": lambda x, w, b, m, s: cbr.ConvBiasMaskReLU(
                x, w, b, m, pad, stride),
            "ConvBias": lambda x, w, b, m, s: cbr.ConvBias(
                x, w, b, pad, stride),
            "ConvFrozenScaleBiasReLU":
                lambda x, w, b, m, s: cbr.ConvFrozenScaleBiasReLU(
                    x, w, s, b, pad, stride),
        }
        flops = 2.0 * n * ho * ho * cout * cin * k * k * 3
        for name, fn in fns.items():
            grad_of = (0, 1) if name == "ConvFrozenScaleBiasReLU" \
                else (0, 1, 2)

            def step(fn=fn, grad_of=grad_of):
                xs = [x.detach().requires_grad_(), w.detach().requires_grad_(),
                      b.detach().requires_grad_()]
                y = fn(xs[0], xs[1], xs[2], mask, s)
                return torch.autograd.grad(y, [xs[i] for i in grad_of],
                                           torch.ones_like(y))
            y = fn(x, w, b, mask, s)
            if y.shape != (n, ho, ho, cout) or y.dtype != torch.bfloat16:
                raise AssertionError(f"{name}: {tuple(y.shape)} {y.dtype}")
            small = [x[:2].cpu(), w.cpu(), b.cpu(), mask[:2].cpu(), s.cpu()]
            gap16 = _hold_pair(f"{name} bf16", _both_devices(
                dev, fn, small), CONV_BF16_TOL)
            gap32 = _hold_pair(f"{name} fp32", _both_devices(
                dev, fn, [t.float() for t in small]), CONTRIB_TOL)
            gap64 = _hold_pair(f"{name} fp64", _both_devices(
                dev, fn, [t.double() for t in small], grad=grad_of),
                CONTRIB_TOL)
            _leg(rows, f"(d) {name} {label} bf16: fwd+bwd", step,
                 flops=flops, peak=BF16_TC_FLOPS,
                 gap=max(gap16, gap32, gap64))


def _bottleneck_flops(n, hw, cin, mid, cout, stride):
    ho = hw // stride
    f = 2.0 * n * (hw * hw * cin * mid + ho * ho * mid * mid * 9
                   + ho * ho * mid * cout)
    if stride != 1 or cin != cout:
        f += 2.0 * n * ho * ho * cin * cout
    return 3 * f  # forward, and the backward's data and weight gradients


#: ResNet-50's stage-1 block and stage 2's first at batch 256: (in, mid,
#: out, stride) over an input of ``BOTTLENECK_INPUT``
BOTTLENECK_INPUT = (256, 56, 56, 256)
BOTTLENECK_BLOCKS = ((256, 64, 256, 1), (256, 128, 512, 2))


def bottleneck_leg(dev, rows):
    """(e) ``Bottleneck`` at ResNet-50's stage-1 block (256 -> 64 -> 256,
    stride 1) and stage 2's first (256 -> 128 -> 512, stride 2, with the
    downsample), batch 256, bf16 input computed in fp32 as flax promotes
    it: forward and backward in training."""
    from apex_tpu_torch.contrib.bottleneck import Bottleneck

    g = torch.Generator(device=dev).manual_seed(45)
    n, hw = BOTTLENECK_INPUT[:2]
    x = torch.randn(BOTTLENECK_INPUT, generator=g, device=dev).bfloat16()
    for cin, mid, cout, stride in BOTTLENECK_BLOCKS:
        block = Bottleneck(cin, mid, cout, stride, device=dev,
                           generator=torch.Generator(device=dev)
                           .manual_seed(46))
        cpu_block = Bottleneck(cin, mid, cout, stride, device="cpu")
        cpu_block.load_state_dict(block.state_dict())
        params = list(block.parameters())

        def step(block=block, params=params):
            xs = x.detach().requires_grad_()
            y = block(xs)
            return torch.autograd.grad(y.sum(), [xs] + params)
        ho = hw // stride
        y = block(x)
        if y.shape != (n, ho, ho, cout) or y.dtype != torch.float32:
            raise AssertionError(f"Bottleneck: {tuple(y.shape)} {y.dtype}")
        block.load_state_dict(cpu_block.state_dict())
        small = x[:4]
        outs = {}
        for side, mod, d in (("card", block, dev),
                             ("cpu", cpu_block, torch.device("cpu"))):
            ys = mod(small.to(d))
            # the gradients in fp64 (see CONTRIB_TOL), on copies
            mod64 = copy.deepcopy(mod).double()
            xs = small.to(d).double().requires_grad_()
            gs = torch.autograd.grad(mod64(xs).sum(), [xs]
                                     + list(mod64.parameters()))
            outs[side] = ([ys, mod.bn3.mean, mod.bn3.var], gs)
        gaps = [_gap("Bottleneck out", a, c, CONTRIB_TOL[torch.float32])
                for a, c in zip(outs["card"][0], outs["cpu"][0])]
        gaps += [_gap("Bottleneck fp64 grads", a, c,
                      CONTRIB_TOL[torch.float64])
                 for a, c in zip(outs["card"][1], outs["cpu"][1])]
        _leg(rows, f"(e) Bottleneck {cin}->{mid}->{cout} stride {stride} "
             f"{list(BOTTLENECK_INPUT)} bf16 -> fp32: train fwd+bwd", step,
             flops=_bottleneck_flops(n, hw, cin, mid, cout, stride),
             gap=max(gaps), out_shape=list(y.shape), out_dtype="float32")


#: an OpenFold-style gather-multiply (chosen here, not a published
#: configuration): 65,536 source rows of 128 channels gathered by 524,288
#: seeded indices (8 a row on average)
IMUL_ROWS, IMUL_N, IMUL_C = 65536, 524288, 128


def index_mul_leg(dev, rows):
    """(f) ``index_mul_2d`` in fp32, fp16 and bf16: the forward, the
    backward and the double backward."""
    from apex_tpu_torch.contrib.index_mul_2d import index_mul_2d

    g = torch.Generator(device=dev).manual_seed(47)
    idx = torch.randint(0, IMUL_ROWS, (IMUL_N,), generator=g, device=dev)
    for dt in (torch.float32, torch.float16, torch.bfloat16):
        a = torch.randn(IMUL_ROWS, IMUL_C, generator=g, device=dev).to(dt)
        b = torch.randn(IMUL_N, IMUL_C, generator=g, device=dev).to(dt)
        wt = torch.randn(IMUL_N, IMUL_C, generator=g, device=dev).to(dt)

        def grads(a, b, idx, wt, double=False):
            a = a.detach().requires_grad_()
            b = b.detach().requires_grad_()
            loss = (index_mul_2d(a, b, idx).float() ** 2
                    * wt.float()).sum()
            ga, gb = torch.autograd.grad(loss, (a, b), create_graph=double)
            if not double:
                return ga, gb
            return torch.autograd.grad(ga.float().square().sum(), b)
        n_bytes = IMUL_N * IMUL_C * a.element_size()
        fwd = index_mul_2d(a, b, idx)
        sl = slice(0, 65536)
        cpu_fwd = index_mul_2d(a.cpu(), b[sl].cpu(), idx[sl].cpu())
        if not torch.equal(index_mul_2d(a, b[sl], idx[sl]).cpu(), cpu_fwd):
            raise AssertionError(f"index_mul_2d {dt}: forward not bitwise")
        card_g = grads(a, b[sl], idx[sl], wt[sl])
        cpu_g = grads(a.cpu(), b[sl].cpu(), idx[sl].cpu(), wt[sl].cpu())
        tol = CONTRIB_TOL[dt]
        # grad_in1 sums the rows of repeated indices in the gradient's own
        # dtype, in the card's atomic order or the CPU's sequential one:
        # up to one rounding a term of the longest sum (the fp16 one read
        # 5.4e-4 of its largest entry, 1.1 roundings; H100 80GB HBM3, 700 W)
        k = int(torch.bincount(idx[sl]).max())
        tol_in1 = tol if dt == torch.float32 else k * (tol - 1e-5) + 1e-5
        gap = max(_gap("index_mul grad_in1", card_g[0], cpu_g[0], tol_in1),
                  _gap("index_mul grad_in2", card_g[1], cpu_g[1], tol))
        if dt == torch.float32:
            gap = max(gap, _gap("index_mul double backward", grads(
                a, b[sl], idx[sl], wt[sl], True)[0], grads(
                a.cpu(), b[sl].cpu(), idx[sl].cpu(), wt[sl].cpu(),
                True)[0], tol))
        name = str(dt)[6:]
        _leg(rows, f"(f) index_mul_2d [{IMUL_ROWS}, {IMUL_C}][{IMUL_N}] "
             f"{name}: fwd", lambda: index_mul_2d(a, b, idx), iters=10,
             nbytes=3 * n_bytes + IMUL_N * 8, gap=0.0)
        _leg(rows, f"(f) index_mul_2d {name}: fwd+bwd",
             lambda: grads(a, b, idx, wt), nbytes=7 * n_bytes + IMUL_N * 8,
             gap=gap)
        _leg(rows, f"(f) index_mul_2d {name}: double backward",
             lambda: grads(a, b, idx, wt, True))
        del fwd


#: elements of each leaf the CPU reference holds the card's masks against
#: (a leading slice along the first dim); the swap search's weight
CONTRIB_SLICE = 1 << 16
SWAP_N = 1024


def _lead(t, n=CONTRIB_SLICE):
    """A leading slice along dim 0 holding at least ``n`` elements (the
    2:4 masks of a slice are those of the whole: groups lie along other
    dims or within the first ``n`` elements of a 1-D leaf)."""
    if t.dim() == 1:
        return t[:n]
    per = max(1, t[0].numel())
    return t[:max(1, -(-n // per))]


def sparsity_leg(dev, rows):
    """(g) ``ASP`` over the GPT-2 345M's parameter tree (masks card
    against CPU bit for bit on each leaf's leading slice), three
    ``wrap_step``-ped pytree ``FusedAdam`` steps (masked entries stay
    exactly 0), and ``channel_swap_search`` on a seeded ``[1024, 1024]``
    weight for 20 iterations."""
    from apex_tpu_torch.contrib.sparsity import (
        ASP,
        channel_swap_search,
        sum_after_2_to_4,
    )

    shapes = gpt345m_param_shapes(torch.float32)
    g = torch.Generator(device=dev).manual_seed(48)
    params = tree_map(lambda m: torch.randn(m.shape, generator=g,
                                            device=dev) * 0.02, shapes)
    asp = ASP()
    box = {}

    def masks_fn():
        box["m"] = asp.compute_sparse_masks(params)
    n_el = sum(t.numel() for t in tree_leaves(params))
    _leg(rows, "(g) ASP.compute_sparse_masks over the 345M tree (fp32)",
         masks_fn, nbytes=n_el * 8, iters=2)
    masks = box["m"]
    for p, m in zip(tree_leaves(params), tree_leaves(masks)):
        head = _lead(p)
        want = asp.compute_sparse_masks({"x": head.cpu()})["x"]
        if not torch.equal(_lead(m).cpu(), want):
            raise AssertionError(f"ASP mask of a {tuple(p.shape)} leaf: "
                                 "card and CPU differ")
    params = asp.apply_masks(params, masks)
    opt = FusedAdam(lr=1e-3, weight_decay=0.01)
    step = asp.wrap_step(opt.step, masks)
    state = opt.init(params)
    grads = tree_map(lambda t: torch.randn(t.shape, generator=g, device=dev)
                     * 1e-3, params)
    for _ in range(3):
        params, state = step(grads, state, params)
    for p, m in zip(tree_leaves(params), tree_leaves(masks)):
        if p[m == 0].any():
            raise AssertionError("ASP: a masked entry moved off 0")
    _leg(rows, "(g) wrap_step(FusedAdam pytree) over the 345M tree",
         lambda: step(grads, state, params), nbytes=n_el * 4 * 8, iters=2)
    del params, state, grads, masks, box
    torch.cuda.empty_cache()

    m = torch.randn(SWAP_N, SWAP_N, generator=g, device=dev)
    out = {}

    def search():
        out["r"] = channel_swap_search(m, max_iters=20)
    _leg(rows, f"(g) channel_swap_search [{SWAP_N}, {SWAP_N}], 20 "
         "iterations", search, iters=1, warmup=0)
    perm, kept = out["r"]
    if sorted(perm.tolist()) != list(range(SWAP_N)):
        raise AssertionError("channel_swap_search: not a permutation")
    base = float(sum_after_2_to_4(m))
    cpu_kept = float(sum_after_2_to_4(m.cpu()[:, torch.as_tensor(perm)]))
    if not kept >= base or abs(cpu_kept - kept) > 1e-6 * kept:
        raise AssertionError(f"channel_swap_search: kept {kept} against "
                             f"unpermuted {base}, CPU {cpu_kept}")
    small = m[:128, :min(256, SWAP_N)]
    pc, kc = channel_swap_search(small.cpu(), max_iters=20)
    pg, kg = channel_swap_search(small, max_iters=20)
    if not (pc == pg).all() or abs(kc - kg) > 1e-6 * kc:
        raise AssertionError("channel_swap_search [128, 256]: card and CPU "
                             "chose other swaps")
    log(f"  (g) channel_swap_search: kept {kept:.2f} against {base:.2f} "
        f"unpermuted (+{100 * (kept / base - 1):.3f} %), CPU {cpu_kept:.2f};"
        f" [128, 256] card = CPU")


#: the MLPerf Training RNN-T reference (``rnn_speech_recognition``:
#: joint hidden 512, 1023 sentencepieces + blank), batch 8; utterances up
#: to 200 encoder frames, transcripts up to 79 tokens (U = 80)
RNNT_B, RNNT_H, RNNT_V, RNNT_T, RNNT_U = 8, 512, 1024, 200, 80


def transducer_leg(dev, rows):
    """(h) the RNN-T joint (packed and dense, ReLU, dropout 0.1, then the
    joint's output layer to the vocabulary) and the loss on fp16 logits,
    dense and ``packed_input``: forward and backward; card against CPU at
    batch 2 in fp32, the losses and the logits' gradient."""
    from apex_tpu_torch.contrib.transducer import (
        TransducerLoss,
        transducer_joint,
        transducer_loss,
    )

    g = torch.Generator(device=dev).manual_seed(49)
    f = torch.randn(RNNT_B, RNNT_T, RNNT_H, generator=g, device=dev).half()
    gg = torch.randn(RNNT_B, RNNT_U, RNNT_H, generator=g, device=dev).half()
    w = (torch.randn(RNNT_V, RNNT_H, generator=g, device=dev)
         * RNNT_H ** -0.5).half()
    bias = torch.zeros(RNNT_V, device=dev, dtype=torch.float16)
    f_len = torch.randint(RNNT_T // 2, RNNT_T + 1, (RNNT_B,), generator=g,
                          device=dev)
    y_len = torch.randint(RNNT_U // 4, RNNT_U, (RNNT_B,), generator=g,
                          device=dev)
    f_len[0], y_len[0] = RNNT_T, RNNT_U - 1
    label = torch.randint(0, RNNT_V - 1, (RNNT_B, RNNT_U - 1), generator=g,
                          device=dev)
    g_len = y_len + 1
    off = torch.cumsum(f_len * g_len, 0)
    packed_rows = int(off[-1])
    drop = torch.Generator(device=dev).manual_seed(50)
    loss_mod = TransducerLoss(packed_input=True)

    def dense_step():
        fs, gs, ws = (t.detach().requires_grad_() for t in (f, gg, w))
        h = transducer_joint(fs, gs, f_len, g_len, relu=True,
                             dropout_prob=0.1, dropout_key=drop)
        x = F.linear(h, ws, bias)
        loss = transducer_loss(x, label, f_len, y_len, RNNT_V - 1).sum()
        return (loss,) + torch.autograd.grad(loss, (fs, gs, ws))

    def packed_step():
        fs, gs, ws = (t.detach().requires_grad_() for t in (f, gg, w))
        h = transducer_joint(fs, gs, f_len, g_len, pack_output=True,
                             relu=True, dropout_prob=0.1, dropout_key=drop,
                             batch_offset=off, packed_batch=packed_rows)
        x = F.linear(h, ws, bias)
        loss = loss_mod(x, label, f_len, y_len, RNNT_V - 1,
                        batch_offset=off, max_f_len=RNNT_T).sum()
        return (loss,) + torch.autograd.grad(loss, (fs, gs, ws))
    ld, lp = dense_step()[0], packed_step()[0]
    if not (torch.isfinite(ld) and torch.isfinite(lp)):
        raise AssertionError("transducer loss not finite")
    # card against CPU at batch 2, fp32: the loss on seeded logits, dense
    # and packed, and the packed joint
    cg = torch.Generator().manual_seed(51)
    x2 = torch.randn(2, RNNT_T, RNNT_U, RNNT_V, generator=cg) * 2
    fl2, yl2, lab2 = f_len[:2].cpu(), y_len[:2].cpu(), label[:2].cpu()
    gap = _hold_pair("transducer loss", _both_devices(
        dev, lambda x, l, fl, yl: transducer_loss(x, l, fl, yl,
                                                  RNNT_V - 1),
        [x2, lab2, fl2, yl2], grad=(0,)), CONTRIB_TOL)
    off2 = torch.cumsum(fl2 * (yl2 + 1), 0)
    rows2 = [x2[i, :int(fl2[i]), :int(yl2[i]) + 1].reshape(-1, RNNT_V)
             for i in range(2)]
    gap = max(gap, _hold_pair("transducer packed loss", _both_devices(
        dev, lambda x, l, fl, yl, o: loss_mod(
            x, l, fl, yl, RNNT_V - 1, batch_offset=o, max_f_len=RNNT_T),
        [torch.cat(rows2), lab2, fl2, yl2, off2], grad=(0,)),
        CONTRIB_TOL))
    joint = _both_devices(dev, lambda f, g, fl, gl, o: transducer_joint(
        f, g, fl, gl, pack_output=True, relu=True, batch_offset=o,
        packed_batch=int(off2[-1])), [f[:2].float().cpu(),
                                       gg[:2].float().cpu(), fl2,
                                       yl2 + 1, off2])
    if not torch.equal(joint["card"][0][0].cpu(), joint["cpu"][0][0]):
        raise AssertionError("transducer joint: card and CPU differ")
    n_logits = RNNT_B * RNNT_T * RNNT_U * RNNT_V
    _leg(rows, f"(h) RNN-T dense: joint [{RNNT_B}, {RNNT_T}, {RNNT_U}, "
         f"{RNNT_H}] + output layer + loss, fp16, fwd+bwd", dense_step, gap=gap,
         loss=round(float(ld.detach()), 3), logits=n_logits)
    _leg(rows, f"(h) RNN-T packed ({packed_rows} rows): joint + output "
         "layer + packed_input loss, fp16, fwd+bwd", packed_step, gap=gap,
         loss=round(float(lp.detach()), 3))


def legacy_optimizer_leg(dev, rows):
    """(i) the legacy contrib ``FusedAdam`` (loss scale 1024, ``grad_norms``
    of the scaled gradients clipped to ``max_grad_norm`` 1.0, both
    ``eps_inside_sqrt`` modes, bf16 ``output_params``) and ``FusedSGD``
    (momentum 0.9) over the 345M tree, 3 steps each on the card; the CPU
    runs the same steps on each leaf's first ``SWA_SLICE`` elements (the
    update is elementwise, and the clip's norm is the whole tree's, the
    same number on both) within ``SWA_TOL``."""
    from apex_tpu_torch.contrib.optimizers import FusedAdam as LegacyAdam
    from apex_tpu_torch.contrib.optimizers import FusedSGD as LegacySGD

    shapes = gpt345m_param_shapes(torch.float32)
    g = torch.Generator(device=dev).manual_seed(52)

    def draw(scale):
        return tree_map(lambda m: torch.randn(
            m.shape, generator=g, device=dev) * scale, shapes)

    def head(tree):
        return tree_map(lambda t: t.reshape(-1)[:SWA_SLICE].cpu(), tree)

    masters = draw(0.02)
    grads = [draw(1024.0 * 1e-4) for _ in range(3)]
    norms = [float(torch.sqrt(sum((t.double() ** 2).sum()
                                  for t in tree_leaves(gr))))
             for gr in grads]
    makers = {
        "FusedAdam eps outside sqrt": lambda: LegacyAdam(
            lr=1e-3, max_grad_norm=1.0, weight_decay=0.01),
        "FusedAdam eps_inside_sqrt": lambda: LegacyAdam(
            lr=1e-3, max_grad_norm=1.0, weight_decay=0.01,
            eps_inside_sqrt=True),
        "FusedSGD momentum 0.9": lambda: LegacySGD(lr=0.01, momentum=0.9),
    }
    n_el = sum(t.numel() for t in tree_leaves(masters))
    for name, make in makers.items():
        opt = make()
        banks = {}
        for side in ("card", "cpu"):
            p = masters if side == "card" else head(masters)
            st = opt.init(p)
            for i in range(3):
                gi = grads[i] if side == "card" else head(grads[i])
                p, st, out = opt.step(gi, st, p, scale=1024.0,
                                      grad_norms=norms[i],
                                      output_params_dtype=torch.bfloat16)
            moments = (st.momentum_buffer,) if "SGD" in name else (
                st.exp_avg, st.exp_avg_sq)
            banks[side] = (p, out) + moments
            if side == "card":
                def one(opt=opt, st=st, p=p):
                    return opt.step(grads[0], st, p, scale=1024.0,
                                    grad_norms=norms[0],
                                    output_params_dtype=torch.bfloat16)
                _leg(rows, f"(i) legacy {name} over the 345M tree: a step",
                     one, nbytes=n_el * (4 * (5 if "SGD" in name else 7)
                                         + 2), iters=2)
                banks[side] = tuple(head(b) for b in banks[side])
        updates = [float((p - p0).abs().max()) for p, p0 in zip(
            tree_leaves(banks["cpu"][0]), tree_leaves(head(masters)))]
        margins = []
        for kind, a, b in zip(("params", "output", "m", "v"), banks["card"],
                              banks["cpu"]):
            for x_, y_, upd in zip(tree_leaves(a), tree_leaves(b), updates):
                atol = (SWA_TOL["rel"] * float(y_.abs().max())
                        if kind in ("m", "v") else SWA_TOL["update"] * upd)
                rtol = SWA_TOL["bf16"] if y_.dtype == torch.bfloat16 \
                    else SWA_TOL["rel"]
                margins.append(check_close(f"legacy {name} {kind}", x_, y_,
                                           y_.dtype, tol=(atol, rtol),
                                           margin=True)[1])
        log(f"  (i) legacy {name}, 3 steps: card against CPU at most "
            f"{max(margins):.3f} of the limits")
        rows[-1]["limit_share"] = round(max(margins), 4)


#: NVIDIA's sentiment-discovery mLSTM (``sentiment-discovery``
#: ``--model mLSTM --rnn_size 4096 --emsize 64``; sequences of 256 bytes,
#: batch 32); the stacked RNNs: 2 layers, bidirectional, hidden 1024,
#: input 1024, seq 64, batch 32
MLSTM = dict(input=64, hidden=4096, seq=256, batch=32)
STACKED = dict(input=1024, hidden=1024, seq=64, batch=32, layers=2)


def _rnn_flops(gates, inp, hid, seq, batch, layers=1, dirs=1, mult=False):
    f = 0.0
    for layer in range(layers):
        i = inp if layer == 0 else hid * dirs
        per = gates * hid * (i + hid) + (hid * (i + hid) if mult else 0)
        f += 2.0 * batch * seq * per * dirs
    return 3 * f


def rnn_leg(dev, rows):
    """(j) the RNN models in fp32: the mLSTM of sentiment-discovery, then
    LSTM, GRU, ReLU and Tanh stacked 2 deep and bidirectional; forward
    and backward; card against CPU at batch 2 over 16 steps."""
    from apex_tpu_torch import RNN

    g = torch.Generator(device=dev).manual_seed(53)
    cases = [("mLSTM", RNN.mLSTM(MLSTM["input"], MLSTM["hidden"], 1),
              MLSTM, dict(gates=4, mult=True))]
    for name, gates in (("LSTM", 4), ("GRU", 3), ("ReLU", 1), ("Tanh", 1)):
        cases.append((name, getattr(RNN, name)(
            STACKED["input"], STACKED["hidden"], STACKED["layers"],
            bidirectional=True), STACKED, dict(gates=gates)))
    for name, model, shp, fl in cases:
        params = model.init(g, device=dev)
        leaves, treedef = tree_flatten(params)
        x = torch.randn(shp["seq"], shp["batch"], shp["input"], generator=g,
                        device=dev)

        def step(model=model, leaves=leaves, treedef=treedef, x=x):
            live = [t.detach().requires_grad_() for t in leaves]
            y, _ = model(tree_unflatten(treedef, live), x)
            return torch.autograd.grad(y.square().mean(), live)
        small = x[:16, :2]
        outs = {}
        for side, d in (("card", dev), ("cpu", torch.device("cpu"))):
            y, fin = model(tree_unflatten(
                treedef, [t.to(d) for t in leaves]), small.to(d))
            # the gradients in fp64 (see CONTRIB_TOL)
            live = [t.to(d, torch.float64).requires_grad_()
                    for t in leaves]
            y64, _ = model(tree_unflatten(treedef, live),
                           small.to(d, torch.float64))
            outs[side] = ([y] + tree_leaves(fin), torch.autograd.grad(
                y64.square().mean(), live))
        gap = max([_gap(f"{name} out", a, c, CONTRIB_TOL[torch.float32])
                   for a, c in zip(outs["card"][0], outs["cpu"][0])]
                  + [_gap(f"{name} fp64 grad", a, c,
                          CONTRIB_TOL[torch.float64])
                     for a, c in zip(outs["card"][1], outs["cpu"][1])])
        dirs = 1 if name == "mLSTM" else 2
        _leg(rows, f"(j) {name} hidden {shp['hidden']} seq {shp['seq']} "
             f"batch {shp['batch']}" + ("" if dirs == 1 else
                                        ", 2 layers bidirectional")
             + " fp32: fwd+bwd", step, iters=2,
             flops=_rnn_flops(fl["gates"], shp["input"], shp["hidden"],
                              shp["seq"], shp["batch"],
                              shp.get("layers", 1), dirs,
                              fl.get("mult", False)), gap=gap)


def contrib_phase(dev):
    """Phase 11: the single-device contribs of A5.5 and ``RNN/`` at full
    width, legs (a)-(j); each times its forward and backward (CUDA-event
    ms, peak memory, a byte or operation bound where the work is clean)
    and holds the card against the CPU. No kernel of the port lies on
    these paths: every launch count reads zero after the phase. Prints a
    ``{"phase11": [...]}`` line of the legs."""
    rows = []
    parts = {}
    _device.reset_launch_counts()
    with tf32_off():  # fp32 legs in fp32, run alone or from main()
        for key, fn in (("a", focal_leg), ("b", group_norm_leg),
                        ("c", groupbn_leg), ("d", conv_bias_relu_leg),
                        ("e", bottleneck_leg), ("f", index_mul_leg),
                        ("g", sparsity_leg), ("h", transducer_leg),
                        ("i", legacy_optimizer_leg), ("j", rnn_leg)):
            t0 = time.perf_counter()
            fn(dev, rows)
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            parts[key] = round(time.perf_counter() - t0, 1)
    launched = {k: v for k, v in _device.launch_counts().items() if v}
    if launched:
        raise AssertionError(f"phase 11 launched kernels of the port: "
                             f"{launched}")
    log(f"  phase 11 parts (s): {parts}; launches: none")
    print(json.dumps({"phase11": rows}), flush=True)


# ---------------------------------------------------------------------------
# phase 12: the rest of the single-device library (A5.6) and
# parallel_state over torch.distributed (A6.1) at the 345M's full width
# ---------------------------------------------------------------------------

#: the applier's chunks: the reference's default and a small one
APPLIER_CHUNKS = (2048 * 32, 4096)
#: the 345M legs of phase 12: layers, sequence, batch, vocabulary
P12_LAYERS, P12_SEQ, P12_BATCH, P12_VOCAB = 24, 1024, 8, 50304


def fp8_allreduces() -> int:
    """All-reduces of one fp8 step with the amax group: one per fp8
    projection's forward (its x and w amaxes together: 4 a layer) and
    one per projection's stacked gradient amaxes (4)."""
    return P12_LAYERS * 4 + 4


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.detach().contiguous().reshape(-1).view(torch.uint8)


def _same_bits(label: str, got, want) -> None:
    """Every leaf of ``got`` equals ``want``'s leaf bit for bit (dtype
    and shape too)."""
    gl, wl = tree_leaves(got), tree_leaves(want)
    bad = [i for i, (a, b) in enumerate(zip(gl, wl))
           if a.dtype != b.dtype or a.shape != b.shape
           or not torch.equal(_bits(a), _bits(b))]
    if len(gl) != len(wl) or bad:
        raise AssertionError(f"{label}: not bit for bit (leaves {bad} of "
                             f"{len(gl)} against {len(wl)})")


def _packed_tree(state):
    """A packed optimizer state's tensors as a tree."""
    return [state.step, state.exp_avg, state.exp_avg_sq,
            state.master_params]


def applier_leg(dev, rows, launches):
    """(a) ``multi_tensor_applier`` over ``packed_adam_apply`` and the
    four flat ops on the 345M's flat buffer at chunks 65536 and 4096,
    each result bit for bit against the direct call; the applier's
    launches counted (the direct calls are the comparison); the six
    optimizers are ``FusedOptimizer``s."""
    spec = PackSpec(gpt345m_param_shapes())
    n = spec.total
    g = torch.Generator(device=dev).manual_seed(31)
    grad = (torch.randn(n, generator=g, device=dev) * 1e-3).to(
        torch.bfloat16)
    m0 = torch.randn(n, generator=g, device=dev) * 1e-3
    v0 = torch.rand(n, generator=g, device=dev) * 1e-6
    src0 = torch.randn(n, generator=g, device=dev) * 0.02
    x = torch.randn(n, generator=g, device=dev) * 1e3
    y = torch.randn(n, generator=g, device=dev)
    x[5 * 1024 + 3] = float("inf")  # a non-finite element in row 5
    inv = torch.tensor(1.0 / 1024, device=dev)
    hyper = dict(param_dtype=torch.bfloat16,
                 lr=torch.tensor(1e-4, device=dev),
                 bc1=torch.tensor(0.1, device=dev),
                 bc2=torch.tensor(0.001, device=dev), inv_scale=inv)

    def adam(apply):
        return apply(packed_adam_apply, grad, m0.clone(), v0.clone(),
                     src0.clone(), **hyper)
    cases = (
        ("packed_adam_apply", adam),
        ("packed_row_stats", lambda a: a(packed_row_stats, x,
                                         inv_scale=inv)),
        ("multi_tensor_l2norm_flat", lambda a: a(multi_tensor_l2norm_flat,
                                                 y)),
        ("multi_tensor_scale_flat", lambda a: a(
            multi_tensor_scale_flat, x.to(torch.bfloat16), inv,
            torch.float32, per_row_flags=True)),
        ("multi_tensor_axpby_flat", lambda a: a(multi_tensor_axpby_flat,
                                                0.5, 2.0, x, y)))
    for chunk in APPLIER_CHUNKS:
        applier = MultiTensorApply(chunk)
        for name, case in cases:
            want = case(lambda op, *a, **k: op(*a, **k))
            torch.cuda.synchronize()
            _device.reset_launch_counts()
            got = case(applier)
            torch.cuda.synchronize()
            for k, c in _device.launch_counts().items():
                launches[k] = launches.get(k, 0) + c
            _same_bits(f"applier {name} chunk {chunk}", got, want)
            del want, got
    six = (FusedAdam(), FusedLAMB(), FusedMixedPrecisionLamb(),
           FusedSGD(lr=0.01), FusedNovoGrad(), FusedAdagrad())
    if not all(isinstance(o, FusedOptimizer) for o in six):
        raise AssertionError("an optimizer is not a FusedOptimizer")
    counted = {k: v for k, v in launches.items() if v}
    log(f"  (a) applier over packed_adam_apply and the four flat ops on "
        f"{n} elements at chunks {APPLIER_CHUNKS}: bit for bit against "
        f"the direct calls; applier launches {counted}; the six "
        f"optimizers are FusedOptimizers")
    rows.append({"leg": "a applier", "elements": n, "chunks":
                 list(APPLIER_CHUNKS), "launches": counted})


def _345m_fp32_tree(dev, seed=32):
    """The 345M's parameter tree in fp32 on the card, random values."""
    g = torch.Generator(device=dev).manual_seed(seed)
    return tree_map(lambda m: torch.randn(m.shape, generator=g, device=dev),
                    gpt345m_param_shapes(torch.float32))


def _gbps(nbytes: int, seconds: float) -> float:
    return nbytes / seconds / 1e9


def hostio_leg(dev, rows, tmp, card):
    """(b) ``write_arrays`` / ``read_arrays`` of the 345M's fp32 tree from
    card tensors (pinned staging) and back into card tensors, bit for
    bit; ``flatten`` / ``unflatten`` round trip bit for bit."""
    if not hostio.native_available():
        raise AssertionError("the native host IO engine did not build")
    leaves = tree_leaves(_345m_fp32_tree(dev))
    nbytes = sum(t.numel() * t.element_size() for t in leaves)
    path = f"{tmp}/master.bin"
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    offs = hostio.write_arrays(path, leaves)
    t_write = time.perf_counter() - t0
    out = [torch.empty_like(t) for t in leaves]
    t0 = time.perf_counter()
    hostio.read_arrays(path, None, offs, out=out)
    torch.cuda.synchronize()
    t_read = time.perf_counter() - t0
    _same_bits("hostio read back", out, leaves)
    del out
    t0 = time.perf_counter()
    arena, aoffs = hostio.flatten(leaves)
    t_flat = time.perf_counter() - t0
    t0 = time.perf_counter()
    back = hostio.unflatten(arena, leaves, aoffs)
    t_unflat = time.perf_counter() - t0
    _same_bits("hostio flatten/unflatten", back,
               [t.cpu() for t in leaves])
    del arena, back
    os.remove(path)
    r = {"leg": "b hostio", "bytes": nbytes,
         "write_gbps": _gbps(nbytes, t_write),
         "read_gbps": _gbps(nbytes, t_read),
         "flatten_gbps": _gbps(nbytes, t_flat),
         "unflatten_gbps": _gbps(nbytes, t_unflat), "card": card}
    log(f"  (b) hostio, the 345M fp32 tree ({nbytes / 1e9:.3f} GB) from "
        f"card tensors: write {r['write_gbps']:.3f} GB/s, read (warm page "
        f"cache) into card tensors {r['read_gbps']:.3f} GB/s, flatten "
        f"{r['flatten_gbps']:.3f} GB/s, unflatten {r['unflatten_gbps']:.3f}"
        f" GB/s; bit for bit; {card}")
    rows.append(r)


def gds_leg(dev, rows, tmp):
    """(c) ``GDSFile``: a bf16 and an fp32 card tensor saved; the file is
    their bytes back to back; ``load_data`` into preallocated card
    tensors gives them back bit for bit, in place."""
    g = torch.Generator(device=dev).manual_seed(33)
    ts = [torch.randn(4096, 1024, generator=g, device=dev).to(
        torch.bfloat16), torch.randn(1024, 1000, generator=g, device=dev)]
    path = f"{tmp}/gds.bin"
    with GDSFile(path, "w") as f:
        for t in ts:
            f.save_data(t)
    raw = torch.frombuffer(bytearray(open(path, "rb").read()),
                           dtype=torch.uint8)
    if not torch.equal(raw, torch.cat([_bits(t).cpu() for t in ts])):
        raise AssertionError("GDSFile bytes are not the tensors' bytes")
    outs = [torch.zeros_like(t) for t in ts]
    with GDSFile(path, "r") as f:
        back = [f.load_data(o) for o in outs]
    if not all(b is o for b, o in zip(back, outs)):
        raise AssertionError("GDSFile.load_data did not fill in place")
    _same_bits("GDSFile load_data", outs, ts)
    os.remove(path)
    log(f"  (c) GDSFile: bf16 [4096, 1024] and fp32 [1024, 1000] card "
        f"tensors, file bytes equal, load_data in place bit for bit")
    rows.append({"leg": "c GDSFile", "bytes": int(raw.numel())})


def _unfused_345m(dev, cpu_offload=False, **cfg_kw):
    """The 345M unfused leg's model through ``gpt_model_provider``: 24 x
    1024, seq 1024, batch 8, bf16 compute over bf16 params with fp32
    masters, packed FusedAdam, saved CE logits, no recompute, random
    weights (seed 0) and tokens (seed 1). Returns ``(cfg, params, opt,
    loss_fn)``, the loss bound to the batch."""
    cfg = GPTConfig(num_layers=P12_LAYERS, hidden_size=HIDDEN,
                    num_attention_heads=N_HEADS, vocab_size=P12_VOCAB,
                    max_position_embeddings=P12_SEQ, hidden_dropout=0.0,
                    attention_dropout=0.0, compute_dtype=torch.bfloat16,
                    ce_save_logits=True, **cfg_kw)
    params, _, loss = gpt_model_provider(
        cfg, torch.Generator(device=dev).manual_seed(0),
        cpu_offload=cpu_offload, device=dev)
    params = tree_map(lambda p: p.to(torch.bfloat16), params)
    tokens = torch.randint(0, cfg.vocab_size, (P12_BATCH, P12_SEQ),
                           device=dev, generator=torch.Generator(
                               device=dev).manual_seed(1))
    labels = torch.roll(tokens, -1, dims=1)
    opt = FusedAdam(lr=1e-4, master_weights=True, packed=True)
    loss_fn = functools.partial(loss, tokens=tokens, labels=labels)
    return cfg, params, opt, loss_fn


def checkpoint_leg(dev, rows, tmp):
    """(d) ``checkpoint``: the 345M unfused leg's train state after 2
    steps saved from the card and loaded onto it through ``target``,
    every leaf bit for bit; one more step from each bit for bit; a
    truncated ``arrays.bin`` raises ``CheckpointCorruptError``; a dead
    writer's ``.tmp-<pid>`` is swept."""
    _, params, opt, loss_fn = _unfused_345m(dev)
    step = train_step_fn(loss_fn, opt)
    state = opt.init(params)
    for _ in range(2):
        params, state, _ = step(params, state)
    train = {"params": params, "opt": state, "step": 2}
    nbytes = sum(t.numel() * t.element_size() for t in
                 tree_leaves(params) + tree_leaves(_packed_tree(state)))
    path = f"{tmp}/ck"
    dead = subprocess.Popen([sys.executable, "-c", "pass"])
    dead.wait()
    stale = f"{path}.tmp-{dead.pid}"
    os.makedirs(stale)
    free_gb = shutil.disk_usage(tmp).free / 1e9
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    save_checkpoint(path, train)
    t_save = time.perf_counter() - t0
    if os.path.exists(stale):
        raise AssertionError("a dead writer's staging tree was not swept")
    t0 = time.perf_counter()
    back = load_checkpoint(path, target=train)
    torch.cuda.synchronize()
    t_load = time.perf_counter() - t0
    if back["step"] != 2 or back["opt"].spec is not state.spec:
        raise AssertionError("checkpoint scalars or spec not restored")
    _same_bits("checkpoint params", back["params"], params)
    _same_bits("checkpoint optimizer state", _packed_tree(back["opt"]),
               _packed_tree(state))
    p_live, s_live, l_live = step(params, state)
    p_back, s_back, l_back = step(back["params"], back["opt"])
    _same_bits("the step after the restore", [l_back, *tree_leaves(
        p_back), *_packed_tree(s_back)], [l_live, *tree_leaves(p_live),
                                          *_packed_tree(s_live)])
    del back, p_back, s_back, p_live, s_live, params, state, train
    data = f"{path}/arrays.bin"
    with open(data, "r+b") as f:
        f.truncate(os.path.getsize(data) // 2)
    try:
        load_checkpoint(path)
    except CheckpointCorruptError as e:
        if e.__cause__ is None:
            raise AssertionError("CheckpointCorruptError without a cause")
    else:
        raise AssertionError("a truncated checkpoint loaded")
    shutil.rmtree(path)
    r = {"leg": "d checkpoint", "bytes": nbytes, "save_s": t_save,
         "load_s": t_load, "save_gbps": _gbps(nbytes, t_save),
         "load_gbps": _gbps(nbytes, t_load), "tmp_free_gb": free_gb}
    log(f"  (d) checkpoint of the 345M train state after 2 steps "
        f"({nbytes / 1e9:.3f} GB: bf16 params, packed FusedAdam m, v, "
        f"masters, step): save {t_save:.3f} s ({r['save_gbps']:.3f} GB/s), "
        f"load onto the card {t_load:.3f} s ({r['load_gbps']:.3f} GB/s, "
        f"warm page cache); every leaf and the next step bit for bit; "
        f"truncation raised CheckpointCorruptError; the dead writer's "
        f"tmp swept; {free_gb:.1f} GB free in the temp directory")
    rows.append(r)


def offload_leg(dev, rows, launches, tmp):
    """(e) ``gpt_model_provider`` with ``cpu_offload`` False and True: the
    345M unfused step without recompute, 1 + 3 steps each from the same
    seeds, losses bit for bit; each side's p50, peak and idle share (one
    profiled step); the offload's peak lower. Then the port's
    ``gpt_scaling_test`` at the 345M's shape, both offloads."""
    sides = {}
    for off in (False, True):
        _, params, opt, loss_fn = _unfused_345m(dev, cpu_offload=off)
        step = train_step_fn(loss_fn, opt)
        state = opt.init(params)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        losses, times = [], []
        _device.reset_launch_counts()
        for i in range(4):
            t0 = time.perf_counter()
            params, state, loss = step(params, state)
            torch.cuda.synchronize()
            if i:
                times.append((time.perf_counter() - t0) * 1e3)
            losses.append(loss)
        for k, c in _device.launch_counts().items():
            launches[k] = launches.get(k, 0) + c
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        box = {}

        def run():
            box["out"] = step(params, state)
        prof = profiled(run, f"345M unfused step, cpu_offload={off}", 6)
        sides[off] = {"losses": losses, "p50": float(np.percentile(times,
                                                                   50)),
                      "peak_gib": peak, "idle": 1 - prof["busy_ms"]
                      / prof["wall_ms"]}
        del params, state, box, step, opt, loss_fn
        torch.cuda.empty_cache()
    _same_bits("cpu_offload losses", sides[True]["losses"],
               sides[False]["losses"])
    if not sides[True]["peak_gib"] < sides[False]["peak_gib"]:
        raise AssertionError(f"cpu_offload did not lower the peak: "
                             f"{sides[True]['peak_gib']:.2f} against "
                             f"{sides[False]['peak_gib']:.2f} GiB")
    for off, s in sides.items():
        log(f"  (e) cpu_offload={off}: step p50 {s['p50']:.2f} ms, peak "
            f"{s['peak_gib']:.2f} GiB, idle share {s['idle']:.3f} "
            f"(profiled step), losses "
            f"{[round(float(x), 6) for x in s['losses']]}")
    log("  (e) losses bit for bit with and without the offload; the "
        "offload's peak is lower")
    results = gpt_scaling_test.main([
        "--layers", str(P12_LAYERS), "--hidden", str(HIDDEN), "--heads",
        str(N_HEADS), "--seq", str(P12_SEQ), "--batch", str(P12_BATCH),
        "--steps", "3", "--offload", "both", "--device", str(dev),
        "--out", f"{tmp}/gpt_scaling.json"])
    log(f"  (e) gpt_scaling_test {P12_LAYERS} x {HIDDEN}: "
        + json.dumps(results))
    rows.append({"leg": "e cpu_offload",
                 **{f"{'on' if k else 'off'}_{m}": v[m] for k, v in
                    sides.items() for m in ("p50", "peak_gib", "idle")},
                 "scaling": results})


def _fp8_run(dev, axes):
    """The 345M fp8 step (phase 10's leg) with ``fp8_amax_reduction_axes
    = axes``, 3 steps from the same seeds: losses, the step ms, the last
    params, optimizer and fp8 states, and the all-reduces of each step."""
    cfg, params, opt, loss_fn = _unfused_345m(
        dev, fp8=True, fp8_amax_reduction_axes=axes)
    step = fp8_step_fn(cfg, loss_fn, opt, dev)
    state = (opt.init(params), init_gpt_fp8_states(cfg, dev))
    real = torch.distributed.all_reduce
    calls = []

    def counted(*a, **k):
        calls.append(1)
        return real(*a, **k)
    losses, times, per_step = [], [], []
    torch.distributed.all_reduce = counted
    try:
        for _ in range(3):
            n0 = len(calls)
            t0 = time.perf_counter()
            params, state, loss = step(params, state)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
            losses.append(loss)
            per_step.append(len(calls) - n0)
    finally:
        torch.distributed.all_reduce = real
    return {"losses": losses, "times": times, "allreduces": per_step,
            "final": [*tree_leaves(params), *_packed_tree(state[0]),
                      *tree_leaves(state[1])]}


def nccl_leg(dev, rows, launches, tmp):
    """(f) ``parallel_state`` on NCCL at world 1: the 345M fp8 step with
    the amax group equals the step without it bit for bit (MAX over one
    rank), with ``fp8_allreduces()`` (100) all-reduces a step;
    ``GradScaler`` with a planted inf
    skips the step and halves the scale."""
    dist = torch.distributed
    dist.init_process_group("nccl", init_method=f"file://{tmp}/store",
                            world_size=1, rank=0)
    try:
        parallel_state.initialize_model_parallel(1, 1, use_fp8_=True)
        _device.reset_launch_counts()
        plain = _fp8_run(dev, None)
        grouped = _fp8_run(dev, ("data", "tensor"))
        for k, c in _device.launch_counts().items():
            launches[k] = launches.get(k, 0) + c
        _same_bits("fp8 step with the amax group",
                   grouped["losses"] + grouped["final"],
                   plain["losses"] + plain["final"])
        if plain["allreduces"] != [0] * 3 or \
                grouped["allreduces"] != [fp8_allreduces()] * 3:
            raise AssertionError(f"all-reduces per step: without "
                                 f"{plain['allreduces']}, with "
                                 f"{grouped['allreduces']}")
        del plain["final"], grouped["final"]
        torch.cuda.empty_cache()
        # the model-parallel loss scaler: an inf on this rank skips
        g = torch.Generator(device=dev).manual_seed(34)
        params = {"w": torch.randn(1024, 1024, generator=g, device=dev).to(
            torch.bfloat16)}
        opt = FusedAdam(lr=1e-3, master_weights=True, packed=True)
        ostate = opt.init(params)
        scaler = GradScaler("dynamic", init_scale=2.0 ** 16)
        sst = scaler.init_state(dev)
        grads = {"w": torch.randn(1024, 1024, generator=g, device=dev)}
        grads["w"][7, 7] = float("inf")
        ugrads, sst = scaler.unscale(sst, grads)
        new_params, ostate = opt.step(ugrads, ostate, params,
                                      found_inf=sst.found_inf)
        new_sst = scaler.update_scale(sst)
        if not bool(sst.found_inf) or \
                float(new_sst.loss_scale) != 2.0 ** 15:
            raise AssertionError("GradScaler did not flag the inf or halve "
                                 "the scale")
        _same_bits("GradScaler skipped step", new_params, params)
    finally:
        parallel_state.destroy_model_parallel()
        dist.destroy_process_group()
    p_plain = float(np.percentile(plain["times"][1:], 50))
    p_grouped = float(np.percentile(grouped["times"][1:], 50))
    log(f"  (f) NCCL world 1: the 345M fp8 step with the amax group "
        f"('data', 'tensor') bit for bit against the step without it; "
        f"all-reduces per step {grouped['allreduces'][0]}; step p50 "
        f"{p_grouped:.2f} ms with, {p_plain:.2f} ms without "
        f"({p_grouped - p_plain:+.2f} ms); GradScaler skipped the "
        f"poisoned step and halved the scale")
    rows.append({"leg": "f nccl", "allreduces_per_step":
                 grouped["allreduces"][0], "p50_with_ms": p_grouped,
                 "p50_without_ms": p_plain,
                 "step_ms_with": grouped["times"],
                 "step_ms_without": plain["times"]})


def a56_phase(dev, card):
    """Phase 12: (a) the applier, (b) hostio, (c) ``GDSFile``, (d)
    ``checkpoint``, (e) ``cpu_offload`` and the scaling study, (f)
    ``parallel_state`` on NCCL at world 1. Prints a ``{"phase12":
    [...]}`` line of the legs; returns the main paths' launches ((a)'s
    applier calls, (e)'s and (f)'s steps)."""
    rows, launches, parts = [], {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        for key, fn, args in (("a", applier_leg, (launches,)),
                              ("b", hostio_leg, (tmp, card)),
                              ("c", gds_leg, (tmp,)),
                              ("d", checkpoint_leg, (tmp,)),
                              ("e", offload_leg, (launches, tmp)),
                              ("f", nccl_leg, (launches, tmp))):
            t0 = time.perf_counter()
            fn(dev, rows, *args)
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            parts[key] = round(time.perf_counter() - t0, 1)
    log(f"  phase 12 parts (s): {parts}")
    print(json.dumps({"phase12": rows}), flush=True)
    return launches


# ---------------------------------------------------------------------------
# phase 13: data parallelism (A6.2, A6.3): DistributedDataParallel with the
# bucketed flat gradient lifecycle, SyncBatchNorm and LARC, ResNet-50 with
# DDP + SyncBatchNorm + FusedAdam (BASELINE config #2), on NCCL at world 1
# ---------------------------------------------------------------------------

#: DDP's bucket cap of the 345M leg, MB (the reference's default)
DDP_BUCKET_MB = 25.0
#: the lifecycle A/B of ``bench_grad_lifecycle`` at its on-card size: 64 Mi
#: bf16 parameters in 24 leaves of odd sizes, 4 MB fp32 buckets, chunk 8192
LIFECYCLE_PARAMS, LIFECYCLE_LEAVES = 64 * 2 ** 20, 24
LIFECYCLE_BUCKET_MB, LIFECYCLE_CHUNK, LIFECYCLE_ITERS = 4.0, 8192, 10
#: the card's memory rate (H100 SXM data sheet), bytes/s
HBM_BYTES_PER_S = 3.35e12
#: LARC over the ResNet-50 tree, card against CPU after 2 steps: each
#: leaf within 1e-5 of its largest entry (fp32; the norms sum in another
#: order on each device)
LARC_TOL = 1e-5


@contextlib.contextmanager
def counted_all_reduces(calls):
    """Count ``torch.distributed.all_reduce`` calls into ``calls``."""
    real = torch.distributed.all_reduce

    def counted(*a, **k):
        calls.append(1)
        return real(*a, **k)
    torch.distributed.all_reduce = counted
    try:
        yield
    finally:
        torch.distributed.all_reduce = real


def host_ops(run, top: int):
    """``(self CPU ms, calls, name)`` of the ``top`` host operations of
    ``run`` by self CPU time, from a CPU-only ``torch.profiler`` trace."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        run()
        torch.cuda.synchronize()
    return sorted(((e.self_cpu_time_total / 1e3, e.count, e.key)
                   for e in prof.key_averages()), reverse=True)[:top]


def ddp_step_fn(loss_fn, opt, scaler, buckets, ddp, max_norm=1.0):
    """The 345M loss-scaled, clipped step (:func:`scaled_step_fn`) on the
    bucketed lifecycle: ``ddp.reduce_flat`` (one all-reduce a bucket,
    straight into the shared layout) -> ``unscale_flat`` ->
    ``clip_grad_norm_flat`` -> ``FusedAdam(packed_spec=buckets.spec)``.
    ``ddp=None`` is the same step with the all-reduce left out (the
    buckets packed and concatenated)."""
    def step(params, state):
        ostate, ss = state
        loss, grads = value_and_grad(
            lambda p: scaler.scale_loss(ss, loss_fn(p)), params)
        if ddp is None:
            flat = buckets.concat(buckets.pack(grads))
        else:
            flat, _ = ddp.reduce_flat(grads, buckets=buckets)
        flat, ss = scaler.unscale_flat(ss, flat, out_dtype=torch.float32)
        flat, _ = clip_grad_norm_flat(flat, max_norm)
        params, ostate = opt.step(flat, ostate, params,
                                  found_inf=ss.found_inf)
        return params, (ostate, scaler.update_scale(ss)), \
            loss / ss.loss_scale
    return step


def _ddp_345m(dev, with_ddp):
    """The 345M unfused leg's model (:func:`_unfused_345m`) on the bucketed
    lifecycle: ``(step, params, state, buckets)``."""
    _, params, _, loss_fn = _unfused_345m(dev)
    buckets = GradBuckets(params, bucket_cap_mb=DDP_BUCKET_MB)
    buckets.check()
    opt = FusedAdam(lr=1e-4, master_weights=True, packed=True,
                    packed_spec=buckets.spec)
    scaler = LossScaler("dynamic")
    ddp = DistributedDataParallel("data", bucket_cap_mb=DDP_BUCKET_MB) \
        if with_ddp else None
    state = (opt.init(params), scaler.init_state(dev))
    return (ddp_step_fn(loss_fn, opt, scaler, buckets, ddp), params, state,
            buckets)


def ddp_345m_leg(dev, rows, launches):
    """(a) The 345M unfused step (24 x 1024, seq 1024, batch 8, bf16 over
    fp32 masters, no recompute) on ``DistributedDataParallel(bucket_cap_mb
    =25)``: launches per step exact, all-reduces a step equal to the
    bucket count, p50 / p99, peak, idle share; 3 steps from the seeds bit
    for bit (losses and the master buffer) against the same step with the
    all-reduce left out; then ``sync_gradients``, one all-reduce a leaf,
    timed against the bucketed reduction on the same gradients."""
    step, params, state, buckets = _ddp_345m(dev, True)
    calls = []
    with counted_all_reduces(calls):
        leg = drive_leg("345M unfused, loss-scaled, clipped, DDP buckets",
                        SCALED_LAUNCHES, 6, step, params, state,
                        P12_BATCH * P12_SEQ)
        n0 = len(calls)
        step(leg["params"], leg["state"])
        per_step = len(calls) - n0
    for k, c in leg["launches"].items():
        launches[k] = launches.get(k, 0) + c
    if per_step != buckets.n_buckets:
        raise AssertionError(f"all-reduces a step {per_step}, buckets "
                             f"{buckets.n_buckets}")
    del leg["params"], leg["state"], step, params, state
    torch.cuda.empty_cache()
    runs, side_ms, hosts = {}, {}, {}
    for with_ddp in (True, False):
        step, params, state, _ = _ddp_345m(dev, with_ddp)
        losses, times = [], []
        for _ in range(3):
            t0 = time.perf_counter()
            params, state, loss = step(params, state)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
            losses.append(loss)
        runs[with_ddp] = (losses, state[0].master_params.clone())
        side_ms[with_ddp] = times[1:]
        box = {"p": params, "s": state}

        def one():
            box["p"], box["s"], _ = step(box["p"], box["s"])
        hosts[with_ddp] = host_ops(one, 8)
        del step, params, state, box
        torch.cuda.empty_cache()
    _same_bits("345M DDP at world 1 against the step without the "
               "all-reduce", runs[True][0] + [runs[True][1]],
               runs[False][0] + [runs[False][1]])
    del runs
    torch.cuda.empty_cache()
    # the per-leaf reduction against the bucketed one, same gradients
    _, params, _, loss_fn = _unfused_345m(dev)
    _, grads = value_and_grad(loss_fn, params)
    del params
    ddp = DistributedDataParallel("data", bucket_cap_mb=DDP_BUCKET_MB)
    n_leaves = len(tree_leaves(grads))
    timed = {}
    for name, fn in (
            ("per_leaf", lambda: sync_gradients(grads, "data")),
            ("bucketed", lambda: ddp.reduce_flat(grads, buckets=buckets))):
        fn()
        torch.cuda.synchronize()
        calls = []
        times = []
        with counted_all_reduces(calls):
            for _ in range(5):
                t0 = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t0) * 1e3)
        timed[name] = (float(np.percentile(times, 50)), len(calls) // 5)
    if timed["per_leaf"][1] != n_leaves:
        raise AssertionError(f"sync_gradients: {timed['per_leaf'][1]} "
                             f"all-reduces for {n_leaves} leaves")
    del grads
    prof = leg["profile"]
    idle = 1 - prof["busy_ms"] / prof["wall_ms"]
    for with_ddp in (True, False):
        log(f"  host ops of a step {'with' if with_ddp else 'without'} the "
            f"all-reduce (self CPU ms, calls): "
            + "; ".join(f"{k[:40]} {ms:.2f} x{n}"
                        for ms, n, k in hosts[with_ddp]))
    log(f"  (a) 345M DDP: {buckets.n_buckets} buckets of <= "
        f"{DDP_BUCKET_MB:g} MB ({buckets.spec.total} elements), "
        f"{per_step} all-reduces a step; p50 {leg['p50']:.2f} ms p99 "
        f"{leg['p99']:.2f} ms, peak {leg['peak']:.2f} GiB, idle "
        f"{idle:.3f}; 3 steps bit for bit against the step without the "
        f"all-reduce (steps 2-3: {side_ms[True]} ms with, {side_ms[False]} "
        f"ms without); the reduction alone: per leaf "
        f"{timed['per_leaf'][0]:.2f}"
        f" ms ({n_leaves} all-reduces), bucketed {timed['bucketed'][0]:.2f} "
        f"ms ({timed['bucketed'][1]})")
    rows.append({"leg": "a 345M DDP", "buckets": buckets.n_buckets,
                 "allreduces_per_step": per_step, "p50_ms": leg["p50"],
                 "p99_ms": leg["p99"], "peak_gib": leg["peak"],
                 "idle": idle, "reduce_per_leaf_ms": timed["per_leaf"][0],
                 "per_leaf_allreduces": n_leaves,
                 "reduce_bucketed_ms": timed["bucketed"][0],
                 "step_ms_with_allreduce": side_ms[True],
                 "step_ms_without_allreduce": side_ms[False],
                 "host_ops_with": hosts[True],
                 "host_ops_without": hosts[False]})


def lifecycle_leg(dev, rows, launches):
    """(b) ``bench_grad_lifecycle``'s A/B at its on-card size: A, the
    per-leaf step (``sync_gradients(allreduce_always_fp32=True)``, the
    tree unscale, packed FusedAdam over the tree); B, the fused flat
    lifecycle (``reduce_flat(concat=False)`` with raw sums ->
    ``found_inf_flat`` -> ``step_flat(grad_scale=scale * world)``, the
    fp32 masters the parameter store). Steps/s of both, B's
    ``sweep_bytes`` over its step time against the card's rate."""
    g = torch.Generator(device=dev).manual_seed(41)
    per = LIFECYCLE_PARAMS // LIFECYCLE_LEAVES
    params = {f"w{i:02d}": (0.1 * torch.randn(per + (i % 3) * 17,
                                              generator=g, device=dev)
                            ).to(torch.bfloat16)
              for i in range(LIFECYCLE_LEAVES)}
    buckets = GradBuckets(params, bucket_cap_mb=LIFECYCLE_BUCKET_MB,
                          chunk_size=LIFECYCLE_CHUNK,
                          reduce_dtype=torch.float32)
    xs = torch.randn(4, generator=g, device=dev)
    world = torch.distributed.get_world_size()

    def loss_fn(p):
        s = 1.0 + 0.01 * xs.mean()
        acc = 0.0
        for leaf in tree_leaves(p):
            acc = acc + ((leaf.to(torch.float32) * s) ** 2).mean()
        return acc / len(p)

    out = {}
    for side in ("A per-leaf", "B flat"):
        scaler = LossScaler("dynamic", init_scale=2.0 ** 8)
        ss = scaler.init_state(dev)
        if side.startswith("B"):
            opt = FusedAdam(lr=1e-3, master_weights=True, packed=True,
                            packed_spec=buckets.spec)
            ddp = DistributedDataParallel(
                "data", allreduce_always_fp32=True, gradient_average=False,
                bucket_cap_mb=LIFECYCLE_BUCKET_MB)
            carry = opt.init(params)

            def step(carry, ss):
                p = buckets.unpack(carry.master_params)
                loss, grads = value_and_grad(
                    lambda q: scaler.scale_loss(ss, loss_fn(q)), p)
                bufs, _ = ddp.reduce_flat(grads, buckets=buckets,
                                          concat=False)
                ss = scaler.found_inf_flat(ss, bufs)
                carry = opt.step_flat(bufs, carry, found_inf=ss.found_inf,
                                      grad_scale=ss.loss_scale * world)
                return carry, scaler.update_scale(ss), loss
        else:
            opt = FusedAdam(lr=1e-3, master_weights=True, packed=True,
                            packed_chunk_size=LIFECYCLE_CHUNK)
            carry = (params, opt.init(params))

            def step(carry, ss):
                p, ostate = carry
                loss, grads = value_and_grad(
                    lambda q: scaler.scale_loss(ss, loss_fn(q)), p)
                grads = sync_gradients(grads, "data",
                                       allreduce_always_fp32=True)
                grads, ss = scaler.unscale(ss, grads)
                p, ostate = opt.step(grads, ostate, p,
                                     found_inf=ss.found_inf)
                return (p, ostate), scaler.update_scale(ss), loss
        for _ in range(2):
            carry, ss, loss = step(carry, ss)
        torch.cuda.synchronize()
        _device.reset_launch_counts()
        t0 = time.perf_counter()
        for _ in range(LIFECYCLE_ITERS):
            carry, ss, loss = step(carry, ss)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        counts = {k: c for k, c in _device.launch_counts().items() if c}
        for k, c in counts.items():
            launches[k] = launches.get(k, 0) + c
        if counts != {"packed_adam": LIFECYCLE_ITERS} or not bool(
                torch.isfinite(loss)):
            raise AssertionError(f"lifecycle {side}: launches {counts}, "
                                 f"loss {float(loss)}")
        out[side] = LIFECYCLE_ITERS / dt
        del carry
        torch.cuda.empty_cache()
    step_s = 1.0 / out["B flat"]
    gbps = buckets.sweep_bytes() / step_s / 1e9
    log(f"  (b) lifecycle A/B, {LIFECYCLE_PARAMS} bf16 parameters in "
        f"{LIFECYCLE_LEAVES} leaves, {buckets.n_buckets} buckets of "
        f"{LIFECYCLE_BUCKET_MB:g} MB: A per-leaf {out['A per-leaf']:.2f} "
        f"steps/s, B flat {out['B flat']:.2f} steps/s "
        f"({out['B flat'] / out['A per-leaf']:.2f}x); B's sweep_bytes "
        f"{buckets.sweep_bytes()} over its step: {gbps:.1f} GB/s, "
        f"{gbps * 1e9 / HBM_BYTES_PER_S:.3f} of 3.35 TB/s")
    rows.append({"leg": "b lifecycle A/B", "steps_per_s_per_leaf":
                 out["A per-leaf"], "steps_per_s_flat": out["B flat"],
                 "buckets": buckets.n_buckets,
                 "sweep_bytes": buckets.sweep_bytes(),
                 "flat_gbps": gbps})


def sgd_spec_leg(dev, rows, launches):
    """(c) ``FusedSGD(packed=True, packed_spec=buckets.spec)`` on the 345M
    tree: the step on the reduced flat buffer bit for bit against the
    step that packs the gradient tree itself."""
    g = torch.Generator(device=dev).manual_seed(42)
    params = tree_map(lambda m: (torch.randn(m.shape, generator=g,
                                             device=dev) * 0.02).to(
        torch.bfloat16), gpt345m_param_shapes())
    grads = tree_map(lambda p: (torch.randn(p.shape, generator=g,
                                            device=dev) * 1e-3).to(
        torch.bfloat16), params)
    buckets = GradBuckets(params, bucket_cap_mb=DDP_BUCKET_MB)
    opt = FusedSGD(lr=0.1, momentum=0.9, weight_decay=1e-4,
                   master_weights=True, packed=True,
                   packed_spec=buckets.spec)
    flat = buckets.concat(buckets.pack(grads))
    results = []
    for i, gr in enumerate((flat, grads)):
        state = opt.init(params)
        if state.spec is not buckets.spec:
            raise AssertionError("FusedSGD did not adopt the buckets' spec")
        torch.cuda.synchronize()
        _device.reset_launch_counts()
        p, state = opt.step(gr, state, params)
        p, state = opt.step(gr, state, p)
        torch.cuda.synchronize()
        if i == 0:  # the flat buffer is the main path; the tree compares
            for k, c in _device.launch_counts().items():
                launches[k] = launches.get(k, 0) + c
        results.append([*tree_leaves(p), *_packed_tree(state)[:2],
                        state.master_params])
    _same_bits("FusedSGD on the reduced buffer against the tree",
               results[0], results[1])
    log(f"  (c) FusedSGD(packed_spec=buckets.spec) on the 345M tree "
        f"({buckets.n_buckets} buckets): 2 steps on the reduced flat buffer "
        f"bit for bit against the tree it packs itself")
    rows.append({"leg": "c FusedSGD packed_spec",
                 "buckets": buckets.n_buckets})


def _sync_bn_grads(dev, level, half, params_cpu, bstats_cpu, x, y, cmt,
                   group):
    """Loss, gradients and running statistics of one ResNet-50 forward
    and backward with SyncBatchNorm over ``group`` on ``dev``, from the
    same weights (:func:`_resnet_grads` with ``sync_bn``)."""
    model = resnet.build_model("resnet50", num_classes=RESNET_CLASSES,
                               sync_bn=True, bn_axis_name=group)
    params = tree_map(lambda t: t.to(dev), params_cpu)
    bstats = tree_map(lambda t: t.to(dev, half if half == torch.float64
                                     else torch.float32), bstats_cpu)
    params, _, st = amp.initialize(params, None, opt_level=level,
                                   half_dtype=half, cast_model_type=cmt)
    cast = st.opt_properties.cast_model_type not in (None, torch.float32)
    xx = main_amp._normalize(x.to(dev), half, cast)
    out = {}

    def loss_fn(p):
        logits, out["new"] = model.apply(p, bstats, xx, train=True)
        return main_amp._loss(logits, y.to(dev))

    loss, grads = value_and_grad(loss_fn, params)
    return (float(loss), tree_map(lambda t: t.double().cpu(), grads),
            tree_map(lambda t: t.double().cpu(), out["new"]))


def _sync_bn_parity(dev, cpu_group):
    """Card (NCCL) against CPU (a gloo group), batch 8, TF32 off, with
    SyncBatchNorm: fp64 within 1e-8 a leaf, fp32 (O0) each leaf within
    ``F32_LEAF_K`` times the CPU's distance from fp64 plus
    ``F32_LEAF_FLOOR``, bf16 (O2) loss within 3e-2 and each leaf within
    3e-2 of its largest entry plus 5 times the CPU's bf16 distance from
    fp64: phase 9's gates."""
    params, bstats = resnet.build_model(
        "resnet50", RESNET_CLASSES, sync_bn=True).init(
        torch.Generator().manual_seed(3))
    x, y = _resnet_batch("cpu", RESNET_PARITY_BATCH, seed=4)
    runs = {}
    with tf32_off():
        for key, level, half, cmt in (
                ("f64", "O0", torch.float64, torch.float64),
                ("f32", "O0", torch.float32, None),
                ("bf16", "O2", torch.bfloat16, None)):
            runs[key] = (
                _sync_bn_grads(dev, level, half, params, bstats, x, y, cmt,
                               "data"),
                _sync_bn_grads("cpu", level, half, params, bstats, x, y,
                               cmt, cpu_group))
    ref = runs["f64"][1]
    card, cpu = runs["f64"]
    worst64 = max(max(_leaf_gaps(card[1], cpu[1]))[0],
                  max(_leaf_gaps(card[2], cpu[2]))[0])
    if abs(card[0] - cpu[0]) > 1e-12 * abs(cpu[0]) or worst64 > 1e-8:
        raise AssertionError(f"sync-BN fp64 parity: loss {card[0]} vs "
                             f"{cpu[0]}, worst leaf {worst64:.2e}")
    card, cpu = runs["f32"]
    over = max((c / (F32_LEAF_K * u + F32_LEAF_FLOOR), p) for (c, p), (u, _)
               in zip(_leaf_gaps(card[1], ref[1]), _leaf_gaps(cpu[1],
                                                              ref[1])))
    rel32 = abs(card[0] - cpu[0]) / abs(cpu[0])
    if over[0] > 1 or rel32 > 1e-4:
        raise AssertionError(f"sync-BN fp32 parity: gate share {over}, "
                             f"loss rel {rel32:.2e}")
    card, cpu = runs["bf16"]
    rel16 = abs(card[0] - cpu[0]) / abs(cpu[0])
    worst16 = 0.0
    for tree_i in (1, 2):
        for a, b, r in zip(*(tree_leaves(t[tree_i])
                             for t in (card, cpu, ref))):
            err, m = float((a - b).abs().max()), float(b.abs().max())
            worst16 = max(worst16, err / max(m, 1e-30))
            if err > 3e-2 * m + 5 * float((b - r).abs().max()):
                raise AssertionError(f"sync-BN bf16 leaf {err:.3e}")
    if rel16 > 3e-2:
        raise AssertionError(f"sync-BN bf16 loss rel {rel16:.2e}")
    out = {"f64_worst": worst64, "f32_gate_share": over[0],
           "f32_loss_rel": rel32, "bf16_loss_rel": rel16,
           "bf16_leaf_worst": worst16}
    log(f"  sync-BN parity card (NCCL) against CPU (gloo), batch 8: "
        + ", ".join(f"{k} {v:.2e}" for k, v in out.items()))
    return out


def resnet_ddp_leg(dev, rows, o2_p50, cpu_group):
    """(d) BASELINE config #2: ``main_amp``'s data-parallel step for
    ResNet-50 at O2 bf16 with ``--sync_bn`` and ``--optimizer adam``,
    batch 256 at 224 px, 2 + 6 steps on one staged batch: p50, images/s,
    peak, idle share and all-reduces a step, beside phase 9's O2 bf16 leg
    without DDP; then card against CPU at batch 8 (:func:`_sync_bn_parity`)."""
    x, y = _resnet_batch(dev)
    model = resnet.build_model("resnet50", num_classes=RESNET_CLASSES,
                               sync_bn=True)
    params, bstats = model.init(torch.Generator(device=dev).manual_seed(0))
    opt = FusedAdam(lr=0.1 * RESNET_BATCH / 256, weight_decay=1e-4)
    params, opt, st = amp.initialize(params, opt, opt_level="O2",
                                     half_dtype=torch.bfloat16)
    ddp = DistributedDataParallel("data")
    params = ddp.broadcast_params(params)
    step = main_amp.make_train_step(model, opt, st.scaler(0), torch.bfloat16,
                                    True, ddp)
    box = {"state": (params, bstats, opt.init(params), st.scaler_state(0))}
    lr = 0.1 * RESNET_BATCH / 256

    def run():
        out = step(*box["state"], x, y, lr)
        box["state"] = out[:4]
        return out
    losses, times, calls = [], [], []
    for i in range(8):
        if i == 2:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            _device.reset_launch_counts()
        t0 = time.perf_counter()
        with counted_all_reduces(calls):
            out = run()
        torch.cuda.synchronize()
        if i >= 2:
            times.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(out[4]))
    launches = {k: c for k, c in _device.launch_counts().items() if c}
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    per_step = len(calls) // 8
    prof = profiled(run, "ResNet-50 O2 bf16 DDP + SyncBatchNorm + FusedAdam "
                    "step", 10)
    idle = 1 - prof["busy_ms"] / prof["wall_ms"]
    p50, p99 = (float(np.percentile(times, q)) for q in (50, 99))
    if launches or not all(np.isfinite(losses)) or \
            not losses[-1] < losses[0]:
        raise AssertionError(f"ResNet-50 DDP: launches {launches}, losses "
                             f"{losses}")
    del box, step, out
    torch.cuda.empty_cache()
    parity = _sync_bn_parity(dev, cpu_group)
    log(f"  (d) ResNet-50 O2 bf16, DDP + SyncBatchNorm + FusedAdam, batch "
        f"{RESNET_BATCH}: p50 {p50:.2f} ms p99 {p99:.2f} ms, "
        f"{RESNET_BATCH / (p50 / 1e3):.0f} images/s, peak {peak:.2f} GiB, "
        f"idle {idle:.3f}, {per_step} all-reduces a step; phase 9's O2 bf16 "
        f"without DDP: p50 {o2_p50:.2f} ms; losses {losses}")
    rows.append({"leg": "d ResNet-50 DDP SyncBN Adam", "p50_ms": p50,
                 "p99_ms": p99, "images_per_s": RESNET_BATCH / (p50 / 1e3),
                 "peak_gib": peak, "idle": idle,
                 "allreduces_per_step": per_step, "phase9_o2_p50_ms": o2_p50,
                 "step_ms": times, "losses": losses, "parity": parity})


def larc_leg(dev, rows):
    """(e) ``LARC(FusedSGD)`` over the ResNet-50 tree (fp32, random
    gradients): the step's ms on the card, and 2 steps card against CPU
    within ``LARC_TOL`` of each leaf's largest entry."""
    params, _ = resnet.init_params("resnet50",
                                   torch.Generator().manual_seed(5),
                                   num_classes=RESNET_CLASSES)
    g = torch.Generator().manual_seed(6)
    grads = tree_map(lambda p: torch.randn(p.shape, generator=g) * 1e-2,
                     params)
    finals, ms = [], None
    for d in (dev, "cpu"):
        opt = LARC(FusedSGD(lr=0.1, momentum=0.9, weight_decay=1e-4),
                   trust_coefficient=0.02)
        p = tree_map(lambda t: t.to(d), params)
        gr = tree_map(lambda t: t.to(d), grads)
        state = opt.init(p)
        for _ in range(2):
            p, state = opt.step(gr, state, p)
        finals.append(p)
        if d == dev:
            torch.cuda.synchronize()
            box = {"p": p, "s": state}

            def one():
                box["p"], box["s"] = opt.step(gr, box["s"], box["p"])
            ms = time_ms(one, iters=10, warmup=2)
    worst = max(_leaf_gaps(tree_map(lambda t: t.double().cpu(), finals[0]),
                           tree_map(lambda t: t.double(), finals[1])))
    if worst[0] > LARC_TOL:
        raise AssertionError(f"LARC card against CPU: {worst}")
    log(f"  (e) LARC(FusedSGD) over the ResNet-50 tree: {ms:.3f} ms a step; "
        f"2 steps card against CPU, worst leaf {worst[0]:.2e} ({worst[1]})")
    rows.append({"leg": "e LARC", "step_ms": ms, "worst_leaf": worst[0]})


def simple_ddp_leg(dev, rows):
    """(f) The simple DDP example through its CLI, 50 steps on the card
    at NCCL world 1: its loss lines, the loss falling."""
    import io

    from apex_tpu_torch.examples.simple.distributed import (
        distributed_data_parallel as simple_ddp,
    )
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        losses = simple_ddp.main(["--steps", "50"])
    text = buf.getvalue()
    for line in text.splitlines():
        log(f"  | {line}")
    if len(losses) != 2 or not losses[-1][1] < losses[0][1] or \
            "step 49: loss" not in text:
        raise AssertionError(f"simple DDP example: {losses}")
    rows.append({"leg": "f simple DDP example", "losses": losses})


def ddp_phase(dev, o2_p50):
    """Phase 13: data parallelism on NCCL at world 1 over a ``file://``
    store (one card: the collectives' path and cost, not a reduction
    across cards): (a) the 345M DDP step, (b) the lifecycle A/B, (c)
    ``FusedSGD(packed_spec=...)``, (d) ResNet-50 with DDP + SyncBatchNorm
    + FusedAdam, (e) ``LARC``, (f) the simple DDP example. Prints a
    ``{"phase13": [...]}`` line; returns the main paths' launches."""
    rows, launches, parts = [], {}, {}
    dist = torch.distributed
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group("nccl", init_method=f"file://{tmp}/store",
                                world_size=1, rank=0)
        try:
            cpu_group = dist.new_group(backend="gloo")
            for key, fn, args in (("a", ddp_345m_leg, (rows, launches)),
                                  ("b", lifecycle_leg, (rows, launches)),
                                  ("c", sgd_spec_leg, (rows, launches)),
                                  ("d", resnet_ddp_leg,
                                   (rows, o2_p50, cpu_group)),
                                  ("e", larc_leg, (rows,)),
                                  ("f", simple_ddp_leg, (rows,))):
                t0 = time.perf_counter()
                fn(dev, *args)
                torch.cuda.synchronize()
                torch.cuda.empty_cache()
                parts[key] = round(time.perf_counter() - t0, 1)
        finally:
            dist.destroy_process_group()
    log(f"  phase 13 parts (s): {parts}")
    print(json.dumps({"phase13": rows}), flush=True)
    return launches


# ---------------------------------------------------------------------------
# phase 14: tensor and sequence parallelism (A6.4): the 345M through the
# tensor-parallel path at TP 1 on NCCL, at TP 2 and TP 8 (BASELINE config
# #4) in gloo worlds whose ranks share the card, the microbatch calculator
# over accumulate_main_grads, and the two single-device examples (A5.7.1)
# ---------------------------------------------------------------------------

#: the 345M of phase 14: 24 x 1024, 16 heads, vocab 50304, seq 1024
P14_LAYERS, P14_SEQ, P14_VOCAB = 24, 1024, 50304
#: leg (a)'s batch (phase 5's), leg (b)'s and (d)'s, config #4's
P14_BATCH_A, P14_BATCH_B, P14_BATCH_C = 8, 4, 8
#: leg (b)'s gradients held against the dense fused step (gathered from
#: the ranks, shard for shard)
P14_GRAD_LEAVES = ("layers/qkv_w", "layers/fc2_w", "layers/input_ln_w",
                   "layers/post_ln_b", "embedding/word")
#: the collectives the mappings use, counted a step
P14_COLLECTIVES = ("all_reduce", "all_gather_into_tensor",
                   "reduce_scatter_tensor")
#: kernel -> the profiler names of its launches, for the device time a
#: launch at the shard shapes (config #4's profiled step)
P14_MATCH = {"layer_norm_fwd": ("::ln_fwd_",),
             "layer_norm_bwd": ("norm_bwd_",),
             "flash_attn_fwd": ("flash_fwd_tc_kernel",),
             "flash_attn_bwd": ("flash_bwd_dq_tc_kernel",
                                "flash_bwd_dkv_tc_kernel"),
             "bias_gelu_fwd": ("bias_gelu_fwd_kernel",),
             "bias_gelu_bwd": ("bias_gelu_bwd_kernel",),
             "bias_dropout_residual_fwd": ("bdr_fwd_kernel",),
             "bias_dropout_residual_bwd": ("bdr_bwd_kernel",),
             "residual_ln_fwd": ("raln_fwd_kernel",),
             "residual_ln_bwd": ("raln_bwd_kernel",),
             "packed_adam": ("packed_adam_kernel",)}
#: the kernels each leg's steps must launch: the unfused step's (a) and
#: the fused step's (b), (c)
P14_UNFUSED_KERNELS = TRAIN_KERNELS
P14_FUSED_KERNELS = TRAIN_KERNELS + FUSED_KERNELS


def p14_cfg(**kw) -> GPTConfig:
    base = dict(num_layers=P14_LAYERS, hidden_size=HIDDEN,
                num_attention_heads=N_HEADS, vocab_size=P14_VOCAB,
                max_position_embeddings=P14_SEQ, hidden_dropout=0.0,
                attention_dropout=0.0, compute_dtype=torch.bfloat16)
    return GPTConfig(**{**base, **kw})


def p14_model(cfg, dev, batch):
    """The 345M's bf16 params (seed 0, drawn on the card: the same on
    every rank) and a batch of tokens (seed 1) with their next-token
    labels."""
    params = tree_map(lambda p: p.to(torch.bfloat16), init_gpt_params(
        cfg, torch.Generator(device=dev).manual_seed(0), device=dev))
    tokens = torch.randint(0, cfg.vocab_size, (batch, P14_SEQ), device=dev,
                           generator=torch.Generator(device=dev).manual_seed(1))
    return params, tokens, torch.roll(tokens, -1, dims=1)


@contextlib.contextmanager
def counted_collectives(counts):
    """Count the calls of each of ``P14_COLLECTIVES`` into ``counts``."""
    dist = torch.distributed
    real = {n: getattr(dist, n) for n in P14_COLLECTIVES}

    def wrap(name):
        def counted(*a, **k):
            counts[name] = counts.get(name, 0) + 1
            return real[name](*a, **k)
        return counted
    for name in P14_COLLECTIVES:
        setattr(dist, name, wrap(name))
    try:
        yield
    finally:
        for name, fn in real.items():
            setattr(dist, name, fn)


def _p14_steps(cfg, params, tokens, labels, axis_name, n):
    """``n`` steps of ``gpt_loss`` (``axis_name`` None: the dense chunked
    loss) with packed FusedAdam(lr 1e-4, fp32 masters): the losses, the
    step ms, the collectives of each step, the launches of the steps."""
    opt = FusedAdam(lr=1e-4, master_weights=True, packed=True)
    state = opt.init(params)
    step = train_step_fn(lambda p: gpt_loss(cfg, p, tokens, labels,
                                            axis_name=axis_name), opt)
    losses, times, per_step = [], [], []
    _device.reset_launch_counts()
    for _ in range(n):
        counts = {}
        with counted_collectives(counts):
            t0 = time.perf_counter()
            params, state, loss = step(params, state)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(loss))
        per_step.append(counts)
    return {"losses": losses, "times": times, "collectives": per_step,
            "launches": _device.launch_counts()}


def tp1_leg(dev, rows, launches, tmp):
    """(a) TP 1 on NCCL at world 1 over a ``file://`` store: the 345M
    unfused step (batch 8, bf16 over fp32 masters, packed FusedAdam)
    through ``axis_name="tensor"`` for 3 steps, its losses against the
    dense step's from the same seeds within phase 5's bf16 loss parity
    (at TP 1 only the loss differs: vocab-parallel cross entropy over the
    whole fp32 logits against the chunk-fused one); p50, peak, the
    collectives a step."""
    dist = torch.distributed
    dist.init_process_group("nccl", init_method=f"file://{tmp}/store14",
                            world_size=1, rank=0)
    try:
        parallel_state.initialize_model_parallel(1)
        cfg = p14_cfg(tensor_model_parallel_size=1)
        dense = _p14_steps(cfg, *p14_model(cfg, dev, P14_BATCH_A), None, 3)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        tp = _p14_steps(cfg, *p14_model(cfg, dev, P14_BATCH_A), "tensor", 3)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
    finally:
        parallel_state.destroy_model_parallel()
        dist.destroy_process_group()
    for k, c in tp["launches"].items():
        launches[k] = launches.get(k, 0) + c
    rel = max(abs(a - b) / abs(b) for a, b in zip(tp["losses"],
                                                  dense["losses"]))
    p50 = float(np.percentile(tp["times"], 50))
    d50 = float(np.percentile(dense["times"], 50))
    log(f"  (a) TP 1 on NCCL world 1, 345M unfused batch {P14_BATCH_A}: "
        f"losses {tp['losses']} against dense {dense['losses']} (max rel "
        f"{rel:.2e}); step p50 {p50:.2f} ms (dense {d50:.2f}), steps "
        f"{[round(t, 2) for t in tp['times']]}; peak {peak:.2f} GiB; "
        f"collectives a step {tp['collectives'][-1]}; launches "
        f"{({k: v for k, v in tp['launches'].items() if v})}")
    if rel > PARITY_TOL[torch.bfloat16][0]:
        raise AssertionError(f"TP 1 losses differ from the dense step's: "
                             f"{rel:.3e}")
    # from these seeds the loss first falls below ln(vocab) and overshoots
    # at the third step on every 345M leg (phase 5's curves), so 3 steps
    # are held to finite values and to the dense step's losses
    if not all(np.isfinite(tp["losses"])):
        raise AssertionError(f"TP 1 losses: {tp['losses']}")
    for name in P14_UNFUSED_KERNELS:
        if tp["launches"][name] <= 0:
            raise AssertionError(f"{name} did not launch on the TP 1 leg")
    rows.append({"leg": "a tp1 nccl", "losses": tp["losses"],
                 "dense_losses": dense["losses"], "max_rel": rel,
                 "step_ms": tp["times"], "p50_ms": p50, "dense_p50_ms": d50,
                 "peak_gib": peak, "collectives_per_step":
                 tp["collectives"][-1]})


def _gather_leaf(tree, key):
    node = tree
    for part in key.split("/"):
        node = node[part]
    return node


def _gloo_probe(dev):
    """Which of the mappings' collectives gloo takes on CUDA tensors:
    ``{name: "ok" or the error}`` (a probe of the transport, run once
    before the legs; the legs then use only what it took)."""
    dist = torch.distributed
    world = dist.get_world_size()
    x = torch.ones(4, 8, device=dev, dtype=torch.bfloat16)
    tries = {
        "all_reduce": lambda: dist.all_reduce(x.clone()),
        "all_gather_into_tensor": lambda: dist.all_gather_into_tensor(
            x.new_empty(4 * world, 8), x),
        "reduce_scatter_tensor": lambda: dist.reduce_scatter_tensor(
            x.new_empty(4 // world if 4 % world == 0 else 1, 8),
            x if 4 % world == 0 else x.new_ones(world, 8)),
    }
    out = {}
    for name, fn in tries.items():
        try:
            fn()
            torch.cuda.synchronize()
            out[name] = "ok"
        except Exception as e:  # the probe's answer, not a failed leg
            out[name] = f"{type(e).__name__}: {str(e)[:200]}"
    return out


def p14_worker(rank: int, world: int, store: str, out: str, spec: str):
    """One rank of a gloo world on the card (legs (b)-(d)); writes
    ``rank<r>.json`` (and ``rank<r>_<label>.pt``, the gradients of
    ``P14_GRAD_LEAVES``) into ``out``."""
    spec = json.loads(spec)
    dist = torch.distributed
    dev = torch.device(spec["device"])
    if dev.type == "cuda":
        dev = torch.device("cuda", dev.index or 0)
        torch.cuda.set_device(dev)
    torch.backends.cuda.matmul.allow_tf32 = False
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            world_size=world, rank=rank)
    res = {"rank": rank, "probe": _gloo_probe(dev), "runs": {}}
    try:
        _build.kernels()
        tpn = spec["tp"]
        parallel_state.initialize_model_parallel(tpn)
        r = parallel_state.get_tensor_model_parallel_rank()
        sp_ok = all(res["probe"][n] == "ok" for n in P14_COLLECTIVES)
        for label, kw, steps in spec["runs"]:
            if kw.get("sequence_parallel") and not sp_ok:
                continue
            cfg = p14_cfg(tensor_model_parallel_size=tpn, fused_block=True,
                          **kw)
            params, tokens, labels = p14_model(cfg, dev, spec["batch"])
            shard = shard_gpt_params(params, cfg, r, tpn)
            del params
            opt = FusedAdam(lr=1e-4, master_weights=True, packed=True)
            state = opt.init(shard)

            def loss_fn(p):
                return gpt_loss(cfg, p, tokens, labels, axis_name="tensor")
            run = {"losses": [], "step_ms": [], "collectives": []}
            box = {"one": None}

            def one_step(i):
                """Gradients (the first step's saved and kept with
                ``save_grads``), then the optimizer's step on the shard."""
                loss, grads = value_and_grad(loss_fn, box["shard"])
                if i == 0 and spec.get("save_grads"):
                    torch.save({k: _gather_leaf(grads, k).float().cpu()
                                for k in P14_GRAD_LEAVES},
                               f"{out}/rank{rank}_{label}.pt")
                    box["one"] = grads
                box["shard"], box["state"] = opt.step(grads, box["state"],
                                                      box["shard"])
                box["loss"] = loss
            box["shard"], box["state"] = shard, state
            del shard, state
            torch.cuda.reset_peak_memory_stats()
            for i in range(steps):
                if i == spec["warm"]:
                    _device.reset_launch_counts()
                counts = {}
                with counted_collectives(counts):
                    t0 = time.perf_counter()
                    if i == spec.get("profile_step") and rank == 0:
                        # a warm-up step, before the counted ones
                        prof = profiled(lambda: one_step(i),
                                        "config #4 rank 0 step", 14)
                        run["profile"] = {
                            "wall_ms": prof["wall_ms"],
                            "busy_ms": prof["busy_ms"],
                            "rows": prof["rows"][:14],
                            "kernels": {k: [
                                sum(n for key, (n, _) in prof["ops"].items()
                                    if any(m in key for m in ms)),
                                sum(t for key, (_, t) in prof["ops"].items()
                                    if any(m in key for m in ms))]
                                for k, ms in P14_MATCH.items()}}
                    else:
                        one_step(i)
                    torch.cuda.synchronize()
                    run["step_ms"].append((time.perf_counter() - t0) * 1e3)
                run["losses"].append(float(box["loss"]))
                run["collectives"].append(counts)
            run["launches"] = {k: v for k, v in
                               _device.launch_counts().items() if v}
            run["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
            if spec.get("microbatches") and not kw.get("sequence_parallel"):
                run["micro"] = _p14_microbatches(cfg, shard_of_start(
                    cfg, dev, spec["batch"], r, tpn), tokens, labels,
                    box["one"], spec["batch"])
            res["runs"][label] = run
            del box, opt
            torch.cuda.empty_cache()
        if spec.get("dense") and rank == 0:
            cfg = p14_cfg(fused_block=True)
            params, tokens, labels = p14_model(cfg, dev, spec["batch"])
            loss, grads = value_and_grad(
                lambda p: gpt_loss(cfg, p, tokens, labels), params)
            torch.save({k: _gather_leaf(grads, k).float().cpu()
                        for k in P14_GRAD_LEAVES}, f"{out}/dense.pt")
            res["dense_loss"] = float(loss)
    finally:
        parallel_state.destroy_model_parallel()
        dist.destroy_process_group()
    with open(f"{out}/rank{rank}.json", "w") as f:
        json.dump(res, f)


def shard_of_start(cfg, dev, batch, r, tpn):
    """This rank's shard of the seeded starting params."""
    return shard_gpt_params(p14_model(cfg, dev, batch)[0], cfg, r, tpn)


def _p14_microbatches(cfg, shard, tokens, labels, one, batch):
    """(d) The microbatch calculator (``build_num_microbatches_calculator``
    for a global batch of ``batch`` rows, micro batch 1, data-parallel 1)
    driving the step's gradient over its microbatches through
    ``accumulate_main_grads`` into fp32 ``main_grad`` buffers: their
    mean against the one-batch gradient ``one`` (the loss is a mean over
    equal microbatches), the worst leaf's gap over its largest entry."""
    calc = build_num_microbatches_calculator(1, None, batch, 1, 1)
    n = calc.get()
    micro = (tokens.reshape(n, batch // n, -1),
             labels.reshape(n, batch // n, -1))

    def grad_fn(p, m):
        return value_and_grad(lambda q: gpt_loss(
            cfg, q, m[0], m[1], axis_name="tensor"), p)[1]
    t0 = time.perf_counter()
    main = accumulate_main_grads(grad_fn, shard, micro)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    worst = 0.0
    for a, b in zip(tree_leaves(main), tree_leaves(one)):
        if a.dtype != torch.float32:
            raise AssertionError("main_grad is not fp32")
        gap = float((a / n - b.float()).abs().max()
                    / b.float().abs().max().clamp_min(1e-30))
        worst = max(worst, gap)
    return {"microbatches": n, "worst": worst, "ms": ms}


def _spawn_p14(tmp, world, spec, timeout=600, worker="p14_worker",
               name=None):
    """Start ``world`` ranks of ``worker`` (:func:`p14_worker` or
    :func:`p15_worker`; one process each, all on the card, a gloo world
    over a file store in ``tmp``), wait for them, and return each rank's
    record; a rank that fails, or a world that does not end within
    ``timeout`` seconds, fails the leg."""
    out = os.path.join(tmp, name or f"w{world}")
    os.makedirs(out, exist_ok=True)
    here = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=here + os.pathsep
               + os.environ.get("PYTHONPATH", ""), OMP_NUM_THREADS="1")
    code = (f"import sys, chip_smoke; chip_smoke.{worker}(int(sys.argv[1]),"
            " int(sys.argv[2]), sys.argv[3], sys.argv[4], sys.argv[5])")
    procs = [subprocess.Popen(
        [sys.executable, "-c", code, str(r), str(world),
         os.path.join(out, "store"), out, json.dumps(spec)], env=env,
        cwd=here, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(world)]
    deadline = time.monotonic() + timeout
    failed, logs = [], []
    try:
        for r, p in enumerate(procs):
            try:
                text, _ = p.communicate(
                    timeout=max(1.0, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                failed.append(f"rank {r}: no exit within {timeout} s")
                continue
            logs.append(text)
            if p.returncode:
                failed.append(f"rank {r} exited {p.returncode}:\n"
                              f"{text[-3000:]}")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    if failed:
        raise AssertionError("\n".join(failed))
    for line in logs[0].splitlines():
        log(f"  | {line}")
    recs = []
    for r in range(world):
        with open(os.path.join(out, f"rank{r}.json")) as f:
            recs.append(json.load(f))
    return recs, out


def _add_launches(launches, recs, label):
    for rec in recs:
        for k, c in rec["runs"][label]["launches"].items():
            launches[k] = launches.get(k, 0) + c


def tp2_leg(dev, rows, launches, tmp):
    """(b) TP 2 in a gloo world of 2 on the card: the 345M fused
    (``fused_block=True``) at batch 4 with sequence parallelism off and,
    where gloo takes the sequence collectives on CUDA tensors, on; each
    rank shards the seeded params with ``shard_gpt_params`` and takes one
    step (gradients, then packed FusedAdam on its shard). The loss equal
    on both ranks; the loss and the gradients of ``P14_GRAD_LEAVES``,
    gathered from the ranks, against the dense fused step on the card
    within phase 5's bf16 parity (loss rel 2e-3, a leaf's worst gap 5e-2
    of its largest entry). (d) rides in the same world: the microbatch
    calculator over 4 microbatches through ``accumulate_main_grads``, the
    fp32 ``main_grad``'s mean against the one-batch gradient within the
    same gradient limit. Returns the gloo probe."""
    spec = {"tp": 2, "batch": P14_BATCH_B, "device": str(dev), "warm": 0, "save_grads": True,
            "dense": True, "microbatches": True,
            "runs": [["tp2", {}, 1],
                     ["tp2_sp", {"sequence_parallel": True}, 1]]}
    recs, out = _spawn_p14(tmp, 2, spec)
    probe = recs[0]["probe"]
    log(f"  gloo on CUDA tensors: {probe}")
    loss_tol, grad_tol, _ = PARITY_TOL[torch.bfloat16]
    dense_loss = recs[0]["dense_loss"]
    dense = torch.load(os.path.join(out, "dense.pt"))
    specs = gpt_partition_specs(p14_cfg())
    for label in recs[0]["runs"]:
        losses = [rec["runs"][label]["losses"][0] for rec in recs]
        if len(set(losses)) != 1:
            raise AssertionError(f"{label}: losses differ by rank: {losses}")
        rel = abs(losses[0] - dense_loss) / abs(dense_loss)
        gaps = {}
        shards = [torch.load(os.path.join(out, f"rank{r}_{label}.pt"))
                  for r in range(2)]
        for key in P14_GRAD_LEAVES:
            dim = _gather_leaf(specs, key)
            got = shards[0][key] if dim is None else torch.cat(
                [s[key] for s in shards], dim)
            if dim is None and not torch.equal(shards[0][key],
                                               shards[1][key]):
                raise AssertionError(f"{label}: {key} differs by rank")
            want = dense[key]
            gaps[key] = float((got - want).abs().max()
                              / want.abs().max().clamp_min(1e-30))
        run0 = recs[0]["runs"][label]
        log(f"  (b) {label} (TP 2, gloo world of 2 on the card, batch "
            f"{P14_BATCH_B}, fused): loss {losses[0]:.6f} on both ranks, "
            f"dense {dense_loss:.6f} (rel {rel:.2e}); gradient gaps "
            f"{({k: f'{v:.2e}' for k, v in gaps.items()})}; step "
            f"{run0['step_ms'][0]:.1f} ms; peaks "
            f"{[round(rec['runs'][label]['peak_gib'], 2) for rec in recs]} "
            f"GiB; collectives {run0['collectives'][0]}; launches "
            f"{run0['launches']}")
        if rel > loss_tol or max(gaps.values()) > grad_tol:
            raise AssertionError(f"{label}: the TP 2 step differs from the "
                                 f"dense step")
        for name in P14_FUSED_KERNELS:
            if run0["launches"].get(name, 0) <= 0:
                raise AssertionError(f"{label}: {name} did not launch")
        _add_launches(launches, recs, label)
        rows.append({"leg": f"b {label}", "loss": losses[0],
                     "dense_loss": dense_loss, "rel": rel, "grad_gaps": gaps,
                     "step_ms": run0["step_ms"],
                     "collectives": run0["collectives"][0],
                     "peaks_gib": [rec["runs"][label]["peak_gib"]
                                   for rec in recs]})
    if "tp2_sp" not in recs[0]["runs"]:
        missing = [n for n in P14_COLLECTIVES if probe[n] != "ok"]
        log(f"  (b) sequence parallelism left out on the card: gloo "
            f"refused {missing} on CUDA tensors (the CPU tests cover it)")
    micro = [rec["runs"]["tp2"]["micro"] for rec in recs]
    worst = max(m["worst"] for m in micro)
    log(f"  (d) microbatch calculator: {micro[0]['microbatches']} "
        f"microbatches through accumulate_main_grads, fp32 main_grad mean "
        f"against the one-batch gradient: worst leaf {worst:.2e} of its "
        f"largest entry; {micro[0]['ms']:.1f} ms")
    if micro[0]["microbatches"] != 4 or worst > grad_tol:
        raise AssertionError(f"(d) microbatches: {micro}")
    rows.append({"leg": "d microbatches", "ranks": micro})
    return probe


def _shard_bounds(batch):
    """Bounds of the kernels whose shapes config #4's shards change: flash
    attention over 2 heads, bias-GeLU over 512 columns, packed Adam over a
    rank's shard (bytes as phase 2 counts them)."""
    b, n, s, d = batch, N_HEADS // 8, P14_SEQ, HEAD_DIM
    rows, cols = batch * P14_SEQ, 4 * HIDDEN // 8
    flops = _attn_flops(b, n, s, s, d, True)
    fwd = bound(4 * b * n * s * d * 2 + b * n * s * 4, flops, BF16_TC_FLOPS)
    bwd = bound(8 * b * n * s * d * 2 + b * n * s * 4, 2.5 * flops,
                BF16_TC_FLOPS)
    shard = sum(t.numel() for t in tree_leaves(shard_gpt_params(
        gpt345m_param_shapes(), p14_cfg(tensor_model_parallel_size=8), 0,
        8)))
    return {"flash_attn_fwd": fwd, "flash_attn_bwd": bwd,
            "bias_gelu_fwd": bound(2 * rows * cols * 2 + cols * 2,
                                   20 * rows * cols),
            "bias_gelu_bwd": bound(3 * rows * cols * 2 + cols * 6,
                                   30 * rows * cols),
            "packed_adam": bound(shard * (2 + 2 + 3 * 8), 16 * shard)}


def tp8_leg(dev, rows, launches, tmp):
    """(c) BASELINE config #4: the 345M at TP 8 with the fused tails
    (``fused_block=True``, the ``fused_dense`` GEMM + bias + GeLU shape on
    4h / 8 = 512 columns) and packed FusedAdam on each rank's shard, in a
    gloo world of 8 on the card, 2 + 3 steps at batch ``P14_BATCH_C``:
    the loss falling and the same on every rank, p50, every rank's peak,
    the collectives a step, rank 0's profile of the second warm-up step
    and its kernels' device time a launch beside their bounds at the
    shard shapes."""
    spec = {"tp": 8, "batch": P14_BATCH_C, "device": str(dev), "warm": 2,
            "profile_step": 1,
            "runs": [["tp8", {}, 5]]}
    recs, _ = _spawn_p14(tmp, 8, spec)
    runs = [rec["runs"]["tp8"] for rec in recs]
    losses = runs[0]["losses"]
    if any(r["losses"] != losses for r in runs):
        raise AssertionError(f"config #4 losses differ by rank: "
                             f"{[r['losses'] for r in runs]}")
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"config #4 losses: {losses}")
    timed = runs[0]["step_ms"][2:]
    p50 = float(np.percentile(timed, 50))
    peaks = [round(r["peak_gib"], 2) for r in runs]
    prof = runs[0]["profile"]
    per_launch = {k: (t / c if c else None, c)
                  for k, (c, t) in prof["kernels"].items()}
    bounds = _shard_bounds(P14_BATCH_C)
    log(f"  (c) config #4, TP 8 in a gloo world of 8 on the card, batch "
        f"{P14_BATCH_C}, fused, packed FusedAdam on the shards: losses "
        f"{losses} on every rank; step p50 {p50:.1f} ms (steps "
        f"{[round(t, 1) for t in runs[0]['step_ms']]}), "
        f"{P14_BATCH_C * P14_SEQ / (p50 / 1e3):.0f} tokens/s; peaks {peaks} "
        f"GiB (sum {sum(peaks):.1f}); collectives a step "
        f"{runs[0]['collectives'][-1]}; launches a step "
        f"{({k: v / 3 for k, v in runs[0]['launches'].items()})}")
    log(f"  (c) rank 0's profiled step: wall {prof['wall_ms']:.1f} ms, "
        f"device busy {prof['busy_ms']:.1f} ms")
    for dev_ms, count, key in prof["rows"]:
        log(f"    {dev_ms:9.3f} ms  x{count:6d}  {key[:90]}")
    for k, (ms, c) in per_launch.items():
        b = bounds.get(k)
        log(f"  (c) {k} at the shard shapes: "
            f"{'n/a' if ms is None else f'{ms:.4f}'} ms a launch over {c} "
            f"launches" + ("" if b is None else
                           f", bound {b[0]:.4f} ms ({b[1]})"))
    for name in P14_FUSED_KERNELS:
        if runs[0]["launches"].get(name, 0) <= 0:
            raise AssertionError(f"config #4: {name} did not launch")
    _add_launches(launches, recs, "tp8")
    rows.append({"leg": "c config #4 tp8", "losses": losses,
                 "step_ms": runs[0]["step_ms"], "p50_ms": p50,
                 "peaks_gib": peaks,
                 "collectives_per_step": runs[0]["collectives"][-1],
                 "profile_wall_ms": prof["wall_ms"],
                 "profile_busy_ms": prof["busy_ms"],
                 "kernel_ms_per_launch": {k: v[0] for k, v in
                                          per_launch.items()},
                 "shard_bounds_ms": {k: v[0] for k, v in bounds.items()}})


def examples_leg(dev, rows, launches):
    """(e) The two single-device examples' CLIs on the card: fp8_training
    at its defaults for 20 steps (every loss finite, the last below the
    first) and the DCGAN for 20 steps (every loss finite)."""
    import io

    from apex_tpu_torch.examples.dcgan import main_amp as dcgan
    from apex_tpu_torch.examples.gpt import fp8_training

    out = {}
    for name, fn, argv in (("fp8_training", fp8_training.main,
                            ["--steps", "20"]),
                           ("dcgan", dcgan.main, ["--steps", "20"])):
        buf = io.StringIO()
        _device.reset_launch_counts()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            printed = fn(argv)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        for k, c in _device.launch_counts().items():
            launches[k] = launches.get(k, 0) + c
        for line in buf.getvalue().splitlines():
            log(f"  | {line}")
        vals = [v for row in printed for v in row[1:]]
        if not vals or not all(np.isfinite(vals)):
            raise AssertionError(f"{name}: {printed}")
        out[name] = {"printed": printed, "s": secs}
    fp8_losses = [l for _, l in out["fp8_training"]["printed"]]
    if not fp8_losses[-1] < fp8_losses[0]:
        raise AssertionError(f"fp8_training loss did not fall: {fp8_losses}")
    log(f"  (e) fp8_training 20 steps in {out['fp8_training']['s']:.1f} s, "
        f"dcgan 20 steps in {out['dcgan']['s']:.1f} s")
    rows.append({"leg": "e examples", **out})


def _side_by_side(fns, dev, rows, launches, *rest):
    """Run legs at once, each in a thread of its own with rows and
    launches of its own (merged after, in the legs' order): legs whose
    work is a gloo world of processes on the card (the main process only
    starts them, waits, and reads their records), so that one world's
    start-up and host-bound steps overlap the other's. Their step times
    are taken with the other world's processes on the same card and
    host."""
    parts = [([], {}) for _ in fns]
    if len(fns) == 1:
        outs = [fns[0](dev, *parts[0], *rest)]
    else:
        with concurrent.futures.ThreadPoolExecutor(len(fns)) as pool:
            futures = [pool.submit(fn, dev, *part, *rest)
                       for fn, part in zip(fns, parts)]
            outs = [f.result() for f in futures]
    for leg_rows, leg_launches in parts:
        rows.extend(leg_rows)
        for k, n in leg_launches.items():
            launches[k] = launches.get(k, 0) + n
    return outs


def tp_phase(dev):
    """Phase 14: tensor and sequence parallelism on one card, on two
    transports. (a) NCCL at world 1 over a ``file://`` store: the
    collectives' path and cost, no reduction across cards. (b)-(d) gloo
    worlds of 2 and 8 processes sharing the card (NCCL refuses two ranks
    on one device): the kernels run on the card at the shard shapes and
    the collectives travel through the host, so the step times are the
    host's reductions, not NVLink's. (e) the two single-device examples.
    Prints a ``{"phase14": [...]}`` line; returns the main paths'
    launches."""
    rows, launches, parts = [], {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        for key, fns, args in (("a", (tp1_leg,), (rows, launches, tmp)),
                               ("b+c", (tp2_leg, tp8_leg),
                                (rows, launches, tmp)),
                               ("e", (examples_leg,), (rows, launches))):
            t0 = time.perf_counter()
            _side_by_side(fns, dev, *args)
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            parts[key] = round(time.perf_counter() - t0, 1)
    log(f"  phase 14 parts (s): {parts}")
    print(json.dumps({"phase14": rows}), flush=True)
    return launches


# ---------------------------------------------------------------------------
# phase 15: pipeline and context parallelism (A6.5), the long-context
# example (A5.7.2), BASELINE config #5
# ---------------------------------------------------------------------------

#: leg (b): the 345M (24 x 1024, seq 1024, P14_VOCAB) at PP 4, 8
#: microbatches of 1, 1 warm-up + 2 timed steps a schedule
P15_PP, P15_MICRO, P15_STEPS = 4, 8, 3
#: the layer gradients (of the stages, put back in layer order) and the
#: word table's (stage 0's, synced over the embedding group) held against
#: the dense step's
P15_GRAD_LEAVES = ("layers/qkv_w", "layers/fc2_w", "layers/input_ln_w",
                   "layers/post_ln_b", "embedding/word")
#: leg (c), BASELINE config #5: GPT-3 XL (Brown et al. 2020, table 2.1: 24
#: layers, d_model 2048, ffn 8192, seq 2048) with Megatron-LM's 16 heads of
#: 128 (the paper's 24 do not divide by TP 8), vocab 50304; the layout
#: (tp, pp, vpp) and 4 microbatches of 1, 1 warm-up + 2 timed steps. The
#: configuration's TP 8 x PP 4 does not fit as 32 processes on one card:
#: measured (H100 80GB HBM3, 700 W) at allocator peaks of 1.10-1.45 GiB a
#: rank and 80,740 MiB of the card in use, 25.6-35.6 s a step; so the leg
#: runs TP 2 x PP 4 (a world of 8) at the same width and depth
C5_LAYERS, C5_HIDDEN, C5_HEADS, C5_SEQ = 24, 2048, 16, 2048
C5_TP, C5_PP, C5_VPP, C5_MICRO, C5_STEPS = 2, 4, 2, 4, 3
C5_CLIP = 1.0
#: leg (d): context parallelism at the 345M's width, seq 16384 (4096
#: tokens a rank at CP 4), batch 1, 1 warm-up + 2 steps a layout; depth cut
#: to 8 layers (each layer's ring moves ~235 MB a rank a step through the
#: host: 7.8 s a step at 24 layers)
P15_CP, P15_CP_SEQ, P15_CP_LAYERS, P15_CP_STEPS = 4, 16384, 8, 3
#: the kernels the pipelined and context-parallel steps must launch, and
#: config #5's with its clip
P15_KERNELS = TRAIN_KERNELS
C5_KERNELS = TRAIN_KERNELS + ("packed_row_reduce",)
#: the collectives counted a step, beside the point-to-point ops
P15_COLLECTIVES = P14_COLLECTIVES
#: leg (d)'s ring chunk checks: the kernels against their plain versions
#: with the global (merged) o and lse; bf16 results within one bf16
#: rounding of values of order 1 (TOL)
RING_TOL = TOL[torch.bfloat16]


def p15_cfg(layers, hidden, heads, seq, vocab, **kw) -> GPTConfig:
    return GPTConfig(num_layers=layers, hidden_size=hidden,
                     num_attention_heads=heads, vocab_size=vocab,
                     max_position_embeddings=seq, hidden_dropout=0.0,
                     attention_dropout=0.0, compute_dtype=torch.bfloat16,
                     apply_query_key_layer_scaling=False, **kw)


def _seeded(dev, seed, shape, std):
    g = torch.Generator(device=dev).manual_seed(seed)
    return (torch.randn(shape, generator=g, device=dev) * std).to(
        torch.bfloat16)


def c5_rank_params(cfg, dev, rp, rt, tp, pp, vpp):
    """Config #5's parameters of rank ``(rp, rt)`` drawn shard by shard
    from seeds (a whole 1.3B tree a process would not fit 32 times): the
    Megatron init (normal 0.02, output projections over sqrt(2 L), zero
    biases, unit norms) of this stage's chunks at this tensor rank's
    shard shapes; the word rows of tensor rank ``rt`` (the same on the
    first and the last stage, the tied pair), the position table on the
    first stage, the final LayerNorm on the last."""
    h, L, ffn = cfg.hidden_size, cfg.num_layers, cfg.ffn_size
    lc = L // (pp * vpp)
    lead = (lc,) if vpp == 1 else (vpp, lc)
    std, out_std = 0.02, 0.02 / (2.0 * L) ** 0.5
    shapes = {"qkv_w": (3 * h // tp, h, std), "proj_w": (h, h // tp, out_std),
              "fc1_w": (ffn // tp, h, std), "fc2_w": (h, ffn // tp, out_std)}
    layers = {}
    for i, (k, (a, b, sd)) in enumerate(sorted(shapes.items())):
        layers[k] = _seeded(dev, 1000 * i + 10 * rp + rt, lead + (a, b), sd)
    zeros = {"qkv_b": 3 * h // tp, "proj_b": h, "fc1_b": ffn // tp,
             "fc2_b": h, "input_ln_b": h, "post_ln_b": h}
    for k, n in zeros.items():
        layers[k] = torch.zeros(lead + (n,), dtype=torch.bfloat16, device=dev)
    for k in ("input_ln_w", "post_ln_w"):
        layers[k] = torch.ones(lead + (h,), dtype=torch.bfloat16, device=dev)
    params = {"layers": layers}
    if rp == 0 or rp == pp - 1:
        params["word"] = _seeded(dev, 7000 + rt, (cfg.vocab_size // tp, h),
                                 std)
    if rp == 0:
        params["position"] = _seeded(dev, 8000,
                                     (cfg.max_position_embeddings, h), std)
    if rp == pp - 1:
        params["final_ln_w"] = torch.ones(h, dtype=torch.bfloat16, device=dev)
        params["final_ln_b"] = torch.zeros(h, dtype=torch.bfloat16,
                                           device=dev)
    return params


def stage_params_of(full, cfg, rp, rt, tp, pp, vpp):
    """This rank's tree cut from a whole (seeded) tree: its tensor shard's
    stage layers, the word rows on the first and last stages, the position
    table on the first, the final LayerNorm on the last."""
    shard = shard_gpt_params(full, cfg, rt, tp) if tp > 1 else full
    params = {"layers": pipeline_stage_layers(shard["layers"], cfg, rp, pp,
                                              vpp)}
    if rp == 0 or rp == pp - 1:
        params["word"] = shard["embedding"]["word"]
    if rp == 0:
        params["position"] = shard["embedding"]["position"]
    if rp == pp - 1:
        params["final_ln_w"] = shard["final_ln_w"]
        params["final_ln_b"] = shard["final_ln_b"]
    return params


def pipelined_gpt_grads(cfg, params, tokens, labels, schedule, rp, pp):
    """The GPT composed around a pipeline ``schedule`` in the reference's
    tied-embedding form: the embedding on the first stage outside the
    schedule, the stage's layers inside it, the final LayerNorm, the tied
    head and the loss on the last stage's final chunk (the dense
    chunk-fused cross entropy at TP 1, else the vocab-parallel one), the
    embedding's backward from the schedule's input gradients, the word
    table's gradients summed over the embedding group (the first and last
    stages). ``params`` is this rank's tree (:func:`stage_params_of`);
    ``tokens``, ``labels`` ``[n_micro, b, s]``. Returns ``(loss, grads)``
    in ``params``' structure."""
    tp_axis = "tensor" if cfg.tensor_model_parallel_size > 1 else None
    first, last = rp == 0, rp == pp - 1
    n, b, s = tokens.shape
    h, dt = cfg.hidden_size, cfg.compute_dtype
    dev = tokens.device
    live = {k: (v.detach().requires_grad_(True) if k != "layers" else v)
            for k, v in params.items()}
    if first:
        emb_params = {"embedding": {"word": live["word"],
                                    "position": live["position"]}}
        emb = torch.stack([gpt_embed(cfg, emb_params, tokens[m],
                                     axis_name=tp_axis) for m in range(n)])
    else:
        emb = torch.empty((n, s, b, h), dtype=dt, device=dev)
    rows = s * b
    chunk = next(c for c in range(min(2048, rows), 0, -1) if rows % c == 0)

    def loss_fn(y, lab):
        hid = ln_fp32(y, live["final_ln_w"], live["final_ln_b"],
                      cfg.layernorm_epsilon).to(dt)
        if tp_axis is None:
            return lm_head_cross_entropy(
                hid.reshape(rows, h), live["word"],
                lab.transpose(0, 1).reshape(rows), chunk_size=chunk).mean()
        logits = _lm_head(cfg, {"embedding": {"word": live["word"]}}, hid,
                          tp_axis).transpose(0, 1)
        return vocab_parallel_cross_entropy(logits, lab, 0.0,
                                            tp_axis).mean()

    def stage_fn(lp, x):
        return transformer_block(cfg, lp, x, None, axis_name=tp_axis)

    loss, glayers, dinputs = schedule(stage_fn, loss_fn, params["layers"],
                                      emb.detach(), labels)
    if first:
        emb.backward(dinputs)
    grads = {"layers": glayers}
    for k, v in live.items():
        if k != "layers":
            grads[k] = v.grad if v.grad is not None else torch.zeros_like(v)
    word = grads.get("word")
    if word is None:  # a middle stage takes part in the group's sum
        word = torch.zeros((cfg.vocab_size // cfg.tensor_model_parallel_size,
                            h), dtype=torch.bfloat16, device=dev)
    word = pp_utils.sync_embedding_grads({"w": word})["w"]
    if "word" in grads:
        grads["word"] = word
    return loss, grads


def warm_stage(cfg, params, tokens, labels, rp, pp, vpp):
    """One microbatch through this stage alone, forward and backward, no
    hop: every stage's process loads its kernels and libraries at once
    (in a pipeline's first step they would load one stage after another,
    each waiting for the last: ~9 s a process on the card, measured)."""
    tp_axis = "tensor" if cfg.tensor_model_parallel_size > 1 else None
    lp = {k: (v[0] if vpp > 1 else v).detach().requires_grad_(True)
          for k, v in params["layers"].items()}
    live = {k: v.detach().requires_grad_(True) for k, v in params.items()
            if k != "layers"}
    if rp == 0:
        x = gpt_embed(cfg, {"embedding": {"word": live["word"],
                                          "position": live["position"]}},
                      tokens[0], axis_name=tp_axis)
    else:
        x = torch.zeros((tokens.shape[2], tokens.shape[1], cfg.hidden_size),
                        dtype=cfg.compute_dtype, device=tokens.device,
                        requires_grad=True)
    y = transformer_block(cfg, lp, x, None, axis_name=tp_axis)
    out = y.float().sum()
    if rp == pp - 1:
        hid = ln_fp32(y, live["final_ln_w"], live["final_ln_b"],
                      cfg.layernorm_epsilon).to(cfg.compute_dtype)
        if tp_axis is None:
            rows = hid.shape[0] * hid.shape[1]
            chunk = next(c for c in range(min(2048, rows), 0, -1)
                         if rows % c == 0)
            out = out + lm_head_cross_entropy(
                hid.reshape(rows, -1), live["word"],
                labels[0].transpose(0, 1).reshape(rows),
                chunk_size=chunk).mean()
        else:
            logits = _lm_head(cfg, {"embedding": {"word": live["word"]}},
                              hid, tp_axis).transpose(0, 1)
            out = out + vocab_parallel_cross_entropy(
                logits, labels[0], 0.0, tp_axis).mean()
    out.backward()
    torch.cuda.synchronize()


def _layer_order(stage_grads, key, pp, vpp):
    """A stacked layer gradient back in layer order from the stages'
    chunks (chunk c of stage s = layer block c pp + s)."""
    blocks = {}
    for s, g in enumerate(stage_grads):
        chunks = [g] if vpp == 1 else list(g)
        for c, ch in enumerate(chunks):
            blocks[c * pp + s] = ch
    return torch.cat([blocks[i] for i in range(pp * vpp)])


@contextlib.contextmanager
def host_seconds(acc):
    """Accumulate into ``acc`` the host seconds spent in the exchanges of
    the schedules and the ring (``"p2p_s"``) and in ``all_reduce``
    (``"all_reduce_s"``, the collectives of the mappings, the loss, the
    syncs): where a gloo world's step time goes."""
    dist = torch.distributed
    sched = pp_schedules.common
    real = (sched.exchange, cp_mod.exchange, dist.all_reduce)

    def timed(fn, key):
        def run(*a, **k):
            t0 = time.perf_counter()
            try:
                return fn(*a, **k)
            finally:
                acc[key] = acc.get(key, 0.0) + time.perf_counter() - t0
        return run
    sched.exchange = timed(real[0], "p2p_s")
    cp_mod.exchange = timed(real[1], "p2p_s")
    dist.all_reduce = timed(real[2], "all_reduce_s")
    try:
        yield
    finally:
        sched.exchange, cp_mod.exchange, dist.all_reduce = real


def _p15_step_loop(rank, label, steps, warm, one_step, run, profile=None):
    """``steps`` steps of ``one_step`` with the collectives and the
    point-to-point ops of each counted and their host seconds taken, the
    launches from step ``warm`` on; the first step profiled on rank 0
    with ``profile``."""
    p2p = pp_p2p
    torch.cuda.reset_peak_memory_stats()
    run.setdefault("host_s", [])
    for i in range(steps):
        if i == warm:
            _device.reset_launch_counts()
        counts, secs = {}, {}
        p2p.reset_p2p_counts()
        cp_mod.reset_ring_counts()
        with counted_collectives(counts), host_seconds(secs):
            t0 = time.perf_counter()
            if i == 0 and profile is not None and rank == 0:
                prof = profiled(one_step, label, 14)
                run["profile"] = {
                    "wall_ms": prof["wall_ms"], "busy_ms": prof["busy_ms"],
                    "rows": prof["rows"][:14],
                    "kernels": {k: [
                        sum(n for key, (n, _) in prof["ops"].items()
                            if any(m in key for m in ms)),
                        sum(t for key, (_, t) in prof["ops"].items()
                            if any(m in key for m in ms))]
                        for k, ms in profile.items()}}
            else:
                one_step()
            torch.cuda.synchronize()
            run["step_ms"].append((time.perf_counter() - t0) * 1e3)
        run["collectives"].append(counts)
        run["host_s"].append({k: round(v, 3) for k, v in secs.items()})
        run["p2p"].append(p2p.p2p_counts())
        run["ring"].append(dict(cp_mod.RING_COUNTS))
    run["launches"] = {k: v for k, v in _device.launch_counts().items() if v}
    run["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30


def _empty_run():
    return {"losses": [], "step_ms": [], "collectives": [], "p2p": [],
            "ring": []}


def _p15_pp_runs(res, spec, dev, rank, out):
    """(b) This stage of the 345M at PP 4: 1F1B, then the interleaved
    schedule (vpp 2), each from the seeded starting weights, packed
    FusedAdam (fp32 masters) on the stage's tree."""
    parallel_state.initialize_model_parallel(1, P15_PP)
    rp = parallel_state.get_pipeline_model_parallel_rank()
    cfg = p14_cfg()
    full, tokens, labels = p14_model(cfg, dev, P15_MICRO)
    tokens = tokens.reshape(P15_MICRO, 1, -1)
    labels = labels.reshape(P15_MICRO, 1, -1)
    for label, vpp in (("1f1b", 1), ("interleaved", 2)):
        if vpp > 1:
            parallel_state.set_virtual_pipeline_model_parallel_world_size(vpp)
        schedule = (pp_schedules.pipeline_forward_backward_1f1b
                    if vpp == 1 else get_forward_backward_func())
        params = stage_params_of(full, cfg, rp, 0, 1, P15_PP, vpp)
        if vpp == 1:
            warm_stage(cfg, params, tokens, labels, rp, P15_PP, vpp)
        opt = FusedAdam(lr=1e-4, master_weights=True, packed=True)
        box = {"p": params, "s": opt.init(params)}
        run = _empty_run()
        run["schedule"] = schedule.__name__

        def one_step():
            loss, grads = pipelined_gpt_grads(cfg, box["p"], tokens, labels,
                                              schedule, rp, P15_PP)
            if not run["losses"]:  # the starting weights' gradients
                box["g0"] = {k: grads["layers"][k.split("/")[1]]
                             for k in P15_GRAD_LEAVES
                             if k.startswith("layers")}
                if rp == 0:
                    box["g0"]["embedding/word"] = grads["word"]
            box["p"], box["s"] = opt.step(grads, box["s"], box["p"])
            run["losses"].append(float(loss))

        _p15_step_loop(rank, label, P15_STEPS, 1, one_step, run)
        torch.save({k: v.float().cpu() for k, v in box["g0"].items()},
                   f"{out}/rank{rank}_{label}.pt")
        res["runs"][label] = run
        del box, opt, params
        torch.cuda.empty_cache()
        parallel_state.set_virtual_pipeline_model_parallel_world_size(None)
    if rank == 0:
        # the dense step on the same batch, for the parity (rank 0 alone)
        loss, grads = value_and_grad(
            lambda p: gpt_loss(cfg, p, tokens.reshape(P15_MICRO, -1),
                               labels.reshape(P15_MICRO, -1)), full)
        torch.save({k: _gather_leaf(grads, k).float().cpu()
                    for k in P15_GRAD_LEAVES}, f"{out}/dense.pt")
        res["dense_loss"] = float(loss)


def c5_rank_kernels_bounds(tp):
    """Bounds of config #5's kernels at a rank's shard shapes: flash over
    16 / tp heads of 128 at seq 2048, the LayerNorms over 2048 rows of
    2048, packed Adam over the rank's stage shard, the row reduction of
    the clip over its gradients (bytes as phase 2 counts them)."""
    b, n, s, d = 1, C5_HEADS // tp, C5_SEQ, C5_HIDDEN // C5_HEADS
    flops = _attn_flops(b, n, s, s, d, True)
    rows, h = s, C5_HIDDEN
    lc = C5_LAYERS // C5_PP
    per_layer = (12 * h * h) // tp + 7 * h + (13 * h) // tp
    shard = lc * per_layer + (50304 // tp) * h
    return {"flash_attn_fwd": bound(4 * b * n * s * d * 2 + b * n * s * 4,
                                    flops, BF16_TC_FLOPS),
            "flash_attn_bwd": bound(8 * b * n * s * d * 2 + b * n * s * 4,
                                    2.5 * flops, BF16_TC_FLOPS),
            "layer_norm_fwd": bound(rows * h * (2 + 2) + 2 * h * 2
                                    + rows * 8, 8 * rows * h),
            "layer_norm_bwd": bound(rows * h * 2 * 3 + rows * 8
                                    + 2 * h * 4, 12 * rows * h),
            "packed_adam": bound(shard * (2 + 2 + 3 * 8), 16 * shard),
            "packed_row_reduce": bound(shard * 2, 2 * shard)}


C5_MATCH = {"layer_norm_fwd": ("::ln_fwd_",), "layer_norm_bwd": ("norm_bwd_",),
            "flash_attn_fwd": ("flash_fwd_tc_kernel",),
            "flash_attn_bwd": ("flash_bwd_dq_tc_kernel",
                               "flash_bwd_dkv_tc_kernel"),
            "packed_adam": ("packed_adam_kernel",),
            "packed_row_reduce": ("row_reduce",)}

#: the leaves replicated over the tensor axis (counted once in the
#: model-parallel gradient norm, on tensor rank 0)
C5_TP_REPLICATED = ("['layers']['input_ln_w']", "['layers']['input_ln_b']",
                    "['layers']['post_ln_w']", "['layers']['post_ln_b']",
                    "['layers']['proj_b']", "['layers']['fc2_b']",
                    "['position']", "['final_ln_w']", "['final_ln_b']")


def _p15_c5_run(res, spec, dev, rank, out):
    """(c) BASELINE config #5 on this rank: the interleaved schedule
    (``get_forward_backward_func`` with vpp set), the gradient clip over
    the model-parallel group (``calc_params_l2_norm``: the row reduction,
    the replicated leaves counted once; the last stage's copy of the tied
    table left out, as Megatron leaves out shared parameters), packed
    FusedAdam on the rank's shard."""
    tp, pp, vpp = spec["tp"], spec["pp"], spec["vpp"]
    parallel_state.initialize_model_parallel(tp, pp, vpp)
    rp = parallel_state.get_pipeline_model_parallel_rank()
    rt = parallel_state.get_tensor_model_parallel_rank()
    cfg = p15_cfg(C5_LAYERS, C5_HIDDEN, C5_HEADS, C5_SEQ, P14_VOCAB,
                  tensor_model_parallel_size=tp)
    params = c5_rank_params(cfg, dev, rp, rt, tp, pp, vpp)
    g = torch.Generator(device=dev).manual_seed(1)
    tokens = torch.randint(0, cfg.vocab_size, (C5_MICRO, 1, C5_SEQ),
                           device=dev, generator=g)
    labels = torch.roll(tokens, -1, dims=2)
    schedule = get_forward_backward_func()
    warm_stage(cfg, params, tokens, labels, rp, pp, vpp)
    opt = FusedAdam(lr=1e-4, master_weights=True, packed=True)
    box = {"p": params, "s": opt.init(params)}
    run = _empty_run()
    run["schedule"] = schedule.__name__
    run["norms"] = []

    def one_step():
        loss, grads = pipelined_gpt_grads(cfg, box["p"], tokens, labels,
                                          schedule, rp, pp)
        counted = dict(grads)
        if rp == pp - 1 and pp > 1:
            counted.pop("word")
        norm = pp_utils.calc_params_l2_norm(
            counted, tp_duplicate_paths=C5_TP_REPLICATED,
            axis_name=("pipeline", "tensor"))
        coef = torch.clamp(C5_CLIP / (norm + 1e-6), max=1.0)
        grads = tree_map(lambda t: (t.float() * coef).to(t.dtype), grads)
        box["p"], box["s"] = opt.step(grads, box["s"], box["p"])
        run["losses"].append(float(loss))
        run["norms"].append(float(norm))

    _p15_step_loop(rank, "config #5 rank 0 step", C5_STEPS, 1, one_step, run,
                   profile=C5_MATCH)
    run["param_count"] = sum(t.numel() for t in tree_leaves(box["p"]))
    res["runs"]["c5"] = run


def card_memory_peak(fn):
    """``(fn(), peak MiB of the card in use)``: ``nvidia-smi``'s
    ``memory.used`` sampled every 2 s while ``fn`` runs (its per-process
    list is empty on the chip's machine, so a world's processes are read
    together)."""
    import threading

    peak, done = [0.0], threading.Event()

    def poll():
        while not done.is_set():
            try:
                out = subprocess.run(
                    ["nvidia-smi", "--query-gpu=memory.used",
                     "--format=csv,noheader,nounits"], capture_output=True,
                    text=True, timeout=20).stdout
                peak[0] = max(peak[0], float(out.split()[0]))
            except (OSError, subprocess.SubprocessError, ValueError,
                    IndexError):
                pass
            done.wait(2.0)

    th = threading.Thread(target=poll, daemon=True)
    th.start()
    try:
        out = fn()
    finally:
        done.set()
        th.join()
    return out, peak[0]


def _cp_shard(t, cp, r, zigzag):
    """Rank r's shard of ``t [b, s]`` (or ``[b, n, s, d]`` along dim 2)."""
    dim = 1 if t.dim() == 2 else 2
    s = t.shape[dim]
    if zigzag:
        idx = torch.from_numpy(cp_mod.zigzag_indices(s, cp)[0]).to(t.device)
        t = t.index_select(dim, idx)
    n = s // cp
    return t.narrow(dim, r * n, n).contiguous()


def _gloo_a2a_probe(dev, world):
    """Whether gloo takes ``all_to_all_single`` on CUDA tensors and moves
    the right values (a probe of the transport Ulysses takes its tensors
    through as they lie): ``"ok"``, or what went wrong."""
    dist = torch.distributed
    rank = dist.get_rank()
    x = torch.arange(world * 4, dtype=torch.float32, device=dev) + 100 * rank
    out = torch.empty_like(x)
    try:
        dist.all_to_all_single(out, x)
        torch.cuda.synchronize()
    except Exception as e:  # the probe's answer, not a failed leg
        return f"{type(e).__name__}: {str(e)[:200]}"
    want = torch.cat([torch.arange(rank * 4, rank * 4 + 4, device=dev)
                      + 100 * j for j in range(world)]).float()
    return "ok" if torch.equal(out, want) else f"wrong values: {out.tolist()}"


def _p15_cp_runs(res, spec, dev, rank, out):
    """(d) This rank of the 345M-wide GPT at CP 4 over seq 16384: zigzag,
    then contiguous, each from the seeded starting weights, packed
    FusedAdam; then Ulysses at [1, 16, 16384, 64] forward and backward."""
    res["a2a_probe"] = _gloo_a2a_probe(dev, P15_CP)
    if res["a2a_probe"] != "ok":
        raise AssertionError(f"gloo all_to_all_single: {res['a2a_probe']}")
    world = P15_CP
    base = p15_cfg(P15_CP_LAYERS, HIDDEN, N_HEADS, P15_CP_SEQ, P14_VOCAB)
    full = tree_map(lambda p: p.to(torch.bfloat16), init_gpt_params(
        base, torch.Generator(device=dev).manual_seed(0), device=dev))
    g = torch.Generator(device=dev).manual_seed(1)
    tokens = torch.randint(0, base.vocab_size, (1, P15_CP_SEQ), device=dev,
                           generator=g)
    labels = torch.roll(tokens, -1, dims=1)
    for label, zig in (("zigzag", True), ("contiguous", False)):
        cfg = dataclasses.replace(base, context_parallel_axis="cp",
                                  context_parallel_zigzag=zig)
        tok = _cp_shard(tokens, world, rank, zig)
        lab = _cp_shard(labels, world, rank, zig)
        opt = FusedAdam(lr=1e-4, master_weights=True, packed=True)
        box = {"p": tree_map(torch.clone, full)}
        box["s"] = opt.init(box["p"])
        run = _empty_run()

        def one_step():
            loss, grads = value_and_grad(
                lambda p: gpt_loss(cfg, p, tok, lab), box["p"])
            if not run["losses"] and rank == 0:
                box["g0"] = {k: _gather_leaf(grads, k)
                             for k in P14_GRAD_LEAVES}
            box["p"], box["s"] = opt.step(grads, box["s"], box["p"])
            run["losses"].append(float(loss))

        _p15_step_loop(rank, label, P15_CP_STEPS, 1, one_step, run)
        if rank == 0:
            torch.save({k: v.float().cpu() for k, v in box["g0"].items()},
                       f"{out}/rank0_{label}.pt")
        res["runs"][label] = run
        del box, opt
        torch.cuda.empty_cache()
    del full
    # Ulysses: forward and backward across the ranks against flash
    # attention on the whole sequence (rank 0) and the plain version on
    # rank 0's rows
    gq = torch.Generator(device=dev).manual_seed(5)
    q, k, v, do = (torch.randn((1, N_HEADS, P15_CP_SEQ, HEAD_DIM),
                               generator=gq, device=dev,
                               dtype=torch.bfloat16) for _ in range(4))
    shards = [_cp_shard(t, world, rank, False).requires_grad_(True)
              for t in (q, k, v)]
    _device.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    o = cp_mod.ulysses_attention(*shards, axis_name="cp", causal=True)
    o.backward(_cp_shard(do, world, rank, False))
    torch.cuda.synchronize()
    uly = {"ms": (time.perf_counter() - t0) * 1e3,
           "launches": {k: c for k, c in _device.launch_counts().items()
                        if c}}
    if rank == 0:
        n = P15_CP_SEQ // world
        full_in = [t.clone().requires_grad_(True) for t in (q, k, v)]
        of = fa_mod.flash_attention(*full_in, causal=True)
        of.backward(do)
        uly["vs_flash"] = [_rel_gap(a, b[:, :, :n]) for a, b in zip(
            (o, *(t.grad for t in shards)),
            (of, *(t.grad for t in full_in)))]
        ref = mha_reference(q[:, :, :n], k[:, :, :n], v[:, :, :n],
                            causal=True)
        uly["vs_plain"] = _rel_gap(o, ref)
    res["ulysses"] = uly


def _rel_gap(got, want) -> float:
    """The worst gap over the largest entry of ``want`` (in fp64)."""
    got, want = got.detach().double(), want.detach().double()
    return float((got - want).abs().max()
                 / want.abs().max().clamp_min(1e-30))


def p15_worker(rank: int, world: int, store: str, out: str, spec: str):
    """One rank of a gloo world on the card for phase 15's legs (b), (c)
    or (d) (``spec["leg"]``); writes ``rank<r>.json`` (and gradient
    files) into ``out``."""
    spec = json.loads(spec)
    dist = torch.distributed
    dev = torch.device(spec["device"])
    if dev.type == "cuda":
        dev = torch.device("cuda", dev.index or 0)
        torch.cuda.set_device(dev)
    torch.backends.cuda.matmul.allow_tf32 = False
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            world_size=world, rank=rank)
    res = {"rank": rank, "runs": {}}
    try:
        _build.kernels()
        {"pp": _p15_pp_runs, "c5": _p15_c5_run,
         "cp": _p15_cp_runs}[spec["leg"]](res, spec, dev, rank, out)
    finally:
        parallel_state.destroy_model_parallel()
        dist.destroy_process_group()
    with open(f"{out}/rank{rank}.json", "w") as f:
        json.dump(res, f)


def nopipe_leg(dev, rows, launches, tmp):
    """(a) NCCL at world 1, pp 1: ``get_forward_backward_func`` picks the
    no-pipelining schedule; the 345M unfused step over 4 microbatches of 2
    (gradients summed in fp32 over the microbatches, then packed FusedAdam)
    against the dense batch-8 step on the same weights: the loss within
    1e-4 relative, every leaf's gradient gap stated."""
    dist = torch.distributed
    dist.init_process_group("nccl", init_method=f"file://{tmp}/store15",
                            world_size=1, rank=0)
    try:
        parallel_state.initialize_model_parallel(1, 1)
        fn = get_forward_backward_func()
        cfg = p14_cfg()
        params, tokens, labels = p14_model(cfg, dev, P14_BATCH_A)
        dense_loss, dense = value_and_grad(
            lambda p: gpt_loss(cfg, p, tokens, labels), params)
        micro = (tokens.reshape(4, 2, -1), labels.reshape(4, 2, -1))
        opt = FusedAdam(lr=1e-4, master_weights=True, packed=True)
        state = opt.init(params)
        _device.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss, grads = fn(lambda p, mb: gpt_loss(cfg, p, mb[0], mb[1]),
                         lambda out, ex: out, params, micro)
        new, state = opt.step(tree_map(lambda g, p: g.to(p.dtype), grads,
                                       params), state, params)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        got = _device.launch_counts()
    finally:
        parallel_state.destroy_model_parallel()
        dist.destroy_process_group()
    for k, c in got.items():
        launches[k] = launches.get(k, 0) + c
    rel = abs(float(loss) - float(dense_loss)) / abs(float(dense_loss))
    leaves, treedef = tree_flatten(grads)
    gaps = {path: float((a.float() - b.float()).abs().max()
                        / b.float().abs().max().clamp_min(1e-30))
            for path, a, b in zip(leaf_paths(treedef), leaves,
                                  tree_leaves(dense))}
    log(f"  (a) pp 1 on NCCL world 1: {fn.__name__}, 345M unfused, 4 "
        f"microbatches of 2: loss {float(loss):.6f} against the dense "
        f"batch-8 step's {float(dense_loss):.6f} (rel {rel:.2e}); the step "
        f"with the optimizer {ms:.1f} ms; worst leaf gap "
        f"{max(gaps.values()):.2e} ({max(gaps, key=gaps.get)}); launches "
        f"{({k: v for k, v in got.items() if v})}")
    if fn.__name__ != "forward_backward_no_pipelining":
        raise AssertionError(f"pp 1 dispatched to {fn.__name__}")
    if rel > 1e-4 or not np.isfinite(float(loss)):
        raise AssertionError(f"no-pipelining loss {float(loss)} against "
                             f"{float(dense_loss)}")
    for name in P15_KERNELS:
        if got.get(name, 0) <= 0:
            raise AssertionError(f"(a): {name} did not launch")
    rows.append({"leg": "a nopipe nccl", "loss": float(loss),
                 "dense_loss": float(dense_loss), "rel": rel, "ms": ms,
                 "grad_gaps": gaps})


def _add_runs(launches, recs, labels):
    for rec in recs:
        for label in labels:
            for k, c in rec["runs"][label]["launches"].items():
                launches[k] = launches.get(k, 0) + c


def pp_leg(dev, rows, launches, tmp):
    """(b) PP 4 in a gloo world of 4 on the card, the 345M at full width
    and depth: 1F1B, then the interleaved schedule (vpp 2, 3 layers a
    chunk), 8 microbatches of 1; the loss the same on every stage and
    within 1e-3 of the dense step's; gradient gaps by leaf against the
    dense step, p50 a schedule, every rank's peak, the P2P ops a step."""
    recs, out = _spawn_p14(tmp, P15_PP, {"leg": "pp", "device": str(dev)},
                           timeout=420,
                           worker="p15_worker", name="pp")
    dense_loss = recs[0]["dense_loss"]
    dense = torch.load(os.path.join(out, "dense.pt"))
    for label, vpp in (("1f1b", 1), ("interleaved", 2)):
        runs = [rec["runs"][label] for rec in recs]
        losses = [r["losses"] for r in runs]
        if any(l != losses[0] for l in losses):
            raise AssertionError(f"(b) {label}: losses differ by stage: "
                                 f"{losses}")
        rel = abs(losses[0][0] - dense_loss) / abs(dense_loss)
        stages = [torch.load(os.path.join(out, f"rank{r}_{label}.pt"))
                  for r in range(P15_PP)]
        gaps = {}
        for key in P15_GRAD_LEAVES:
            got = stages[0][key] if key == "embedding/word" else \
                _layer_order([st[key] for st in stages], key, P15_PP, vpp)
            want = dense[key]
            gaps[key] = float((got - want).abs().max()
                              / want.abs().max().clamp_min(1e-30))
        p50 = float(np.percentile(runs[0]["step_ms"][1:], 50))
        peaks = [round(r["peak_gib"], 2) for r in runs]
        log(f"  (b) PP 4 {label} ({runs[0]['schedule']}), gloo world of 4 "
            f"on the card, 345M, 8 microbatches of 1: losses {losses[0]} "
            f"on every stage, dense {dense_loss:.6f} (rel {rel:.2e}); "
            f"gradient gaps {({k: f'{v:.2e}' for k, v in gaps.items()})}; "
            f"step p50 {p50:.1f} ms (steps "
            f"{[round(t, 1) for t in runs[0]['step_ms']]}); host seconds in "
            f"the hops and all-reduces a step (rank 0) {runs[0]['host_s']}; "
            f"peaks {peaks} "
            f"GiB; P2P a step {[r['p2p'][-1] for r in runs]}; collectives "
            f"a step {runs[0]['collectives'][-1]}; launches a step "
            f"{[{k: v / (P15_STEPS - 1) for k, v in r['launches'].items()} for r in runs]}")
        if rel > 1e-3 or max(gaps.values()) > PARITY_TOL[torch.bfloat16][1]:
            raise AssertionError(f"(b) {label} differs from the dense step")
        for name in P15_KERNELS:
            if sum(r["launches"].get(name, 0) for r in runs) <= 0:
                raise AssertionError(f"(b) {label}: {name} did not launch")
        rows.append({"leg": f"b pp4 {label}", "losses": losses[0],
                     "dense_loss": dense_loss, "rel": rel, "grad_gaps": gaps,
                     "step_ms": runs[0]["step_ms"], "p50_ms": p50,
                     "peaks_gib": peaks,
                     "p2p_per_step": [r["p2p"][-1] for r in runs],
                     "collectives_per_step": runs[0]["collectives"][-1]})
    _add_runs(launches, recs, ("1f1b", "interleaved"))


def c5_leg(dev, rows, launches, tmp):
    """(c) BASELINE config #5: GPT-3 XL at TP x PP = ``C5_TP`` x ``C5_PP``
    interleaved (vpp ``C5_VPP``), 4 microbatches of 1 at seq 2048, in a
    gloo world of ``C5_TP * C5_PP`` processes on the card: the loss the
    same on every rank and finite, p50 and tokens/s, every rank's peak
    and device memory, the collectives and P2P ops a step, rank 0's
    kernels' device ms a launch at the shard shapes beside their bounds."""
    world = C5_TP * C5_PP
    spec = {"leg": "c5", "tp": C5_TP, "pp": C5_PP, "vpp": C5_VPP,
            "device": str(dev)}
    (recs, _), card_mib = card_memory_peak(lambda: _spawn_p14(
        tmp, world, spec, timeout=420, worker="p15_worker", name="c5"))
    runs = [rec["runs"]["c5"] for rec in recs]
    losses = runs[0]["losses"]
    if any(r["losses"] != losses for r in runs) or not all(
            np.isfinite(losses)):
        raise AssertionError(f"config #5 losses: {[r['losses'] for r in runs]}")
    timed = runs[0]["step_ms"][1:]
    p50 = float(np.percentile(timed, 50))
    tokens = C5_MICRO * C5_SEQ
    peaks = [round(r["peak_gib"], 2) for r in runs]
    prof = runs[0]["profile"]
    bounds = c5_rank_kernels_bounds(C5_TP)
    per_launch = {k: (t / c if c else None, c)
                  for k, (c, t) in prof["kernels"].items()}
    log(f"  (c) config #5, GPT-3 XL at TP {C5_TP} x PP {C5_PP} "
        f"({runs[0]['schedule']}, vpp {C5_VPP}), gloo world of {world} on "
        f"the card, {C5_MICRO} microbatches of 1 at seq {C5_SEQ}: losses "
        f"{losses} on every rank, grad norms {runs[0]['norms']}; step p50 "
        f"{p50:.1f} ms (steps {[round(t, 1) for t in runs[0]['step_ms']]}),"
        f" {tokens / (p50 / 1e3):.0f} tokens/s; peaks {peaks} GiB (sum "
        f"{sum(peaks):.1f}); host seconds in the hops and all-reduces a "
        f"step (rank 0) {runs[0]['host_s']}; the card's memory in use at "
        f"peak {card_mib:.0f} "
        f"MiB (nvidia-smi); parameters a "
        f"rank {[r['param_count'] for r in runs]}; collectives a step "
        f"{runs[0]['collectives'][-1]}; P2P a step {runs[0]['p2p'][-1]}; "
        f"launches a step {({k: v / (C5_STEPS - 1) for k, v in runs[0]['launches'].items()})}")
    log(f"  (c) rank 0's first step, profiled: wall {prof['wall_ms']:.1f} ms,"
        f" device busy {prof['busy_ms']:.1f} ms")
    for dev_ms, count, key in prof["rows"]:
        log(f"    {dev_ms:9.3f} ms  x{count:6d}  {key[:90]}")
    for k, (ms, c) in per_launch.items():
        b = bounds.get(k)
        log(f"  (c) {k} at the shard shapes: "
            f"{'n/a' if ms is None else f'{ms:.4f}'} ms a launch over {c} "
            f"launches" + ("" if b is None else
                           f", bound {b[0]:.4f} ms ({b[1]})"))
    for name in C5_KERNELS:
        if runs[0]["launches"].get(name, 0) <= 0:
            raise AssertionError(f"config #5: {name} did not launch")
    _add_runs(launches, recs, ("c5",))
    rows.append({"leg": "c config #5", "layout": [C5_TP, C5_PP, C5_VPP],
                 "losses": losses, "norms": runs[0]["norms"],
                 "step_ms": runs[0]["step_ms"], "p50_ms": p50,
                 "tokens_per_s": tokens / (p50 / 1e3), "peaks_gib": peaks,
                 "card_used_mib": card_mib,
                 "collectives_per_step": runs[0]["collectives"][-1],
                 "p2p_per_step": runs[0]["p2p"][-1],
                 "profile_wall_ms": prof["wall_ms"],
                 "profile_busy_ms": prof["busy_ms"],
                 "kernel_ms_per_launch": {k: v[0] for k, v in
                                          per_launch.items()},
                 "bounds_ms": {k: v[0] for k, v in bounds.items()}})


def ring_chunk_checks(dev):
    """The ring's flash chunks on the card against their plain versions,
    before the GPT leg trusts them: one rank's share of a CP 4 ring over
    seq 16384 at [1, 16, 4096, 64] bf16 (the causal diagonal chunk, a whole
    past chunk, the zigzag pair stacked [2, 16, 2048, 64]), forwards merged
    by lse, then each chunk's backward from the GLOBAL o and lse (delta
    from the o passed in); device ms a launch at those shapes beside their
    bounds. Returns (forward, backward) worst errors and the timings."""
    g = torch.Generator(device=dev).manual_seed(11)
    b, n, s, d = 1, N_HEADS, P15_CP_SEQ // P15_CP, HEAD_DIM

    def rnd(*shape):
        return torch.randn(shape, generator=g, device=dev,
                           dtype=torch.bfloat16)

    q, k0, k1, v0, v1, do = (rnd(b, n, s, d) for _ in range(6))
    scale = 1.0 / HEAD_DIM ** 0.5
    errs_f, errs_b = [], []
    # rank 1 of 4: the causal diagonal (its own K/V) and one past chunk
    parts = []
    for k, v, causal in ((k1, v1, True), (k0, v0, False)):
        o_k, l_k = fa_mod._launch_fwd(q, k, v, None, None, None, None, causal,
                                      scale, 0.0, None)
        o_p, l_p = fa_mod._plain_fwd(q, k, v, None, None, None, None, causal,
                                     scale, 0.0, None)
        errs_f.append(_rel_gap(o_k, o_p))
        errs_f.append(_rel_gap(l_k, l_p))
        parts.append((o_k, l_k))
    o = torch.zeros((b, n, s, d), dtype=torch.float32, device=dev)
    lse = torch.full((b, n, s), -1e30, dtype=torch.float32, device=dev)
    for o_j, l_j in parts:
        o, lse = cp_mod._merge(o, lse, o_j, l_j)
    o = o.to(torch.bfloat16)
    for k, v, causal in ((k1, v1, True), (k0, v0, False)):
        got = fa_mod._launch_bwd(q, k, v, o, lse, do, None, None, None, None,
                                 causal, scale, 0.0, None, False)[:3]
        want = fa_mod._plain_bwd(q, k, v, o, lse, do, None, None, None, None,
                                 causal, scale, 0.0, None, False)[:3]
        for a, w in zip(got, want):
            errs_b.append(_rel_gap(a, w))
    # the zigzag pair: two half chunks stacked along the batch
    h = s // 2
    qz = torch.cat([q[:, :, :h], q[:, :, h:]])
    kz = torch.cat([k0[:, :, :h], k0[:, :, h:]])
    vz = torch.cat([v0[:, :, :h], v0[:, :, h:]])
    oz_k, lz_k = fa_mod._launch_fwd(qz, kz, vz, None, None, None, None, False,
                                    scale, 0.0, None)
    oz_p, lz_p = fa_mod._plain_fwd(qz, kz, vz, None, None, None, None, False,
                                   scale, 0.0, None)
    errs_f.append(_rel_gap(oz_k, oz_p))
    fwd_err, bwd_err = max(errs_f), max(errs_b)
    timing = {}
    for label, (qq, kk, vv, causal) in (
            ("full chunk [1,16,4096,64]", (q, k0, v0, False)),
            ("diagonal chunk [1,16,4096,64] causal", (q, k1, v1, True)),
            ("zigzag pair [2,16,2048,64]", (qz, kz, vz, False))):
        bb, nn, sq, dd = qq.shape
        flops = _attn_flops(bb, nn, sq, sq, dd, causal)
        oo, ll = fa_mod._launch_fwd(qq, kk, vv, None, None, None, None,
                                    causal, scale, 0.0, None)
        dd_ = torch.ones_like(oo)
        f_ms = device_ms(lambda: fa_mod._launch_fwd(
            qq, kk, vv, None, None, None, None, causal, scale, 0.0, None),
            "flash_fwd_tc_kernel")
        b_ms = device_ms(lambda: fa_mod._launch_bwd(
            qq, kk, vv, oo, ll, dd_, None, None, None, None, causal, scale,
            0.0, None, False),
            ("flash_bwd_dq_tc_kernel", "flash_bwd_dkv_tc_kernel"))
        timing[label] = {
            "fwd_ms": f_ms, "bwd_ms": b_ms,
            "fwd_bound": bound(4 * bb * nn * sq * dd * 2 + bb * nn * sq * 4,
                               flops, BF16_TC_FLOPS),
            "bwd_bound": bound(8 * bb * nn * sq * dd * 2 + bb * nn * sq * 4,
                               2.5 * flops, BF16_TC_FLOPS)}
    tol = RING_TOL
    log(f"  (d) ring chunks on the card against their plain versions, "
        f"global o and lse: forward worst {fwd_err:.3e} (o and lse), "
        f"backward worst {bwd_err:.3e}, each of the largest entry")
    def ms(v):  # a trace now and then records no device activity
        return "not measured" if v is None else f"{v:.4f} ms"
    for label, t in timing.items():
        log(f"  (d) {label}: forward {ms(t['fwd_ms'])} (bound "
            f"{t['fwd_bound'][0]:.4f}, {t['fwd_bound'][1]}), backward "
            f"{ms(t['bwd_ms'])} (bound {t['bwd_bound'][0]:.4f}, "
            f"{t['bwd_bound'][1]})")
    if fwd_err > tol[0] or bwd_err > tol[0]:
        raise AssertionError(f"ring chunks differ from their plain versions: "
                             f"{fwd_err}, {bwd_err}")
    return fwd_err, bwd_err, timing


def cp_leg(dev, rows, launches, tmp):
    """(d) CP 4 in a gloo world of 4 on the card: the 345M-wide GPT at seq
    16384 (4096 tokens a rank), batch 1, zigzag then contiguous, 1 warm-up
    + 2 steps each, held against the dense seq-16384 step run alone on the
    card first (loss within 1e-3 relative, gradient gaps by leaf); the
    ring's flash launches a step, the K/V bytes a step over the ring;
    Ulysses forward and backward at [1, 16, 16384, 64] against flash
    attention on the whole sequence and the plain version on rank 0's
    rows. Returns the ring chunks' check errors."""
    fwd_err, bwd_err, timing = ring_chunk_checks(dev)
    cfg = p15_cfg(P15_CP_LAYERS, HIDDEN, N_HEADS, P15_CP_SEQ, P14_VOCAB)
    full = tree_map(lambda p: p.to(torch.bfloat16), init_gpt_params(
        cfg, torch.Generator(device=dev).manual_seed(0), device=dev))
    g = torch.Generator(device=dev).manual_seed(1)
    tokens = torch.randint(0, cfg.vocab_size, (1, P15_CP_SEQ), device=dev,
                           generator=g)
    labels = torch.roll(tokens, -1, dims=1)
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    dense_loss, grads = value_and_grad(
        lambda p: gpt_loss(cfg, p, tokens, labels), full)
    torch.cuda.synchronize()
    dense_ms = (time.perf_counter() - t0) * 1e3
    dense_peak = torch.cuda.max_memory_allocated() / 2 ** 30
    dense = {k: _gather_leaf(grads, k).float().cpu() for k in P14_GRAD_LEAVES}
    dense_loss = float(dense_loss)
    del full, grads
    torch.cuda.empty_cache()
    recs, out = _spawn_p14(tmp, P15_CP, {"leg": "cp", "device": str(dev)},
                           timeout=480,
                           worker="p15_worker", name="cp")
    for label in ("zigzag", "contiguous"):
        runs = [rec["runs"][label] for rec in recs]
        losses = runs[0]["losses"]
        if any(r["losses"] != losses for r in runs):
            raise AssertionError(f"(d) {label}: losses differ by rank")
        rel = abs(losses[0] - dense_loss) / abs(dense_loss)
        got = torch.load(os.path.join(out, f"rank0_{label}.pt"))
        gaps = {k: float((got[k] - dense[k]).abs().max()
                         / dense[k].abs().max().clamp_min(1e-30))
                for k in P14_GRAD_LEAVES}
        p50 = float(np.percentile(runs[0]["step_ms"][1:], 50))
        steps_timed = P15_CP_STEPS - 1
        per_step = {k: v / steps_timed for k, v in runs[0]["launches"].items()}
        ring = runs[0]["ring"][-1]
        log(f"  (d) CP 4 {label}, gloo world of 4 on the card, 345M width, "
            f"{P15_CP_LAYERS} layers, seq {P15_CP_SEQ}: losses {losses} on "
            f"every rank, dense {dense_loss:.6f} (rel {rel:.2e}); gradient "
            f"gaps {({k: f'{v:.2e}' for k, v in gaps.items()})}; step p50 "
            f"{p50:.1f} ms (steps {[round(t, 1) for t in runs[0]['step_ms']]})"
            f", {P15_CP_SEQ / (p50 / 1e3):.0f} tokens/s; host seconds in the "
            f"hops and all-reduces a step (rank 0) {runs[0]['host_s']}; peaks "
            f"{[round(r['peak_gib'], 2) for r in runs]} GiB; the ring a step "
            f"(rank 0) {ring}; launches a step {per_step}; collectives a "
            f"step {runs[0]['collectives'][-1]}")
        if rel > 1e-3 or max(gaps.values()) > PARITY_TOL[torch.bfloat16][1]:
            raise AssertionError(f"(d) {label} differs from the dense step")
        for name in P15_KERNELS:
            if runs[0]["launches"].get(name, 0) <= 0:
                raise AssertionError(f"(d) {label}: {name} did not launch")
        rows.append({"leg": f"d cp4 {label}", "losses": losses,
                     "dense_loss": dense_loss, "rel": rel, "grad_gaps": gaps,
                     "step_ms": runs[0]["step_ms"], "p50_ms": p50,
                     "peaks_gib": [r["peak_gib"] for r in runs],
                     "ring_per_step": ring, "launches_per_step": per_step,
                     "collectives_per_step": runs[0]["collectives"][-1]})
    uly = recs[0]["ulysses"]
    log(f"  (d) Ulysses [1, 16, {P15_CP_SEQ}, 64] bf16 causal across 4 ranks: "
        f"forward + backward {uly['ms']:.1f} ms (rank 0); against flash on "
        f"the whole sequence (o, dq, dk, dv; of the largest entry) "
        f"{uly['vs_flash']}; forward against the plain version on rank 0's "
        f"rows {uly['vs_plain']:.3e}; "
        f"gloo all_to_all_single on CUDA tensors: {recs[0]['a2a_probe']}")
    if max(uly["vs_flash"]) > RING_TOL[0] or uly["vs_plain"] > RING_TOL[0]:
        raise AssertionError(f"Ulysses differs: {uly}")
    log(f"  (d) the dense seq-{P15_CP_SEQ} step alone: {dense_ms:.1f} ms, "
        f"peak {dense_peak:.2f} GiB")
    _add_runs(launches, recs, ("zigzag", "contiguous"))
    rows.append({"leg": "d ulysses", **uly, "a2a_probe": recs[0]["a2a_probe"],
                 "ring_chunks": timing, "dense_ms": dense_ms,
                 "dense_peak_gib": dense_peak})
    return fwd_err, bwd_err


def long_context_leg(dev, rows, launches):
    """(e) The long-context example's CLI on the card: 5 steps at --seq
    8192 on one rank, then --world 4 (a gloo world of 4 processes on the
    card); every loss finite, the last below the first. It runs alone:
    beside (b) and (c)'s worlds the card ran out of memory (an H100
    80GB HBM3)."""
    from apex_tpu_torch.examples.long_context import train_long_context

    out = {}
    for name, argv in (("one rank", ["--seq", "8192", "--steps", "5"]),
                       ("world 4", ["--world", "4", "--seq", "8192",
                                    "--steps", "5"])):
        _device.reset_launch_counts()
        t0 = time.perf_counter()
        printed = train_long_context.main(argv)  # prints its own rows
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        for k, c in _device.launch_counts().items():
            launches[k] = launches.get(k, 0) + c
        losses = [l for _, l, _, _ in printed]
        if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
            raise AssertionError(f"long context {name}: {losses}")
        out[name] = {"rows": printed, "s": secs}
    log(f"  (e) long context at seq 8192: one rank {out['one rank']['s']:.1f}"
        f" s, world 4 {out['world 4']['s']:.1f} s (5 steps each, process "
        f"start-up included)")
    rows.append({"leg": "e long context", **out})


def pp_cp_phase(dev):
    """Phase 15: pipeline and context parallelism on one card. (a) NCCL at
    world 1: the no-pipelining schedule; (b)-(d) gloo worlds of processes
    sharing the card (NCCL refuses two ranks on one device): the kernels
    at the stages' and shards' shapes, the point-to-point hops and the
    collectives through host memory, so step times are the host's, not
    NVLink's; (e) the long-context example. Prints a ``{"phase15": [...]}``
    line; returns the main paths' launches and the ring chunks' check
    errors."""
    rows, launches, parts = [], {}, {}
    errs = (0.0, 0.0)
    with tempfile.TemporaryDirectory() as tmp:
        for key, fns, args in (("a", (nopipe_leg,), (rows, launches, tmp)),
                               ("b+c", (pp_leg, c5_leg),
                                (rows, launches, tmp)),
                               ("d", (cp_leg,), (rows, launches, tmp)),
                               ("e", (long_context_leg,), (rows, launches))):
            t0 = time.perf_counter()
            got = _side_by_side(fns, dev, *args)
            if key == "d":
                errs = got[0]
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            parts[key] = round(time.perf_counter() - t0, 1)
    log(f"  phase 15 parts (s): {parts}")
    print(json.dumps({"phase15": rows}), flush=True)
    return launches, errs


# ---------------------------------------------------------------------------
# phase 16: the rest of A6 — ZeRO-2 (DistributedFusedAdam at NCCL world 1
# and in a gloo world of 4, DistributedFusedLAMB on BERT-large in a world of
# 2), SpatialBottleneck over the halo exchangers (a world of 4), and
# tensor-parallel serving (worlds of 2 and 4), every gloo rank on the card
# ---------------------------------------------------------------------------

#: the 345M ZeRO legs: phase 5's global batch and leg (b)'s world
P16_BATCH, P16_ZERO_WORLD = 8, 4
#: leg (b): warm-up steps, then timed ones
P16_ZERO_WARM, P16_ZERO_TIMED = 2, 3
#: the ZeRO legs' learning rate: Adam's first steps move every one of the
#: 345M's parameters by about the rate, and at 1e-4 the random model's
#: third loss rose above its first (both optimizers alike, on an H100);
#: at 1e-5 the loss falls step by step
P16_ZERO_LR = 1e-5
#: the depth of the ZeRO legs (a), (b) and of (c)'s BERT-large: 6 of the
#: 24 layers. A cut: phase 16 within what the script's 1200 s limit
#: leaves after phases 1-15 (at 24 layers (b) took 37.3 s on an H100 80GB
#: HBM3 at 700 W, at 12 layers 20.8 s)
P16_ZERO_LAYERS = P16_BERT_LAYERS = 6
#: the ZeRO legs sync the bf16 gradients and gather the bf16 params in
#: bf16 (the reference's common setting; fp32 would double the bytes)
P16_SYNC = dict(grad_sync_dtype=torch.bfloat16,
                param_sync_dtype=torch.bfloat16)
#: leg (c): BERT-large at config #3's batch of 16 over a world of 2
P16_BERT_BATCH, P16_LAMB_WORLD, P16_LAMB_STEPS = 16, 2, 3
#: leg (d): ResNet-50's conv2_x block (256 -> 64 -> 256, stride 1) on a
#: [batch, H, W, C] bf16 input, H split over a world of 4 (14 rows a rank)
P16_SPATIAL_X, P16_SPATIAL_BLOCK, P16_SPATIAL_WORLD = \
    (32, 56, 56, 256), (256, 64, 256), 4
#: leg (d)'s limits: the forward in fp32 (bf16 input promoted, as flax
#: promotes it) over the largest entry; the gradients of fp64 copies of
#: both blocks over the largest entry; and the gradients at the timed
#: dtype by the norm of the difference over the norm of the dense one.
#: In fp32 the two forwards part by ~1e-6, enough to flip a ReLU whose
#: input lies that close to zero, and a flip moves a gradient entry by a
#: whole cotangent, so the worst entry is no measure there; a few flipped
#: entries move the norm little, a halo lost moves whole rows (the
#: planted fault, read beside it). On an H100 80GB HBM3 at 700 W the
#: sound gradients read up to 1.10e-3 of the norm (bn2's bias) and the
#: lost halos 0.258 at least (bn3's bias): the limit sits between
P16_SPATIAL_TOL = (1e-5, CONTRIB_TOL[torch.float64], 1e-2)
#: leg (e): phase 3's trace at TP 2 and TP 4; the second run speculates
#: (spec_k 4) and samples every other request
P16_TP = (2, 4)
#: the gloo worlds of the phase, side by side: (size, legs). TP 4 in a
#: world of its own beside them took as long (65.3 s against 65.0 for
#: the worlds, on an H100 80GB HBM3 at 700 W): the processes share one
#: card and 8 host cores
P16_WORLDS = ((4, ("zero", "spatial", "tp")), (2, ("lamb", "tp")))
#: leg (e)'s depth: the 345M's width at 2 of its 24 layers. A cut: at 24
#: layers a TP 4 world's 49 all-reduces a step through the host took
#: ~0.3-0.5 s a step, 208 s for the leg; 55 s at 8 layers, 47 s at 4 and
#: 32 s at 2 (an H100 80GB HBM3 at 700 W), within what the script's time
#: limit leaves after phases 1-15
P16_TP_LAYERS = 2
P16_SAMPLING = dict(temperature=0.8, top_k=40, top_p=0.95, seed=7)
#: leg (e)'s near-tie rule: where a TP engine's tokens first part from
#: the TP 1 engine's, the two engines' logits at that prefix (serving
#: forward) differ by at most this share of the largest (bf16 rounding of
#: the row-parallel sums), and that gap accounts for
#: the two choices (``tp_serving_check``)
P16_TIE_GAP = 0.05


def p16_serving_cfg() -> GPTConfig:
    """Leg (e)'s model: the 345M (bf16, phase 3's positions) at
    ``P16_TP_LAYERS`` layers."""
    return dataclasses.replace(gpt345m(torch.bfloat16),
                               num_layers=P16_TP_LAYERS)


def _p16_requests(vocab: int, sampled: bool):
    """Phase 3's trace (the same draws: its warm-up prompt first), rids
    fixed so the sampled rows' draws match across processes."""
    from apex_tpu_torch.serving import SamplingParams

    rng = np.random.default_rng(0)
    rng.integers(0, vocab, 16)  # phase 3's warm-up prompt
    return [Request(prompt=[int(t) for t in rng.integers(0, vocab,
                                                         size=128)],
                    max_new_tokens=64, arrival_step=i * 4, rid=9000 + i,
                    sampling=(SamplingParams(**P16_SAMPLING)
                              if sampled and i % 2 else None))
            for i in range(16)]


def _zero_steps(cfg, params, tokens, labels, opt, n, group_size=1,
                probe=None):
    """``n`` steps of ``gpt_loss`` with ``opt``: the global losses (the
    ranks' mean), step ms and collectives of each step; the params and
    state after the last. ``probe(grads)``, when given, runs on the first
    step's gradients after that step, outside its timing; its result is
    ``out["probe"]``."""
    state = opt.init(params)
    out = {"losses": [], "step_ms": [], "collectives": []}
    for i in range(n):
        counts = {}
        with counted_collectives(counts):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            loss, grads = value_and_grad(
                lambda p: gpt_loss(cfg, p, tokens, labels), params)
            params, state = opt.step(grads, state, params)
            torch.cuda.synchronize()
            out["step_ms"].append((time.perf_counter() - t0) * 1e3)
        loss = loss.detach().float().reshape(1)
        if group_size > 1:
            torch.distributed.all_reduce(loss)
        out["losses"].append(float(loss) / group_size)
        out["collectives"].append(counts)
        if i == 0 and probe is not None:
            out["probe"] = probe(grads)
        del grads
    return out, params, state


def zero_world1_leg(dev, rows, launches, tmp):
    """(a) ``DistributedFusedAdam(distributed_size=1)`` on NCCL at world 1:
    the 345M unfused step (batch 8, bf16 over fp32 masters, lr
    ``P16_ZERO_LR``) 3 steps from the seeded weights, against pytree
    ``FusedAdam(master_weights=True)``
    3 steps from the same weights: each step's loss within phase 5's bf16
    parity; the p50 and the collectives a step. Saves the dense step's
    first gradients (batch 8, bf16) for leg (b)."""
    from apex_tpu_torch.contrib.optimizers import DistributedFusedAdam

    dist = torch.distributed
    dist.init_process_group("nccl", init_method=f"file://{tmp}/store16",
                            world_size=1, rank=0)
    try:
        cfg = p14_cfg(num_layers=P16_ZERO_LAYERS)
        params, tokens, labels = p14_model(cfg, dev, P16_BATCH)
        dense, _, _ = _zero_steps(
            cfg, params, tokens, labels,
            FusedAdam(lr=P16_ZERO_LR, master_weights=True), 3,
            probe=lambda g: torch.save(
                tree_map(lambda x: x.detach().cpu(), g),
                os.path.join(tmp, "zero_a_grads.pt")))
        _device.reset_launch_counts()
        zero, _, state = _zero_steps(
            cfg, params, tokens, labels,
            DistributedFusedAdam(lr=P16_ZERO_LR, distributed_size=1,
                                 **P16_SYNC), 3)
        got = _device.launch_counts()
    finally:
        dist.destroy_process_group()
    for k, c in got.items():
        launches[k] = launches.get(k, 0) + c
    tol = PARITY_TOL[torch.bfloat16][0]
    rels = [abs(a - b) / abs(b) for a, b in zip(zero["losses"],
                                                 dense["losses"])]
    p50 = float(np.median(zero["step_ms"]))
    log(f"  (a) ZeRO at NCCL world 1, 345M unfused at {P16_ZERO_LAYERS} "
        f"layers, batch {P16_BATCH}: "
        f"losses {zero['losses']} against pytree FusedAdam's "
        f"{dense['losses']} (rel {max(rels):.2e}, limit {tol}); step p50 "
        f"{p50:.1f} ms (FusedAdam {np.median(dense['step_ms']):.1f} ms); "
        f"collectives a step {zero['collectives'][-1]}; launches "
        f"{({k: v for k, v in got.items() if v})}")
    if max(rels) > tol or not all(np.isfinite(zero["losses"])):
        raise AssertionError(f"(a) ZeRO at world 1: {zero['losses']} "
                             f"against {dense['losses']}")
    for name in ("layer_norm_fwd", "layer_norm_bwd", "flash_attn_fwd",
                 "flash_attn_bwd"):
        if got.get(name, 0) <= 0:
            raise AssertionError(f"(a) {name} did not launch")
    rows.append({"leg": "a zero world 1", "losses": zero["losses"],
                 "dense_losses": dense["losses"], "rel": max(rels),
                 "step_ms": zero["step_ms"], "p50_ms": p50,
                 "dense_p50_ms": float(np.median(dense["step_ms"])),
                 "collectives": zero["collectives"][-1],
                 "state_bytes": sum(t.numel() * t.element_size() for t in
                                    (state.exp_avg, state.exp_avg_sq,
                                     state.param_shard))})


def _leaf_paths(tree, prefix=""):
    """The ``a/b`` paths of a dict tree's leaves in ``tree_flatten``'s
    order (keys sorted)."""
    if isinstance(tree, dict):
        return [p for k in sorted(tree)
                for p in _leaf_paths(tree[k], f"{prefix}{k}/")]
    return [prefix[:-1]]


def _zero_grad_probe(opt, grads, dense_path, rank, world):
    """(b)'s gradient check on this rank's shard of the first step: the
    reduced fp32 shard (``_reduce_grads``, the step's own reduce-scatter
    and averaging) against the same range of leg (a)'s dense batch-8
    gradient, and two planted faults read the same way: the gradient of
    half the batch (the second half's ranks reduce zeros, the result
    doubled) and this rank's shard held against the next rank's range (a
    shard in the wrong place). Each leaf's worst gap, taken with MAX over
    the group, and its largest dense entry."""
    layout = opt._layout
    lo, hi = layout.shard_bounds(rank)
    dev = tree_flatten(grads)[0][0].device
    want_flat = layout.flatten(tree_map(lambda x: x.to(dev),
                                        torch.load(dense_path)),
                               torch.float32)
    want = want_flat[lo:hi]
    nlo, nhi = layout.shard_bounds((rank + 1) % world)
    want_next = want_flat[nlo:nhi]
    got = opt._reduce_grads(grads, layout, 1.0)
    half = opt._reduce_grads(
        tree_map(lambda g: g * (rank < world // 2), grads), layout,
        1.0) * 2.0
    n = layout.n_leaves
    table = torch.zeros((4, n), dtype=torch.float64)
    for i in range(n):
        a, b = max(lo, layout.offsets[i]), min(hi, layout.offsets[i + 1])
        if a >= b:
            continue
        part = slice(a - lo, b - lo)
        w = want[part].double()
        for row, (g, ref) in enumerate(((got, w), (half, w),
                                        (got, want_next[part].double()))):
            table[row, i] = float((g[part].double() - ref).abs().max())
        table[3, i] = float(w.abs().max())
    torch.distributed.all_reduce(table, op=torch.distributed.ReduceOp.MAX)
    scale = table[3].clamp_min(1e-30)
    names = _leaf_paths(grads)
    return {name: {"sound": float(table[0, i] / scale[i]),
                   "half_batch": float(table[1, i] / scale[i]),
                   "misplaced": float(table[2, i] / scale[i])}
            for i, name in enumerate(names)}


def _p16_zero_run(res, spec, dev, rank, world, out):
    """(b) one rank of ZeRO-2 on the 345M: its ``P16_BATCH / world`` rows
    of the batch, DistributedFusedAdam over the world, warm-up then timed
    steps; the first step's reduced gradient shard held against leg
    (a)'s dense gradient (``_zero_grad_probe``)."""
    from apex_tpu_torch.contrib.optimizers import DistributedFusedAdam

    cfg = p14_cfg(num_layers=P16_ZERO_LAYERS)
    params, tokens, labels = p14_model(cfg, dev, P16_BATCH)
    b = P16_BATCH // world
    tokens, labels = tokens[rank * b:(rank + 1) * b], labels[
        rank * b:(rank + 1) * b]
    opt = DistributedFusedAdam(lr=P16_ZERO_LR, distributed_size=world,
                               **P16_SYNC)
    warm, params, state = _zero_steps(
        cfg, params, tokens, labels, opt, P16_ZERO_WARM, world,
        probe=lambda g: _zero_grad_probe(opt, g, spec["zero_dense"], rank,
                                         world))
    torch.cuda.empty_cache()
    # the peak of the steady steps (the probe's buffers left out)
    torch.cuda.reset_peak_memory_stats()
    _device.reset_launch_counts()
    timed = {"losses": [], "step_ms": [], "collectives": []}
    for _ in range(P16_ZERO_TIMED):
        counts = {}
        with counted_collectives(counts):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            loss, grads = value_and_grad(
                lambda p: gpt_loss(cfg, p, tokens, labels), params)
            params, state = opt.step(grads, state, params)
            torch.cuda.synchronize()
            timed["step_ms"].append((time.perf_counter() - t0) * 1e3)
        loss = loss.detach().float().reshape(1)
        torch.distributed.all_reduce(loss)
        timed["losses"].append(float(loss) / world)
        timed["collectives"].append(counts)
    layout = opt._layout
    res["runs"]["zero"] = {
        "grad_gaps": warm["probe"],
        "losses": warm["losses"] + timed["losses"],
        "step_ms": timed["step_ms"], "warm_ms": warm["step_ms"],
        "collectives": timed["collectives"][-1],
        "launches": {k: v for k, v in _device.launch_counts().items() if v},
        "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
        "state_bytes": sum(t.numel() * t.element_size() for t in
                           (state.exp_avg, state.exp_avg_sq,
                            state.param_shard)),
        "dense_state_bytes": 3 * 4 * layout.total,
        "reduce_scatter_bytes": layout.padded * 2,
        "all_gather_bytes": layout.padded * 2,
        "shard_size": layout.shard_size, "padded": layout.padded}


def zero_world4_check(rows, launches, recs):
    """(b)'s verdicts from its ranks' records."""
    runs = [rec["runs"]["zero"] for rec in recs]
    losses = runs[0]["losses"]
    if any(r["losses"] != losses for r in runs):
        raise AssertionError(f"(b) losses differ by rank: "
                             f"{[r['losses'] for r in runs]}")
    if not all(np.isfinite(losses)) or losses[-1] >= losses[0]:
        raise AssertionError(f"(b) the loss does not fall: {losses}")
    # the first step's reduced gradient against the dense batch-8 one, a
    # leaf's worst gap over its largest entry, within phase 5's bf16
    # gradient parity (phase 14 (b)'s check); each planted fault must
    # break the same limit, or the check could not see it
    grad_tol = PARITY_TOL[torch.bfloat16][1]
    gaps = runs[0]["grad_gaps"]
    worst = {kind: max(g[kind] for g in gaps.values())
             for kind in ("sound", "half_batch", "misplaced")}
    ratios = [r["state_bytes"] / r["dense_state_bytes"] for r in runs]
    p50 = float(np.median(runs[0]["step_ms"]))
    sound = {k: f"{gaps[k]['sound']:.2e}" for k in P14_GRAD_LEAVES}
    log(f"  (b) ZeRO-2 in a gloo world of {len(recs)} on the card, 345M at "
        f"{P16_ZERO_LAYERS} layers, "
        f"batch {P16_BATCH // len(recs)} a rank: losses {losses} (equal on "
        f"every rank); step 1's reduced gradient against (a)'s dense one, "
        f"a leaf's worst gap of its largest entry "
        f"{sound}, "
        f"worst over all {len(gaps)} leaves: sound {worst['sound']:.3e}, "
        f"planted faults: half the batch {worst['half_batch']:.3e}, a "
        f"shard misplaced {worst['misplaced']:.3e} (limit {grad_tol}); "
        f"optimizer "
        f"state a rank {runs[0]['state_bytes']} B "
        f"= {ratios[0]:.6f} of the dense {runs[0]['dense_state_bytes']} B; "
        f"step p50 {p50:.1f} ms; peaks "
        f"{[round(r['peak_gib'], 2) for r in runs]} GiB; a step moves "
        f"{runs[0]['reduce_scatter_bytes']} B through the reduce-scatter "
        f"and {runs[0]['all_gather_bytes']} B through the all-gather "
        f"(collectives {runs[0]['collectives']})")
    if worst["sound"] > grad_tol:
        raise AssertionError(f"(b) the reduced gradient apart from the "
                             f"dense one: {gaps}")
    if min(worst["half_batch"], worst["misplaced"]) <= grad_tol:
        raise AssertionError(f"(b) a planted fault passes the gradient "
                             f"check: {worst}")
    if any(abs(x - 1 / len(recs)) > 1e-4 for x in ratios):
        raise AssertionError(f"(b) state a rank is not 1/{len(recs)}: "
                             f"{ratios}")
    if runs[0]["collectives"].get("reduce_scatter_tensor") != 1 or \
            runs[0]["collectives"].get("all_gather_into_tensor") != 1:
        raise AssertionError(f"(b) collectives {runs[0]['collectives']}")
    for rec in recs:
        for k, c in rec["runs"]["zero"]["launches"].items():
            launches[k] = launches.get(k, 0) + c
    rows.append({"leg": "b zero-2 world 4", "losses": losses,
                 "grad_gaps": {k: gaps[k] for k in P14_GRAD_LEAVES},
                 "grad_worst": worst, "grad_limit": grad_tol,
                 "state_ratio": ratios,
                 "step_ms": runs[0]["step_ms"], "p50_ms": p50,
                 "peaks_gib": [r["peak_gib"] for r in runs],
                 "reduce_scatter_bytes": runs[0]["reduce_scatter_bytes"],
                 "all_gather_bytes": runs[0]["all_gather_bytes"],
                 "collectives": runs[0]["collectives"]})


def _p16_bert(dev):
    """BERT-large as config #3 (1024 wide, vocab 30592, seq 512, bf16
    compute over fp32 params, dropout 0, no recompute) at
    ``P16_BERT_LAYERS`` layers, seeded weights and the padded batch of
    16."""
    cfg = GPTConfig(num_layers=P16_BERT_LAYERS, hidden_size=HIDDEN,
                    num_attention_heads=N_HEADS, vocab_size=BERT_VOCAB,
                    max_position_embeddings=512, hidden_dropout=0.0,
                    attention_dropout=0.0, compute_dtype=torch.bfloat16)
    params = init_gpt_params(
        cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
    batch = bert_batch([torch.Generator(device=dev).manual_seed(i)
                        for i in (1, 2, 3)], P16_BERT_BATCH, 512,
                       cfg.vocab_size, dev)
    return cfg, params, batch


def _lamb_steps(cfg, params, batch, opt, n, world=1, split=1):
    """``n`` LAMB steps of BERT's loss on ``batch``: the losses (the
    world's mean) and step ms. ``split``: the gradient is the mean of the
    gradients of ``split`` equal parts of the batch, as a world of
    ``split`` ranks reduces them (the fp32 sum, then the division)."""
    state = opt.init(params)
    losses, ms = [], []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        b = batch[0].shape[0] // split
        parts = [value_and_grad(lambda p: bert_mlm_loss(
            cfg, p, *(t[i * b:(i + 1) * b] for t in batch)), params)
            for i in range(split)]
        loss = sum(l for l, _ in parts) / split
        grads = tree_map(lambda *g: sum(g) / split, *[g for _, g in parts])
        params, state = opt.step(grads, state, params)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        loss = loss.detach().float().reshape(1)
        if world > 1:
            torch.distributed.all_reduce(loss)
        losses.append(float(loss) / world)
    return losses, ms


def _p16_lamb_run(res, spec, dev, rank, world, out):
    """(c) one rank: its half of config #3's batch, DistributedFusedLAMB
    over the world."""
    from apex_tpu_torch.contrib.optimizers import DistributedFusedLAMB

    cfg, params, batch = _p16_bert(dev)
    b = P16_BERT_BATCH // world
    batch = tuple(t[rank * b:(rank + 1) * b] for t in batch)
    _device.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    losses, ms = _lamb_steps(cfg, params, batch,
                             DistributedFusedLAMB(lr=1e-3,
                                                  distributed_size=world),
                             P16_LAMB_STEPS, world)
    res["runs"]["lamb"] = {
        "losses": losses, "step_ms": ms,
        "launches": {k: v for k, v in _device.launch_counts().items() if v},
        "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30}


def _p16_shard_case(g, dev, heads, lens):
    """Pools of ``heads`` heads (the TP engine's page size, 8) and a page
    table over ``lens``, as ``_page_case`` builds them."""
    B = len(lens)
    pools = [(torch.randn(POOL_PAGES, heads, PAGE, HEAD_DIM, generator=g,
                          device=dev).bfloat16(),
              torch.randn(POOL_PAGES, heads, PAGE, HEAD_DIM, generator=g,
                          device=dev).bfloat16()) for _ in range(8)]
    q = torch.randn(B, heads, HEAD_DIM, generator=g, device=dev).bfloat16()
    perm = torch.randperm(POOL_PAGES - 1, generator=g, device=dev) + 1
    pt = torch.zeros(B, MP, dtype=torch.int32, device=dev)
    for b, L in enumerate(lens):
        pt[b, :-(-L // PAGE)] = perm[b * MP:b * MP + (-(-L // PAGE))]
    return q, pools, pt, torch.tensor(lens, dtype=torch.int32, device=dev)


def tp_shard_kernel_checks(dev, rows):
    """#1 at the TP engine's shard shapes: 8 slots of 8 and of 4 heads
    (TP 2, TP 4; page size 8, the local head count's), the decode lengths
    of phase 2, against its plain version and twice bit for bit; its
    device time against the bound at each shape. Returns the worst
    error and the timings."""
    from apex_tpu_torch.serving import default_page_size

    g = torch.Generator(device=dev).manual_seed(16)
    lens = [0, 1, 7, 8, 64, 129, 191, 192]
    worst, out = 0.0, {}
    for heads in (N_HEADS // tp for tp in P16_TP):
        if default_page_size(heads, HEAD_DIM) != PAGE:
            raise AssertionError(f"{heads} heads: page size "
                                 f"{default_page_size(heads, HEAD_DIM)}")
        q, pools, pt, kl = _p16_shard_case(g, dev, heads, lens)
        k, v = pools[0]
        got = flash_decode(q, k, v, pt, kl)
        again = flash_decode(q, k, v, pt, kl)
        want = paged_decode_reference(q, k, v, pt, kl)
        if not torch.equal(got, again):
            raise AssertionError(f"flash_decode at {heads} heads: two "
                                 "launches differ")
        err = check_close(f"flash_decode {heads} heads", got, want, q.dtype)
        worst = max(worst, err)
        t = _decode_timing(dev, q, pools, pt, kl,
                           f"decode bf16 [8,{heads},64] (TP {N_HEADS // heads}"
                           " shard)")
        out[heads] = {"max_abs_err": err, **t}
        rows.append({"leg": f"flash_decode shard {heads} heads",
                     "max_abs_err": err, **t})
    return worst, out


@torch.no_grad()
def _serving_logits(cfg, spec0, params, prompt, dev, heads=None, comm=None):
    """The serving forward's fp32 logits at ``prompt``'s last position:
    one chunk over a fresh pool of ``spec0``'s page geometry with
    ``heads`` heads (a TP rank's share under ``comm``: its vocab slice)."""
    from apex_tpu_torch.serving import PagedKVSpec, prefill_chunk_tokens

    spec = PagedKVSpec(spec0.num_layers, heads or spec0.num_heads,
                       spec0.head_dim, page_size=spec0.page_size,
                       num_pages=spec0.pages_per_seq + 1,
                       pages_per_seq=spec0.pages_per_seq, dtype=spec0.dtype)
    n = len(prompt)
    pt = torch.zeros((1, spec.pages_per_seq), dtype=torch.int32, device=dev)
    pt[0, :-(-n // spec.page_size)] = torch.arange(
        1, -(-n // spec.page_size) + 1)
    z = torch.zeros((1,), dtype=torch.int32, device=dev)
    return prefill_chunk_tokens(
        cfg, params, spec, spec.init_cache(dev), z, z,
        torch.ones((1,), dtype=torch.bool, device=dev),
        torch.tensor([prompt], dtype=torch.int32, device=dev),
        torch.tensor([n], dtype=torch.int32, device=dev), pt, chunk=n,
        tp_axis=comm)[0][0]


def _at_filter_boundary(logits, tok: int, sp, tol: float) -> bool:
    """Whether ``tok`` sits at a sampling filter's boundary under
    ``logits`` within ``tol`` (in scaled logits): its scaled logit within
    ``tol`` of the k-th largest, or the probability mass before it within
    ``2 tol`` (relative; a perturbation of ``tol`` moves a softmax mass by
    about that) of ``top_p``."""
    scaled = logits.float() / sp.temperature
    vals, order = torch.sort(scaled, descending=True)
    r = int((order == tok).nonzero()[0, 0])
    if sp.top_k and abs(float(vals[r] - vals[sp.top_k - 1])) <= tol:
        return True
    if sp.top_p < 1.0:
        kth = vals[sp.top_k - 1] if sp.top_k else vals[-1]
        probs = torch.where(vals >= kth, torch.exp(vals - vals[0]), 0.0)
        probs = probs / probs.sum()
        before = float(torch.cumsum(probs, 0)[r] - probs[r])
        return abs(before - sp.top_p) <= 2 * tol * sp.top_p
    return False


def _p16_divergence(cfg, eng, params, req, got, ref, dev):
    """Where this TP engine's tokens first part from the TP 1 engine's
    (every rank calls it): at that prefix, the TP engine's logits (its
    vocab slices, gathered) and the TP 1 model's, both through the
    serving forward; their largest gap; the replicated sampler's choice
    on each; and the margin by which the TP 1 logits prefer the TP 1
    token over the TP token (Gumbel-perturbed and scaled for a sampled
    row, the same draw keys on both sides). None where the tokens are
    equal."""
    from apex_tpu_torch.amp import cast_params_for_inference

    if got == ref:
        return None
    j = next((i for i, (x, y) in enumerate(zip(got, ref)) if x != y),
             min(len(got), len(ref)))
    if j >= min(len(got), len(ref)):
        return {"rid": req.rid, "j": j, "lengths": [len(got), len(ref)]}
    prefix = list(req.prompt) + ref[:j]
    part = _serving_logits(cfg, eng.spec, eng.params, prefix, dev,
                           eng.spec_local.num_heads, eng.comm)
    tp = eng.comm.all_gather(part[None].contiguous(), "divergence")[0]
    one = _serving_logits(cfg, eng.spec, cast_params_for_inference(
        params, cfg.compute_dtype), prefix, dev)
    sp = sampling.resolve(req.sampling)
    rows = [torch.full((1,), v, dtype=dt, device=dev) for v, dt in (
        (sp.temperature, torch.float32), (sp.top_k, torch.int32),
        (sp.top_p, torch.float32), (sampling.i32_wrap(sp.seed), torch.int32),
        (sampling.i32_wrap(req.rid), torch.int32),
        (len(prefix), torch.int32))]
    picks = [int(sampling.sample_tokens(lg[None], *rows)[0])
             for lg in (tp, one)]
    a, b = got[j], ref[j]
    scores = one
    if not sp.is_greedy:
        vi = torch.arange(one.numel(), dtype=torch.int32, device=dev)
        u = sampling.uniform_from_hash(rows[3], rows[4], rows[5], vi)
        scores = one / sp.temperature - torch.log(-torch.log(u))
    gap = float((tp - one).abs().max())
    tol = 2 * gap / (1.0 if sp.is_greedy else sp.temperature)
    boundary = (not sp.is_greedy) and any(
        _at_filter_boundary(lg, t, sp, tol) for lg in (tp, one)
        for t in (a, b))
    return {"rid": req.rid, "j": j, "tp_token": a, "tp1_token": b,
            "gap": gap, "filter_boundary": boundary,
            "gap_rel": float((tp - one).abs().max() / one.abs().max()),
            "picks": picks, "both_picked": sorted(picks) == sorted([a, b]),
            "margin": float(scores[b] - scores[a]),
            "scale": 1.0 if sp.is_greedy else 1.0 / sp.temperature}


def _p16_profile_step(eng, cfg, rank, world):
    """One decode step of 8 slots at 128 + 4 tokens, profiled on rank 0
    (every rank runs the same steps): wall and busy ms, and #1's device
    time a launch."""
    rng = np.random.default_rng(3)
    for i in range(SLOTS):
        eng.submit(Request(prompt=[int(t) for t in rng.integers(
            0, cfg.vocab_size, size=128)], max_new_tokens=8, rid=9100 + i))
    while any(r.prefilling for _, r in eng.scheduler.running()) or \
            eng.scheduler.waiting:
        eng.run_step()
    for _ in range(2):
        eng.run_step()
    out = None
    if rank == 0:
        prof = profiled(eng.run_step, f"TP {world} rank 0 decode step", 8)
        fd = [(ms, n) for ms, n, key in prof["rows"] if "flash_decode" in key]
        out = {"wall_ms": prof["wall_ms"], "busy_ms": prof["busy_ms"],
               "flash_decode_launches": sum(n for _, n in fd),
               "flash_decode_ms_a_launch":
                   sum(m for m, _ in fd) / max(1, sum(n for _, n in fd))}
    else:
        eng.run_step()
    while not eng.scheduler.idle:
        eng.run_step()
    return out


def _p16_tp_run(res, spec, dev, rank, world, out):
    """(e) one rank of a TP ``world`` engine over phase 3's trace: plain
    (prefill_chunk 8), then spec_k 4 with every other request sampled;
    the launches, the collectives issued and the step times of each; the
    logit gap of the near-tie rule; rank 0's profiled short trace."""
    cfg = p16_serving_cfg()
    params = init_gpt_params(
        cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
    runs = {}
    for label, kw in (("plain", {}), ("spec_sampled", {"spec_k": 4})):
        eng = ServingEngine(cfg, params, n_slots=SLOTS, prefill_chunk=8,
                            tp=world, device=dev, **kw)
        warm = np.random.default_rng(0).integers(0, cfg.vocab_size, 16)
        eng.generate([Request(prompt=[int(t) for t in warm],
                              max_new_tokens=4, rid=8999)])
        reqs = _p16_requests(cfg.vocab_size, label != "plain")
        torch.cuda.synchronize()
        _device.reset_launch_counts()
        eng.comm.reset_issued()
        got = eng.generate(reqs)
        torch.cuda.synchronize()
        st = eng.last_stats
        runs[label] = {
            "tokens": [got[r.rid] for r in reqs],
            "launches": {k: v for k, v in _device.launch_counts().items()
                         if v},
            "issued": dict(eng.comm.issued),
            "issued_bytes": dict(eng.comm.issued_bytes),
            **{k: st[k] for k in ("steps", "step_ms", "tokens_per_sec",
                                  "wall_s", "generated_tokens",
                                  "psum_per_program", "kv_bytes_per_shard",
                                  "comm_volume", "completed",
                                  "accepted_tokens", "drafted_tokens")},
            "global_bytes": eng.spec.cache_bytes()}
        runs[label]["divergences"] = [
            d for d in (_p16_divergence(cfg, eng, params, rq, toks, ref, dev)
                        for rq, toks, ref in zip(
                            reqs, runs[label]["tokens"], spec["refs"][label]))
            if d is not None]
        if label == "plain":
            runs["profile"] = _p16_profile_step(eng, cfg, rank, world)
        del eng
        torch.cuda.empty_cache()
    res["runs"]["tp"] = runs


def tp_serving_check(rows, launches, recs, world, refs, cfg_params, dev):
    """(e)'s verdicts for a world: every rank emits rank 0's tokens; those
    are the TP 1 engine's, or first apart at a near-tie within twice the
    measured TP-against-TP 1 logit gap; the pool a rank holds is 1/tp of
    the whole; psum_per_program all 3s; 2L + 1 all-reduce sums a step."""
    cfg = cfg_params[0]
    runs = [rec["runs"]["tp"] for rec in recs]
    for label in ("plain", "spec_sampled"):
        got = runs[0][label]
        for r, run in enumerate(runs):
            if run[label]["tokens"] != got["tokens"]:
                raise AssertionError(f"(e) TP {world} {label}: rank {r} "
                                     "emits other tokens than rank 0")
        divs = got["divergences"]
        for d in divs:
            log(f"  (e) TP {world} {label}: {d}")
            # a near-tie: the two engines' logits at that prefix differ by
            # a bf16 rounding's worth, and that gap accounts for the two
            # choices: the sampler picks the two tokens from the two
            # sides' logits (in either order), or the TP 1 logits prefer
            # the TP 1 token by no more than twice the gap (scaled as the
            # draw scales it), or one of the tokens lies within twice the
            # gap of a top-k / top-p filter's boundary (sampled rows)
            if ("margin" not in d or d["gap_rel"] > P16_TIE_GAP
                    or not (d["both_picked"] or d["filter_boundary"]
                            or d["margin"] <= 2 * d["gap"] * d["scale"])):
                raise AssertionError(f"(e) TP {world} {label}: rid "
                                     f"{d['rid']} diverges beyond a "
                                     f"near-tie: {d}")
        near = len(divs)
        steps = got["steps"]
        sums = got["issued"].get("all_reduce_sum", 0)
        per = {k: v / steps for k, v in got["launches"].items()}
        log(f"  (e) TP {world} {label}: {got['generated_tokens']} tokens, "
            f"{steps} steps, step p50 {got['step_ms']['p50']:.2f} ms, "
            f"{got['tokens_per_sec']:.1f} tokens/s; every rank rank 0's "
            f"tokens; against TP 1: {16 - near} of 16 identical, {near} "
            f"first apart at a near-tie; psum_per_program "
            f"{got['psum_per_program']}; "
            f"all-reduce sums a step {sums / steps:.2f} (2L + 1 = "
            f"{2 * cfg.num_layers + 1}); issued {got['issued']}; launches a "
            f"step a rank {({k: round(v, 2) for k, v in per.items()})}; "
            f"kv bytes a rank {got['kv_bytes_per_shard']} x {world} = "
            f"{got['kv_bytes_per_shard'] * world} (TP 1 pool "
            f"{refs['pool_bytes']})")
        if any(v != 3 for v in got["psum_per_program"].values()):
            raise AssertionError(f"(e) psum_per_program "
                                 f"{got['psum_per_program']}")
        if sums != steps * (2 * cfg.num_layers + 1):
            raise AssertionError(f"(e) {sums} all-reduce sums over {steps} "
                                 "steps")
        if got["kv_bytes_per_shard"] * world != refs["pool_bytes"]:
            raise AssertionError("(e) a rank's pool is not 1/tp of TP 1's")
        if got["completed"] != 16:
            raise AssertionError(f"(e) {got['completed']} of 16 completed")
        for name in SERVING_KERNELS:
            if got["launches"].get(name, 0) <= 0:
                raise AssertionError(f"(e) {name} did not launch")
        for run in runs:
            for k, c in run[label]["launches"].items():
                launches[k] = launches.get(k, 0) + c
        rows.append({"leg": f"e tp{world} {label}", "near_ties": near,
                     "divergences": divs, "steps": steps,
                     "step_ms": got["step_ms"],
                     "tokens_per_sec": got["tokens_per_sec"],
                     "psum_per_program": got["psum_per_program"],
                     "all_reduce_sums_a_step": sums / steps,
                     "issued_bytes": got["issued_bytes"],
                     "launches_a_step": per,
                     "kv_bytes_per_shard": got["kv_bytes_per_shard"],
                     "accepted_tokens": got["accepted_tokens"],
                     "drafted_tokens": got["drafted_tokens"]})
    prof = runs[0]["profile"]
    log(f"  (e) TP {world} rank 0 profiled decode step: wall "
        f"{prof['wall_ms']:.1f} ms, device busy {prof['busy_ms']:.2f} ms; "
        f"flash_decode {prof['flash_decode_launches']} launches, "
        f"{prof['flash_decode_ms_a_launch']:.5f} ms device a launch, bound "
        f"at the shard shape {refs['shard'][N_HEADS // world]['bound_ms']:.5f}"
        f" ms")
    rows.append({"leg": f"e tp{world} profile", **prof,
                 "shard_bound_ms":
                     refs["shard"][N_HEADS // world]["bound_ms"]})


def _p16_spatial_run(res, spec, dev, rank, world, out):
    """(d) one rank of SpatialBottleneck: its 14-row slab of the seeded
    conv2_x input; forward and backward against the dense Bottleneck on
    the whole image (the same weights, computed on every rank), the
    parameter gradients summed over the ranks; the four exchangers'
    halos held against the neighbouring slabs' rows."""
    from apex_tpu_torch.contrib import bottleneck as bn

    torch.backends.cudnn.allow_tf32 = False
    n, hh, ww, c = P16_SPATIAL_X
    cin, mid, cout = P16_SPATIAL_BLOCK
    hl = hh // world
    g = torch.Generator(device=dev).manual_seed(61)
    x = torch.randn(P16_SPATIAL_X, generator=g, device=dev).bfloat16()
    cot = torch.randn((n, hh, ww, cout), generator=g, device=dev)
    sl = slice(rank * hl, (rank + 1) * hl)
    sp = bn.SpatialBottleneck(cin, mid, cout, axis_name="spatial",
                              device=dev, generator=torch.Generator(
                                  device=dev).manual_seed(62))
    dense = bn.Bottleneck(cin, mid, cout, device=dev)
    with torch.no_grad():
        for name in ("conv1", "conv3"):
            getattr(dense, name).kernel.copy_(getattr(sp, name).kernel)
        dense.conv2.kernel.copy_(sp.conv2_kernel)
    xs = x[:, sl].contiguous().requires_grad_()
    times = []
    for i in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        xs.grad = None
        sp.zero_grad()
        y = sp(xs)
        (y * cot[:, sl]).sum().backward()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    xd = x.detach().requires_grad_()
    dense_times = []
    for i in range(2):  # the first call warms cuDNN's algorithm choice
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        xd.grad = None
        dense.zero_grad()
        yd = dense(xd)
        (yd * cot).sum().backward()
        torch.cuda.synchronize()
        dense_times.append((time.perf_counter() - t0) * 1e3)
    gaps = {"out": _rel_gap(y, yd[:, sl])}
    # the gradients at the timed dtype (see P16_SPATIAL_TOL), and the
    # same reading with the halos never exchanged (NoComm in place of
    # SendRecv for one call): the fault the check must see
    dense_params = dict(dense.named_parameters())
    names = {"conv2_kernel": "conv2.kernel"}

    def norm_gaps(block):
        out = {"dx": _norm_gap(xs.grad, xd.grad[:, sl])}
        for k, p in block.named_parameters():
            g = p.grad.clone()
            torch.distributed.all_reduce(g)
            out[k] = _norm_gap(g, dense_params[names.get(k, k)].grad)
        return out

    norm = norm_gaps(sp)
    with unittest.mock.patch.object(bn.bottleneck, "HaloExchangerSendRecv",
                                    bn.HaloExchangerNoComm):
        xs.grad = None
        sp.zero_grad()
        (sp(xs) * cot[:, sl]).sum().backward()
    planted = norm_gaps(sp)
    # the gradients in fp64, on copies of both blocks (see P16_SPATIAL_TOL)
    sp64, dense64 = copy.deepcopy(sp).double(), copy.deepcopy(dense).double()
    xs64 = x[:, sl].double().requires_grad_()
    xd64 = x.double().requires_grad_()
    (sp64(xs64) * cot[:, sl].double()).sum().backward()
    (dense64(xd64) * cot.double()).sum().backward()
    gaps["dx"] = _rel_gap(xs64.grad, xd64.grad[:, sl])
    dense64_params = dict(dense64.named_parameters())
    for k, p in sp64.named_parameters():
        g = p.grad.clone()
        torch.distributed.all_reduce(g)
        gaps[k] = _rel_gap(g, dense64_params[names.get(k, k)].grad)
    # the exchangers: a rank's halos are its neighbours' boundary rows
    semantics = {}
    zero = torch.zeros_like(x[:, 0:1])
    want_l = x[:, rank * hl - 1:rank * hl] if rank else zero
    want_r = x[:, (rank + 1) * hl:(rank + 1) * hl + 1] \
        if rank < world - 1 else zero
    mine = x[:, sl]
    for name in ("SendRecv", "AllGather", "Peer", "NoComm"):
        ex = getattr(bn, "HaloExchanger" + name)("spatial")
        li, ri = ex.left_right_halo_exchange(mine[:, :1], mine[:, -1:])
        if name == "NoComm":
            ok = torch.equal(li, mine[:, -1:]) and torch.equal(ri, mine[:, :1])
        else:
            ok = torch.equal(li, want_l) and torch.equal(ri, want_r)
        semantics[name] = bool(ok)
    res["runs"]["spatial"] = {"gaps": gaps, "norm_gaps": norm,
                              "planted_norm_gaps": planted, "ms": times,
                              "dense_ms": dense_times, "semantics": semantics,
                              "shape": list(y.shape), "dtype": str(y.dtype)}


def spatial_check(rows, recs):
    runs = [rec["runs"]["spatial"] for rec in recs]
    fwd_tol, grad_tol, norm_tol = P16_SPATIAL_TOL
    worst = {k: max(r["gaps"][k] for r in runs) for k in runs[0]["gaps"]}
    norm = {k: max(r["norm_gaps"][k] for r in runs)
            for k in runs[0]["norm_gaps"]}
    planted = {k: max(r["planted_norm_gaps"][k] for r in runs)
               for k in runs[0]["planted_norm_gaps"]}
    p50 = float(np.median([t for r in runs for t in r["ms"][1:]]))
    dense_ms = runs[0]["dense_ms"][-1]
    log(f"  (d) SpatialBottleneck {P16_SPATIAL_BLOCK} over "
        f"{list(P16_SPATIAL_X)} bf16, H over a gloo world of {len(recs)} "
        f"({runs[0]['shape']} {runs[0]['dtype']} a rank): gaps against the "
        f"dense Bottleneck (the output in fp32, the gradients in fp64, of "
        f"the largest entry) {({k: f'{v:.2e}' for k, v in worst.items()})}"
        f"; the gradients at the timed dtype, norm of the difference over "
        f"the dense norm {({k: f'{v:.2e}' for k, v in norm.items()})} "
        f"(limit {norm_tol}; with the halos never exchanged "
        f"{({k: f'{v:.2e}' for k, v in planted.items()})}); "
        f"fwd+bwd a rank p50 {p50:.2f} ms (dense on the whole image, warm, "
        f"{dense_ms:.2f} ms; cold {runs[0]['dense_ms'][0]:.2f} ms); "
        f"exchangers {[r['semantics'] for r in runs]}")
    if worst["out"] > fwd_tol or max(v for k, v in worst.items()
                                     if k != "out") > grad_tol:
        raise AssertionError(f"(d) SpatialBottleneck apart from the dense "
                             f"block: {worst}")
    if max(norm.values()) > norm_tol:
        raise AssertionError(f"(d) SpatialBottleneck's gradients apart from "
                             f"the dense block's: {norm}")
    if max(planted.values()) <= norm_tol:
        raise AssertionError(f"(d) the gradient check does not see lost "
                             f"halos: {planted}")
    if not all(all(r["semantics"].values()) for r in runs):
        raise AssertionError(f"(d) exchangers: "
                             f"{[r['semantics'] for r in runs]}")
    rows.append({"leg": "d spatial bottleneck world 4", "gaps": worst,
                 "norm_gaps": norm, "planted_norm_gaps": planted,
                 "norm_limit": norm_tol,
                 "p50_ms": p50, "dense_ms": dense_ms,
                 "semantics": runs[0]["semantics"]})


_P16_RUNS = {"zero": _p16_zero_run, "lamb": _p16_lamb_run,
             "spatial": _p16_spatial_run, "tp": _p16_tp_run}


def a6_worker(rank: int, world: int, store: str, out: str, spec: str):
    """One rank of a phase-16 gloo world on the card: the legs of
    ``spec["legs"]`` in turn; writes ``rank<r>.json`` into ``out``."""
    spec = json.loads(spec)
    dist = torch.distributed
    dev = torch.device(spec["device"])
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    torch.backends.cuda.matmul.allow_tf32 = False
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            world_size=world, rank=rank)
    res = {"rank": rank, "runs": {}}
    try:
        _build.kernels()
        for leg in spec["legs"]:
            t0 = time.perf_counter()
            _P16_RUNS[leg](res, spec, dev, rank, world, out)
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            res.setdefault("seconds", {})[leg] = round(
                time.perf_counter() - t0, 1)
    finally:
        dist.destroy_process_group()
    with open(f"{out}/rank{rank}.json", "w") as f:
        json.dump(res, f)


def p16_references(dev, rows):
    """The single-process references of (c) and (e): pytree FusedLAMB's
    losses on config #3's batch, and the TP 1 engine's tokens of the
    trace (plain from phase 3 when it ran, and the spec_k 4 run with the
    sampled rows) and its pool bytes."""
    cfg, params, batch = _p16_bert(dev)
    # the reference takes the world's gradient: the two halves' mean
    lamb, lamb_ms = _lamb_steps(cfg, params, batch, FusedLAMB(lr=1e-3),
                                P16_LAMB_STEPS, split=P16_LAMB_WORLD)
    del params
    torch.cuda.empty_cache()
    scfg = p16_serving_cfg()
    sparams = init_gpt_params(
        scfg, torch.Generator(device=dev).manual_seed(0), device=dev)
    refs = {"lamb": lamb, "lamb_ms": lamb_ms}
    for label, kw in (("plain", {}), ("spec_sampled", {"spec_k": 4})):
        eng = ServingEngine(scfg, sparams, n_slots=SLOTS, prefill_chunk=8,
                            device=dev, **kw)
        reqs = _p16_requests(scfg.vocab_size, label != "plain")
        got = eng.generate(reqs)
        refs[label] = [got[r.rid] for r in reqs]
        refs["pool_bytes"] = eng.spec.cache_bytes()
        log(f"  TP 1 reference {label}: {eng.last_stats['steps']} steps, "
            f"step p50 {eng.last_stats['step_ms']['p50']:.2f} ms, "
            f"{eng.last_stats['tokens_per_sec']:.1f} tokens/s")
        del eng
    return refs, (scfg, sparams)


def lamb_check(rows, launches, recs, world, refs):
    """(c)'s verdicts: the loss equal on both ranks, falling, and each
    step's within phase 5's bf16 loss parity of pytree FusedLAMB's over
    the same gradient."""
    runs = [rec["runs"]["lamb"] for rec in recs]
    losses = runs[0]["losses"]
    rels = [abs(a - b) / abs(b) for a, b in zip(losses, refs["lamb"])]
    log(f"  (c) BERT-large at {P16_BERT_LAYERS} layers, "
        f"DistributedFusedLAMB, gloo world of {world}, batch "
        f"{P16_BERT_BATCH // world} a rank: losses {losses} (equal on both "
        f"ranks) against pytree FusedLAMB's {refs['lamb']} over the same "
        f"two halves' mean gradient (rel {max(rels):.2e}); step ms "
        f"{runs[0]['step_ms']} (FusedLAMB {refs['lamb_ms']}); peaks "
        f"{[round(r['peak_gib'], 2) for r in runs]} GiB")
    if any(r["losses"] != losses for r in runs) or \
            max(rels) > PARITY_TOL[torch.bfloat16][0] or \
            losses[-1] >= losses[0]:
        raise AssertionError(f"(c) LAMB: {losses} against {refs['lamb']}")
    for rec in recs:
        for k, n in rec["runs"]["lamb"]["launches"].items():
            launches[k] = launches.get(k, 0) + n
    rows.append({"leg": "c lamb world 2", "losses": losses,
                 "dense_losses": refs["lamb"], "rel": max(rels),
                 "step_ms": runs[0]["step_ms"],
                 "peaks_gib": [r["peak_gib"] for r in runs]})


def a6_phase(dev):
    """Phase 16: the rest of A6. (a) ZeRO at NCCL world 1; (b) ZeRO-2, (d)
    the spatial bottleneck and (e) TP 4 serving in one gloo world of 4,
    and beside it (c) DistributedFusedLAMB on BERT-large and (e) TP 2
    serving in a gloo world of 2, every rank a process on the one card
    (collectives through host memory: step times are the host's, not
    NVLink's, and the two worlds' share it); #1
    checked at the shard shapes. Prints a ``{"phase16": [...]}`` line;
    returns the main paths' launches and #1's worst error."""
    rows, launches, parts = [], {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        zero_world1_leg(dev, rows, launches, tmp)
        parts["a"] = round(time.perf_counter() - t0, 1)
        t0 = time.perf_counter()
        fd_err, shard = tp_shard_kernel_checks(dev, rows)
        refs, cfg_params = p16_references(dev, rows)
        refs["shard"] = shard
        parts["refs"] = round(time.perf_counter() - t0, 1)
        torch.cuda.empty_cache()
        # the worlds run side by side (a world's ranks wait on the host
        # most of a step): their legs' times are taken with the other
        # worlds' processes on the same card and host
        spec = {"device": str(dev),
                "zero_dense": os.path.join(tmp, "zero_a_grads.pt"),
                "refs": {k: refs[k] for k in ("plain", "spec_sampled")}}
        t0 = time.perf_counter()
        with concurrent.futures.ThreadPoolExecutor(len(P16_WORLDS)) as pool:
            futures = [pool.submit(
                _spawn_p14, tmp, world, {**spec, "legs": list(legs)},
                timeout=600, worker="a6_worker", name=f"p16w{i}")
                for i, (world, legs) in enumerate(P16_WORLDS)]
            done = [f.result() for f in futures]
        parts["worlds"] = round(time.perf_counter() - t0, 1)
        for (world, legs), (recs, out) in zip(P16_WORLDS, done):
            log(f"  world of {world} {legs}: seconds on rank 0 "
                f"{recs[0]['seconds']}")
            if "zero" in legs:
                zero_world4_check(rows, launches, recs)
            if "spatial" in legs:
                spatial_check(rows, recs)
            if "lamb" in legs:
                lamb_check(rows, launches, recs, world, refs)
            if "tp" in legs:
                tp_serving_check(rows, launches, recs, world, refs,
                                 cfg_params, dev)
    log(f"  phase 16 parts (s): {parts}")
    print(json.dumps({"phase16": rows}), flush=True)
    return launches, fd_err


# ---------------------------------------------------------------------------
# phase 17: resilience and the elastic service (A7.1, A7.2)
# ---------------------------------------------------------------------------

#: (a): the 345M loss-scaled, clipped unfused step (phase 5's leg, 24
#: layers, seq 1024, batch 8), 8 steps, saves every 3, every tensor
#: dropped after step 6 and restored
P17_STEPS, P17_SAVE_EVERY, P17_DROP_AT = 8, 3, 6
#: (b), (c): the 345M's width at 2 of its 24 layers (time), hidden
#: dropout 0.1 from a card generator; (b) runs 9 steps and dies after 7,
#: past the save at step 6, which barriers the one at step 3: at least
#: step 3 is committed when it dies, so the resume must restore
P17_CRASH_LAYERS, P17_CRASH_STEPS, P17_DIE_AT = 2, 9, 7
#: (c): batches 4-6 poisoned, 3 skipped steps in a row against a budget of 2
P17_POISON, P17_SKIP_BUDGET, P17_REWIND_STEPS = (4, 5, 6), 2, 10
#: (d): a chunk no two of worlds 4, 2, 1 round alike (8192, 6144, 5120
#: elements), so the layouts differ and the restore re-flattens
P17_RESHARD_CHUNK = 5 * 1024
#: (e): the fake hosts' steps, the kill (incarnation, host, spec) and
#: the world of each incarnation: host 1 of a world of 2 killed at step 8
#: of 12, the world restarted reshaped to 4
P17_HOST_STEPS = 12
P17_HOST_CHAOS = {(0, 1): "kill@8"}
P17_HOST_WORLDS = (2, 4)
P17_KERNELS = ("layer_norm_fwd", "layer_norm_bwd", "flash_attn_fwd",
               "flash_attn_bwd", "packed_adam", "packed_row_reduce",
               "scale_flat")


def p17_cfg(layers: int, dropout: float = 0.0) -> GPTConfig:
    return GPTConfig(num_layers=layers, hidden_size=HIDDEN,
                     num_attention_heads=N_HEADS, vocab_size=P12_VOCAB,
                     max_position_embeddings=P12_SEQ, hidden_dropout=dropout,
                     attention_dropout=0.0, compute_dtype=torch.bfloat16,
                     ce_save_logits=True)


def p17_batch(i: int, dev, batch: int = P12_BATCH):
    """Step ``i``'s tokens and labels, numpy-seeded by the index: the same
    batch for a step in every run and process."""
    tokens = torch.from_numpy(np.random.default_rng([17, int(i)]).integers(
        0, P12_VOCAB, (batch, P12_SEQ))).to(dev)
    return tokens, torch.roll(tokens, -1, dims=1)


def p17_params(cfg, dev):
    """The bf16 params of ``cfg`` from seed 0, on the card."""
    params = init_gpt_params(cfg, torch.Generator(device=dev).manual_seed(0),
                             device=dev)
    return tree_map(lambda p: p.to(torch.bfloat16), params)


def p17_step_fn(cfg, opt, scaler, clip=True):
    """Phase 5's loss-scaled step: the scaled loss's gradients (optionally
    NaN, :func:`resilience.poison_grads`), packed, unscaled into fp32 in
    one sweep (#24), clipped to norm 1 (#22) unless ``clip`` is off, the
    packed Adam (#17) with the scaler's ``found_inf``, the scale's update.
    Returns ``(params, opt state, scaler state, unscaled loss)``; the
    loss stays on the card. ``gen``: hidden dropout's generator."""
    def step(params, ostate, ss, batch, gen=None, poison=False):
        tokens, labels = batch
        kw = ({"generator": gen, "deterministic": False} if gen is not None
              else {})
        loss, grads = value_and_grad(lambda p: scaler.scale_loss(
            ss, gpt_loss(cfg, p, tokens, labels, **kw)), params)
        if poison:
            grads = poison_grads(grads, True)
        flat = ostate.spec.pack(grads)
        flat, ss2 = scaler.unscale_flat(ss, flat, out_dtype=torch.float32)
        if clip:
            flat, _ = clip_grad_norm_flat(flat, 1.0)
        params, ostate = opt.step(flat, ostate, params,
                                  found_inf=ss2.found_inf)
        return params, ostate, scaler.update_scale(ss2), loss / ss.loss_scale
    return step


def _state_bits(label, got, want):
    """Every tensor leaf of two train states (params, packed state,
    scaler, rng) bit for bit."""
    _same_bits(label, [x for x in res_tree_leaves(rstate.device_part(got))
                       if isinstance(x, torch.Tensor)],
               [x for x in res_tree_leaves(rstate.device_part(want))
                if isinstance(x, torch.Tensor)])


def _dir_bytes(path: str) -> int:
    return sum(os.path.getsize(os.path.join(d, f))
               for d, _, fs in os.walk(path) for f in fs)


def p17_checkpoint_leg(dev, rows, launches, tmp):
    """(a) The 345M step under ``CheckpointManager(async_save=True,
    save_every=3, keep_n=2)`` for 6 steps, every tensor dropped, the
    state restored through ``resume_or_init`` into fresh card tensors and
    run to step 8: the losses, params and packed state equal an
    uninterrupted run's bit for bit. Times the armed manager's steps
    against the plain run's (one process), the saves and the restore,
    counts the bytes written and the peak memory with a save in flight."""
    cfg = p17_cfg(P12_LAYERS)

    def fresh():
        params = p17_params(cfg, dev)
        opt = FusedAdam(lr=1e-4, master_weights=True, packed=True)
        sc = LossScaler("dynamic")
        return rcapture(0, params, opt.init(params), scaler=sc.init_state(dev),
                        data={"position": 0}), opt, sc

    def run(st, opt, sc, upto, mgr=None):
        step = p17_step_fn(cfg, opt, sc)
        it = IndexedBatches(lambda i: p17_batch(i, dev),
                            position=st.data["position"])
        params, ostate, ss = st.params, st.opt_state, st.scaler
        losses, times = [], []
        for k in range(st.step, upto):
            t0 = time.perf_counter()
            params, ostate, ss, loss = step(params, ostate, ss, next(it))
            if mgr is not None:
                mgr.maybe_save(rcapture(k + 1, params, ostate, scaler=ss,
                                        data=it.state()))
            losses.append(float(loss).hex())  # the step's one sync
            times.append((time.perf_counter() - t0) * 1e3)
        return rcapture(upto, params, ostate, scaler=ss,
                        data=it.state()), losses, times

    st, opt, sc = fresh()
    torch.cuda.reset_peak_memory_stats()
    ref, ref_losses, plain_ms = run(st, opt, sc, P17_STEPS)
    peak_plain = torch.cuda.max_memory_allocated() / 2 ** 30
    ring = telemetry.RingBufferRecorder()
    root = os.path.join(tmp, "p17a")
    mgr = CheckpointManager(root, keep_n=2, async_save=True,
                            save_every=P17_SAVE_EVERY, sink=ring)
    st, opt, sc = fresh()
    torch.cuda.reset_peak_memory_stats()
    _device.reset_launch_counts()
    head, losses, armed_ms = run(st, opt, sc, P17_DROP_AT, mgr)
    peak_armed = torch.cuda.max_memory_allocated() / 2 ** 30
    t0 = time.perf_counter()
    mgr.wait_until_finished()
    barrier_s = time.perf_counter() - t0
    saves = ring.events("checkpoint_saved")
    if [e["step"] for e in saves] != [3, 6] or mgr.all_steps() != [3, 6]:
        raise AssertionError(f"saves {[e['step'] for e in saves]}, "
                             f"retained {mgr.all_steps()}")
    nbytes = _dir_bytes(os.path.join(root, "step_00000006"))
    del head, st, opt, sc, mgr
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated() / 2 ** 30
    t0 = time.perf_counter()
    mgr = CheckpointManager(root, keep_n=2, async_save=True,
                            save_every=P17_SAVE_EVERY, sink=ring)
    box = {}

    def init():
        box["st"], box["opt"], box["sc"] = fresh()
        return box["st"]

    back, resumed = rresume_or_init(mgr, init)
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    if not resumed or back.step != P17_DROP_AT or \
            back.data != {"position": P17_DROP_AT}:
        raise AssertionError(f"resumed {resumed} at {back.step}, "
                             f"{back.data}")
    tail, tail_losses, _ = run(back, box["opt"], box["sc"], P17_STEPS, mgr)
    mgr.close()
    counts = _device.launch_counts()
    if losses + tail_losses != ref_losses:
        raise AssertionError(f"losses after the restore {tail_losses} "
                             f"differ from the uninterrupted run's "
                             f"{ref_losses[P17_DROP_AT:]}")
    _state_bits("(a) the state after the restore's steps", tail, ref)
    for k in P17_KERNELS:
        launches[k] = launches.get(k, 0) + counts.get(k, 0)
        if counts.get(k, 0) <= 0:
            raise AssertionError(f"(a): {k} did not launch")
    save_s = [e["duration_s"] for e in saves]
    r = {"leg": "a checkpoint manager", "plain_p50_ms": _p50(plain_ms[1:]),
         "armed_p50_ms": _p50(armed_ms[1:]), "armed_ms": armed_ms,
         "save_s": save_s, "barrier_s": barrier_s, "restore_s": restore_s,
         "bytes": nbytes, "peak_gib_plain": peak_plain,
         "peak_gib_armed": peak_armed, "held_gib_after_drop": held}
    rows.append(r)
    log(f"  (a) 345M scaled step x{P17_STEPS}: p50 {r['plain_p50_ms']:.2f} ms "
        f"plain, {r['armed_p50_ms']:.2f} ms under the async manager (steps "
        f"{[round(t, 2) for t in armed_ms]} ms; saves at 3 and 6); writes "
        f"{[round(s, 3) for s in save_s]} s in the background, "
        f"{nbytes:,} B a step; barrier {barrier_s:.3f} s; peak "
        f"{peak_armed:.2f} GiB with saves in flight against "
        f"{peak_plain:.2f}; {held:.2f} GiB held after the drop; restore "
        f"into fresh card tensors {restore_s:.3f} s (warm page cache); "
        f"losses, params and packed state equal the uninterrupted run's "
        f"bit for bit")
    shutil.rmtree(root, ignore_errors=True)


def _p50(ms) -> float:
    return float(np.percentile(np.asarray(ms, np.float64), 50))


def p17_crash_worker(argv=None) -> int:
    """(b)'s process: the 2-layer 345M-width step with hidden dropout
    from a card generator, under ``CheckpointManager(save_every=3)``,
    appending ``S <step> <loss hex>`` a step; resumes from the newest
    checkpoint. ``--die-at K``: ``os._exit(13)`` after step K;
    ``--preemptable``: the SIGTERM flush, exit 17. Writes its launch
    counts to ``--launches`` when it reaches ``--steps``."""
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("--root", required=True)
    ap.add_argument("--losses", required=True)
    ap.add_argument("--steps", type=int, default=P17_CRASH_STEPS)
    ap.add_argument("--die-at", type=int, default=None)
    ap.add_argument("--preemptable", action="store_true")
    ap.add_argument("--step-sleep", type=float, default=0.0)
    ap.add_argument("--launches", default=None)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--no-checkpoint", action="store_true",
                    help="the uninterrupted run: no manager")
    args = ap.parse_args(argv)
    dev = torch.device(args.device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if dev.type == "cuda":
        _build.kernels()
    cfg = p17_cfg(P17_CRASH_LAYERS, dropout=0.1)
    opt = FusedAdam(lr=1e-4, master_weights=True, packed=True)
    sc = LossScaler("dynamic")
    step = p17_step_fn(cfg, opt, sc)

    def init():
        params = p17_params(cfg, dev)
        return rcapture(0, params, opt.init(params), scaler=sc.init_state(dev),
                        rng=torch.Generator(device=dev).manual_seed(5)
                        .get_state(), data={"position": 0})

    if args.no_checkpoint:
        mgr, st = None, init()
    else:
        mgr = CheckpointManager(args.root, keep_n=2, async_save=True,
                                save_every=3)
        st, _ = rresume_or_init(mgr, init)
    it = IndexedBatches(lambda i: p17_batch(i, dev),
                        position=st.data["position"])
    params, ostate, ss, done = st.params, st.opt_state, st.scaler, st.step
    gen = torch.Generator(device=dev)
    gen.set_state(st.rng)

    def settled():
        # a copy no later step touches (the packed step updates its
        # buffers in place): what SIGTERM flushes, whenever it lands
        return rstate.tree_map(
            lambda t: t.clone() if isinstance(t, torch.Tensor) else t,
            rcapture(done, params, ostate, scaler=ss, rng=gen.get_state(),
                     data=it.state()))

    latest = {"st": settled()}
    if args.preemptable and mgr is not None:
        mgr.install_preemption_handler(lambda: latest["st"])
    _device.reset_launch_counts()
    with open(args.losses, "a") as f:
        while done < args.steps:
            params, ostate, ss, loss = step(params, ostate, ss, next(it),
                                            gen=gen)
            done += 1
            f.write(f"S {done - 1} {float(loss).hex()}\n")
            f.flush()
            if mgr is None:
                continue
            latest["st"] = settled()
            mgr.maybe_save(latest["st"])
            if args.die_at is not None and done == args.die_at:
                os._exit(13)
            if mgr.preempted:
                return 17
            if args.step_sleep:
                time.sleep(args.step_sleep)
    if mgr is not None:
        mgr.close()
    if args.launches:
        with open(args.launches, "w") as f:
            json.dump(_device.launch_counts(), f)
    return 0


def _p17_records(path):
    out = {}
    with open(path) as f:
        for line in f:
            if line.startswith("S "):
                _, s, hexval = line.split()
                if int(s) in out and out[int(s)] != hexval:
                    raise AssertionError(f"{path}: replayed step {s} "
                                         f"differs")
                out[int(s)] = hexval
    return out


def _p17_committed(ck):
    """{step: meta} of the committed step directories under ``ck``."""
    out = {}
    for name in sorted(os.listdir(ck)):
        if name.startswith("step_") and ".tmp-" not in name:
            with open(os.path.join(ck, name, "meta.json")) as f:
                meta = json.load(f)
            out[meta["step"]] = meta
    return out


def p17_crash_leg(dev, rows, launches, tmp):
    """(b) Real crashes at the 345M's width (2 layers): an uninterrupted
    process, one that ``os._exit``s after step 7 and one preempted by
    SIGTERM (its emergency flush, exit 17) run side by side on the card;
    each interrupted run is resumed in a fresh process writing records
    of its own. Each resume must start at the newest step its crashed
    run committed, above 0 and at most the step the crash reached, and the
    records of both processes together equal the uninterrupted run's
    byte for byte."""
    here = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=here + os.pathsep
               + os.environ.get("PYTHONPATH", ""), OMP_NUM_THREADS="1")
    d = os.path.join(tmp, "p17b")
    os.makedirs(d, exist_ok=True)

    def start(name, *extra, losses=None):
        return subprocess.Popen(
            [sys.executable, "-c", "import sys, chip_smoke; sys.exit("
             "chip_smoke.p17_crash_worker(sys.argv[1:]))",
             "--root", os.path.join(d, name + "_ck"),
             "--losses", os.path.join(d, (losses or name) + ".txt"),
             "--device", dev.type, *extra],
            env=env, cwd=here, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)

    def finish(p, want_rc, label):
        try:
            text, _ = p.communicate(timeout=300)
        except subprocess.TimeoutExpired:
            p.kill()
            p.wait()
            raise AssertionError(f"(b) {label}: no exit within 300 s")
        if p.returncode != want_rc:
            raise AssertionError(f"(b) {label} exited {p.returncode}, not "
                                 f"{want_rc}:\n{text[-3000:]}")

    t0 = time.perf_counter()
    ref = start("ref", "--no-checkpoint", "--launches",
                os.path.join(d, "ref.json"))
    crash = start("crash", "--die-at", str(P17_DIE_AT))
    pre = start("pre", "--preemptable", "--steps", "100000",
                "--step-sleep", "0.2")
    pre_lines = os.path.join(d, "pre.txt")
    deadline = time.monotonic() + 240
    while time.monotonic() < deadline and pre.poll() is None:
        if os.path.exists(pre_lines) and \
                len(open(pre_lines).read().splitlines()) >= 4:
            break
        time.sleep(0.1)
    pre.send_signal(15)
    finish(pre, 17, "the preempted run")
    finish(crash, 13, "the crashed run")
    # what each killed process left committed: its resume must start at
    # the newest of it (its writer threads died with it)
    crash_ck = _p17_committed(os.path.join(d, "crash_ck"))
    pre_ck = _p17_committed(os.path.join(d, "pre_ck"))
    emergency = [s for s, m in pre_ck.items() if m["emergency"]]
    if not emergency:
        raise AssertionError("(b) no emergency checkpoint after SIGTERM")
    flush_step = max(emergency)
    resume = start("crash", "--launches", os.path.join(d, "resume.json"),
                   losses="resume")
    pre_resume = start("pre", losses="pre_resume")
    finish(ref, 0, "the uninterrupted run")
    finish(resume, 0, "the resumed run")
    finish(pre_resume, 0, "the run resumed after the preemption")
    ref_recs = _p17_records(os.path.join(d, "ref.txt"))
    if sorted(ref_recs) != list(range(P17_CRASH_STEPS)):
        raise AssertionError(f"(b) the uninterrupted run recorded "
                             f"{sorted(ref_recs)}")

    def joined(label, before_path, after_path, committed, reached):
        before = _p17_records(before_path)
        after = _p17_records(after_path)
        first = min(after, default=None)
        newest = max(committed, default=None)
        if sorted(before)[:reached] != list(range(reached)):
            raise AssertionError(f"(b) {label}: the killed run recorded "
                                 f"{sorted(before)}, not steps 0-"
                                 f"{reached - 1}")
        if first is None or first != newest or not 0 < first <= reached:
            raise AssertionError(
                f"(b) {label}: the resume started at step {first}; the "
                f"newest committed step is {newest}, and it must lie in "
                f"(0, {reached}]")
        if sorted(after) != list(range(first, P17_CRASH_STEPS)):
            raise AssertionError(f"(b) {label}: the resume recorded "
                                 f"{sorted(after)}")
        for s in set(before) & set(after):
            if before[s] != after[s]:
                raise AssertionError(f"(b) {label}: replayed step {s} "
                                     f"differs")
        return {**{s: v for s, v in before.items()
                   if s < P17_CRASH_STEPS}, **after}, first

    crashed, crash_from = joined(
        "os._exit", os.path.join(d, "crash.txt"),
        os.path.join(d, "resume.txt"), crash_ck, P17_DIE_AT)
    if flush_step >= P17_CRASH_STEPS:
        raise AssertionError(f"(b) the emergency flush came at step "
                             f"{flush_step}, past the {P17_CRASH_STEPS} "
                             f"steps the resume is held to")
    pre_recs, pre_from = joined(
        "SIGTERM", pre_lines, os.path.join(d, "pre_resume.txt"), pre_ck,
        flush_step)
    if pre_from != flush_step:
        raise AssertionError(f"(b) the preempted run resumed at step "
                             f"{pre_from}, not its flush at {flush_step}")
    if crashed != ref_recs or pre_recs != ref_recs:
        bad = sorted(s for s in ref_recs if crashed.get(s) != ref_recs[s]
                     or pre_recs.get(s) != ref_recs[s])
        raise AssertionError(f"(b) resumed records differ from the "
                             f"uninterrupted run's at steps {bad}")
    for name in ("ref", "resume"):
        with open(os.path.join(d, name + ".json")) as f:
            for k, v in json.load(f).items():
                launches[k] = launches.get(k, 0) + v
    rows.append({"leg": "b crash", "seconds": time.perf_counter() - t0,
                 "flush_step": flush_step, "crash_resumed_at": crash_from})
    log(f"  (b) 2-layer 345M-width processes: os._exit after step "
        f"{P17_DIE_AT} and a resume from step {crash_from} (committed "
        f"{sorted(crash_ck)}), SIGTERM (emergency checkpoint at step "
        f"{flush_step}, exit 17) and a resume from step {pre_from}: "
        f"{P17_CRASH_STEPS} loss records "
        f"each equal the uninterrupted process's byte for byte "
        f"({time.perf_counter() - t0:.1f} s)")
    shutil.rmtree(d, ignore_errors=True)


def p17_rewind_leg(dev, rows, launches):
    """(c) ``poison_grads`` on batches 4-6 of (b)'s model: three skipped
    steps in a row against ``skip_budget=2`` trigger the rewind, which
    restores the ring's snapshot bit for bit and emits one ``rewind``
    record; the run finishes with finite losses."""
    cfg = p17_cfg(P17_CRASH_LAYERS, dropout=0.1)
    opt = FusedAdam(lr=1e-4, master_weights=True, packed=True)
    sc = LossScaler("dynamic")
    step = p17_step_fn(cfg, opt, sc)
    chaos = ChaosMonkey().poison_batches(P17_POISON)
    ring = telemetry.RingBufferRecorder()
    ctl = RewindController(keep=2, skip_budget=P17_SKIP_BUDGET,
                           snapshot_every=1, recorder=ring)
    params = p17_params(cfg, dev)
    ostate, ss = opt.init(params), sc.init_state(dev)
    gen = torch.Generator(device=dev).manual_seed(5)
    it = IndexedBatches(lambda i: p17_batch(i, dev))
    losses, skipped, done = [], [], 0
    _device.reset_launch_counts()
    t0 = time.perf_counter()
    while done < P17_REWIND_STEPS:
        poison = chaos.should_poison(it.position)
        params, ostate, ss, loss = step(params, ostate, ss, next(it),
                                        gen=gen, poison=poison)
        done += 1
        losses.append(float(loss))
        skipped.append(bool(ss.consecutive_skips > 0))
        ctl.offer(rcapture(done, params, ostate, scaler=ss,
                           rng=gen.get_state(), data=it.state()),
                  consecutive_skips=ss.consecutive_skips)
        if ctl.rewind_pending:
            snap = ctl._ring[-1]
            back = ctl.rewind(data_iter=it, current_step=done, device=dev)
            _state_bits("(c) the rewind against the ring's snapshot",
                        rstate.to_device(back, "cpu"), snap.state)
            params, ostate, ss = back.params, back.opt_state, back.scaler
            gen.set_state(back.rng)
            done = back.step
    counts = _device.launch_counts()
    events = ring.events("rewind")
    if len(events) != 1 or events[0]["to_step"] != P17_POISON[0]:
        raise AssertionError(f"(c) rewind records {events}")
    finite = all(np.isfinite(losses)) and all(
        bool(torch.isfinite(p.float()).all()) for p in tree_leaves(params))
    if not finite:
        raise AssertionError(f"(c) losses {losses} or params not finite")
    for k in P17_KERNELS:
        launches[k] = launches.get(k, 0) + counts.get(k, 0)
    rows.append({"leg": "c rewind", "losses": losses, "skipped": skipped,
                 "event": events[0]})
    log(f"  (c) batches {list(P17_POISON)} poisoned, skip budget "
        f"{P17_SKIP_BUDGET}: skipped {skipped}; one rewind to step "
        f"{events[0]['to_step']} (trigger {events[0]['trigger']!r}, the "
        f"ring's snapshot bit for bit); {len(losses)} finite losses "
        f"({time.perf_counter() - t0:.1f} s)")


def p17_reshard_leg(dev, rows, launches, tmp):
    """(d) The 345M's packed Adam state (#17's buffers over a bucketed
    layout of world 4) saved by ``ElasticCheckpointManager`` as 4 host
    shards, restored onto worlds 2 and 1 (layouts of their own:
    ``reflatten_flat`` on the card); every leaf equals the source's bit
    for bit, and one step from each equals one step from the source."""
    cfg = p17_cfg(P12_LAYERS)
    sc = LossScaler("dynamic")

    def state_for(world):
        params = p17_params(cfg, dev)
        b = grad_buckets_for_world(params, world, bucket_cap_mb=25.0,
                                   chunk_size=P17_RESHARD_CHUNK)
        opt = FusedAdam(lr=1e-4, master_weights=True, packed=True,
                        packed_spec=b.spec)
        return rcapture(0, params, opt.init(params),
                        scaler=sc.init_state(dev), data={"position": 0}), opt

    src, opt4 = state_for(4)
    step4 = p17_step_fn(cfg, opt4, sc, clip=False)
    params, ostate, ss = src.params, src.opt_state, src.scaler
    _device.reset_launch_counts()
    for k in range(2):
        params, ostate, ss, _ = step4(params, ostate, ss, p17_batch(k, dev))
    src = rcapture(2, params, ostate, scaler=ss, data={"position": 2})
    root = os.path.join(tmp, "p17d")
    ring = telemetry.RingBufferRecorder()
    t0 = time.perf_counter()
    mgrs = [ElasticCheckpointManager(root, host=h, world=4, sink=ring,
                                     barrier_timeout_s=300.0)
            for h in range(4)]
    for m in mgrs[1:]:
        m.save(src, blocking=False)
    mgrs[0].save(src, blocking=True)
    for m in mgrs[1:]:
        m.wait_until_finished()
    save_s = time.perf_counter() - t0
    nbytes = _dir_bytes(os.path.join(root, "step_00000002"))
    spec4 = src.opt_state.spec

    def leaves_by_leaf(st):
        sp = st.opt_state.spec
        out = [*tree_leaves(st.params), st.opt_state.step, *tree_leaves(
            st.scaler)]
        for name in ("exp_avg", "exp_avg_sq", "master_params"):
            out += tree_leaves(sp.unpack(getattr(st.opt_state, name),
                                         cast=False))
        return out

    def one_step(st, opt):
        c = rstate.tree_map(lambda t: t.clone() if isinstance(
            t, torch.Tensor) else t, st)
        p, o, s, loss = p17_step_fn(cfg, opt, sc, clip=False)(
            c.params, c.opt_state, c.scaler, p17_batch(2, dev))
        return [loss, *leaves_by_leaf(rcapture(3, p, o, scaler=s))]

    want_leaves = leaves_by_leaf(src)
    want_step = one_step(src, opt4)
    restore_s = {}
    for world in (2, 1):
        template, opt = state_for(world)
        if template.opt_state.spec == spec4:
            raise AssertionError(f"world {world} lays out like world 4")
        t0 = time.perf_counter()
        back = ElasticCheckpointManager(root, host=0, world=world,
                                        sink=ring).restore(template)
        torch.cuda.synchronize()
        restore_s[world] = time.perf_counter() - t0
        if back.step != 2 or back.opt_state.exp_avg.device.type != dev.type:
            raise AssertionError(f"(d) world {world}: step {back.step} on "
                                 f"{back.opt_state.exp_avg.device}")
        _same_bits(f"(d) the state on world {world}", leaves_by_leaf(back),
                   want_leaves)
        _same_bits(f"(d) one step on world {world}", one_step(back, opt),
                   want_step)
        del back, template
    counts = _device.launch_counts()
    reshards = ring.events("checkpoint_reshard")
    if [(e["saved_world"], e["world"]) for e in reshards] != [(4, 2), (4, 1)]:
        raise AssertionError(f"(d) reshard records {reshards}")
    for k in ("packed_adam", "scale_flat"):
        launches[k] = launches.get(k, 0) + counts.get(k, 0)
    rows.append({"leg": "d reshard", "save_s": save_s, "bytes": nbytes,
                 "restore_s": restore_s, "totals": {
                     4: spec4.total, **{e["world"]: e["total"]
                                        for e in reshards}}})
    log(f"  (d) the 345M packed Adam state ({spec4.total:,} elements a "
        f"buffer at world 4) saved as 4 host shards in {save_s:.2f} s "
        f"({nbytes:,} B), restored onto world 2 in {restore_s[2]:.2f} s and "
        f"world 1 in {restore_s[1]:.2f} s (re-flattened on the card to "
        f"{[e['total'] for e in reshards]} elements): every leaf and one "
        f"step from each equal the source's bit for bit")
    shutil.rmtree(root, ignore_errors=True)


def p17_supervised_leg(dev, rows, launches, tmp):
    """(e) The port's fake hosts (``resilience/_elastic_host.py``) on the
    card under ``Supervisor``: a world of 2, host 1 SIGKILLed at step 8 of
    12, then the world restarted reshaped to 4; the loss records equal
    the uninterrupted in-process run's byte for byte. Reports the
    incident's MTTR (detection to the restarted world's first heartbeat)
    and its relaunch-to-first-heartbeat time."""
    from apex_tpu_torch.resilience import _elastic_host as eh

    here = os.path.dirname(os.path.abspath(__file__))
    run = os.path.join(tmp, "p17e")
    os.makedirs(run, exist_ok=True)
    losses = os.path.join(run, "losses.txt")
    program = os.path.join(here, "apex_tpu_torch", "resilience",
                           "_elastic_host.py")

    def build_cmd(host, world, incarnation):
        return [sys.executable, program, "--host", str(host), "--world",
                str(world), "--steps", str(P17_HOST_STEPS), "--root",
                os.path.join(run, "ckpt"), "--losses", losses,
                "--heartbeat-dir", os.path.join(run, "hb"),
                "--save-every", "2", "--barrier-timeout", "120",
                "--step-sleep", "0.05", "--events",
                os.path.join(run, "events.jsonl"), "--launches",
                os.path.join(run, f"launches-{host}.json"), "--device",
                dev.type]

    def host_env(host, world, incarnation):
        spec = P17_HOST_CHAOS.get((incarnation, host))
        return {"APEX_TPU_ELASTIC_CHAOS": spec} if spec else None

    ring = telemetry.RingBufferRecorder()
    env = dict(os.environ, PYTHONPATH=here + os.pathsep
               + os.environ.get("PYTHONPATH", ""), OMP_NUM_THREADS="1")
    sup = Supervisor(
        build_cmd, P17_HOST_WORLDS[0], heartbeat_dir=os.path.join(run, "hb"),
        heartbeat_timeout_s=60.0, startup_timeout_s=240.0, poll_s=0.05,
        max_restarts=len(P17_HOST_WORLDS), sink=ring, env=env,
        host_env=host_env,
        on_restart=lambda inc, world: P17_HOST_WORLDS[inc + 1])
    t0 = time.perf_counter()
    summary = sup.run()
    wall = time.perf_counter() - t0
    want, _ = eh.reference_records(2, P17_HOST_STEPS, device=dev)
    got = _p17_records(losses)
    if got != want:
        raise AssertionError(f"(e) supervised records differ from the "
                             f"reference at steps "
                             f"{sorted(s for s in want if got.get(s) != want[s])}")
    if summary["world_history"] != list(P17_HOST_WORLDS) or \
            [i["kind"] for i in summary["incidents"]] != \
            ["host_death"] * len(P17_HOST_CHAOS):
        raise AssertionError(f"(e) supervisor summary {summary}")
    mttr = [i["recovery_s"] for i in summary["incidents"]]
    first_beat = [round(e["t_end"] - e["t_start"], 3)
                  for e in ring.events("span") if e["name"] == "restore"
                  and not e.get("blackbox_replay")]
    for h in range(P17_HOST_WORLDS[-1]):
        with open(os.path.join(run, f"launches-{h}.json")) as f:
            for k, v in json.load(f).items():
                launches[k] = launches.get(k, 0) + v
    rows.append({"leg": "e supervised", "mttr_s": mttr,
                 "first_heartbeat_s": first_beat, "wall_s": wall,
                 "world_history": summary["world_history"]})
    log(f"  (e) fake hosts on the card, worlds {summary['world_history']}, "
        f"SIGKILL {P17_HOST_CHAOS}: {P17_HOST_STEPS} loss records equal the "
        f"reference's byte for byte; MTTR (detection to first heartbeat) "
        f"{mttr} s, relaunch to first heartbeat {first_beat} s; "
        f"{wall:.1f} s in all")
    shutil.rmtree(run, ignore_errors=True)


def resilience_phase(dev):
    """Phase 17 (A7.1, A7.2): (a) the checkpoint manager on the 345M
    step (alone: it is timed); then (b)'s crash processes, started from
    a thread, run beside (c) the rewind and (d) the reshard in this
    process; then (e) the supervised world (alone: its MTTR is timed).
    Returns the launches of the kernels on these paths."""
    rows, launches = [], {}
    tmp = tempfile.mkdtemp(prefix="chip_smoke_p17_")
    parts = {}
    try:
        t0 = time.perf_counter()
        p17_checkpoint_leg(dev, rows, launches, tmp)
        parts["a"] = round(time.perf_counter() - t0, 1)
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        crash_rows, crash_launches = [], {}
        with concurrent.futures.ThreadPoolExecutor(1) as pool:
            crash = pool.submit(p17_crash_leg, dev, crash_rows,
                                crash_launches, tmp)
            p17_rewind_leg(dev, rows, launches)
            p17_reshard_leg(dev, rows, launches, tmp)
            crash.result()
        rows.extend(crash_rows)
        for k, n in crash_launches.items():
            launches[k] = launches.get(k, 0) + n
        parts["b+c+d"] = round(time.perf_counter() - t0, 1)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        p17_supervised_leg(dev, rows, launches, tmp)
        parts["e"] = round(time.perf_counter() - t0, 1)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    log(f"  phase 17 parts (s): {parts}")
    log(f"  p17_json {json.dumps(rows)}")
    log(f"  phase 17 launches {launches}")
    return launches


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
        parity_drain()  # phase 7's legs whose CPU halves have landed
        return out

    (fd, ln, ln_bwd, ln_wide_errs, rms, tier_errs, fwd_branch_errs,
     (fa_fwd, fa_bwd), head_dim_errs, extra_errs, adam, fused, softmax,
     lamb, sgd, flat, row_stats, novograd, f16_errs) = phase(
        "phase 2: kernels against their plain versions",
        lambda: (flash_decode_checks(dev), layer_norm_checks(dev),
                 layer_norm_bwd_checks(dev), layer_norm_width_checks(dev),
                 rms_norm_checks(dev), norm_bwd_tier_checks(dev),
                 norm_fwd_branch_checks(dev),
                 flash_attention_checks(dev),
                 flash_head_dim_checks(dev), flash_bias_segment_checks(dev),
                 packed_adam_checks(dev),
                 fused_block_checks(dev), fused_softmax_checks(dev),
                 packed_lamb_checks(dev), packed_sgd_checks(dev),
                 packed_flat_checks(dev), packed_row_stats_checks(dev),
                 packed_novograd_checks(dev), fp16_site_checks(dev)))
    fa_fwd["max_abs_err"] = max(fa_fwd["max_abs_err"], head_dim_errs[0],
                                extra_errs[0])
    fa_bwd["max_abs_err"] = max(fa_bwd["max_abs_err"], head_dim_errs[1],
                                extra_errs[1])
    ln["max_abs_err"] = max(ln["max_abs_err"], ln_wide_errs[0],
                            fwd_branch_errs[0])
    rms[0]["max_abs_err"] = max(rms[0]["max_abs_err"], fwd_branch_errs[1])
    ln_bwd["max_abs_err"] = max(ln_bwd["max_abs_err"], ln_wide_errs[1],
                                tier_errs[0])
    rms[1]["max_abs_err"] = max(rms[1]["max_abs_err"], tier_errs[1])
    phase("phase 2: the norm forwards against F.layer_norm and F.rms_norm, "
          "device time", norm_fwd_library_times, dev)
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
    train, train_p50 = phase(
        "phase 5: GPT-2 345M bf16 train step: headline, unfused, fused, "
        "non-flash, packed-SGD, loss-scaled clipped and two monitored legs",
        train_345m, dev)
    bert = phase("phase 6: BERT-large bf16: non-flash and flash legs with "
                 "FusedLAMB, then pytree and packed LAMB and packed "
                 "NovoGrad without recompute", train_bert_large, dev)
    tmp7 = tempfile.mkdtemp(prefix="chip_smoke_p7_")
    parity_start(tmp7)
    norms = phase("phase 7: the norm modules and the activation watch, card "
                  "against CPU", lambda: (norm_module_parity(dev),
                                          watch_parity(dev)))[0]
    phase("phase 7: training parity, card against CPU (the card halves; "
          "the CPU halves in the parity worker, checked as they land)",
          lambda: [leg() for leg in parity_legs(dev)])
    contrib = phase("phase 8: the attention contribs (fmha, multihead_attn, "
                    "openfold) at full width, kernels against plain "
                    "versions", attention_contribs, dev)
    o2 = phase("phase 9: ResNet-50 amp O0-O3 with FusedSGD (BASELINE "
               "config #1), the overflow skip, card against CPU, the "
               "example's CLI", resnet_phase, dev)
    fp8_launches = phase(
        "phase 10: fp8 fused_dense (the fp8 GEMM route, the GEMM chain, the "
        "345M fp8 train step, card against CPU), fused_dense_gelu_dense, "
        "MLP, fused_rope, FusedAdamSWA", fp8_and_friends_phase, dev,
        train_p50["unfused"])
    phase("phase 11: the single-device contribs of A5.5 and RNN/ at full "
          "width (focal_loss, group_norm, groupbn, conv_bias_relu, "
          "Bottleneck, index_mul_2d, sparsity, transducer, the legacy "
          "optimizers, the RNNs), card against CPU, no kernel of the port",
          contrib_phase, dev)
    p12 = phase("phase 12: the rest of the single-device library (A5.6: "
                "the applier, hostio, GDSFile, checkpoint, cpu_offload and "
                "the scaling study) and parallel_state on NCCL with the fp8 "
                "amax group and GradScaler (A6.1), 345M width", a56_phase,
                dev, card)
    p13 = phase("phase 13: data parallelism on NCCL at world 1 (A6.2, "
                "A6.3): the 345M step on DDP buckets, the lifecycle A/B, "
                "FusedSGD(packed_spec), ResNet-50 DDP + SyncBatchNorm + "
                "FusedAdam (BASELINE config #2), LARC, the simple DDP "
                "example", ddp_phase, dev, o2["p50_ms"])
    phase("phase 7, joined: the parity worker's remaining CPU halves "
          "against their card halves", parity_drain, True)
    shutil.rmtree(tmp7, ignore_errors=True)
    p14 = phase("phase 14: tensor and sequence parallelism (A6.4): the 345M "
                "at TP 1 on NCCL world 1, at TP 2 and TP 8 (BASELINE config "
                "#4) in gloo worlds on the card, the microbatch calculator, "
                "and the fp8 and DCGAN examples (A5.7.1)", tp_phase, dev)
    p15, (ring_fwd_err, ring_bwd_err) = phase(
        "phase 15: pipeline and context parallelism (A6.5): no pipelining "
        "on NCCL world 1, the 345M at PP 4 (1F1B, interleaved), BASELINE "
        "config #5 (GPT-3 XL, TP x PP interleaved), CP 4 at seq 16384 (ring "
        "and Ulysses), and the long-context example (A5.7.2)", pp_cp_phase,
        dev)
    fa_fwd["max_abs_err"] = max(fa_fwd["max_abs_err"], ring_fwd_err)
    fa_bwd["max_abs_err"] = max(fa_bwd["max_abs_err"], ring_bwd_err)
    p16, fd_shard_err = phase(
        "phase 16: the rest of A6 (A6.6, A6.7): ZeRO DistributedFusedAdam "
        "at NCCL world 1 and ZeRO-2 on the 345M in a gloo world of 4, "
        "DistributedFusedLAMB on BERT-large in a world of 2, "
        "SpatialBottleneck over the halo exchangers in a world of 4, and "
        "the 345M served at TP 2 and TP 4", a6_phase, dev)
    fd["max_abs_err"] = max(fd["max_abs_err"], fd_shard_err)
    p17 = phase("phase 17: resilience and the elastic service (A7.1, "
                "A7.2): the 345M step under the async checkpoint manager, "
                "dropped and restored; crashes and a preemption in "
                "processes; a rewind; the packed Adam state resharded 4 -> "
                "2 -> 1; the supervised fake hosts on the card",
                resilience_phase, dev)
    # the serving runs: phase 3, the overload storm and both sides of the
    # speculative A/B
    served = [serving, overload, *spec_launches.values()]
    fd["launches"] = (sum(c["flash_decode"] for c in served)
                      + p16.get("flash_decode", 0))
    # launches on the main paths: the serving runs, the eight GPT legs, the
    # five BERT legs, phase 10's fp8 step and fused_dense_gelu_dense,
    # phase 12's applier calls and 345M steps, phase 13's DDP steps, and
    # phase 14's tensor-parallel steps on every rank and its examples,
    # phase 15's pipelined and context-parallel steps on every rank,
    # phase 16's ZeRO steps and tensor-parallel serving on every rank, and
    # phase 17's resilience legs (the fake hosts' launches too)
    ln["launches"] = (sum(c["layer_norm_fwd"] for c in served)
                      + train["layer_norm_fwd"] + bert["layer_norm_fwd"]
                      + fp8_launches["layer_norm_fwd"]
                      + p12.get("layer_norm_fwd", 0)
                      + p13.get("layer_norm_fwd", 0)
                      + p14.get("layer_norm_fwd", 0)
                      + p15.get("layer_norm_fwd", 0)
                      + p16.get("layer_norm_fwd", 0)
                      + p17.get("layer_norm_fwd", 0))
    log(f"  flash_decode at the spec step's 64 query rows: "
        f"{json.dumps(spec_fd)}")
    kernels = (fd, ln, ln_bwd, *rms, fa_fwd, fa_bwd, adam, *fused,
               *softmax, *lamb, sgd, *flat, row_stats, novograd)
    # the fp16 instantiations (fault C3) are held in phase 2 as well
    for kr in kernels:
        if kr["name"] in f16_errs:
            kr["max_abs_err"] = max(kr["max_abs_err"], f16_errs[kr["name"]])
    for kr in kernels[2:]:
        kr["launches"] = (train.get(kr["name"], 0) + bert.get(kr["name"], 0)
                          + contrib.get(kr["name"], 0)
                          + fp8_launches.get(kr["name"], 0)
                          + p12.get(kr["name"], 0)
                          + p13.get(kr["name"], 0)
                          + p14.get(kr["name"], 0)
                          + p15.get(kr["name"], 0)
                          + p16.get(kr["name"], 0)
                          + p17.get(kr["name"], 0))
    # no model of the JAX package normalises with RMSNorm: its kernels'
    # launches are those of the norm-module parity runs of phase 7
    for kr in rms:
        kr["launches"] = norms[kr["name"]]
    # no model of the JAX package normalises with RMSNorm, so no main path
    # launches these two: the RMSNorm kernels run through the modules
    # (phase 7); axpby_flat runs through the applier (phase 12)
    exempt = ("rms_norm_fwd", "rms_norm_bwd")
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
