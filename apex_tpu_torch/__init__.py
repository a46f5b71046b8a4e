"""apex_tpu_torch: the PyTorch / NVIDIA Hopper port of ``apex_tpu``.

The JAX package ``apex_tpu`` stays the reference; this package mirrors
its module paths (``apex_tpu_torch/serving/engine.py`` is the
counterpart of ``apex_tpu/serving/engine.py``) and never imports it or
JAX. Each TPU kernel on a ported path becomes a kernel written by hand
for the H100 (``csrc/``, built with ``nvcc`` for ``sm_90a`` at first
use), beside a plain PyTorch version of the same function. Entry points
run on the card unless the caller asks for the CPU.

Ported so far, on one device: serving — ``serving.ServingEngine`` over
``serving.decode_model`` with the ``ops.flash_decode`` and
``ops.layer_norm`` (forward) kernels; the unfused train step —
``transformer.testing.gpt_loss`` with the ``ops.layer_norm`` (forward
and backward) and ``ops.flash_attention`` (forward and backward)
kernels, and ``optimizers.FusedAdam`` over the ``ops.packed_optimizer``
packed Adam kernel; the fused block tails (``ops.fused_block``);
attention without flash through ``transformer.functional.fused_softmax``
(forward and backward kernels); BERT (``bert_forward``,
``standalone_bert``) with ``contrib.xentropy.softmax_cross_entropy_loss``
and ``optimizers.FusedLAMB``, pytree or packed (the ``ops.packed_optimizer``
row reduce, LAMB stage 1 and trust-ratio apply kernels);
``optimizers.FusedSGD``, pytree or packed (the packed SGD kernel); the
norms, the telemetry core, the attention contribs, the amp frontend and
``fp16_utils``; and ``fused_dense`` (with the fp8 delayed-scaling recipe
of ``fused_dense.fp8``, whose GEMM is ``torch._scaled_mm`` on the fp8
tensor cores, and the GPT's ``GPTConfig(fp8=True)``), ``mlp``,
``transformer.functional.fused_rope`` and
``contrib.openfold.FusedAdamSWA``; the single-device contribs
(``contrib.focal_loss``, ``group_norm``, ``groupbn``, ``cudnn_gbn``,
``conv_bias_relu``, ``bottleneck``, ``index_mul_2d``, ``sparsity``,
``transducer``, the legacy ``contrib.optimizers``), the single-device
``parallel.sync_batch_norm`` and ``RNN``, plain PyTorch over cuDNN and
cuBLAS.
"""
from ._device import (  # noqa: F401
    kernel_route,
    launch_counts,
    reset_launch_counts,
    resolve_device,
)
