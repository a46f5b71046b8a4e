"""Contrib pack (counterpart of ``apex_tpu/contrib``): ``contrib.xentropy``'s
chunked LM-head cross entropy, ``contrib.clip_grad``,
``contrib.layer_norm``, the attention contribs over the flash kernels
(``contrib.fmha``: packed varlen sequences; ``contrib.multihead_attn``:
self and encoder-decoder attention; ``contrib.openfold``: pair-biased
attention, the small-shape LayerNorm and ``FusedAdamSWA``), and the
single-device contribs in plain PyTorch: ``focal_loss``, ``group_norm``,
``groupbn``, ``cudnn_gbn``, ``conv_bias_relu``, ``bottleneck``
(``Bottleneck``), ``index_mul_2d``, ``sparsity``, ``transducer`` and
``optimizers`` (the legacy ``FusedAdam`` / ``FusedSGD``). Not yet:
``gpu_direct_storage`` and the multi-rank parts (the spatial bottleneck,
the ``DistributedFused*`` optimizers; ROADMAP.md, queues A5.6, A6)."""
