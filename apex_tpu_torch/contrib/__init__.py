"""Contrib pack (counterpart of ``apex_tpu/contrib``): ``contrib.xentropy``'s
chunked LM-head cross entropy, ``contrib.clip_grad``,
``contrib.layer_norm``, and the attention contribs over the flash kernels:
``contrib.fmha`` (packed varlen sequences), ``contrib.multihead_attn``
(self and encoder-decoder attention) and ``contrib.openfold`` (pair-biased
attention and the small-shape LayerNorm) are ported so far."""
