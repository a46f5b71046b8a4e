"""Contrib pack (counterpart of ``apex_tpu/contrib``): ``contrib.xentropy``'s
chunked LM-head cross entropy, ``contrib.clip_grad`` and
``contrib.layer_norm`` are ported so far."""
