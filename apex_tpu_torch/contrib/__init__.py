"""Contrib pack (counterpart of ``apex_tpu/contrib``): ``contrib.xentropy``'s
chunked LM-head cross entropy and ``contrib.clip_grad`` are ported so
far."""
