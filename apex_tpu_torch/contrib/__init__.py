"""Contrib pack (counterpart of ``apex_tpu/contrib``): only
``contrib.xentropy``'s chunked LM-head cross entropy is ported so far."""
