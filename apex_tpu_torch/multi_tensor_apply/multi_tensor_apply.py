"""The multi-tensor applier (counterpart of
``apex_tpu/multi_tensor_apply/multi_tensor_apply.py``).

The reference's ``multi_tensor_applier(op, noop_flag, tensor_lists,
*args)`` forwards a chunk size into an ``amp_C`` CUDA op. Here, as in
the JAX package, it forwards to the port's functional ops: the tree ops
of ``ops.multi_tensor`` take no chunking, and the flat-buffer ops of
``ops.packed_optimizer`` that carry ``accepts_chunk_size = True``
(``packed_row_stats``, ``multi_tensor_l2norm_flat``,
``multi_tensor_scale_flat``, ``multi_tensor_axpby_flat``) get the
applier's ``chunk_size`` as a keyword unless the call names one.
"""
from __future__ import annotations


class MultiTensorApply:
    """Callable forwarding to a functional multi-tensor op: ``op(*args,
    **kwargs)``, its return value passed straight through, with
    ``chunk_size`` injected into ops marked ``accepts_chunk_size``."""

    available = True
    warned = False

    def __init__(self, chunk_size: int = 2048 * 32):
        self.chunk_size = int(chunk_size)

    def __call__(self, op, *args, **kwargs):
        if getattr(op, "accepts_chunk_size", False):
            kwargs.setdefault("chunk_size", self.chunk_size)
        return op(*args, **kwargs)


multi_tensor_applier = MultiTensorApply()
