"""Packed optimizer state: flat buffers + PackSpec bookkeeping
(counterpart of ``apex_tpu/optimizers/_packed.py``).

With ``packed=True`` an optimizer's ``init`` returns a
:class:`PackedState` whose moments and masters are contiguous 1-D fp32
buffers, and ``step`` runs one packed kernel sweep over them
(``ops.packed_optimizer``). The kernels update the moments and the
masters in place: a state handed to ``step`` is consumed by it (the JAX
package donated it to the same effect).
"""
from __future__ import annotations

from typing import Any, Optional

import torch

from .._tree import tree_leaves
from ..multi_tensor_apply.packing import DEFAULT_CHUNK, PackSpec

Tree = Any


class PackedState:
    """``step`` int32 device scalar; ``exp_avg`` / ``exp_avg_sq`` fp32
    flat buffers (``exp_avg`` doubles as SGD's momentum buffer, and SGD
    keeps no ``exp_avg_sq``: None); ``master_params`` fp32 flat buffer or
    None; ``spec`` the layout."""

    def __init__(self, step, exp_avg, exp_avg_sq, master_params,
                 spec: PackSpec):
        self.step = step
        self.exp_avg = exp_avg
        self.exp_avg_sq = exp_avg_sq
        self.master_params = master_params
        self.spec = spec

    @property
    def momentum_buffer(self) -> torch.Tensor:
        """SGD's name for ``exp_avg``."""
        return self.exp_avg

    def sweep_bytes(self) -> int:
        """The least device-memory traffic of one packed step, in bytes:
        the gradient read and the parameters written (in the packed
        parameter dtype), each present fp32 state buffer read and
        written, over the whole padded buffer (``spec.total``); the
        packing copies are not counted."""
        spec = self.spec
        item = spec.common_dtype().itemsize
        total = 2 * item * spec.total + 2 * 4 * spec.total  # g, p; exp_avg
        if self.exp_avg_sq is not None:
            total += 2 * 4 * self.exp_avg_sq.numel()
        if self.master_params is not None:
            total += 2 * 4 * spec.total
        return int(total)

    def __repr__(self):
        return f"PackedState(step={self.step}, spec={self.spec})"


def packed_init(params: Tree, *, chunk_size: Optional[int] = None,
                with_exp_avg_sq: bool = True,
                master_weights: bool = False) -> PackedState:
    """Build the flat-buffer state for ``params`` on their device, laid
    out by a ``PackSpec`` of ``chunk_size`` (default ``DEFAULT_CHUNK``).
    ``with_exp_avg_sq=False`` keeps no second moment (SGD)."""
    spec = PackSpec(params, chunk_size=chunk_size or DEFAULT_CHUNK)
    dev = tree_leaves(params)[0].device
    return PackedState(
        step=torch.zeros((), dtype=torch.int32, device=dev),
        exp_avg=spec.zeros(torch.float32, dev),
        exp_avg_sq=spec.zeros(torch.float32, dev) if with_exp_avg_sq
        else None,
        master_params=spec.pack(params, torch.float32) if master_weights
        else None,
        spec=spec)


def tree_common_dtype(tree: Tree, fallback=torch.float32) -> torch.dtype:
    dtypes = {l.dtype for l in tree_leaves(tree)}
    return dtypes.pop() if len(dtypes) == 1 else fallback


def as_flat_grads(grads, spec: PackSpec) -> torch.Tensor:
    """``grads`` — a tree, or a pre-packed 1-D buffer of exactly
    ``spec.total`` elements in the spec's layout — as the flat gradient
    buffer (a tree is packed in its leaves' common dtype)."""
    if isinstance(grads, torch.Tensor) and grads.dim() == 1 and not (
            spec.n_leaves == 1 and spec.shapes[0] == tuple(grads.shape)):
        if grads.shape[0] != spec.total:
            raise ValueError(
                f"flat gradient buffer has {grads.shape[0]} elements but "
                f"the optimizer's PackSpec lays out {spec.total}")
        return grads
    return spec.pack(grads, tree_common_dtype(grads))


def packed_src(state: PackedState, params: Tree,
               master_weights: bool) -> torch.Tensor:
    """The fp32 update source: the resident masters, or the params
    packed on the fly."""
    if master_weights:
        return state.master_params
    return state.spec.pack(params, torch.float32)
