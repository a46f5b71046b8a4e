"""Packed optimizer state: flat buffers + PackSpec bookkeeping
(counterpart of ``apex_tpu/optimizers/_packed.py``).

With ``packed=True`` an optimizer's ``init`` returns a
:class:`PackedState` whose moments and masters are contiguous 1-D fp32
buffers, and ``step`` runs one packed kernel sweep over them
(``ops.packed_optimizer``). The kernel updates m, v and the masters in
place: a state handed to ``step`` is consumed by it (the JAX package
donated it to the same effect).
"""
from __future__ import annotations

from typing import Any

import torch

from .._tree import tree_leaves
from ..multi_tensor_apply.packing import PackSpec

Tree = Any


class PackedState:
    """``step`` int32 device scalar; ``exp_avg`` / ``exp_avg_sq`` fp32
    flat buffers; ``master_params`` fp32 flat buffer or None; ``spec``
    the layout."""

    def __init__(self, step, exp_avg, exp_avg_sq, master_params,
                 spec: PackSpec):
        self.step = step
        self.exp_avg = exp_avg
        self.exp_avg_sq = exp_avg_sq
        self.master_params = master_params
        self.spec = spec

    def __repr__(self):
        return f"PackedState(step={self.step}, spec={self.spec})"


def packed_init(params: Tree, *, master_weights: bool = False
                ) -> PackedState:
    """Build the flat-buffer state for ``params`` on their device."""
    spec = PackSpec(params)
    dev = tree_leaves(params)[0].device
    return PackedState(
        step=torch.zeros((), dtype=torch.int32, device=dev),
        exp_avg=spec.zeros(torch.float32, dev),
        exp_avg_sq=spec.zeros(torch.float32, dev),
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
