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
from ..multi_tensor_apply.packing import (
    DEFAULT_CHUNK,
    BucketBuffers,
    PackSpec,
)

Tree = Any


class PackedState:
    """``step`` int32 device scalar; ``exp_avg`` / ``exp_avg_sq`` fp32
    flat buffers (``exp_avg`` doubles as SGD's momentum buffer, and SGD
    keeps no ``exp_avg_sq``: None; NovoGrad's ``exp_avg_sq`` is one value
    per leaf, ``(n_leaves,)``); ``master_params`` fp32 flat buffer or
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
        written, over the whole padded buffer (``spec.total``; a per-leaf
        ``exp_avg_sq`` counts its ``n_leaves`` values); the packing
        copies are not counted."""
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
                per_leaf_exp_avg_sq: bool = False,
                master_weights: bool = False,
                spec: Optional[PackSpec] = None) -> PackedState:
    """Build the flat-buffer state for ``params`` on their device, laid
    out by a ``PackSpec`` of ``chunk_size`` (default ``DEFAULT_CHUNK``).
    ``with_exp_avg_sq=False`` keeps no second moment (SGD);
    ``per_leaf_exp_avg_sq=True`` keeps one fp32 value per leaf
    (NovoGrad's layer-wise moment).

    ``spec=`` adopts a layout built elsewhere (``GradBuckets(params)
    .spec``): the optimizer then steps on the reduced flat buffer of the
    bucketed all-reduce as it comes. The adopted spec owns the chunking,
    so a ``chunk_size`` other than its own raises, and ``params`` must
    have its structure and shapes."""
    if spec is not None:
        if chunk_size is not None and chunk_size != spec.chunk_size:
            raise ValueError(
                f"chunk_size={chunk_size} conflicts with the adopted "
                f"spec's chunk_size={spec.chunk_size}: the external layout "
                "owns the kernel chunking; drop chunk_size or build the "
                "spec (GradBuckets) with the one you want")
        spec.check(params)
    else:
        spec = PackSpec(params, chunk_size=chunk_size or DEFAULT_CHUNK)
    dev = tree_leaves(params)[0].device
    if not with_exp_avg_sq:
        exp_avg_sq = None
    elif per_leaf_exp_avg_sq:
        exp_avg_sq = torch.zeros(spec.n_leaves, dtype=torch.float32,
                                 device=dev)
    else:
        exp_avg_sq = spec.zeros(torch.float32, dev)
    return PackedState(
        step=torch.zeros((), dtype=torch.int32, device=dev),
        exp_avg=spec.zeros(torch.float32, dev),
        exp_avg_sq=exp_avg_sq,
        master_params=spec.pack(params, torch.float32) if master_weights
        else None,
        spec=spec)


def tree_common_dtype(tree: Tree, fallback=torch.float32) -> torch.dtype:
    dtypes = {l.dtype for l in tree_leaves(tree)}
    return dtypes.pop() if len(dtypes) == 1 else fallback


def as_flat_grads(grads, spec: PackSpec) -> torch.Tensor:
    """``grads`` as the flat gradient buffer in ``spec``'s layout. Three
    forms: the :class:`BucketBuffers` handoff of the bucketed all-reduce
    (concatenated here), a 1-D buffer of exactly ``spec.total`` elements
    (the reduced buffer, taken as it is), or a tree (packed in its
    leaves' common dtype). Any other 1-D length raises, unless the
    tensor is the spec's own single-leaf tree (a bare leaf of that
    shape), which packs."""
    if isinstance(grads, BucketBuffers):
        return spec.concat_buckets(grads.buffers)
    if isinstance(grads, torch.Tensor) and grads.dim() == 1 and not (
            spec.n_leaves == 1 and spec.shapes[0] == tuple(grads.shape)
            and spec.treedef == ("leaf",)):
        if grads.shape[0] != spec.total:
            raise ValueError(
                f"flat gradient buffer has {grads.shape[0]} elements but "
                f"the optimizer's PackSpec lays out {spec.total}: build the "
                "optimizer over the same spec as the gradient buckets "
                "(packed_spec=buckets.spec)")
        return grads
    return spec.pack(grads, tree_common_dtype(grads))


def packed_src(state: PackedState, params: Tree,
               master_weights: bool) -> torch.Tensor:
    """The fp32 update source: the resident masters, or the params
    packed on the fly."""
    if master_weights:
        return state.master_params
    return state.spec.pack(params, torch.float32)
