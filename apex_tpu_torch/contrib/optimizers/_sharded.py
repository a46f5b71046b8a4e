"""The sharded (ZeRO-2) optimizer substrate (counterpart of
``apex_tpu/contrib/optimizers/_sharded.py``).

The reference's ``DistributedFusedAdam`` flattens the params into
buckets, shards the optimizer state and the reduced gradients over a
``distributed`` process group (optionally replicated over a
``redundant`` one) and overlaps bucketed reduce-scatters and
all-gathers with the backward and the forward. The JAX package keeps one
flat fp32 buffer padded to a multiple of the axis size, ``psum_scatter``
into the local shard, a shard-local update and an ``all_gather``; so does
the port, with ``torch.distributed``'s ``reduce_scatter_tensor`` and
``all_gather_into_tensor`` over the axis's process group. A rank is a
process and holds only its own ``(shard_size,)`` slice of every state
buffer.

:class:`ShardedLayout` is the static bookkeeping both ZeRO optimizers
share: tree <-> padded flat buffer, the shard geometry, the per-position
leaf ids (the LAMB trust ratio's segments) and the rank's slice of each.
The shard-local update is plain PyTorch over the flat shard, as the JAX
package's is plain XLA; running the packed sweeps on the shard is queued
as performance work (ROADMAP.md).
"""
from __future__ import annotations

from typing import Any, List, Optional, Tuple

import numpy as np
import torch

from ..._tree import tree_flatten, tree_unflatten
from ...transformer.tensor_parallel.mappings import (
    _all_gather,
    _reduce_scatter,
    all_reduce,
    axis_world,
)

Pytree = Any


class ShardedLayout:
    """Static map between a param tree and a padded flat buffer split
    into ``n_shards`` equal contiguous shards (the reduce-scatter /
    all-gather tiling). Built once from a template; holds no tensors of
    the tree."""

    def __init__(self, params_template: Pytree, n_shards: int):
        if n_shards < 1:
            raise ValueError(f"n_shards must be >= 1, got {n_shards}")
        leaves, treedef = tree_flatten(params_template)
        if not leaves:
            raise ValueError("cannot build a ShardedLayout over an empty pytree")
        self.treedef = treedef
        self.shapes: List[Tuple[int, ...]] = [tuple(l.shape) for l in leaves]
        self.dtypes = [l.dtype for l in leaves]
        self.sizes = [int(np.prod(s)) if s else 1 for s in self.shapes]
        self.n_leaves = len(leaves)
        self.total = sum(self.sizes)
        self.n_shards = n_shards
        self.shard_size = -(-self.total // n_shards)  # ceil
        self.padded = self.shard_size * n_shards
        self.offsets = np.concatenate([[0], np.cumsum(self.sizes)]).tolist()

    # -- tree <-> flat -----------------------------------------------------
    def flatten(self, tree: Pytree, dtype=torch.float32) -> torch.Tensor:
        """Ravel + concat + zero-pad to ``(padded,)`` in ``dtype``."""
        leaves = tree_flatten(tree)[0]
        if len(leaves) != self.n_leaves:
            raise ValueError(
                f"pytree has {len(leaves)} leaves, layout expects {self.n_leaves}"
            )
        shapes = [tuple(l.shape) for l in leaves]
        if shapes != self.shapes:
            raise ValueError(
                f"pytree leaf shapes {shapes} do not match layout {self.shapes} "
                "(same optimizer instance reused for a different model?)"
            )
        flat = torch.cat([l.reshape(-1).to(dtype) for l in leaves])
        pad = self.padded - self.total
        if pad:
            flat = torch.cat([flat, flat.new_zeros(pad)])
        return flat

    def unflatten(self, flat: torch.Tensor, cast: bool = True) -> Pytree:
        """``(padded,)`` -> tree, each leaf cast back to its template
        dtype (``cast``)."""
        leaves = []
        for i in range(self.n_leaves):
            piece = flat[self.offsets[i]:self.offsets[i + 1]].reshape(
                self.shapes[i])
            leaves.append(piece.to(self.dtypes[i]) if cast else piece)
        return tree_unflatten(self.treedef, leaves)

    # -- shard bookkeeping -------------------------------------------------
    def zeros(self, dtype=torch.float32, device=None) -> torch.Tensor:
        """A ``(padded,)`` zero buffer (the global spelling)."""
        return torch.zeros((self.padded,), dtype=dtype, device=device)

    def segment_ids(self, device=None) -> torch.Tensor:
        """int32 ``(padded,)``: the leaf index of every flat position;
        padding gets the extra segment ``n_leaves``."""
        ids = np.full((self.padded,), self.n_leaves, np.int32)
        for i in range(self.n_leaves):
            ids[self.offsets[i]:self.offsets[i + 1]] = i
        return torch.from_numpy(ids).to(device)

    def valid_mask(self, device=None) -> torch.Tensor:
        """bool ``(padded,)``: True at real positions, False at padding."""
        mask = np.zeros((self.padded,), bool)
        mask[:self.total] = True
        return torch.from_numpy(mask).to(device)

    def shard_bounds(self, index: int) -> Tuple[int, int]:
        """The ``[lo, hi)`` flat range of shard ``index``."""
        if not 0 <= index < self.n_shards:
            raise ValueError(f"shard {index} outside [0, {self.n_shards})")
        return index * self.shard_size, (index + 1) * self.shard_size

    def shard_of(self, flat: torch.Tensor, index: int) -> torch.Tensor:
        """Shard ``index``'s ``(shard_size,)`` slice of a ``(padded,)``
        buffer (a copy)."""
        lo, hi = self.shard_bounds(index)
        return flat[lo:hi].clone()


class ShardAxis:
    """A mesh axis name of the JAX API resolved to a process group
    (``tensor_parallel.mappings.axis_world``: the ``parallel_state``
    group of the axis once model parallelism is initialised, else the
    default group; with no process group at all, a world of 1 where every
    collective is the identity). A ``ProcessGroup`` may stand in for the
    name. ``index`` is this process's rank in the group."""

    def __init__(self, axis_name):
        self.name = axis_name
        self.group, self.size, self.index, self.active = axis_world(
            axis_name)

    def reduce_scatter(self, flat: torch.Tensor) -> torch.Tensor:
        """The sum over the group of ``flat``, this rank's ``1/size``
        slice (``psum_scatter(tiled=True)``)."""
        if not self.active:
            return flat
        return _reduce_scatter(flat, self.group, self.size)

    def all_reduce(self, x: torch.Tensor) -> torch.Tensor:
        """A summed copy of ``x`` over the group (``psum``)."""
        return all_reduce(x, self.group) if self.active else x

    def all_gather(self, shard: torch.Tensor) -> torch.Tensor:
        """The ranks' shards concatenated in rank order
        (``all_gather(tiled=True)``)."""
        if not self.active:
            return shard
        return _all_gather(shard, self.group, self.size, 0)


def check_axis(axis: ShardAxis, size: Optional[int], what: str) -> None:
    """Raise unless ``axis`` holds ``size`` ranks (None: any)."""
    if size is not None and axis.size != size:
        where = ("no process group" if not axis.active
                 else f"a group of {axis.size}")
        raise ValueError(
            f"{what} is {size}, but axis {axis.name!r} resolves to {where} "
            f"(world {axis.size})")
