"""Flat-buffer packing: the bookkeeping behind the packed optimizer
(counterpart of ``apex_tpu/multi_tensor_apply/packing.py``).

:class:`PackSpec` lays every leaf of a parameter tree into one
contiguous 1-D buffer: leaves in the JAX package's flatten order (dicts
by sorted key, ``_tree.tree_flatten``), each at an offset aligned to
``ROW`` elements, the total padded to a whole number of chunks. Offsets
and leaf order equal the JAX package's for the same tree, so flat
buffers of the two packages compare element by element. Padding is
always zero. The paged KV pool uses ``ROW`` and :func:`is_row_aligned`.

Buckets (``bucket_elems``, ``pack_bucket``, ``shard_bounds``) come with
the distributed slice (ROADMAP.md, queue A6.2).
"""
from __future__ import annotations

from typing import Any, Optional, Tuple

import numpy as np
import torch

from .._tree import leaf_paths, tree_flatten, tree_unflatten

#: the packed-buffer row: 8 sublanes x 128 lanes, the unit every packed
#: leaf and every KV page is aligned to
ROW = 8 * 128

#: the reference's default chunk: 2048 * 32 elements
DEFAULT_CHUNK = 2048 * 32


def is_row_aligned(n_elems: int) -> bool:
    """True when ``n_elems`` fills whole ``ROW``s."""
    return int(n_elems) % ROW == 0


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


class PackSpec:
    """Static tree <-> aligned flat buffer map (one bucket)."""

    def __init__(self, params_template: Any,
                 chunk_size: int = DEFAULT_CHUNK):
        chunk_size = _round_up(int(chunk_size), ROW)
        leaves, treedef = tree_flatten(params_template)
        if not leaves:
            raise ValueError("cannot build a PackSpec over an empty tree")
        self.treedef = treedef
        self.shapes: Tuple[Tuple[int, ...], ...] = tuple(
            tuple(l.shape) for l in leaves)
        self.dtypes: Tuple[torch.dtype, ...] = tuple(l.dtype for l in leaves)
        self.sizes: Tuple[int, ...] = tuple(
            int(np.prod(s)) if s else 1 for s in self.shapes)
        self.n_leaves = len(leaves)
        self.chunk_size = chunk_size
        offsets, padded = [], []
        end = 0
        for n in self.sizes:
            pn = _round_up(n, ROW)
            offsets.append(end)
            padded.append(pn)
            end += pn
        self.total = _round_up(end, chunk_size)
        self.offsets: Tuple[int, ...] = tuple(offsets)
        self.padded_sizes: Tuple[int, ...] = tuple(padded)
        self.n_rows = self.total // ROW
        self._row_segments = {}  # device -> row_segments() tensors

    def __repr__(self):
        return (f"PackSpec(n_leaves={self.n_leaves}, total={self.total}, "
                f"chunk_size={self.chunk_size})")

    def common_dtype(self, fallback: torch.dtype = torch.float32
                     ) -> torch.dtype:
        """The single dtype of the template leaves, or ``fallback`` when
        they mix dtypes (:meth:`unpack` casts each leaf back)."""
        return self.dtypes[0] if len(set(self.dtypes)) == 1 else fallback

    def check(self, tree: Any) -> None:
        leaves = tree_flatten(tree)[0]
        if len(leaves) != self.n_leaves or tuple(
                tuple(l.shape) for l in leaves) != self.shapes:
            raise ValueError(
                "tree does not match PackSpec (same optimizer instance "
                f"reused for a different model?): spec {self!r} vs "
                f"{len(leaves)} leaves")

    def pack(self, tree: Any, dtype: Optional[torch.dtype] = None
             ) -> torch.Tensor:
        """Ravel + per-leaf zero-pad + concatenate to ``(total,)``, in
        ``dtype`` (default: the leaves' common dtype), on the leaves'
        device. One write of the buffer."""
        self.check(tree)
        dtype = dtype if dtype is not None else self.common_dtype()
        leaves = tree_flatten(tree)[0]
        out = torch.zeros(self.total, dtype=dtype, device=leaves[0].device)
        for leaf, o, n in zip(leaves, self.offsets, self.sizes):
            out[o:o + n].copy_(leaf.reshape(-1))
        return out

    def unpack(self, flat: torch.Tensor, cast: bool = True) -> Any:
        """``(total,)`` -> tree. Each leaf is a view into ``flat`` (no
        copy) unless ``cast`` has to change its dtype to the template's."""
        if flat.shape != (self.total,):
            raise ValueError(f"flat buffer of shape {tuple(flat.shape)}, "
                             f"spec lays out ({self.total},)")
        leaves = []
        for i in range(self.n_leaves):
            o = self.offsets[i]
            piece = flat[o:o + self.sizes[i]].view(self.shapes[i])
            if cast and piece.dtype != self.dtypes[i]:
                piece = piece.to(self.dtypes[i])
            leaves.append(piece)
        return tree_unflatten(self.treedef, leaves)

    def zeros(self, dtype: torch.dtype = torch.float32,
              device=None) -> torch.Tensor:
        return torch.zeros(self.total, dtype=dtype, device=device)

    def leaf_names(self) -> Tuple[str, ...]:
        """Leaf path strings in flatten order, in the JAX package's
        (``jax.tree_util.keystr``) format."""
        return tuple(leaf_paths(self.treedef))

    def row_leaf_ids(self) -> np.ndarray:
        """int32 ``(n_rows,)``: leaf index owning each ROW-sized row;
        padding rows get ``n_leaves``."""
        ids = np.full((self.n_rows,), self.n_leaves, np.int32)
        for i in range(self.n_leaves):
            r0 = self.offsets[i] // ROW
            r1 = (self.offsets[i] + self.sizes[i] + ROW - 1) // ROW
            ids[r0:r1] = i
        return ids

    def row_segment_lengths(self) -> np.ndarray:
        """int64 ``(n_leaves + 1,)``: the number of ROW-sized rows of each
        leaf in flatten order, then the trailing padding rows. Leaves
        occupy contiguous row ranges in this order, so these lengths are
        the segments of :meth:`row_leaf_ids` (a per-leaf sum over rows
        needs no scatter)."""
        lengths = np.array([p // ROW for p in self.padded_sizes] + [0],
                           np.int64)
        lengths[-1] = self.n_rows - lengths[:-1].sum()
        return lengths

    def row_segments(self, device) -> Tuple[torch.Tensor, torch.Tensor]:
        """``(row_segment_lengths, row_leaf_ids)`` as int64 tensors on
        ``device``, copied there once per spec and device and reused by
        every later step (the step itself copies nothing from the
        host)."""
        device = torch.device(device)
        if device not in self._row_segments:
            self._row_segments[device] = (
                torch.from_numpy(self.row_segment_lengths()).to(device),
                torch.from_numpy(self.row_leaf_ids().astype(np.int64)).to(
                    device))
        return self._row_segments[device]

    def valid_mask(self) -> np.ndarray:
        """bool ``(total,)``: True at real positions, False at padding."""
        mask = np.zeros((self.total,), bool)
        for o, n in zip(self.offsets, self.sizes):
            mask[o:o + n] = True
        return mask
