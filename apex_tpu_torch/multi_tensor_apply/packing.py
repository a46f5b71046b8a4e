"""Flat-buffer packing: the bookkeeping behind the packed optimizer and
the bucketed gradient all-reduce (counterpart of
``apex_tpu/multi_tensor_apply/packing.py``).

:class:`PackSpec` lays every leaf of a parameter tree into one
contiguous 1-D buffer: leaves in the JAX package's flatten order (dicts
by sorted key, ``_tree.tree_flatten``), each at an offset aligned to
``align`` elements (a multiple of ``ROW``), the total padded to a whole
number of chunks. Offsets and leaf order equal the JAX package's for the
same tree, so flat buffers of the two packages compare element by
element. Padding is always zero. The paged KV pool uses ``ROW`` and
:func:`is_row_aligned`.

With ``bucket_elems`` the same layout is cut into contiguous buckets of
whole chunks, in one walk over the leaves: a bucket closes when the next
leaf would overflow it (and it already holds a leaf; an oversized leaf
gets a bucket of its own), the offset rounding up to the next chunk
boundary inside the previous leaf's padding. Each bucket's buffer
(:meth:`PackSpec.pack_bucket`) depends on its own leaves alone, and the
buckets concatenate (:meth:`PackSpec.concat_buckets`) into exactly the
buffer :meth:`PackSpec.pack` writes: the layout the data-parallel
all-reduce (one collective a bucket, ``parallel.GradBuckets``) and the
packed optimizer kernels share. :class:`BucketBuffers` carries the
reduced buckets to the optimizer without concatenating them first.
"""
from __future__ import annotations

from typing import Any, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from .._tree import leaf_paths, tree_flatten, tree_unflatten

#: the packed-buffer row: 8 sublanes x 128 lanes, the unit every packed
#: leaf and every KV page is aligned to
ROW = 8 * 128

#: the reference's default chunk: 2048 * 32 elements
DEFAULT_CHUNK = 2048 * 32


class BucketBuffers(NamedTuple):
    """Per-bucket flat gradient buffers, not yet concatenated: the
    handoff of the bucketed all-reduce
    (``parallel.sync_gradients_bucketed(concat=False)``), each element
    one bucket's reduced buffer in the shared :class:`PackSpec` layout.
    The packed optimizers and ``LossScaler.unscale_flat`` take it and
    concatenate there; ``LossScaler.found_inf_flat`` reads the buckets
    one by one."""

    buffers: Tuple[torch.Tensor, ...]


def is_row_aligned(n_elems: int) -> bool:
    """True when ``n_elems`` fills whole ``ROW``s."""
    return int(n_elems) % ROW == 0


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


class PackSpec:
    """Static tree <-> aligned flat buffer map, cut into buckets of at
    most ``bucket_elems`` elements (one bucket without it). Equal specs
    (the same tree structure, shapes, dtypes, ``align``, chunk and
    bucket cap) compare equal and hash alike, as the JAX package's."""

    def __init__(self, params_template: Any, align: int = ROW,
                 chunk_size: int = DEFAULT_CHUNK,
                 bucket_elems: Optional[int] = None):
        if align % ROW:
            raise ValueError(f"align ({align}) must be a multiple of {ROW}")
        chunk_size = _round_up(int(chunk_size), align)
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
        self.align = align
        self.chunk_size = chunk_size
        self.bucket_elems = int(bucket_elems) if bucket_elems else None
        # one walk lays out the leaves and closes the buckets: a bucket
        # closes (the offset rounds up to a chunk boundary, absorbed into
        # the previous leaf's padding) when the next leaf would overflow
        # it and it already holds a leaf
        offsets, padded = [], []
        end = 0
        bounds, ranges, start_leaf = [0], [], 0
        for i, n in enumerate(self.sizes):
            pn = _round_up(n, align)
            if (self.bucket_elems and i > start_leaf
                    and (end - bounds[-1]) + pn > self.bucket_elems):
                b = _round_up(end, chunk_size)
                padded[-1] += b - end
                end = b
                bounds.append(b)
                ranges.append((start_leaf, i))
                start_leaf = i
            offsets.append(end)
            padded.append(pn)
            end += pn
        self.total = _round_up(end, chunk_size)
        bounds.append(self.total)
        ranges.append((start_leaf, self.n_leaves))
        self.offsets: Tuple[int, ...] = tuple(offsets)
        self.padded_sizes: Tuple[int, ...] = tuple(padded)
        self.bucket_bounds: Tuple[int, ...] = tuple(bounds)
        self.bucket_leaf_ranges: Tuple[Tuple[int, int], ...] = tuple(ranges)
        self.n_rows = self.total // ROW
        self._row_segments = {}  # device -> row_segments() tensors

    @property
    def n_buckets(self) -> int:
        return len(self.bucket_bounds) - 1

    def _key(self):
        return (self.treedef, self.shapes,
                tuple(str(d) for d in self.dtypes),
                self.align, self.chunk_size, self.bucket_elems)

    def __eq__(self, other):
        return isinstance(other, PackSpec) and self._key() == other._key()

    def __hash__(self):
        return hash(self._key())

    def __repr__(self):
        return (f"PackSpec(n_leaves={self.n_leaves}, total={self.total}, "
                f"chunk_size={self.chunk_size}, n_buckets={self.n_buckets})")

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

    def pack_bucket(self, tree: Any, bucket: int,
                    dtype: Optional[torch.dtype] = None) -> torch.Tensor:
        """Ravel + zero-pad bucket ``bucket``'s leaves alone to its
        extent (``bucket_bounds[b + 1] - bucket_bounds[b]`` elements), in
        ``dtype`` (default: the leaves' common dtype). The buckets'
        buffers concatenate into :meth:`pack`'s."""
        self.check(tree)
        dtype = dtype if dtype is not None else self.common_dtype()
        lo, hi = self.bucket_leaf_ranges[bucket]
        b0 = self.bucket_bounds[bucket]
        leaves = tree_flatten(tree)[0][lo:hi]
        out = torch.zeros(self.bucket_bounds[bucket + 1] - b0, dtype=dtype,
                          device=leaves[0].device)
        for leaf, o, n in zip(leaves, self.offsets[lo:hi],
                              self.sizes[lo:hi]):
            out[o - b0:o - b0 + n].copy_(leaf.reshape(-1))
        return out

    def bucket_slice(self, flat: torch.Tensor, bucket: int) -> torch.Tensor:
        """Bucket ``bucket``'s sub-buffer of a packed global buffer (a
        view)."""
        return flat[self.bucket_bounds[bucket]:self.bucket_bounds[bucket + 1]]

    def concat_buckets(self, buffers) -> torch.Tensor:
        """Per-bucket buffers, in order, as the ``(total,)`` global buffer
        (one copy; a single bucket is returned as it is)."""
        buffers = list(buffers)
        if len(buffers) != self.n_buckets:
            raise ValueError(f"expected {self.n_buckets} bucket buffers, "
                             f"got {len(buffers)}")
        for b, buf in enumerate(buffers):
            extent = self.bucket_bounds[b + 1] - self.bucket_bounds[b]
            if tuple(buf.shape) != (extent,):
                raise ValueError(f"bucket {b} buffer has shape "
                                 f"{tuple(buf.shape)}, expected ({extent},)")
        return buffers[0] if len(buffers) == 1 else torch.cat(buffers)

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

    def shard_bounds(self, shard_count: int) -> Tuple[Tuple[int, int], ...]:
        """Equal ROW-aligned element ranges ``[(lo, hi), ...]`` cutting
        ``[0, total)`` into ``shard_count`` contiguous shards; raises
        where the layout admits none (the total not divisible by the
        count, or a shard not whole rows)."""
        shard_count = int(shard_count)
        if shard_count <= 0:
            raise ValueError(f"shard_count must be > 0, got {shard_count}")
        if self.total % shard_count:
            raise ValueError(
                f"total {self.total} is not divisible by shard_count "
                f"{shard_count}: build the spec with a chunk_size that is a "
                f"multiple of shard_count*ROW ({shard_count * ROW})")
        size = self.total // shard_count
        if size % ROW:
            raise ValueError(f"shard size {size} is not ROW-aligned ({ROW}):"
                             f" shard boundaries would split rows")
        return tuple((h * size, (h + 1) * size) for h in range(shard_count))

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
        leaf's padded extent in flatten order, then the trailing padding
        rows. Leaves occupy contiguous row ranges in this order, so a
        per-leaf sum over rows needs no scatter; a leaf's segment also
        holds its padding rows (whole rows past its elements, where
        ``align`` exceeds a row or a bucket closes), which are zero and
        which :meth:`row_leaf_ids` gives to no leaf."""
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


def layout_findings(spec: PackSpec) -> List[Tuple[str, str]]:
    """``(code, message)`` for each invariant of ``spec``'s layout that
    fails (none for a spec this module built): ROW and chunk alignment,
    no overlap between leaves, bucket bounds on chunk boundaries covering
    ``[0, total)``, and bucket leaf ranges partitioning the leaves in
    order, each leaf inside its bucket. The checks and their codes are
    those of the JAX package's ``analysis.check_pack_spec``."""
    out = []

    def err(code, msg):
        out.append((code, msg))

    lens = {"offsets": len(spec.offsets), "sizes": len(spec.sizes),
            "padded_sizes": len(spec.padded_sizes),
            "shapes": len(spec.shapes), "dtypes": len(spec.dtypes)}
    if len(set(lens.values())) != 1 or lens["offsets"] != spec.n_leaves:
        err("inconsistent_leaf_tables", f"per-leaf tables disagree in "
            f"length ({lens}, n_leaves={spec.n_leaves})")
    if spec.align % ROW:
        err("align_not_row_multiple",
            f"align {spec.align} is not a multiple of ROW ({ROW})")
    if spec.chunk_size % spec.align:
        err("chunk_not_aligned", f"chunk_size {spec.chunk_size} is not a "
            f"multiple of align {spec.align}")
    if spec.total % spec.chunk_size:
        err("total_not_chunk_multiple", f"total {spec.total} is not a "
            f"multiple of chunk_size {spec.chunk_size}")
    end = 0
    for i, (off, n, pn) in enumerate(zip(spec.offsets, spec.sizes,
                                         spec.padded_sizes)):
        if off % ROW:
            err("misaligned_offset",
                f"leaf {i} offset {off} is not ROW-aligned ({ROW})")
        if off < end:
            err("overlapping_leaves", f"leaf {i} offset {off} overlaps the "
                f"previous leaf's padded extent {end}")
        if pn < n:
            err("padded_size_too_small",
                f"leaf {i} padded size {pn} < element count {n}")
        end = off + pn
    if end > spec.total:
        err("leaves_exceed_total",
            f"leaf extents end at {end} > total {spec.total}")
    bounds, ranges = spec.bucket_bounds, spec.bucket_leaf_ranges
    if bounds[0] != 0 or bounds[-1] != spec.total:
        err("bucket_bounds_cover", f"bucket bounds {bounds[0]}.."
            f"{bounds[-1]} do not cover [0, {spec.total})")
    prev = None
    for b in bounds:
        if b % spec.chunk_size:
            err("bucket_not_chunk_aligned", f"bucket boundary {b} is not a "
                f"multiple of chunk_size {spec.chunk_size}")
        if prev is not None and b <= prev:
            err("bucket_bounds_not_increasing",
                f"bucket boundary {b} does not increase past {prev}")
        prev = b
    n_tab = min(spec.n_leaves, len(spec.offsets), len(spec.padded_sizes))
    if len(ranges) != len(bounds) - 1:
        err("bucket_tables_mismatch", f"{len(ranges)} bucket leaf ranges "
            f"for {len(bounds) - 1} buckets")
    expect = 0
    for bi, (lo, hi) in enumerate(ranges[:len(bounds) - 1]):
        if lo != expect or hi < lo:
            err("bucket_leaves_not_partition", f"bucket {bi} leaf range "
                f"({lo}, {hi}) breaks the in-order partition (expected "
                f"start {expect})")
        for li in range(lo, min(hi, n_tab)):
            o, pn = spec.offsets[li], spec.padded_sizes[li]
            if o < bounds[bi] or o + pn > bounds[bi + 1]:
                err("leaf_outside_bucket", f"leaf {li} extent [{o}, "
                    f"{o + pn}) escapes bucket {bi} bounds [{bounds[bi]}, "
                    f"{bounds[bi + 1]})")
        expect = hi
    if expect != spec.n_leaves:
        err("bucket_leaves_not_partition", f"bucket leaf ranges end at "
            f"{expect}, expected {spec.n_leaves}")
    return out
