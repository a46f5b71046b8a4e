"""Data-parallel gradient synchronisation over ``torch.distributed``
(counterpart of ``apex_tpu/parallel/distributed.py``).

The reference's ``apex.parallel.DistributedDataParallel``
(``apex/parallel/distributed.py:131-643``) wraps an ``nn.Module``, hooks
its backward and all-reduces flat buckets of gradients on side streams.
The JAX package keeps the semantics as a functional transform of a
gradient tree; so does the port, with the collectives of
``torch.distributed`` in place of ``psum``:

- :func:`sync_gradients`: one ``all_reduce`` a leaf, the reference's
  arithmetic (``allreduce_always_fp32``, the pre-division before the sum
  and the post-division after it, mean or sum);
- :class:`GradBuckets` + :func:`sync_gradients_bucketed`: the tree
  packed into chunk-aligned buckets of one ``PackSpec`` layout, ONE
  ``all_reduce`` a bucket, and the reduced buckets concatenated into the
  very buffer the packed optimizers sweep (``FusedAdam(packed=True,
  packed_spec=buckets.spec)``), or handed over unconcatenated as
  ``BucketBuffers`` (``concat=False``);
- :class:`DistributedDataParallel`: the wrapper of a gradient function
  (``_tree.value_and_grad``), not of a module; :class:`Reducer`, the
  manual average.

Groups: an ``axis_name`` of the JAX API names a ``parallel_state`` axis.
It resolves to that axis's process group when model parallelism is
initialised, to the default group otherwise, and, with no process group
at all, to a world of 1 (no collective runs; the arithmetic is the same),
as the JAX functions behave on one device (:func:`axis_group`). A
``ProcessGroup`` may stand in for the name.

Each collective is issued with ``async_op=True`` in bucket (or leaf)
order and waited on just before its result is read by the post-division;
with NCCL the wait makes the current stream wait for the collective, so
nothing waits on the host. Overlap with the backward (the reference's
hooks; XLA's scheduler in the JAX package) is not done here. Each
bucket's collective runs under a ``torch.profiler.record_function``
range named ``apex_tpu.grad_bucket/<i>``, the JAX package's scope names.

``message_size``, ``delay_allreduce``, ``shared_param``,
``allreduce_trigger_params``, ``retain_allreduce_buffers`` and
``num_allreduce_streams`` configure the reference's hooks and streams;
they are accepted and ignored, as in the JAX package.
"""
from __future__ import annotations

import functools
from typing import Any, Callable, NamedTuple, Optional, Tuple

import torch
import torch.distributed as dist

from .._tree import tree_flatten, tree_leaves, tree_map, tree_unflatten
from ..multi_tensor_apply.packing import (
    DEFAULT_CHUNK,
    ROW,
    BucketBuffers,
    PackSpec,
    layout_findings,
)

Tree = Any


# ---------------------------------------------------------------------------
# groups
# ---------------------------------------------------------------------------

def axis_group(axis_name) -> Tuple[Any, int]:
    """``(group, world)`` of an axis name: ``(None, 1)`` without a
    process group (no collective runs); the axis's ``parallel_state``
    group when model parallelism is initialised (a name that is not one
    of its axes raises); else, or for None, the default group (``group``
    None). A ``ProcessGroup`` is taken as it is."""
    active = dist.is_available() and dist.is_initialized()
    if active and isinstance(axis_name, dist.ProcessGroup):
        return axis_name, dist.get_world_size(axis_name)
    from ..transformer import parallel_state as ps

    if axis_name is not None and ps.model_parallel_is_initialized():
        axes = (axis_name,) if isinstance(axis_name, str) else axis_name
        if not set(axes) <= {ps.PIPELINE_AXIS, ps.DATA_AXIS,
                             ps.TENSOR_AXIS}:
            raise ValueError(
                f"axis {axis_name!r} is not an axis of the initialized "
                f"model-parallel layout ({ps.PIPELINE_AXIS!r}, "
                f"{ps.DATA_AXIS!r}, {ps.TENSOR_AXIS!r})")
        if active:
            return ps.get_group(axes), len(ps.get_group_ranks(axes))
    if not active:
        return None, 1
    return None, dist.get_world_size()


def _all_reduce(buf: torch.Tensor, group):
    """An in-place sum over ``group``, issued asynchronously: the work
    handle (None where no collective runs)."""
    return dist.all_reduce(buf, group=group, async_op=True)


def _div(g: torch.Tensor, v: float) -> torch.Tensor:
    """``g / v`` as a true division in ``g``'s precision (a divisor on
    ``g``'s device, so no kernel turns it into a reciprocal multiply),
    the JAX package's ``g / python_float``."""
    return g / torch.full((), v, dtype=g.dtype, device=g.device)


# ---------------------------------------------------------------------------
# flatten / unflatten (apex_C)
# ---------------------------------------------------------------------------

def flatten(tree: Tree) -> torch.Tensor:
    """Every leaf of ``tree`` raveled into one 1-D buffer, in flatten
    order, in the leaves' promoted dtype (``apex_C.flatten``,
    ``csrc/flatten_unflatten.cpp:6-10``; the JAX package's
    ``ravel_pytree``). An empty tree gives an empty fp32 buffer."""
    leaves = tree_leaves(tree)
    if not leaves:
        return torch.zeros(0, dtype=torch.float32)
    dtype = functools.reduce(torch.promote_types,
                             (l.dtype for l in leaves))
    return torch.cat([l.reshape(-1).to(dtype) for l in leaves])


def unflatten(flat: torch.Tensor, tree: Tree) -> Tree:
    """``flat`` cut back into the structure, shapes and dtypes of the
    template ``tree`` (``apex_C.unflatten``)."""
    leaves, treedef = tree_flatten(tree)
    out, o = [], 0
    for l in leaves:
        n = l.numel()
        out.append(flat[o:o + n].reshape(l.shape).to(l.dtype))
        o += n
    if o != flat.numel():
        raise ValueError(f"flat buffer of {flat.numel()} elements, the "
                         f"template holds {o}")
    return tree_unflatten(treedef, out)


# ---------------------------------------------------------------------------
# the reduction arithmetic
# ---------------------------------------------------------------------------

def _pre(g: torch.Tensor, gradient_predivide_factor: float,
         owned: bool) -> torch.Tensor:
    """The reference's pre-division (``apex/parallel/distributed.py:
    454-459``), into a buffer this module owns (the collective sums in
    place, and the caller's gradients stay as they were)."""
    if gradient_predivide_factor != 1.0:
        return _div(g, gradient_predivide_factor)
    return g if owned else g.clone()


def _post(g: torch.Tensor, world: int, *, gradient_average: bool,
          gradient_predivide_factor: float) -> torch.Tensor:
    """After the sum: ``/ (world / predivide)`` for a mean, else ``*
    predivide`` where it was divided (``:429-479``)."""
    if gradient_average:
        return _div(g, world / gradient_predivide_factor)
    if gradient_predivide_factor != 1.0:
        return g * gradient_predivide_factor
    return g


def _active() -> bool:
    return dist.is_available() and dist.is_initialized()


def _reduce_buffers(bufs, axis_name, names=None, **kw):
    """The reference ``allreduce_bucket`` arithmetic (the JAX package's
    ``_reduce_buffer``) on buffers this module owns, already pre-divided
    (:func:`_pre`): every sum issued first, in order (under the profiler
    range ``names[i]`` where given), then each waited on and post-divided
    in order (:func:`_post`). The per-leaf and the bucketed paths share
    it, so the two agree element for element. Returns the reduced
    buffers."""
    group, world = axis_group(axis_name)
    works = []
    for i, b in enumerate(bufs):
        if not _active():
            works.append(None)
        elif names is None:
            works.append(_all_reduce(b, group))
        else:
            with torch.profiler.record_function(names[i]):
                works.append(_all_reduce(b, group))
    out = []
    for b, w in zip(bufs, works):
        if w is not None:
            w.wait()
        out.append(_post(b, world, **kw))
    return out


def sync_gradients(grads: Tree, axis_name: str = "data", *,
                   gradient_average: bool = True,
                   allreduce_always_fp32: bool = False,
                   gradient_predivide_factor: float = 1.0,
                   keep_fp32: bool = False) -> Tree:
    """All-reduce a gradient tree over ``axis_name``, one collective a
    leaf (``apex/parallel/distributed.py:429-479``): the optional fp32
    upcast, the pre-division, the sum, the post-division, mean or sum.
    ``keep_fp32=True`` keeps upcast leaves in fp32; the default casts
    them back to the leaf dtype (reference parity). The caller's
    tensors are not changed."""
    leaves, treedef = tree_flatten(grads)
    kw = dict(gradient_average=gradient_average,
              gradient_predivide_factor=gradient_predivide_factor)
    bufs = []
    for g in leaves:
        b = g.to(torch.float32) if allreduce_always_fp32 else g
        bufs.append(_pre(b, gradient_predivide_factor, owned=b is not g))
    out = _reduce_buffers(bufs, axis_name, **kw)
    if not keep_fp32:
        out = [o.to(g.dtype) for o, g in zip(out, leaves)]
    return tree_unflatten(treedef, out)


# ---------------------------------------------------------------------------
# buckets
# ---------------------------------------------------------------------------

class GradBuckets:
    """The bucket structure of the flat-buffer gradient lifecycle.

    The reference DDP discovers its buckets from the hooks' firing order
    on the first backward (``apex/parallel/distributed.py:340-427``);
    here, as in the JAX package, they are laid out up front from the
    tree: leaves in flatten order, greedily filled to ``bucket_cap_mb``
    measured in ``reduce_dtype`` (pass ``torch.float32`` when the
    reduction runs in fp32, so that the cap prices the buffers the
    collective moves; an oversized leaf gets a bucket of its own), each
    bucket a chunk-aligned range of ONE :class:`PackSpec` layout. The
    reduced buckets concatenate into the buffer the packed optimizers
    sweep, so nothing is packed again between the all-reduce and the
    update: build the optimizer with ``packed_spec=buckets.spec``."""

    def __init__(self, template: Tree, *, bucket_cap_mb: float = 25.0,
                 align: int = ROW, chunk_size: int = DEFAULT_CHUNK,
                 reduce_dtype=None):
        if bucket_cap_mb <= 0:
            raise ValueError(
                f"bucket_cap_mb must be > 0, got {bucket_cap_mb}")
        leaves = tree_leaves(template)
        if not leaves:
            raise ValueError("cannot bucket an empty gradient tree")
        dtypes = {l.dtype for l in leaves}
        self.grad_dtype = dtypes.pop() if len(dtypes) == 1 else torch.float32
        self.reduce_dtype = (reduce_dtype if reduce_dtype is not None
                             else self.grad_dtype)
        itemsize = self.reduce_dtype.itemsize
        self.bucket_cap_mb = float(bucket_cap_mb)
        cap_elems = max(int(bucket_cap_mb * 2 ** 20) // itemsize, 1)
        self.spec = PackSpec(template, align=align, chunk_size=chunk_size,
                             bucket_elems=cap_elems)

    @property
    def n_buckets(self) -> int:
        return self.spec.n_buckets

    def pack(self, grads: Tree, dtype=None):
        """The K per-bucket flat buffers of ``grads``, in ``dtype``
        (default ``reduce_dtype``); each depends on its own leaves
        alone."""
        dtype = dtype if dtype is not None else self.reduce_dtype
        return [self.spec.pack_bucket(grads, b, dtype)
                for b in range(self.n_buckets)]

    def concat(self, buffers) -> torch.Tensor:
        return self.spec.concat_buckets(buffers)

    def unpack(self, flat: torch.Tensor) -> Tree:
        return self.spec.unpack(flat)

    def sweep_bytes(self) -> int:
        """The least device-memory traffic of one bucketed reduction, in
        bytes: every gradient leaf read and the packed buckets written,
        then each reduced bucket read and written once more, at the
        padded length (``spec.total``); link traffic is not counted."""
        total = self.spec.total
        return int(self.grad_dtype.itemsize * total
                   + 3 * self.reduce_dtype.itemsize * total)

    def check(self) -> None:
        """Raise if the layout breaks an invariant of the packed path (ROW
        and chunk alignment, no overlap, chunk-aligned bucket bounds, an
        in-order leaf partition: ``packing.layout_findings``)."""
        findings = layout_findings(self.spec)
        if findings:
            raise ValueError(
                f"GradBuckets layout violates packing invariants ({self!r}):"
                "\n" + "\n".join(f"- {c}: {m}" for c, m in findings))

    def __repr__(self):
        return (f"GradBuckets(n_buckets={self.n_buckets}, "
                f"total={self.spec.total}, "
                f"bucket_cap_mb={self.bucket_cap_mb})")


def sync_gradients_bucketed(
        grads: Tree, axis_name: str = "data", *,
        buckets: Optional[GradBuckets] = None, bucket_cap_mb: float = 25.0,
        gradient_average: bool = True, allreduce_always_fp32: bool = False,
        gradient_predivide_factor: float = 1.0,
        match_leaf_dtype: bool = False, concat: bool = True):
    """The bucketed all-reduce (the reference's ``allreduce_fallback`` /
    ``flat_dist_call``, ``apex/parallel/distributed.py:282-305``): K
    collectives, one a bucket, in place of one a leaf.

    ``grads`` is packed into ``buckets`` (built from its structure when
    not given, the cap sized in fp32 under ``allreduce_always_fp32``),
    each bucket summed by one ``all_reduce``, and ``(flat, buckets)``
    returned: ``flat`` the reduced global buffer in ``buckets.spec``'s
    layout, for ``LossScaler.unscale_flat`` and a packed optimizer over
    the same spec. ``allreduce_always_fp32`` casts each bucket up once,
    at packing, and the result stays fp32 unless ``match_leaf_dtype``
    casts it back (one downcast a bucket, the per-leaf path's
    semantics). ``concat=False`` returns the buckets as
    :class:`BucketBuffers`, which the packed optimizers and the scaler
    take as they are."""
    if buckets is None:
        buckets = GradBuckets(
            grads, bucket_cap_mb=bucket_cap_mb,
            reduce_dtype=torch.float32 if allreduce_always_fp32 else None)
    reduce_dtype = (torch.float32 if allreduce_always_fp32
                    else buckets.reduce_dtype)
    bufs = [_pre(b, gradient_predivide_factor, owned=True)
            for b in buckets.pack(grads, reduce_dtype)]
    out = _reduce_buffers(
        bufs, axis_name,
        names=[f"apex_tpu.grad_bucket/{i}" for i in range(len(bufs))],
        gradient_average=gradient_average,
        gradient_predivide_factor=gradient_predivide_factor)
    if match_leaf_dtype:
        out = [o.to(buckets.grad_dtype) for o in out]
    if not concat:
        return BucketBuffers(tuple(out)), buckets
    return buckets.concat(out), buckets


class Reducer:
    """Manual averaging across the data-parallel group (reference
    ``apex/parallel/distributed.py:91-128``): ``reduce(tree)`` returns
    each leaf's mean over the ranks of ``axis_name``."""

    def __init__(self, axis_name: str = "data"):
        self.axis_name = axis_name

    def reduce(self, tree: Tree) -> Tree:
        leaves, treedef = tree_flatten(tree)
        group, world = axis_group(self.axis_name)
        bufs = [l.clone() for l in leaves]
        works = [_all_reduce(b, group) if _active() else None for b in bufs]
        out = []
        for b, w in zip(bufs, works):
            if w is not None:
                w.wait()
            out.append(_div(b, world))
        return tree_unflatten(treedef, out)


class CollectiveBudget(NamedTuple):
    """The collectives a step declares: ``counts`` by collective,
    ``axes`` they run over (the JAX package's
    ``analysis.CollectiveBudget`` fields; the auditor that enforces one
    comes with the static analysis)."""

    counts: dict
    axes: Tuple[str, ...]


class DistributedDataParallel:
    """Functional DDP: wraps a gradient function so that its gradients
    come out synchronised across the data-parallel group.

        ddp = DistributedDataParallel(axis_name="data")
        grad_fn = ddp.wrap_grad_fn(
            lambda p: _tree.value_and_grad(loss_fn, p), has_value=True)
        loss, grads = grad_fn(params)          # already all-reduced

    With ``bucket_cap_mb``, :meth:`sync` runs the bucketed reduction (one
    collective a bucket) and :meth:`reduce_flat` hands the reduced global
    buffer to the packed lifecycle::

        buckets = GradBuckets(params, bucket_cap_mb=25)
        ddp = DistributedDataParallel("data", bucket_cap_mb=25)
        opt = FusedAdam(packed=True, master_weights=True,
                        packed_spec=buckets.spec)
        flat, _ = ddp.reduce_flat(grads, buckets=buckets)
        flat, sstate = scaler.unscale_flat(sstate, flat,
                                           out_dtype=torch.float32)
        params, opt_state = opt.step(flat, opt_state, params,
                                     found_inf=sstate.found_inf)
    """

    def __init__(self, axis_name: str = "data",
                 message_size: int = 10_000_000,
                 delay_allreduce: bool = False,
                 shared_param: Optional[bool] = None,
                 allreduce_trigger_params: Optional[list] = None,
                 retain_allreduce_buffers: bool = False,
                 allreduce_always_fp32: bool = False,
                 num_allreduce_streams: int = 1,
                 gradient_average: bool = True,
                 gradient_predivide_factor: float = 1.0,
                 bucket_cap_mb: Optional[float] = None):
        del message_size, delay_allreduce, shared_param  # hook mechanics
        del allreduce_trigger_params, retain_allreduce_buffers
        del num_allreduce_streams
        self.axis_name = axis_name
        self.allreduce_always_fp32 = allreduce_always_fp32
        self.gradient_average = gradient_average
        self.gradient_predivide_factor = gradient_predivide_factor
        self.bucket_cap_mb = bucket_cap_mb

    def reduce_flat(self, grads: Tree,
                    buckets: Optional[GradBuckets] = None, *,
                    match_leaf_dtype: bool = False, concat: bool = True):
        """The bucketed all-reduce: ``(flat, buckets)``, or
        ``(BucketBuffers, buckets)`` with ``concat=False``
        (:func:`sync_gradients_bucketed`). Pass the ``buckets`` the
        packed optimizer shares."""
        return sync_gradients_bucketed(
            grads, self.axis_name, buckets=buckets,
            bucket_cap_mb=self.bucket_cap_mb or 25.0,
            gradient_average=self.gradient_average,
            allreduce_always_fp32=self.allreduce_always_fp32,
            gradient_predivide_factor=self.gradient_predivide_factor,
            match_leaf_dtype=match_leaf_dtype, concat=concat)

    def collective_budget(self, buckets: GradBuckets, *,
                          extra_psums: int = 0) -> CollectiveBudget:
        """The collectives of a step built on :meth:`reduce_flat`: one
        all-reduce a bucket over this DDP's axis, plus ``extra_psums``
        the step adds (a loss average, an overflow flag)."""
        return CollectiveBudget(
            counts={"all_reduce": buckets.n_buckets + int(extra_psums)},
            axes=(self.axis_name,))

    def sync(self, grads: Tree) -> Tree:
        """The synchronised gradient tree: bucketed with
        ``bucket_cap_mb`` (K collectives, leaf dtypes kept), else one
        collective a leaf."""
        if self.bucket_cap_mb:
            flat, buckets = self.reduce_flat(grads, match_leaf_dtype=True)
            return buckets.unpack(flat)
        return sync_gradients(
            grads, self.axis_name, gradient_average=self.gradient_average,
            allreduce_always_fp32=self.allreduce_always_fp32,
            gradient_predivide_factor=self.gradient_predivide_factor)

    def wrap_grad_fn(self, grad_fn: Callable, has_value: bool = False,
                     flat: bool = False,
                     buckets: Optional[GradBuckets] = None) -> Callable:
        """``grad_fn`` with its gradients synchronised. ``has_value``:
        the output is ``(value, grads)`` and only ``grads`` is synced.
        ``flat=True`` returns the reduced global flat buffer in
        ``buckets.spec``'s layout, and needs ``buckets`` (the layout the
        packed optimizer shares)."""
        if flat and buckets is None:
            raise ValueError(
                "wrap_grad_fn(flat=True) requires buckets=: the flat buffer "
                "is only interpretable through the same GradBuckets the "
                "packed optimizer was built over (packed_spec=buckets.spec)")

        def _out(grads):
            if flat:
                return self.reduce_flat(grads, buckets=buckets)[0]
            return self.sync(grads)

        @functools.wraps(grad_fn)
        def wrapped(*args, **kwargs):
            out = grad_fn(*args, **kwargs)
            if has_value:
                value, grads = out
                return value, _out(grads)
            return _out(out)

        return wrapped

    def broadcast_params(self, params: Tree, src_index: int = 0) -> Tree:
        """``params`` made identical across the group: each leaf is the
        copy held by the group's rank ``src_index`` (the reference's
        initial broadcast, ``distributed.py:257``). Returns new tensors."""
        group, _ = axis_group(self.axis_name)
        out = tree_map(lambda p: p.detach().clone(), params)
        if _active():
            src = (dist.get_global_rank(group, src_index)
                   if group is not None else src_index)
            works = [dist.broadcast(p, src=src, group=group, async_op=True)
                     for p in tree_leaves(out)]
            for w in works:
                w.wait()
        return out
