"""Pipeline-parallel utilities (counterpart of
``apex_tpu/transformer/pipeline_parallel/utils.py``): the microbatch
calculator's globals and slicing, the left-to-right LM masks, the
parameter L2 norm, the loss average over data-parallel ranks, memory
reports and the gradient syncs of replicated parameters.

Ranks are processes and every reduction is a ``torch.distributed``
collective over the ``parallel_state`` group of the named axis
(``parallel.distributed.axis_group``; no collective without a process
group). The JAX module's ``pvary``, ``pvary_full``, ``pvary_union_like``
and ``vma_tracking_active`` mark values as varying over mesh axes for
``shard_map``'s type checks; a process holds plain tensors, so they have
no counterpart here. Where the JAX docstrings separate gradients that
the varying-axis transposes already summed from per-device partials,
every gradient here is a per-rank partial, which :func:`sync_grads_by_spec`
and :func:`sync_embedding_grads` sum.
"""
from __future__ import annotations

from typing import Any, Callable, List, Optional, Sequence

import torch
import torch.distributed as dist

from ..._tree import leaf_paths, tree_flatten, tree_map, tree_unflatten
from ...ops.packed_optimizer import multi_tensor_l2norm_flat
from .. import parallel_state
from ..microbatches import (  # noqa: F401
    ConstantNumMicroBatches,
    RampupBatchsizeNumMicroBatches,
    build_num_microbatches_calculator,
)

Pytree = Any

_GLOBAL_NUM_MICROBATCHES_CALCULATOR = None
_GLOBAL_AUTORESUME = None


def _group(axis_name):
    from ...parallel.distributed import axis_group

    group, world = axis_group(axis_name)
    return group, world, dist.is_available() and dist.is_initialized()


def setup_microbatch_calculator(
    rank: int,
    rampup_batch_size: Optional[List[int]],
    global_batch_size: int,
    micro_batch_size: int,
    data_parallel_size: int,
) -> None:
    """Reference ``utils.py:58-75``."""
    global _GLOBAL_NUM_MICROBATCHES_CALCULATOR
    if _GLOBAL_NUM_MICROBATCHES_CALCULATOR is not None:
        raise RuntimeError("num microbatches calculator is already initialized")
    _GLOBAL_NUM_MICROBATCHES_CALCULATOR = build_num_microbatches_calculator(
        rank, rampup_batch_size, global_batch_size, micro_batch_size,
        data_parallel_size)


def _reconfigure_microbatch_calculator(
    rank, rampup_batch_size, global_batch_size, micro_batch_size,
    data_parallel_size,
) -> None:
    """Reference ``utils.py:78-89`` (testing hook)."""
    global _GLOBAL_NUM_MICROBATCHES_CALCULATOR
    _GLOBAL_NUM_MICROBATCHES_CALCULATOR = build_num_microbatches_calculator(
        rank, rampup_batch_size, global_batch_size, micro_batch_size,
        data_parallel_size)


def destroy_num_microbatches_calculator() -> None:
    global _GLOBAL_NUM_MICROBATCHES_CALCULATOR
    _GLOBAL_NUM_MICROBATCHES_CALCULATOR = None


def get_num_microbatches() -> int:
    return _GLOBAL_NUM_MICROBATCHES_CALCULATOR.get()


def get_current_global_batch_size() -> int:
    return _GLOBAL_NUM_MICROBATCHES_CALCULATOR.get_current_global_batch_size()


def get_micro_batch_size() -> int:
    return _GLOBAL_NUM_MICROBATCHES_CALCULATOR.micro_batch_size


def update_num_microbatches(consumed_samples, consistency_check=True) -> None:
    _GLOBAL_NUM_MICROBATCHES_CALCULATOR.update(consumed_samples,
                                               consistency_check)


def get_autoresume():
    """Reference ``utils.py:142`` — the autoresume hook (None)."""
    return _GLOBAL_AUTORESUME


def listify_model(model) -> List[Any]:
    """Reference ``utils.py:115``."""
    return model if isinstance(model, list) else [model]


def get_kth_microbatch(batch: Optional[Pytree], k: int) -> Pytree:
    """Microbatch ``k`` of a batch whose leaves hold the global batch on
    dim 0 (reference ``utils.py:122-139``)."""
    if batch is None:
        return batch
    mbs = get_micro_batch_size()
    start, end = k * mbs, (k + 1) * mbs
    return tree_map(lambda t: t[start:end], batch)


def split_into_microbatches(batch: Pytree, num_microbatches: int) -> Pytree:
    """Leaves ``[gbs, ...] -> [n, gbs / n, ...]``: the schedules'
    microbatched inputs."""
    return tree_map(
        lambda t: t.reshape((num_microbatches, -1) + tuple(t.shape[1:])),
        batch)


def _keep_leaf(path: str, tp_duplicate_paths) -> bool:
    """False for a leaf replicated over the tensor axis on a tensor rank
    other than 0 (it is counted once, on rank 0)."""
    if not tp_duplicate_paths:
        return True
    if not parallel_state.model_parallel_is_initialized() \
            or parallel_state.get_tensor_model_parallel_rank() == 0:
        return True
    if callable(tp_duplicate_paths):
        return not tp_duplicate_paths(path)
    return path not in set(tp_duplicate_paths)


def calc_params_l2_norm(params: Pytree, tp_duplicate_paths=(),
                        axis_name=None) -> torch.Tensor:
    """Global L2 norm of a tree (reference ``utils.py:213-239``): one
    sweep of ``multi_tensor_l2norm_flat`` (the packed row reduction's
    kernel on the card) over the leaves laid end to end, and with
    ``axis_name`` (an axis or axes of ``parallel_state``, e.g.
    ``("pipeline", "tensor")``, the model-parallel group) the squared
    norm summed over that group in one all-reduce.

    ``tp_duplicate_paths``: the leaves replicated over the tensor axis
    (key paths in ``jax.tree_util.keystr`` form, ``['final_ln_w']``, or a
    predicate over them); they count on tensor rank 0 only, as the
    reference drops them on the other ranks. The JAX function leaves
    this to its caller."""
    leaves, treedef = tree_flatten(params)
    paths = leaf_paths(treedef)
    kept = [p.reshape(-1) for p, path in zip(leaves, paths)
            if _keep_leaf(path, tp_duplicate_paths)]
    if not kept:
        dev = leaves[0].device if leaves else None
        sq = torch.zeros((), dtype=torch.float32, device=dev)
    else:
        dtype = kept[0].dtype
        if any(p.dtype != dtype for p in kept):
            kept = [p.float() for p in kept]
        norm, _ = multi_tensor_l2norm_flat(torch.cat(kept))
        sq = norm.float() ** 2
    if axis_name is not None:
        group, world, active = _group(axis_name)
        if active:
            dist.all_reduce(sq, group=group)
    return torch.sqrt(sq)


def allreduce_sequence_parallel_grads(
    grads: Pytree,
    is_sequence_parallel_param: Callable[[str], bool],
    axis_name: Optional[str] = None,
) -> Pytree:
    """Sum over the tensor axis the gradients of the parameters that
    ``is_sequence_parallel_param`` (a required predicate over the key
    path, ``jax.tree_util.keystr`` form) names: under Megatron sequence
    parallelism they are replicated while their activations are
    sequence-sharded, so each rank holds a partial gradient. One
    all-reduce a named leaf."""
    a = axis_name if axis_name is not None else parallel_state.TENSOR_AXIS
    group, _, active = _group(a)
    leaves, treedef = tree_flatten(grads)
    out = []
    for path, leaf in zip(leaf_paths(treedef), leaves):
        if active and is_sequence_parallel_param(path):
            leaf = leaf.clone()
            dist.all_reduce(leaf, group=group)
        out.append(leaf)
    return tree_unflatten(treedef, out)


def average_losses_across_data_parallel_group(losses: Sequence,
                                              axis_name=None):
    """Reference ``utils.py:242-250``: the losses stacked and averaged
    over the data-parallel group (as they are without one)."""
    a = axis_name if axis_name is not None else parallel_state.DATA_AXIS
    averaged = torch.stack([torch.as_tensor(l, dtype=torch.float32)
                            for l in losses])
    group, world, active = _group(a)
    if active and world > 1:
        dist.all_reduce(averaged, group=group)
        averaged = averaged / world
    return averaged


def report_memory(name: str) -> str:
    """Reference ``utils.py:253-262``: the CUDA caching allocator's
    allocated, peak, reserved and peak reserved MB of the current
    device, printed and returned."""
    if not torch.cuda.is_available():
        string = f"{name} memory stats unavailable without a CUDA device"
    else:
        mega = 1024 * 1024
        string = (
            f"{name} memory (MB) | allocated: "
            f"{torch.cuda.memory_allocated() / mega:.1f} | max allocated: "
            f"{torch.cuda.max_memory_allocated() / mega:.1f} | reserved: "
            f"{torch.cuda.memory_reserved() / mega:.1f} | max reserved: "
            f"{torch.cuda.max_memory_reserved() / mega:.1f}")
    print(string, flush=True)
    return string


def print_params_min_max_norm(params: Pytree, iteration: int) -> None:
    """Reference ``utils.py:265-300`` param dump."""
    leaves, treedef = tree_flatten(params)
    for path, leaf in zip(leaf_paths(treedef), leaves):
        l32 = leaf.detach().float()
        print(f"iter {iteration} param {path} min {float(l32.min()):.4e} "
              f"max {float(l32.max()):.4e} norm "
              f"{float(torch.linalg.norm(l32.reshape(-1))):.4e}", flush=True)


def get_ltor_masks_and_position_ids(
    data: torch.Tensor,
    eod_token: int,
    reset_position_ids: bool = False,
    reset_attention_mask: bool = False,
    eod_mask_loss: bool = False,
):
    """Left-to-right LM masks and positions (reference ``utils.py:303-357``,
    the JAX module's cumulative-EOD arithmetic): ``(attention_mask [b, 1,
    s, s] bool, True = masked out; loss_mask [b, s] fp32; position_ids
    [b, s])``. With ``reset_position_ids`` positions restart after each
    EOD (the EOD keeps its position in the document it ends); with
    ``reset_attention_mask`` tokens attend only within their document."""
    b, s = data.shape
    dev = data.device
    causal = torch.ones((s, s), dtype=torch.bool, device=dev).triu(1)
    loss_mask = torch.ones((b, s), dtype=torch.float32, device=dev)
    if eod_mask_loss:
        loss_mask = torch.where(data == eod_token, 0.0, loss_mask)
    position_ids = torch.arange(s, device=dev).expand(b, s)
    is_eod = data == eod_token
    # document id of each token: the EODs strictly before it
    doc_id = torch.cumsum(is_eod.long(), dim=1) - is_eod.long()
    if reset_position_ids:
        doc_start = torch.where(is_eod, position_ids + 1, 0)
        doc_start = torch.nn.functional.pad(doc_start[:, :-1], (1, 0))
        start_of_doc = torch.cummax(doc_start, dim=1).values
        position_ids = position_ids - start_of_doc
    attention_mask = causal.expand(b, 1, s, s)
    if reset_attention_mask:
        same_doc = doc_id[:, None, :, None] == doc_id[:, None, None, :]
        attention_mask = attention_mask | ~same_doc
    return attention_mask, loss_mask, position_ids


def _parts(spec) -> set:
    """The axes a per-leaf spec shards over: a ``PartitionSpec``-like
    sequence of None, axis names and tuples of them."""
    sharded = set()
    for part in spec or ():
        if part is None:
            continue
        if isinstance(part, str):
            sharded.add(part)
        else:
            sharded.update(part)
    return sharded


def _flatten_up_to(treedef, tree) -> list:
    """The nodes of ``tree`` at the leaf positions of ``treedef`` (a spec
    is a tuple, which a plain flatten would open)."""
    out = []

    def walk(td, node):
        kind = td[0]
        if kind == "leaf":
            out.append(node)
        elif kind == "dict":
            for k, c in zip(td[1], td[2]):
                walk(c, node[k])
        elif kind in ("list", "tuple"):
            for i, c in enumerate(td[2]):
                walk(c, node[i])

    walk(treedef, tree)
    return out


def sync_grads_by_spec(grads: Pytree, pspec: Pytree,
                       axis_names: Sequence[str]) -> Pytree:
    """Sum each gradient leaf over every axis of ``axis_names`` its
    parameter is NOT sharded on: a parameter replicated over an axis
    holds per-rank partial gradients there (data-parallel sync over
    ``data``, replicated weights over ``tensor`` / ``pipeline``).
    ``pspec`` mirrors ``grads`` with a spec per leaf (a sequence of
    None, axis names, or tuples of them, as ``PartitionSpec``). One
    all-reduce a leaf that needs one."""
    leaves, treedef = tree_flatten(grads)
    spec_leaves = _flatten_up_to(treedef, pspec)
    out = []
    for g, spec in zip(leaves, spec_leaves):
        unsynced = tuple(a for a in axis_names if a not in _parts(spec))
        if unsynced:
            group, _, active = _group(unsynced)
            if active:
                g = g.clone()
                dist.all_reduce(g, group=group)
        out.append(g)
    return tree_unflatten(treedef, out)


def _group_masked_sum(grads: Pytree, in_group: bool, axis_name) -> Pytree:
    """Zero on the ranks outside the group, then summed over the
    pipeline axis: every stage leaves with the group's sum (the JAX
    module's masked psum)."""
    a = axis_name if axis_name is not None else parallel_state.PIPELINE_AXIS
    group, _, active = _group(a)

    def sync(g):
        g = g.clone() if in_group else torch.zeros_like(g)
        if active:
            dist.all_reduce(g, group=group)
        return g

    return tree_map(sync, grads)


def sync_embedding_grads(grads: Pytree, axis_name: Optional[str] = None
                         ) -> Pytree:
    """Sum the tied word embedding's gradients over the embedding group
    (the first and last pipeline stages, and the split stage of an
    encoder-decoder): each stage outside the group contributes zeros and
    every stage receives the group's sum, as the JAX masked psum does;
    the reference all-reduces over the ``_EMBEDDING_GROUP`` of
    ``parallel_state.py:319-407``. For a table held by the first and last
    stages (the reference layout); a table sharded by vocab over the
    pipeline axis needs no pipeline sync. Membership ignores the virtual
    rank, as the reference's step-end ``_allreduce_embedding_grads``
    (with virtual chunks the last stage holds the head in its last chunk
    whatever the current virtual rank); the JAX function asks with the
    current one."""
    return _group_masked_sum(
        grads, parallel_state.is_rank_in_embedding_group(ignore_virtual=True),
        axis_name)


def sync_position_embedding_grads(grads: Pytree,
                                  axis_name: Optional[str] = None) -> Pytree:
    """The position table's sum over the position-embedding group
    (stage 0 and the split stage)."""
    return _group_masked_sum(
        grads, parallel_state.is_rank_in_position_embedding_group(),
        axis_name)


def mask_to_axis_root(value: torch.Tensor, axis_names) -> torch.Tensor:
    """``value`` on the rank at index 0 of every axis of ``axis_names``,
    zeros elsewhere (a loss replicated over an axis counted once when the
    ranks' losses are summed)."""
    if isinstance(axis_names, str):
        axis_names = (axis_names,)
    keep = True
    for a in axis_names:
        from ...parallel.distributed import axis_group

        group, _ = axis_group(a)
        if dist.is_available() and dist.is_initialized():
            idx = dist.get_rank(group) if group is not None \
                else dist.get_rank()
            keep = keep and idx == 0
    return value if keep else torch.zeros_like(value)
