"""Model-parallel state over ``torch.distributed`` (counterpart of
``apex_tpu/transformer/parallel_state.py``).

The JAX package's registry is one ``jax.sharding.Mesh`` with the axes
``(pipeline, data, tensor)``, ``tensor`` innermost, and a "rank" is a
traced ``axis_index`` inside ``shard_map``. Here the same layout is laid
over the ``torch.distributed`` world: global rank ``(p * dp + d) * tp +
t`` sits at pipeline stage ``p``, data-parallel index ``d`` and tensor
index ``t`` (the JAX mesh's ``reshape(pp, dp, tp)`` of its devices), and
:func:`initialize_model_parallel` builds one process group for every
non-empty set of axes, each rank in every group of that set, so that a
reduction over any axes (the fp8 amax group is ``(data, tensor)`` inside
a pipeline stage; the model-parallel group of the loss scaler is
``(tensor, pipeline)``) has its group ready. Every rank creates every
group in the same order, as ``new_group`` requires.

Differences from the JAX module:

- the rank getters return this process's host integers; the JAX ones
  return a traced ``axis_index`` and raise outside a traced region
  unless the axis is trivial;
- :func:`get_tensor_model_parallel_src_rank` is the global rank of the
  first rank of this rank's tensor group (what ``broadcast(src=...)``
  takes); the JAX one is the axis index 0;
- :func:`get_mesh` returns a :class:`ModelParallelMesh` of global ranks
  (``devices`` shaped ``(pp, dp, tp)``) in place of the ``Mesh``.

Without an initialised process group the module works at world 1 only,
as the JAX one does on one device: groups are ``None`` and every
reduction is the identity.
"""
from __future__ import annotations

import itertools
from typing import Dict, FrozenSet, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

# Canonical axis names (the JAX module's).
PIPELINE_AXIS = "pipeline"
DATA_AXIS = "data"
TENSOR_AXIS = "tensor"
_AXES = (PIPELINE_AXIS, DATA_AXIS, TENSOR_AXIS)


class ModelParallelMesh:
    """The ``(pipeline, data, tensor)`` layout of global ranks:
    ``devices[p, d, t]`` is the rank at those coordinates (the JAX
    ``Mesh``'s ``devices``, as rank numbers)."""

    def __init__(self, devices: np.ndarray, axis_names: Tuple[str, ...]):
        self.devices = devices
        self.axis_names = tuple(axis_names)

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    def __repr__(self):
        return f"ModelParallelMesh({self.shape})"


# Module-level state (the JAX module's globals).
_MESH: Optional[ModelParallelMesh] = None
_COORDS: Optional[Dict[str, int]] = None
_GROUPS: Dict[FrozenSet[str], Optional[object]] = {}
_GROUP_RANKS: Dict[FrozenSet[str], Tuple[int, ...]] = {}
_TENSOR_MODEL_PARALLEL_WORLD_SIZE: Optional[int] = None
_PIPELINE_MODEL_PARALLEL_WORLD_SIZE: Optional[int] = None
_DATA_PARALLEL_WORLD_SIZE: Optional[int] = None
_VIRTUAL_PIPELINE_MODEL_PARALLEL_RANK: Optional[int] = None
_VIRTUAL_PIPELINE_MODEL_PARALLEL_WORLD_SIZE: Optional[int] = None
_PIPELINE_MODEL_PARALLEL_SPLIT_RANK: Optional[int] = None
_USE_FP8: bool = False


def _axes_key(axes) -> FrozenSet[str]:
    axes = (axes,) if isinstance(axes, str) else tuple(axes)
    unknown = [a for a in axes if a not in _AXES]
    if unknown or not axes:
        raise ValueError(f"axes must name some of {_AXES}, got {axes!r}")
    return frozenset(axes)


def _members(ranks: np.ndarray, coords: Dict[str, int],
             key: FrozenSet[str]) -> Tuple[int, ...]:
    """The global ranks that share ``coords`` on every axis outside
    ``key``, in rank order."""
    index = tuple(slice(None) if a in key else coords[a] for a in _AXES)
    return tuple(int(r) for r in np.sort(ranks[index].reshape(-1)))


def initialize_model_parallel(
    tensor_model_parallel_size_: int = 1,
    pipeline_model_parallel_size_: int = 1,
    virtual_pipeline_model_parallel_size_: Optional[int] = None,
    pipeline_model_parallel_split_rank_: Optional[int] = None,
    use_fp8_: bool = False,
    *,
    default_backend: Optional[str] = None,
    p2p_backend: Optional[str] = None,
) -> ModelParallelMesh:
    """Lay the ``(pipeline, data, tensor)`` layout over the process
    group's world and build its groups (reference
    ``apex/transformer/parallel_state.py:155-419``). The data-parallel
    size is ``world / (tp * pp)``. ``default_backend`` / ``p2p_backend``
    are accepted for the reference's signature; the groups take the
    world's backend. Returns the layout, also kept for the getters."""
    global _MESH, _COORDS, _GROUPS, _GROUP_RANKS
    global _TENSOR_MODEL_PARALLEL_WORLD_SIZE
    global _PIPELINE_MODEL_PARALLEL_WORLD_SIZE, _DATA_PARALLEL_WORLD_SIZE
    global _VIRTUAL_PIPELINE_MODEL_PARALLEL_RANK
    global _VIRTUAL_PIPELINE_MODEL_PARALLEL_WORLD_SIZE
    global _PIPELINE_MODEL_PARALLEL_SPLIT_RANK, _USE_FP8
    del default_backend, p2p_backend
    distributed = dist.is_available() and dist.is_initialized()
    world = dist.get_world_size() if distributed else 1
    rank = dist.get_rank() if distributed else 0
    tp = int(tensor_model_parallel_size_)
    pp = int(pipeline_model_parallel_size_)
    if world % (tp * pp) != 0:
        raise RuntimeError(
            f"world size ({world}) is not divisible by tp ({tp}) x pp ({pp})"
            + ("" if distributed else
               "; without an initialised torch.distributed process group "
               "the world is this one process"))
    dp = world // (tp * pp)
    if virtual_pipeline_model_parallel_size_ is not None:
        # the reference requires pp > 2 for the interleaved schedule
        if pp <= 2:
            raise RuntimeError(
                "pipeline-model-parallel size should be greater than 2 with "
                "interleaved schedule")
        _VIRTUAL_PIPELINE_MODEL_PARALLEL_RANK = 0
        _VIRTUAL_PIPELINE_MODEL_PARALLEL_WORLD_SIZE = (
            virtual_pipeline_model_parallel_size_)
    else:
        _VIRTUAL_PIPELINE_MODEL_PARALLEL_RANK = None
        _VIRTUAL_PIPELINE_MODEL_PARALLEL_WORLD_SIZE = None
    _PIPELINE_MODEL_PARALLEL_SPLIT_RANK = pipeline_model_parallel_split_rank_
    _USE_FP8 = bool(use_fp8_)

    ranks = np.arange(world).reshape(pp, dp, tp)
    p, d, t = (int(c) for c in np.argwhere(ranks == rank)[0])
    coords = {PIPELINE_AXIS: p, DATA_AXIS: d, TENSOR_AXIS: t}
    sizes = {PIPELINE_AXIS: pp, DATA_AXIS: dp, TENSOR_AXIS: tp}
    groups, group_ranks = {}, {}
    # every non-empty set of axes; inside a set, every combination of the
    # other axes' coordinates, in one order on every rank
    for n in range(1, len(_AXES) + 1):
        for combo in itertools.combinations(_AXES, n):
            key = frozenset(combo)
            others = [a for a in _AXES if a not in key]
            for fixed in itertools.product(*(range(sizes[a])
                                             for a in others)):
                where = dict(zip(others, fixed))
                members = _members(ranks, where, key)
                group = dist.new_group(list(members)) if distributed \
                    else None
                if all(where[a] == coords[a] for a in others):
                    groups[key] = group
                    group_ranks[key] = members
    _MESH = ModelParallelMesh(ranks, _AXES)
    _COORDS = coords
    _GROUPS = groups
    _GROUP_RANKS = group_ranks
    _TENSOR_MODEL_PARALLEL_WORLD_SIZE = tp
    _PIPELINE_MODEL_PARALLEL_WORLD_SIZE = pp
    _DATA_PARALLEL_WORLD_SIZE = dp
    return _MESH


def model_parallel_is_initialized() -> bool:
    """Reference ``parallel_state.py:429``."""
    return _MESH is not None


def get_mesh() -> ModelParallelMesh:
    if _MESH is None:
        raise RuntimeError(
            "model parallel state is not initialized "
            "(call parallel_state.initialize_model_parallel)")
    return _MESH


def tp_submesh(tp: int, *, replica: int = 0, devices=None
               ) -> ModelParallelMesh:
    """A single-axis ``(tensor,)`` layout of ``tp`` ranks, the slice a
    tensor-parallel serving replica runs on: ``devices`` verbatim when
    given (exactly ``tp`` of them), else row ``replica`` of the
    initialised layout's ranks, else ranks ``replica * tp`` to
    ``(replica + 1) * tp - 1`` of the world."""
    if tp < 1:
        raise ValueError(f"tp must be >= 1, got {tp}")
    if devices is not None:
        devices = list(devices)
        if len(devices) != tp:
            raise ValueError(f"got {len(devices)} devices for tp={tp}")
        return ModelParallelMesh(np.asarray(devices), (TENSOR_AXIS,))
    if _MESH is not None:
        flat = _MESH.devices.reshape(-1)
        if tp * (replica + 1) > flat.size:
            raise ValueError(
                f"replica {replica} x tp={tp} exceeds the initialized "
                f"layout ({flat.size} ranks)")
        if _TENSOR_MODEL_PARALLEL_WORLD_SIZE not in (None, 1, tp):
            raise ValueError(
                f"engine tp={tp} disagrees with the initialized layout's "
                f"tensor axis ({_TENSOR_MODEL_PARALLEL_WORLD_SIZE})")
        return ModelParallelMesh(flat[replica * tp:(replica + 1) * tp],
                                 (TENSOR_AXIS,))
    world = dist.get_world_size() if (dist.is_available()
                                      and dist.is_initialized()) else 1
    if tp * (replica + 1) > world:
        raise ValueError(
            f"replica {replica} x tp={tp} needs rank {tp * (replica + 1) - 1}"
            f" but the world has {world}")
    return ModelParallelMesh(np.arange(replica * tp, (replica + 1) * tp),
                             (TENSOR_AXIS,))


def axis_size(axis_name: str) -> int:
    """The size of a named axis of the initialised layout."""
    return get_mesh().shape[axis_name]


def _coord(axis: str) -> int:
    if _COORDS is None:
        raise RuntimeError("model parallel is not initialized")
    return _COORDS[axis]


# --- world sizes (reference :488-528) ---------------------------------------

def get_tensor_model_parallel_world_size() -> int:
    if _TENSOR_MODEL_PARALLEL_WORLD_SIZE is None:
        raise RuntimeError("model parallel is not initialized")
    return _TENSOR_MODEL_PARALLEL_WORLD_SIZE


def get_pipeline_model_parallel_world_size() -> int:
    if _PIPELINE_MODEL_PARALLEL_WORLD_SIZE is None:
        raise RuntimeError("model parallel is not initialized")
    return _PIPELINE_MODEL_PARALLEL_WORLD_SIZE


def get_data_parallel_world_size() -> int:
    if _DATA_PARALLEL_WORLD_SIZE is None:
        raise RuntimeError("model parallel is not initialized")
    return _DATA_PARALLEL_WORLD_SIZE


# --- ranks (reference :535-560): this process's coordinates ------------------

def get_tensor_model_parallel_rank() -> int:
    return _coord(TENSOR_AXIS)


def get_pipeline_model_parallel_rank() -> int:
    return _coord(PIPELINE_AXIS)


def get_data_parallel_rank() -> int:
    return _coord(DATA_AXIS)


def get_tensor_model_parallel_src_rank() -> int:
    """The global rank of the first rank of this rank's tensor group
    (reference ``:713-718``)."""
    return get_group_ranks((TENSOR_AXIS,))[0]


# --- groups ------------------------------------------------------------------

def get_group(axes):
    """This rank's process group over ``axes`` (an axis name or a
    sequence of them, in any order); ``None`` without a process group."""
    if _MESH is None:
        raise RuntimeError("model parallel is not initialized")
    return _GROUPS[_axes_key(axes)]


def get_group_ranks(axes) -> Tuple[int, ...]:
    """The global ranks of this rank's group over ``axes``, ascending."""
    if _MESH is None:
        raise RuntimeError("model parallel is not initialized")
    return _GROUP_RANKS[_axes_key(axes)]


# --- pipeline stage predicates (reference :562-640) --------------------------

def is_pipeline_first_stage(ignore_virtual: bool = False) -> bool:
    if not ignore_virtual:
        vpp = _VIRTUAL_PIPELINE_MODEL_PARALLEL_WORLD_SIZE
        if vpp is not None and _VIRTUAL_PIPELINE_MODEL_PARALLEL_RANK != 0:
            return False
    return get_pipeline_model_parallel_rank() == 0


def is_pipeline_last_stage(ignore_virtual: bool = False) -> bool:
    if not ignore_virtual:
        vpp = _VIRTUAL_PIPELINE_MODEL_PARALLEL_WORLD_SIZE
        if vpp is not None and \
                _VIRTUAL_PIPELINE_MODEL_PARALLEL_RANK != vpp - 1:
            return False
    return (get_pipeline_model_parallel_rank()
            == get_pipeline_model_parallel_world_size() - 1)


def is_pipeline_stage_before_split(rank=None) -> bool:
    """Reference ``:600-613`` (encoder side of an encoder-decoder split)."""
    if get_pipeline_model_parallel_world_size() == 1:
        return True
    if rank is None:
        rank = get_pipeline_model_parallel_rank()
    if _PIPELINE_MODEL_PARALLEL_SPLIT_RANK is None:
        return True
    return rank < _PIPELINE_MODEL_PARALLEL_SPLIT_RANK


def is_pipeline_stage_after_split(rank=None) -> bool:
    """Reference ``:616-629``."""
    if get_pipeline_model_parallel_world_size() == 1:
        return True
    if rank is None:
        rank = get_pipeline_model_parallel_rank()
    if _PIPELINE_MODEL_PARALLEL_SPLIT_RANK is None:
        return True
    return rank >= _PIPELINE_MODEL_PARALLEL_SPLIT_RANK


def is_pipeline_stage_at_split() -> bool:
    """Reference ``:632-640``."""
    rank = get_pipeline_model_parallel_rank()
    return (is_pipeline_stage_before_split(rank)
            and is_pipeline_stage_after_split(rank + 1))


# --- virtual pipeline state (reference :643-667) -----------------------------

def get_virtual_pipeline_model_parallel_rank() -> Optional[int]:
    return _VIRTUAL_PIPELINE_MODEL_PARALLEL_RANK


def set_virtual_pipeline_model_parallel_rank(rank: Optional[int]) -> None:
    global _VIRTUAL_PIPELINE_MODEL_PARALLEL_RANK
    _VIRTUAL_PIPELINE_MODEL_PARALLEL_RANK = rank


def get_virtual_pipeline_model_parallel_world_size() -> Optional[int]:
    return _VIRTUAL_PIPELINE_MODEL_PARALLEL_WORLD_SIZE


def set_virtual_pipeline_model_parallel_world_size(size: Optional[int]
                                                   ) -> None:
    global _VIRTUAL_PIPELINE_MODEL_PARALLEL_WORLD_SIZE
    _VIRTUAL_PIPELINE_MODEL_PARALLEL_WORLD_SIZE = size


def get_pipeline_model_parallel_split_rank() -> Optional[int]:
    return _PIPELINE_MODEL_PARALLEL_SPLIT_RANK


def set_pipeline_model_parallel_split_rank(rank: Optional[int]) -> None:
    global _PIPELINE_MODEL_PARALLEL_SPLIT_RANK
    _PIPELINE_MODEL_PARALLEL_SPLIT_RANK = rank


# --- pipeline neighbours (reference :730-745): stage indices -----------------

def get_pipeline_model_parallel_next_rank() -> int:
    rank = get_pipeline_model_parallel_rank()
    return (rank + 1) % get_pipeline_model_parallel_world_size()


def get_pipeline_model_parallel_prev_rank() -> int:
    rank = get_pipeline_model_parallel_rank()
    return (rank - 1) % get_pipeline_model_parallel_world_size()


# --- embedding groups (reference :319-407, :466-486) -------------------------

def is_rank_in_embedding_group(ignore_virtual: bool = False) -> bool:
    """First and last pipeline stages, plus the split stage when one is
    set (encoder-decoder tying)."""
    in_group = (is_pipeline_first_stage(ignore_virtual)
                or is_pipeline_last_stage(ignore_virtual))
    split = _PIPELINE_MODEL_PARALLEL_SPLIT_RANK
    if split is not None:
        in_group = in_group or get_pipeline_model_parallel_rank() == split
    return in_group


def is_rank_in_position_embedding_group() -> bool:
    """Stage 0, plus the split stage when one is set."""
    in_group = is_pipeline_first_stage(ignore_virtual=True)
    split = _PIPELINE_MODEL_PARALLEL_SPLIT_RANK
    if split is not None:
        in_group = in_group or get_pipeline_model_parallel_rank() == split
    return in_group


# --- amax reduction group (fp8, reference :280-292, :472-476) ----------------

def get_amax_reduction_group():
    """The process group of the fp8 amax all-reduce: (data, tensor)
    inside this rank's pipeline stage. Raises unless
    ``initialize_model_parallel(..., use_fp8_=True)``, as the reference
    asserts."""
    if _MESH is None:
        raise RuntimeError("model parallel is not initialized")
    if not _USE_FP8:
        raise RuntimeError(
            "amax reduction group is not initialized "
            "(initialize_model_parallel(..., use_fp8_=True))")
    return get_group((DATA_AXIS, TENSOR_AXIS))


def reduce_amax(amax: torch.Tensor, axes=None) -> torch.Tensor:
    """All-reduce an amax statistic in place with MAX over the amax
    group, or over the group of ``axes`` (ranks that share a tensor's
    shards must derive one fp8 scale from it). One ``all_reduce`` a
    call; the identity without a process group. Returns ``amax``."""
    group = (get_amax_reduction_group() if axes is None
             else get_group(axes))
    if group is not None:
        dist.all_reduce(amax, op=dist.ReduceOp.MAX, group=group)
    return amax


# --- misc sizes --------------------------------------------------------------

def get_num_layers(num_layers: int, is_encoder_and_decoder_model: bool = False,
                   rank: Optional[int] = None) -> int:
    """Layers owned by pipeline stage ``rank`` (reference ``:670-706``;
    ``rank`` defaults to this process's stage)."""
    pp = get_pipeline_model_parallel_world_size()
    if is_encoder_and_decoder_model:
        split = _PIPELINE_MODEL_PARALLEL_SPLIT_RANK
        if split is None:
            raise RuntimeError(
                "split rank required for encoder-decoder models")
        if rank is None:
            rank = get_pipeline_model_parallel_rank()
        if rank < split:
            return num_layers // max(split, 1)
        return num_layers // max(pp - split, 1)
    if num_layers % pp != 0:
        raise RuntimeError(
            f"num_layers ({num_layers}) must be divisible by pipeline size "
            f"({pp})")
    return num_layers // pp


def destroy_model_parallel() -> None:
    """Reference ``parallel_state.py:761-796``: forget the layout and
    destroy its groups (the default group stays)."""
    global _MESH, _COORDS, _GROUPS, _GROUP_RANKS
    global _TENSOR_MODEL_PARALLEL_WORLD_SIZE
    global _PIPELINE_MODEL_PARALLEL_WORLD_SIZE, _DATA_PARALLEL_WORLD_SIZE
    global _VIRTUAL_PIPELINE_MODEL_PARALLEL_RANK
    global _VIRTUAL_PIPELINE_MODEL_PARALLEL_WORLD_SIZE
    global _PIPELINE_MODEL_PARALLEL_SPLIT_RANK, _USE_FP8
    if dist.is_available() and dist.is_initialized():
        for group in set(g for g in _GROUPS.values() if g is not None):
            dist.destroy_process_group(group)
    _MESH = None
    _COORDS = None
    _GROUPS = {}
    _GROUP_RANKS = {}
    _TENSOR_MODEL_PARALLEL_WORLD_SIZE = None
    _PIPELINE_MODEL_PARALLEL_WORLD_SIZE = None
    _DATA_PARALLEL_WORLD_SIZE = None
    _VIRTUAL_PIPELINE_MODEL_PARALLEL_RANK = None
    _VIRTUAL_PIPELINE_MODEL_PARALLEL_WORLD_SIZE = None
    _PIPELINE_MODEL_PARALLEL_SPLIT_RANK = None
    _USE_FP8 = False
