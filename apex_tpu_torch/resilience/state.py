"""Resumable training state: one container for everything a restart needs
(counterpart of ``apex_tpu/resilience/state.py``).

The reference checkpoints model+optimizer state and leaves the rest of
the training loop — scaler counters, RNG stream, where the data iterator
was — to the launcher scripts, which is exactly the state a preempted
run needs to continue *bit-exactly*. :class:`TrainState` names all of
it:

- ``step``        host int, the loop's step counter;
- ``params``      model parameters (any tree of tensors);
- ``opt_state``   pytree or packed (:class:`~apex_tpu_torch.optimizers.
  _packed.PackedState` — its flat buffers checkpoint as plain tensors,
  the static :class:`PackSpec` rides the restore template);
- ``scaler``      :class:`~apex_tpu_torch.amp.scaler.LossScaleState` or
  None;
- ``rng``         the loop's generator state: ``torch.Generator.
  get_state()`` (a CPU ``uint8`` tensor; the card's generator gives one
  too), restored with ``set_state``, or a tuple of such states. The JAX
  package holds a uint32 PRNG key there;
- ``data``        host-side, JSON-serializable data-iterator state (see
  :class:`ResumableIterator`) — stored in the checkpoint's ``meta.json``,
  not the array tree;
- ``metrics`` / ``numerics`` — the telemetry states, so cumulative
  counters (overflow skips, scale growths, first-bad-step) survive a
  restart instead of silently resetting.

``resume_or_init(manager, init_fn)`` is the loop's one-liner entry:
restore the newest good checkpoint if one exists, else initialize fresh.
A resumed run replays the loss curve of an uninterrupted one bit-exactly
(``tests/test_torch_crash_resume.py`` pins this on the CPU,
``chip_smoke.py`` phase 17 on the card).

The same template contract drives the elastic service
(:mod:`~apex_tpu_torch.resilience.elastic`): ``init_fn`` builds the state
for THIS world's layout, and an :class:`ElasticCheckpointManager` restore
re-flattens packed flat-buffer leaves saved at a different world size
into the template's spec bit-exactly — the template always describes the
run being started, never the run that saved.

Trees flatten in the JAX package's order (``_tree.tree_flatten``: dicts
by sorted key, ``None`` an empty subtree), with a packed optimizer state
as the node JAX registers: its ``step``, ``exp_avg``, ``exp_avg_sq`` and
``master_params`` children in that order, the spec static.
"""
from __future__ import annotations

from typing import Any, Callable, List, NamedTuple, Optional, Tuple

import torch

from ..optimizers._packed import PackedState

Pytree = Any

_PACKED_FIELDS = ("step", "exp_avg", "exp_avg_sq", "master_params")


class TrainState(NamedTuple):
    """Everything a training loop needs to continue after a restart."""

    step: int
    params: Pytree
    opt_state: Any = None
    scaler: Any = None
    rng: Any = None
    data: Any = None
    metrics: Any = None
    numerics: Any = None


def capture(
    step,
    params: Pytree,
    opt_state: Any = None,
    *,
    scaler: Any = None,
    rng: Any = None,
    data: Any = None,
    metrics: Any = None,
    numerics: Any = None,
) -> TrainState:
    """Assemble a :class:`TrainState` (coercing ``step`` to a host int)."""
    return TrainState(
        step=int(step), params=params, opt_state=opt_state, scaler=scaler,
        rng=rng, data=data, metrics=metrics, numerics=numerics,
    )


def device_part(state: TrainState) -> Tuple:
    """The tensor-bearing fields, in checkpoint order (``step`` and
    ``data`` are host-side and live in the checkpoint's ``meta.json``)."""
    return (state.params, state.opt_state, state.scaler, state.rng,
            state.metrics, state.numerics)


def tree_flatten(tree: Pytree) -> Tuple[List[Any], tuple]:
    """``(leaves, treedef)`` in the JAX package's order, a packed
    optimizer state expanded into its four children."""
    leaves: List[Any] = []

    def walk(t):
        if isinstance(t, PackedState):
            return ("packed", t.spec,
                    tuple(walk(getattr(t, f)) for f in _PACKED_FIELDS))
        if isinstance(t, dict):
            keys = tuple(sorted(t))
            return ("dict", keys, tuple(walk(t[k]) for k in keys))
        if isinstance(t, list):
            return ("list", len(t), tuple(walk(x) for x in t))
        if isinstance(t, tuple):
            return ("tuple", type(t), tuple(walk(x) for x in t))
        if t is None:
            return ("none",)
        leaves.append(t)
        return ("leaf",)

    return leaves, walk(tree)


def tree_unflatten(treedef: tuple, leaves) -> Pytree:
    it = iter(leaves)

    def build(td):
        kind = td[0]
        if kind == "leaf":
            return next(it)
        if kind == "none":
            return None
        if kind == "dict":
            return {k: build(c) for k, c in zip(td[1], td[2])}
        items = [build(c) for c in td[2]]
        if kind == "packed":
            return PackedState(*items, spec=td[1])
        if kind == "list":
            return items
        cls = td[1]
        return cls(*items) if cls is not tuple else tuple(items)

    return build(treedef)


def tree_leaves(tree: Pytree) -> List[Any]:
    return tree_flatten(tree)[0]


def tree_map(fn: Callable, tree: Pytree) -> Pytree:
    leaves, treedef = tree_flatten(tree)
    return tree_unflatten(treedef, [fn(x) for x in leaves])


def _host_copy(x):
    if isinstance(x, torch.Tensor):
        return x.detach().to("cpu", copy=True)
    return x


def host_snapshot(tree: Pytree) -> Pytree:
    """A deep host copy of every tensor leaf.

    Each card tensor is copied to fresh host memory (the copy waits for
    the tensor's value), CPU tensors are cloned — no view into a live
    buffer survives, so the original tensors may be updated in place by
    the next step (the packed optimizers do) or freed immediately after
    this returns. For a packed optimizer this is cheap by construction:
    the whole state is a handful of contiguous flat buffers, one copy
    each."""
    return tree_map(_host_copy, tree)


def to_device(tree: Pytree, device) -> Pytree:
    """Every tensor leaf of ``tree`` on ``device`` (a copy)."""
    device = torch.device(device)
    return tree_map(lambda x: x.to(device, copy=True)
                    if isinstance(x, torch.Tensor) else x, tree)


def flat_leaves(tree: Pytree) -> dict:
    """Flatten to the on-disk form: a dict of zero-padded leaf indices.

    Sidesteps every container serialization question (packed states,
    named tuples, None fields): only raw leaves are stored; the structure
    comes back from the restore template.
    """
    leaves = tree_leaves(tree)
    return {f"{i:05d}": leaf for i, leaf in enumerate(leaves)}


def unflatten_like(template: Pytree, flat: dict) -> Pytree:
    """Rebuild ``template``'s structure from :func:`flat_leaves` output."""
    t_leaves, treedef = tree_flatten(template)
    if len(flat) != len(t_leaves):
        raise ValueError(
            f"checkpoint has {len(flat)} leaves, template expects "
            f"{len(t_leaves)} — the run's state structure changed")
    leaves = [flat[f"{i:05d}"] for i in range(len(t_leaves))]
    return tree_unflatten(treedef, leaves)


def resume_or_init(
    manager,
    init_fn: Callable[[], TrainState],
    *,
    step: Optional[int] = None,
) -> Tuple[TrainState, bool]:
    """Restore the newest good checkpoint, else initialize fresh.

    ``init_fn`` builds the step-0 :class:`TrainState`; its structure is
    the restore template (shapes and dtypes must match the saved run;
    each restored tensor lands on its template leaf's device). Returns
    ``(state, resumed)``. Corrupted or partial checkpoints are skipped
    automatically (the manager falls back to the newest good step and
    emits a ``checkpoint_fallback`` event per bad one); if checkpoints
    exist but EVERY one fails to load, the manager raises rather than
    silently restarting the run from step 0.
    """
    template = init_fn()
    restored = manager.restore(template, step=step)
    if restored is None:
        return template, False
    return restored, True


# ---------------------------------------------------------------------------
# resumable data iteration
# ---------------------------------------------------------------------------


class ResumableIterator:
    """A position-checkpointable wrapper over a deterministic batch stream.

    ``factory()`` returns a fresh iterator over the epoch's batches; this
    wrapper counts consumption so :meth:`state` / :meth:`restore` can
    round-trip the position through a checkpoint's ``meta.json``. Restore
    re-creates the stream and drains ``position`` items — O(position),
    correct for any iterator. :class:`IndexedBatches` gives O(1) seek
    when batches are addressable by index (the common synthetic / memory-
    mapped case).

    :meth:`skip` advances without yielding — the rewind path uses it to
    jump the stream past a poisoned window.
    """

    def __init__(self, factory: Callable[[], Any], *, position: int = 0):
        self._factory = factory
        self._it = iter(factory())
        self.position = 0
        if position:
            self.skip(position)

    def __iter__(self):
        return self

    def __next__(self):
        batch = next(self._it)
        self.position += 1
        return batch

    def skip(self, n: int) -> None:
        """Advance ``n`` batches without returning them."""
        for _ in range(int(n)):
            next(self._it)
            self.position += 1

    def state(self) -> dict:
        return {"position": int(self.position)}

    def restore(self, state: dict) -> None:
        """Reset to a fresh stream and seek to the saved position."""
        self._it = iter(self._factory())
        self.position = 0
        self.skip(int(state["position"]))


class IndexedBatches(ResumableIterator):
    """Random-access batches: ``fn(i)`` produces batch ``i`` — seek is
    O(1), so restore and rewind-skip cost nothing."""

    def __init__(self, fn: Callable[[int], Any], *, position: int = 0):
        self._fn = fn
        self.position = int(position)

    def __next__(self):
        batch = self._fn(self.position)
        self.position += 1
        return batch

    def skip(self, n: int) -> None:
        self.position += int(n)

    def restore(self, state: dict) -> None:
        self.position = int(state["position"])
