"""Model-parallel random streams and activation checkpointing
(counterpart of ``apex_tpu/transformer/tensor_parallel/random.py``).

The JAX package keeps named PRNG keys and folds the tensor-parallel
rank into a key where the streams must differ by rank. Here a stream is
a named ``torch.Generator`` on the host (a draw from it seeds the
device's dropout, as the model's generators do), and a rank is this
process:

- :class:`RngStateTracker`: ``add``, ``fork`` (yields a generator seeded
  from the named stream and advances it, so two forks differ), states
  saved and restored, a repeated seed or name raising;
- :func:`model_parallel_manual_seed`: ``default`` seeded with ``seed``,
  ``model-parallel-rng`` with ``seed + 2718 + tp_rank`` (the reference's
  offset, this process's rank in its tensor group);
- :func:`model_parallel_rng_key`: a generator, or a seed, that differs
  by tensor-parallel rank;
- :func:`checkpoint` / :class:`CheckpointFunction`: the forward
  recomputed in the backward (``torch.utils.checkpoint``, non-reentrant,
  the device's RNG state preserved) with the tracker's states put back
  as they were for the replay, so a recomputed dropout draws the same
  mask.
"""
from __future__ import annotations

import contextlib
from typing import Dict, Optional, Union

import torch
import torch.utils.checkpoint as _ckpt

from .. import parallel_state

_MODEL_PARALLEL_RNG_TRACKER_NAME = "model-parallel-rng"
_SEED_MOD = 2 ** 63


def _draw(generator: torch.Generator) -> int:
    """A non-negative 63-bit seed drawn from ``generator``."""
    return int(torch.randint(0, 2 ** 62, (), generator=generator,
                             device=generator.device))


def fold_in(seed: int, data: int) -> int:
    """A seed derived from ``seed`` and ``data`` (splitmix64's mixer over
    their combination): distinct ``data`` give unrelated seeds."""
    z = (int(seed) * 0x9E3779B97F4A7C15 + int(data) + 1) % 2 ** 64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) % 2 ** 64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) % 2 ** 64
    return (z ^ (z >> 31)) % _SEED_MOD


class RngStateTracker:
    """Named ``torch.Generator`` streams (the reference's
    ``CudaRNGStatesTracker``)."""

    def __init__(self):
        self.states_: Dict[str, torch.Generator] = {}
        self.seeds_: set = set()

    def reset(self) -> None:
        self.states_ = {}
        self.seeds_ = set()

    def get_states(self) -> Dict[str, torch.Tensor]:
        """A copy of every stream's state (``Generator.get_state``)."""
        return {k: g.get_state() for k, g in self.states_.items()}

    def set_states(self, states: Dict[str, torch.Tensor]) -> None:
        """Put the streams in ``states`` back (a name not yet added gets
        a host generator)."""
        new = {}
        for k, st in states.items():
            g = self.states_.get(k) or torch.Generator()
            g.set_state(st)
            new[k] = g
        self.states_ = new

    def add(self, name: str, seed: int) -> None:
        """A host stream ``name`` seeded with ``seed``; a seed or a name
        used before raises, as in the reference."""
        if seed in self.seeds_:
            raise Exception(f"seed {seed} already exists")
        self.seeds_.add(seed)
        if name in self.states_:
            raise Exception(f"rng state {name} already exists")
        self.states_[name] = torch.Generator().manual_seed(
            int(seed) % _SEED_MOD)

    @contextlib.contextmanager
    def fork(self, name: str = _MODEL_PARALLEL_RNG_TRACKER_NAME):
        """Yield a generator seeded from the stream ``name``, advancing
        the stream (successive forks draw different numbers)."""
        if name not in self.states_:
            raise Exception(f"rng state {name} is not added")
        src = self.states_[name]
        yield torch.Generator(device=src.device).manual_seed(_draw(src))


_RNG_STATE_TRACKER = RngStateTracker()


def get_rng_state_tracker() -> RngStateTracker:
    """The process's tracker (the reference's ``get_cuda_rng_tracker``)."""
    return _RNG_STATE_TRACKER


get_cuda_rng_tracker = get_rng_state_tracker


def _tp_rank() -> int:
    if parallel_state.model_parallel_is_initialized():
        return parallel_state.get_tensor_model_parallel_rank()
    return 0


def model_parallel_manual_seed(seed: int) -> None:
    """Seed ``default`` with ``seed`` and ``model-parallel-rng`` with
    ``seed + 2718 + tp_rank``, after resetting the tracker; also
    ``torch.manual_seed(seed)``, the reference's default stream."""
    torch.manual_seed(seed)
    _RNG_STATE_TRACKER.reset()
    _RNG_STATE_TRACKER.add("default", seed)
    _RNG_STATE_TRACKER.add(_MODEL_PARALLEL_RNG_TRACKER_NAME,
                           seed + 2718 + _tp_rank())


model_parallel_cuda_manual_seed = model_parallel_manual_seed


def model_parallel_rng_key(key: Union[torch.Generator, int],
                           axis_name: Optional[str] = None
                           ) -> Union[torch.Generator, int]:
    """``key`` made to differ by the rank on ``axis_name`` (default
    ``tensor``), where the JAX one folds the axis index into a key: a
    seed gives a seed, a generator a new generator seeded from one draw
    of it (the same on every rank that shares the generator's state)
    folded with the rank."""
    from .mappings import axis_world

    rank = axis_world(axis_name)[2]
    if isinstance(key, torch.Generator):
        return torch.Generator(device=key.device).manual_seed(
            fold_in(_draw(key), rank))
    return fold_in(int(key), rank)


def checkpoint(function, distribute_saved_activations: bool = False, *args):
    """``function(*args)`` with its activations recomputed in the
    backward (``torch.utils.checkpoint``, non-reentrant, the device's
    RNG state preserved), the tracker's streams set back to their state
    at the forward for the replay and restored after it.
    ``distribute_saved_activations`` (the reference's partitioned saved
    activations) is accepted and has no effect, as in the JAX package."""
    del distribute_saved_activations
    tracker = _RNG_STATE_TRACKER
    at_forward = tracker.get_states()
    calls = [0]

    def run(*a):
        calls[0] += 1
        if calls[0] == 1:
            return function(*a)
        current = tracker.get_states()
        tracker.set_states(at_forward)
        try:
            return function(*a)
        finally:
            tracker.set_states(current)

    return _ckpt.checkpoint(run, *args, use_reentrant=False,
                            preserve_rng_state=True)


class CheckpointFunction:
    """The reference's ``CheckpointFunction.apply(function,
    distribute_saved_activations, *args)``."""

    @staticmethod
    def apply(function, distribute_saved_activations, *args):
        return checkpoint(function, distribute_saved_activations, *args)
