"""Process-global args, timers and microbatch calculator (counterpart of
``apex_tpu/transformer/testing/global_vars.py``), and the Megatron
timers the registry hands out (the JAX package keeps them in
``pipeline_parallel/_timers.py``, which comes with A6.5)."""
from __future__ import annotations

import time
from typing import Dict, Optional

import torch

from ...telemetry.recorder import is_logging_process
from ..microbatches import build_num_microbatches_calculator
from .arguments import parse_args

_GLOBAL_ARGS = None
_GLOBAL_NUM_MICROBATCHES_CALCULATOR = None
_GLOBAL_TIMERS = None


def _fence(barrier_on) -> None:
    """Wait for the card when ``barrier_on`` (a tensor, or a list of
    them) holds a CUDA tensor: the reference's ``cuda.synchronize``."""
    items = barrier_on if isinstance(barrier_on, (list, tuple)) \
        else [barrier_on]
    for t in items:
        if isinstance(t, torch.Tensor) and t.is_cuda:
            torch.cuda.synchronize(t.device)
            return


class _Timer:
    """One named timer on the monotonic ``perf_counter`` clock."""

    def __init__(self, name: str):
        self.name_ = name
        self.elapsed_ = 0.0
        self.started_ = False
        self.start_time = time.perf_counter()

    def start(self, barrier_on=None) -> None:
        if self.started_:
            raise RuntimeError("timer has already been started")
        if barrier_on is not None:
            _fence(barrier_on)
        self.start_time = time.perf_counter()
        self.started_ = True

    def stop(self, barrier_on=None) -> None:
        if not self.started_:
            raise RuntimeError("timer is not started")
        if barrier_on is not None:
            _fence(barrier_on)
        self.elapsed_ += time.perf_counter() - self.start_time
        self.started_ = False

    def reset(self) -> None:
        self.elapsed_ = 0.0
        self.started_ = False

    def elapsed(self, reset: bool = True) -> float:
        started = self.started_
        if started:
            self.stop()
        elapsed = self.elapsed_
        if reset:
            self.reset()
        if started:
            self.start()
        return elapsed


class Timers:
    """Named timers; :meth:`log` prints on the logging process
    (``torch.distributed`` rank ``log_rank``, default 0) and records into
    ``sink`` when given."""

    def __init__(self, log_rank: Optional[int] = None, sink=None):
        self.timers: Dict[str, _Timer] = {}
        self.log_rank = log_rank
        self.sink = sink

    def __call__(self, name: str) -> _Timer:
        if name not in self.timers:
            self.timers[name] = _Timer(name)
        return self.timers[name]

    def write(self, names, writer, iteration, normalizer=1.0, reset=False):
        assert normalizer > 0.0
        for name in names:
            value = self.timers[name].elapsed(reset=reset) / normalizer
            writer.add_scalar(f"{name}-time", value, iteration)

    def log(self, names=None, normalizer=1.0, reset=True,
            iteration=None) -> str:
        assert normalizer > 0.0
        names = names if names is not None else list(self.timers)
        string = "time (ms)"
        values = {}
        for name in names:
            ms = self.timers[name].elapsed(reset=reset) * 1000.0 / normalizer
            values[name] = ms
            string += f" | {name}: {ms:.2f}"
        if self.sink is not None:
            self.sink.record({"event": "timers", "iteration": iteration,
                              "ms": values})
        if is_logging_process(self.log_rank):
            print(string, flush=True)
        return string


def _ensure_var_is_initialized(var, name):
    if var is None:
        raise RuntimeError(f"{name} is not initialized")


def _ensure_var_is_not_initialized(var, name):
    if var is not None:
        raise RuntimeError(f"{name} is already initialized")


def get_args():
    _ensure_var_is_initialized(_GLOBAL_ARGS, "args")
    return _GLOBAL_ARGS


def get_num_microbatches():
    return _GLOBAL_NUM_MICROBATCHES_CALCULATOR.get()


def get_current_global_batch_size():
    return _GLOBAL_NUM_MICROBATCHES_CALCULATOR.get_current_global_batch_size()


def update_num_microbatches(consumed_samples, consistency_check=True):
    _GLOBAL_NUM_MICROBATCHES_CALCULATOR.update(consumed_samples,
                                               consistency_check)


def get_timers():
    _ensure_var_is_initialized(_GLOBAL_TIMERS, "timers")
    return _GLOBAL_TIMERS


def set_global_variables(extra_args_provider=None, args_defaults=None,
                         ignore_unknown_args=True, override_args=None):
    """Parse the args, build the microbatch calculator (when both batch
    sizes are given) and the timers; returns the args."""
    args = _parse_args(extra_args_provider, args_defaults,
                       ignore_unknown_args, override_args)
    if args.micro_batch_size is not None and \
            args.global_batch_size is not None:
        _build_num_microbatches_calculator(args)
    _set_timers()
    return args


def _parse_args(extra_args_provider=None, defaults=None,
                ignore_unknown_args=True, override_args=None):
    global _GLOBAL_ARGS
    _ensure_var_is_not_initialized(_GLOBAL_ARGS, "args")
    _GLOBAL_ARGS = parse_args(extra_args_provider, defaults,
                              ignore_unknown_args, override_args)
    return _GLOBAL_ARGS


def _build_num_microbatches_calculator(args):
    global _GLOBAL_NUM_MICROBATCHES_CALCULATOR
    _ensure_var_is_not_initialized(_GLOBAL_NUM_MICROBATCHES_CALCULATOR,
                                   "num microbatches calculator")
    _GLOBAL_NUM_MICROBATCHES_CALCULATOR = build_num_microbatches_calculator(
        args.rank, args.rampup_batch_size, args.global_batch_size,
        args.micro_batch_size, args.data_parallel_size)


def _set_timers():
    global _GLOBAL_TIMERS
    _ensure_var_is_not_initialized(_GLOBAL_TIMERS, "timers")
    _GLOBAL_TIMERS = Timers()


def destroy_global_vars():
    global _GLOBAL_ARGS, _GLOBAL_NUM_MICROBATCHES_CALCULATOR, _GLOBAL_TIMERS
    _GLOBAL_ARGS = None
    _GLOBAL_NUM_MICROBATCHES_CALCULATOR = None
    _GLOBAL_TIMERS = None
