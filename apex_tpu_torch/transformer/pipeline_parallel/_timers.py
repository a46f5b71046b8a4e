"""Megatron-style timers (counterpart of
``apex_tpu/transformer/pipeline_parallel/_timers.py``): named timers on
the monotonic ``perf_counter`` host clock; ``start`` / ``stop`` with
``barrier_on`` first wait for the card (``torch.cuda.synchronize`` of
the device a CUDA tensor of ``barrier_on`` lies on), the reference's
``cuda.synchronize`` fence, where the JAX ones ``block_until_ready``.
:class:`Timers` prints on the logging process and records into a
telemetry ``sink``."""
from __future__ import annotations

import time
from typing import Dict, Optional

import torch

from ...telemetry.recorder import is_logging_process


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
