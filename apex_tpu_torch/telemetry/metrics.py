"""Device-resident training metrics: accumulate on the card, drain without
a sync (counterpart of ``apex_tpu/telemetry/metrics.py``).

A :class:`MetricsState` rides the train step: every statistic is a 0-dim
tensor on the card updated by device arithmetic, and :func:`drain` hands
the window to a sink every ``every_n`` steps through
:func:`~apex_tpu_torch.telemetry.recorder.defer`: a ``non_blocking`` copy
into pinned memory, emitted once the card has reached it. The JAX package
gates its drain with a ``lax.cond`` over the device counter; here the step
counters are host integers (every :func:`accumulate` adds exactly one and
every drain resets the window, so the host knows them without reading the
card), and the ``every_n`` test is made on them. Instrumentation thus adds
no host sync to the step. Call
:func:`~apex_tpu_torch.telemetry.recorder.flush` once at the end of a run.

Usage::

    rec = telemetry.JsonlRecorder("train_metrics.jsonl")
    metrics = telemetry.init_metrics()
    for step in ...:
        loss, grads = ...
        metrics = telemetry.accumulate(metrics, loss=loss, tokens=b * s)
        metrics = telemetry.drain(metrics, rec, every_n=10)
    telemetry.flush()

Window statistics (loss, norms, tokens) reset at every drain; the
overflow-skip / scale-growth counters are cumulative for the whole run
(see :meth:`apex_tpu_torch.amp.LossScaler.update_scale` with
``metrics=``). Records keep the JAX package's keys and order; a late
emission changes only ``t_wall``.
"""
from __future__ import annotations

import time
from typing import Any, NamedTuple, Optional

import torch

from .._device import resolve_device
from .._tree import tree_leaves
from .recorder import defer, stamp_wall

Tree = Any


class MetricsState(NamedTuple):
    """Metric accumulators: 0-dim tensors on the card, except the two
    step counters, which the host keeps. ``total_*`` fields are
    cumulative; the rest are window accumulators reset by :func:`drain`.
    ``last_drain_t`` is the host clock at the last drain (``wall_dt_s``'s
    baseline)."""

    total_steps: int            # never reset
    window_steps: int           # steps since the last drain
    loss_sum: torch.Tensor      # f32 window sum
    loss_last: torch.Tensor     # f32 most recent loss
    grad_norm_sum: torch.Tensor   # f32 window sum of global grad L2 norms
    param_norm_sum: torch.Tensor  # f32 window sum of global param L2 norms
    tokens: torch.Tensor        # f32 window token count
    total_tokens: torch.Tensor  # f32 cumulative token count
    loss_scale: torch.Tensor    # f32 last observed loss scale (0 = none)
    overflow_skips: torch.Tensor  # i32 cumulative skipped steps
    scale_growths: torch.Tensor   # i32 cumulative loss-scale growths
    last_drain_t: Optional[float] = None


def init_metrics(device=None) -> MetricsState:
    """Zeroed accumulators, on the card unless ``device`` names another."""
    dev = resolve_device(device)

    def f():
        return torch.zeros((), dtype=torch.float32, device=dev)

    def i():
        return torch.zeros((), dtype=torch.int32, device=dev)
    return MetricsState(
        total_steps=0, window_steps=0, loss_sum=f(), loss_last=f(),
        grad_norm_sum=f(), param_norm_sum=f(), tokens=f(), total_tokens=f(),
        loss_scale=f(), overflow_skips=i(), scale_growths=i())


def _global_l2(tree: Tree) -> torch.Tensor:
    leaves = tree_leaves(tree)
    return torch.sqrt(sum(torch.sum(torch.square(l.float()))
                          for l in leaves))


def _f32(v):
    """A tensor as fp32 where it lies, a number as a Python float (a
    kernel argument: no copy to the card)."""
    return v.float() if isinstance(v, torch.Tensor) else float(v)


def _like(v, ref: torch.Tensor) -> torch.Tensor:
    """``v`` as a 0-dim tensor of ``ref``'s dtype on ``ref``'s device; a
    number becomes a fill there (no copy from the host)."""
    if isinstance(v, torch.Tensor):
        return v.to(device=ref.device, dtype=ref.dtype).reshape(())
    return torch.full_like(ref, v)


def accumulate(m: MetricsState, *, loss=None, grads: Optional[Tree] = None,
               grad_norm=None, params: Optional[Tree] = None,
               param_norm=None, tokens=None) -> MetricsState:
    """Fold one step's statistics into the window. ``loss``/``tokens``
    cost nothing beyond an add; ``grads=``/``params=`` compute a global
    L2 norm (one more read of the tree): pass ``grad_norm``/``param_norm``
    instead when the step already has one."""
    if grads is not None:
        if grad_norm is not None:
            raise ValueError("pass grads= or grad_norm=, not both")
        grad_norm = _global_l2(grads)
    if params is not None:
        if param_norm is not None:
            raise ValueError("pass params= or param_norm=, not both")
        param_norm = _global_l2(params)
    tok = 0.0 if tokens is None else _f32(tokens)
    return m._replace(
        total_steps=m.total_steps + 1,
        window_steps=m.window_steps + 1,
        loss_sum=m.loss_sum + (0.0 if loss is None else _f32(loss)),
        loss_last=m.loss_last if loss is None else _like(loss, m.loss_last),
        grad_norm_sum=m.grad_norm_sum
        + (0.0 if grad_norm is None else _f32(grad_norm)),
        param_norm_sum=m.param_norm_sum
        + (0.0 if param_norm is None else _f32(param_norm)),
        tokens=m.tokens + tok,
        total_tokens=m.total_tokens + tok)


def observe_scale_update(m: MetricsState, found_inf, old_scale,
                         new_scale) -> MetricsState:
    """Fold one loss-scale update into the cumulative counters:
    ``found_inf`` (the flag the update consumed) counts a skipped step, a
    ``new_scale`` above ``old_scale`` a growth. Device arithmetic."""
    new = _like(new_scale, m.loss_scale)
    return m._replace(
        loss_scale=new,
        overflow_skips=m.overflow_skips + _like(found_inf, m.overflow_skips),
        scale_growths=m.scale_growths
        + (new > _like(old_scale, m.loss_scale)).to(torch.int32))


def summarize(m: MetricsState) -> dict:
    """Window means and cumulative counters as device scalars (reading
    them on the host IS a sync: use :func:`drain` in a step)."""
    n = float(max(m.window_steps, 1))
    return {
        "step": m.total_steps,
        "steps_in_window": m.window_steps,
        "loss": m.loss_sum / n,
        "loss_last": m.loss_last,
        "grad_norm": m.grad_norm_sum / n,
        "param_norm": m.param_norm_sum / n,
        "tokens": m.tokens,
        "total_tokens": m.total_tokens,
        "loss_scale": m.loss_scale,
        "overflow_skips": m.overflow_skips,
        "scale_growths": m.scale_growths,
    }


_DEVICE_FIELDS = ("loss_sum", "loss_last", "grad_norm_sum",
                  "param_norm_sum", "tokens", "total_tokens", "loss_scale",
                  "overflow_skips", "scale_growths")


def _reset_window(m: MetricsState) -> MetricsState:
    z = torch.zeros_like(m.loss_sum)
    return m._replace(window_steps=0, loss_sum=z, grad_norm_sum=z,
                      param_norm_sum=z, tokens=z)


def drain(m: MetricsState, sink, *, every_n: int = 1,
          tag: Optional[str] = None,
          bytes_per_step: Optional[float] = None,
          extra: Optional[dict] = None) -> MetricsState:
    """Emit the window to ``sink`` every ``every_n`` steps (decided on the
    host counters), without a sync: the record is built on the host once
    the card has produced the values (:func:`~.recorder.defer`), and the
    window resets.

    ``sink`` is a recorder (``.record(dict)``) or a bare
    ``callable(dict)``. Records carry window means, cumulative counters,
    ``t_wall`` and, from the second drain on, ``wall_dt_s`` (host time
    since the previous drain of this state) with ``steps_per_sec`` /
    ``tokens_per_sec``; with ``bytes_per_step`` also ``achieved_gbps``.
    ``extra`` adds static key/values to every record."""
    record = sink.record if hasattr(sink, "record") else sink
    if not callable(record):
        raise TypeError(
            f"sink must expose .record(dict) or be callable, got {sink!r}")
    if not (m.window_steps > 0 and m.total_steps % every_n == 0):
        return m
    now = time.perf_counter()
    last, steps, window = m.last_drain_t, m.total_steps, m.window_steps

    def emit(v):
        n = max(window, 1)
        rec = {
            "event": "metrics",
            "step": steps,
            "steps_in_window": window,
            "loss": float(v["loss_sum"]) / n,
            "loss_last": float(v["loss_last"]),
            "grad_norm": float(v["grad_norm_sum"]) / n,
            "param_norm": float(v["param_norm_sum"]) / n,
            "tokens": float(v["tokens"]),
            "total_tokens": float(v["total_tokens"]),
            "loss_scale": float(v["loss_scale"]),
            "overflow_skips": int(v["overflow_skips"]),
            "scale_growths": int(v["scale_growths"]),
        }
        stamp_wall(rec)
        if tag is not None:
            rec["tag"] = tag
        if extra:
            rec.update(extra)
        if last is not None:
            dt = max(now - last, 1e-12)
            rec["wall_dt_s"] = dt
            rec["steps_per_sec"] = window / dt
            if float(v["tokens"]):
                rec["tokens_per_sec"] = float(v["tokens"]) / dt
            if bytes_per_step:
                rec["achieved_gbps"] = (
                    float(bytes_per_step) * window / dt / 1e9)
        record(rec)

    defer({k: getattr(m, k) for k in _DEVICE_FIELDS}, emit)
    return _reset_window(m)._replace(last_drain_t=now)
