"""Numerics health monitor: per-tensor overflow provenance, activation
watch, anomaly events (counterpart of ``apex_tpu/telemetry/numerics.py``).

- :class:`NumericsState` — per-leaf gradient statistics of the current
  step (sum of squares, max |g|, non-finite count) and the anomaly
  engine's scalars (grad-norm EWMA, loss scale, first bad step), 0-dim
  and ``(n_leaves,)`` tensors on the card; the step count is a host
  integer (each observation adds one).
- :class:`NumericsMonitor` — the static half: leaf names (tree paths in
  ``jax.tree_util.keystr``'s format, or ``PackSpec.leaf_names()``), the
  packed row -> leaf table, the rule thresholds.
- **Overflow provenance** — :meth:`NumericsMonitor.observe` takes a
  grads tree (per-leaf reductions in plain PyTorch), a packed flat buffer
  (ONE :func:`~apex_tpu_torch.ops.packed_optimizer.packed_row_stats` sweep,
  the CUDA kernel, then a per-leaf sum or max over the leaves' contiguous
  rows), or the per-leaf / per-row flags the loss scaler's unscale already
  produced. Rows never straddle leaves, so a non-finite row names exactly
  one tensor.
- **Anomaly rules** — ``nonfinite_grads`` (with the guilty leaves),
  ``grad_spike`` (norm against an EWMA), ``scale_collapse`` (the loss
  scale crossing below a floor, edge-triggered), ``scaler_stall`` (the
  scaler's consecutive-skip run crossing ``max_consecutive_skips``,
  edge-triggered), evaluated on the card.
- **Activation watch** — :func:`tap` / :func:`tap_flat` points, identity
  unless an :func:`activation_watch` context is active.

The drain has no ``lax.cond`` to hide behind. Each step's flags and
payload go to the host through
:func:`~apex_tpu_torch.telemetry.recorder.defer` (a ``non_blocking``
copy into pinned memory and a CUDA event), and the records of a step are
built once its event has completed: healthy steps cost a small copy and
no host sync, and ``telemetry.flush()`` emits what is still in flight.
Records carry the state's own ``step``, so a late emission changes only
``t_wall``; they are byte-compatible with the JAX package's.

Usage (pytree path)::

    rec = telemetry.JsonlRecorder("train.jsonl")
    mon = numerics.NumericsMonitor(params)
    nstate = mon.init()
    for step in ...:
        loss, grads = ...
        nstate = mon.observe(nstate, grads=grads)
        params, opt_state = opt.step(grads, opt_state, params)
        nstate = mon.drain(nstate, rec)
    telemetry.flush()

With the loss scaler provenance is free
(``scaler.unscale_flat(sstate, flat, numerics=(mon, nstate))``); the
packed path builds the monitor from the optimizer's ``PackSpec``
(``NumericsMonitor(spec=state.spec)``) and observes the flat gradient
buffer (``observe(nstate, flat_grads=flat, inv_scale=1 / scale)``).
"""
from __future__ import annotations

import contextlib
from typing import Any, NamedTuple, Optional, Tuple

import numpy as np
import torch

from .._device import resolve_device
from .._tree import leaf_paths, tree_flatten, tree_leaves
from .metrics import _like
from .recorder import defer, stamp_wall

Tree = Any

# scale_floor default: well above fp32 underflow, far below any healthy
# dynamic scale — the "loss scale has collapsed, training is dead" line.
_DEFAULT_SCALE_FLOOR = 2.0 ** -10


def leaf_names(tree: Tree) -> Tuple[str, ...]:
    """Leaf path strings in flatten order (``jax.tree_util.keystr``'s
    format)."""
    return tuple(leaf_paths(tree_flatten(tree)[1]))


def _segment_rows(rows: torch.Tensor, lengths: torch.Tensor, n_leaves: int,
                  op: str) -> torch.Tensor:
    """Per-row partials -> per-leaf: a sum or a max over each leaf's
    contiguous rows (``lengths``: rows per leaf, then the padding rows,
    whose segment is dropped). A fixed order (no scatter) and a max that
    keeps a nan, as JAX's ``segment_max``."""
    out = torch.segment_reduce(rows, op, lengths=lengths, unsafe=True)
    return out[:n_leaves]


def _row_lengths(row_ids: np.ndarray, n_rows: int, n_leaves: int,
                 device) -> torch.Tensor:
    """Rows per leaf, then the trailing padding rows. A padding row
    between two leaves (a bucket closing, an ``align`` above a row) joins
    the leaf before it, so that every leaf's rows stay one contiguous
    segment; its values are padding (zero), which no sum or max sees."""
    if n_rows > len(row_ids):
        raise ValueError(f"{n_rows} rows, the PackSpec lays out "
                         f"{len(row_ids)}")
    ids = row_ids[:n_rows].astype(np.int64)
    real = ids < n_leaves
    owner = np.maximum.accumulate(np.where(real, ids, -1))
    if real.any():
        owner[np.flatnonzero(real)[-1] + 1:] = n_leaves
    owner[owner < 0] = n_leaves
    lengths = np.bincount(owner, minlength=n_leaves + 1)
    return torch.from_numpy(lengths.astype(np.int64)).to(device)


def _guilty_leaves(names, leaf_nf, sq=None, ma=None):
    """Host-side list of the non-finite leaves for an anomaly event."""
    out = []
    for i in np.nonzero(np.asarray(leaf_nf) > 0)[0]:
        d = {"name": names[i], "nonfinite": float(leaf_nf[i])}
        if ma is not None:
            d["maxabs"] = float(ma[i])
        if sq is not None:
            d["norm"] = float(np.sqrt(sq[i]))
        out.append(d)
    return out


class NumericsState(NamedTuple):
    """Numerics accumulators. Per-leaf tensors are ``(n_leaves,)`` and
    describe the CURRENT step (:meth:`NumericsMonitor.observe` rewrites
    them); the 0-dim tensors carry the run-level anomaly-engine state.
    ``step`` is a host integer."""

    step: int                        # observed steps
    grad_sq: torch.Tensor            # f32 (n,) sq-sums (nan = unknown)
    grad_maxabs: torch.Tensor        # f32 (n,) max |g| (nan = unknown)
    grad_nonfinite: torch.Tensor     # f32 (n,) non-finite counts/flags
    overflow: torch.Tensor           # bool, this step saw non-finite grads
    spike: torch.Tensor              # bool, this step's norm spiked
    spike_ratio: torch.Tensor        # f32, norm / ewma when spike else 0
    grad_norm: torch.Tensor          # f32, this step's global grad norm
    ewma_norm: torch.Tensor          # f32, EWMA of finite global norms
    ewma_steps: torch.Tensor         # i32, finite norms folded in
    loss_scale: torch.Tensor         # f32, last scale from the scaler
    prev_loss_scale: torch.Tensor    # f32, the scale before that update
    first_bad_step: torch.Tensor     # i32, first overflow step (-1 = never)
    consecutive_skips: torch.Tensor       # i32, scaler skip-run length
    prev_consecutive_skips: torch.Tensor  # i32, the run length before


def observe_scale_update(state: NumericsState, found_inf, old_scale,
                         new_scale, consecutive_skips=None
                         ) -> NumericsState:
    """Fold one loss-scale update into the numerics state (device
    arithmetic). Called by :meth:`apex_tpu_torch.amp.LossScaler
    .update_scale` with ``numerics=``: the consumed ``found_inf`` marks the
    step overflowed (the first bad step latches), the old and new scales
    feed ``scale_collapse`` and the post-update ``consecutive_skips`` feeds
    ``scaler_stall``."""
    found = _like(found_inf, state.overflow)
    overflow = state.overflow | found
    if consecutive_skips is None:
        # a caller without the scaler's counter: the run length from the
        # overflow flags this state has seen (reset on a clean update)
        consecutive_skips = torch.where(
            found, state.consecutive_skips + 1,
            torch.zeros_like(state.consecutive_skips))
    return state._replace(
        overflow=overflow,
        first_bad_step=torch.where(
            (state.first_bad_step < 0) & overflow,
            torch.full_like(state.first_bad_step, state.step),
            state.first_bad_step),
        prev_loss_scale=_like(old_scale, state.loss_scale),
        loss_scale=_like(new_scale, state.loss_scale),
        prev_consecutive_skips=state.consecutive_skips,
        consecutive_skips=_like(consecutive_skips, state.consecutive_skips))


class NumericsMonitor:
    """Static half of the numerics monitor: names, mappings, thresholds.

    Build from a params/grads template tree (leaf names from tree paths)
    or from a :class:`~apex_tpu_torch.multi_tensor_apply.packing.PackSpec`
    (``spec=``: names AND the row -> leaf table for packed flat buffers).

    Anomaly rules (evaluated on the card, emitted by :meth:`drain`):

    - ``nonfinite_grads`` — any per-leaf non-finite count > 0 (or a folded
      scaler ``found_inf``); the event names the guilty leaves.
    - ``grad_spike`` — finite global grad norm > ``spike_factor`` x the
      EWMA of previous finite norms, after ``spike_warmup`` finite steps.
    - ``scale_collapse`` — loss scale crossed below ``scale_floor``
      (edge-triggered on the crossing).
    - ``scaler_stall`` — the scaler's consecutive-skip counter crossed
      ``max_consecutive_skips`` (edge-triggered).
    """

    def __init__(self, template: Optional[Tree] = None, *, spec=None,
                 ewma_decay: float = 0.98, spike_factor: float = 10.0,
                 spike_warmup: int = 20,
                 scale_floor: float = _DEFAULT_SCALE_FLOOR,
                 max_consecutive_skips: int = 8, tag: Optional[str] = None):
        from ..multi_tensor_apply.packing import PackSpec

        # NumericsMonitor(pack_spec) passed positionally is honoured
        if isinstance(template, PackSpec) and spec is None:
            template, spec = None, template
        if (template is None) == (spec is None):
            raise ValueError(
                "pass exactly one of a params/grads template pytree or "
                "spec= (a PackSpec)")
        if spec is not None:
            self.names: Tuple[str, ...] = spec.leaf_names()
            self._row_ids = np.asarray(spec.row_leaf_ids())
        else:
            self.names = leaf_names(template)
            self._row_ids = None
        self._lengths = {}  # (rows, device) -> per-leaf row counts
        self.n_leaves = len(self.names)
        self.ewma_decay = float(ewma_decay)
        # 1 - decay rounded in fp32, as the JAX package computes it
        self._one_minus_decay = float(np.float32(1.0)
                                      - np.float32(ewma_decay))
        self.spike_factor = float(spike_factor)
        self.spike_warmup = int(spike_warmup)
        self.scale_floor = float(scale_floor)
        self.max_consecutive_skips = int(max_consecutive_skips)
        self.tag = tag

    # -- state --------------------------------------------------------------
    def init(self, device=None) -> NumericsState:
        """The first state, on the card unless ``device`` names another."""
        dev = resolve_device(device)
        n = self.n_leaves

        def f():
            return torch.zeros((), dtype=torch.float32, device=dev)

        def i(v=0):
            return torch.full((), v, dtype=torch.int32, device=dev)
        false = torch.zeros((), dtype=torch.bool, device=dev)
        return NumericsState(
            step=0,
            grad_sq=torch.full((n,), float("nan"), device=dev),
            grad_maxabs=torch.full((n,), float("nan"), device=dev),
            grad_nonfinite=torch.zeros((n,), device=dev),
            overflow=false, spike=false.clone(), spike_ratio=f(),
            grad_norm=f(), ewma_norm=f(), ewma_steps=i(), loss_scale=f(),
            prev_loss_scale=f(), first_bad_step=i(-1),
            consecutive_skips=i(), prev_consecutive_skips=i())

    # -- observation (device arithmetic) ----------------------------------
    def observe(self, state: NumericsState, *, grads: Optional[Tree] = None,
                flat_grads: Optional[torch.Tensor] = None,
                leaf_nonfinite: Optional[torch.Tensor] = None,
                row_nonfinite: Optional[torch.Tensor] = None,
                inv_scale=1.0, exact_counts: bool = False) -> NumericsState:
        """Begin this step's numerics window from exactly one source.

        - ``grads=`` (tree): per-leaf sum of squares and max |g|; the
          per-leaf non-finite INDICATOR falls out of the max (a non-finite
          element makes it nan or inf); ``exact_counts=True`` adds a third
          reduction for exact counts.
        - ``flat_grads=`` (a packed 1-D buffer; the monitor built from the
          matching ``spec=``): one ``packed_row_stats`` sweep, reduced per
          leaf over the row-aligned offsets, exact counts included.
          ``inv_scale`` unscales first (loss-scaled grads).
        - ``leaf_nonfinite=`` (``(n_leaves,)``) or ``row_nonfinite=``
          (``(rows,)``): provenance only, from flags an existing sweep
          already produced (the scaler's unscale); norms stay nan.
        """
        srcs = [s is not None
                for s in (grads, flat_grads, leaf_nonfinite, row_nonfinite)]
        if sum(srcs) != 1:
            raise ValueError(
                "observe() takes exactly one of grads=, flat_grads=, "
                "leaf_nonfinite=, row_nonfinite=")
        n = self.n_leaves
        if grads is not None:
            leaves = tree_leaves(grads)
            if len(leaves) != n:
                raise ValueError(
                    f"grads tree has {len(leaves)} leaves, monitor was "
                    f"built over {n}")
            static_unit = (isinstance(inv_scale, (int, float))
                           and float(inv_scale) == 1.0)
            sqs, mas, nfs = [], [], []
            for leaf in leaves:
                x = leaf.detach()
                if not static_unit:
                    x = x.float() * inv_scale
                # one read of the leaf each, in fp32 (no fp32 copy of a
                # bf16 leaf); both norms keep a nan
                sqs.append(torch.linalg.vector_norm(
                    x, 2, dtype=torch.float32).square())
                mas.append(torch.linalg.vector_norm(
                    x, float("inf"), dtype=torch.float32))
                if exact_counts:
                    nfs.append(torch.sum(~torch.isfinite(x),
                                         dtype=torch.float32))
            sq, ma = torch.stack(sqs), torch.stack(mas)
            nf = (torch.stack(nfs) if exact_counts
                  else (~torch.isfinite(ma)).float())
        elif flat_grads is not None:
            sq, ma, nf = self._segment_stats(flat_grads, inv_scale)
        else:
            if leaf_nonfinite is None:
                leaf_nonfinite = self._rows_to_leaves(
                    row_nonfinite.float(), "sum")
            nf = leaf_nonfinite.float()
            if tuple(nf.shape) != (n,):
                raise ValueError(
                    f"leaf flags shape {tuple(nf.shape)} != ({n},)")
            sq = ma = torch.full((n,), float("nan"), device=nf.device)

        overflow = torch.any(nf > 0)
        norm = torch.sqrt(torch.sum(sq))
        step = state.step + 1
        # spike: judged against the EWMA of PREVIOUS finite norms, then
        # the current finite norm is folded in
        finite = torch.isfinite(norm) & ~overflow
        warmed = state.ewma_steps >= self.spike_warmup
        ratio = norm / torch.clamp_min(state.ewma_norm, 1e-30)
        spike = finite & warmed & (ratio > self.spike_factor)
        new_ewma = torch.where(
            finite,
            torch.where(state.ewma_steps == 0, norm,
                        self.ewma_decay * state.ewma_norm
                        + self._one_minus_decay * norm),
            state.ewma_norm)
        return state._replace(
            step=step, grad_sq=sq, grad_maxabs=ma, grad_nonfinite=nf,
            overflow=overflow, spike=spike,
            spike_ratio=torch.where(spike, ratio, torch.zeros_like(ratio)),
            grad_norm=norm, ewma_norm=new_ewma,
            ewma_steps=state.ewma_steps + finite.to(torch.int32),
            first_bad_step=torch.where(
                (state.first_bad_step < 0) & overflow,
                torch.full_like(state.first_bad_step, step),
                state.first_bad_step))

    def _rows_to_leaves(self, rows: torch.Tensor, op: str) -> torch.Tensor:
        if self._row_ids is None:
            raise ValueError(
                "packed observation needs a monitor built from the "
                "optimizer's PackSpec: NumericsMonitor(spec=state.spec)")
        key = (rows.shape[0], rows.device)
        if key not in self._lengths:
            self._lengths[key] = _row_lengths(self._row_ids, rows.shape[0],
                                              self.n_leaves, rows.device)
        return _segment_rows(rows, self._lengths[key], self.n_leaves, op)

    def _segment_stats(self, flat: torch.Tensor, inv_scale):
        from ..ops.packed_optimizer import packed_row_stats

        if self._row_ids is None:
            self._rows_to_leaves(flat, "sum")  # raises: no PackSpec
        if flat.ndim != 1:
            raise ValueError(
                f"flat_grads must be 1-D, got {tuple(flat.shape)}")
        row_sq, row_ma, row_nf = packed_row_stats(flat, inv_scale=inv_scale)
        return (self._rows_to_leaves(row_sq, "sum"),
                self._rows_to_leaves(row_ma, "max"),
                self._rows_to_leaves(row_nf, "sum"))

    # -- drain ------------------------------------------------------------
    def drain(self, state: NumericsState, sink, *, tag: Optional[str] = None,
              health_every: int = 0) -> NumericsState:
        """Emit anomaly events (and optional periodic health records).

        Call once per step after the observations. The step's flags and
        payload go to the host with no sync (:func:`~.recorder.defer`);
        once they arrive, a step with an event emits its records and a
        healthy step emits none. ``health_every=N`` also emits a per-leaf
        health table every N steps (decided on the host step count); 0
        disables it. ``sink`` is a recorder (``.record(dict)``) or a bare
        callable; rank gating happens at the sink."""
        record = sink.record if hasattr(sink, "record") else sink
        if not callable(record):
            raise TypeError(
                f"sink must expose .record(dict) or be callable, got "
                f"{sink!r}")
        names = self.names
        tag = self.tag if tag is None else tag
        floor = self.scale_floor
        collapse = ((state.loss_scale > 0) & (state.loss_scale < floor)
                    & (state.prev_loss_scale >= floor))
        # edge-triggered: fires on the step the run length CROSSES the
        # budget, not on every later skipped step
        budget = self.max_consecutive_skips
        stall = ((state.consecutive_skips >= budget)
                 & (state.prev_consecutive_skips < budget)
                 & (budget > 0))
        step = state.step
        health = bool(health_every) and step > 0 and step % health_every == 0

        def emit(v):
            if bool(v["overflow"] | v["spike"] | v["collapse"] | v["stall"]):
                self._emit_events(record, names, tag, step, v)
            if health:
                rec = stamp_wall(
                    {"event": "numerics_health", "step": step,
                     "grad_norm": float(v["norm"]),
                     "ewma_norm": float(v["ewma"]),
                     "loss_scale": float(v["scale"]),
                     "first_bad_step": int(v["first_bad"]),
                     "leaves": {
                         names[i]: {
                             "norm": float(np.sqrt(v["sq"][i])),
                             "maxabs": float(v["ma"][i]),
                             "nonfinite": float(v["nf"][i]),
                         } for i in range(len(names))}})
                if tag is not None:
                    rec["tag"] = tag
                record(rec)

        defer({"nf": state.grad_nonfinite, "sq": state.grad_sq,
               "ma": state.grad_maxabs, "overflow": state.overflow,
               "spike": state.spike, "ratio": state.spike_ratio,
               "norm": state.grad_norm, "ewma": state.ewma_norm,
               "scale": state.loss_scale, "prev_scale": state.prev_loss_scale,
               "collapse": collapse, "first_bad": state.first_bad_step,
               "stall": stall, "consec": state.consecutive_skips}, emit)
        return state

    def _emit_events(self, record, names, tag, step, v) -> None:
        base = stamp_wall({"step": step})
        if tag is not None:
            base["tag"] = tag
        if bool(v["overflow"]):
            record({**base, "event": "anomaly", "kind": "nonfinite_grads",
                    "leaves": _guilty_leaves(names, v["nf"], sq=v["sq"],
                                             ma=v["ma"]),
                    "loss_scale": float(v["scale"]),
                    "first_bad_step": int(v["first_bad"])})
        if bool(v["spike"]):
            record({**base, "event": "anomaly", "kind": "grad_spike",
                    "grad_norm": float(v["norm"]),
                    "ewma_norm": float(v["ewma"]),
                    "ratio": float(v["ratio"])})
        if bool(v["collapse"]):
            record({**base, "event": "anomaly", "kind": "scale_collapse",
                    "loss_scale": float(v["scale"]),
                    "prev_loss_scale": float(v["prev_scale"]),
                    "floor": self.scale_floor})
        if bool(v["stall"]):
            record({**base, "event": "anomaly", "kind": "scaler_stall",
                    "consecutive_skips": int(v["consec"]),
                    "max_consecutive_skips": self.max_consecutive_skips,
                    "loss_scale": float(v["scale"]),
                    "first_bad_step": int(v["first_bad"])})


# ---------------------------------------------------------------------------
# activation watch: opt-in taps
# ---------------------------------------------------------------------------

_ACTIVE_WATCH: Optional["ActivationWatch"] = None


class ActivationWatch:
    """Config and sink of an active :func:`activation_watch` context."""

    def __init__(self, sink, *, only_nonfinite: bool = False,
                 tag: Optional[str] = None):
        record = sink.record if hasattr(sink, "record") else sink
        if not callable(record):
            raise TypeError(
                f"sink must expose .record(dict) or be callable, got "
                f"{sink!r}")
        self._record = record
        self.only_nonfinite = bool(only_nonfinite)
        self.tag = tag

    def _emit(self, name, layer, maxabs, nonfinite, norm, extra=None):
        rec = stamp_wall(
            {"event": "activation", "name": str(name),
             "maxabs": float(maxabs), "nonfinite": float(nonfinite),
             "norm": float(norm)})
        layer = int(layer)
        if layer >= 0:
            rec["layer"] = layer
        if self.tag is not None:
            rec["tag"] = self.tag
        if extra:
            rec.update(extra)
        self._record(rec)

    def _submit(self, payload: dict, emit) -> None:
        """Defer ``emit`` on ``payload``; under ``only_nonfinite`` it runs
        only for a non-finite count above 0 (decided on the host once the
        values arrive: no sync)."""
        def gated(v):
            if not self.only_nonfinite or float(v["nonfinite"]) > 0:
                emit(v)
        defer(payload, gated)


@contextlib.contextmanager
def activation_watch(sink, *, only_nonfinite: bool = False,
                     tag: Optional[str] = None):
    """Enable the :func:`tap` points for code run inside this context.
    ``only_nonfinite=True`` emits a tap only when its activation holds a
    non-finite value. Taps fire in the forward as it runs (and again in a
    recomputed forward)."""
    global _ACTIVE_WATCH
    prev = _ACTIVE_WATCH
    _ACTIVE_WATCH = ActivationWatch(
        sink, only_nonfinite=only_nonfinite, tag=tag)
    try:
        yield _ACTIVE_WATCH
    finally:
        _ACTIVE_WATCH = prev


def watching() -> bool:
    """True when an :func:`activation_watch` context is active."""
    return _ACTIVE_WATCH is not None


def tap(name: str, x: torch.Tensor, *, layer=None) -> torch.Tensor:
    """Activation-watch tap: identity (the same tensor) unless a watch is
    active; then the max |x|, non-finite count and L2 norm of ``x`` go to
    the watch's sink. ``name`` as in the JAX package
    (``apex_tpu.transformer_layer/attn``, ``.../mlp``,
    ``apex_tpu.packed_adam/grads``)."""
    w = _ACTIVE_WATCH
    if w is None:
        return x
    with torch.no_grad():
        x32 = x.detach().float()
        stats = {"maxabs": torch.max(torch.abs(x32)),
                 "nonfinite": torch.sum(~torch.isfinite(x32),
                                        dtype=torch.float32),
                 "norm": torch.sqrt(torch.sum(x32 * x32))}
    layer = -1 if layer is None else int(layer)
    w._submit(stats, lambda v: w._emit(name, layer, v["maxabs"],
                                       v["nonfinite"], v["norm"]))
    return x


def tap_flat(name: str, flat: torch.Tensor, *, spec=None,
             inv_scale=1.0) -> torch.Tensor:
    """Flat-buffer tap for the packed kernels: identity unless a watch is
    active; then one ``packed_row_stats`` sweep, and with ``spec`` (the
    buffer's ``PackSpec``) a non-finite buffer names its guilty leaves
    through the row-aligned offsets."""
    w = _ACTIVE_WATCH
    if w is None:
        return flat
    from ..ops.packed_optimizer import packed_row_stats

    with torch.no_grad():
        row_sq, row_ma, row_nf = packed_row_stats(flat.detach(),
                                                  inv_scale=inv_scale)
        stats = {"maxabs": torch.max(row_ma), "nonfinite": torch.sum(row_nf),
                 "norm": torch.sqrt(torch.sum(row_sq))}
        if spec is not None:
            if row_nf.shape[0] != spec.n_rows:
                raise ValueError(
                    f"tap_flat: a buffer of {row_nf.shape[0]} rows, the "
                    f"PackSpec lays out {spec.n_rows}")
            stats["leaf_nf"] = _segment_rows(
                row_nf, spec.row_segments(flat.device)[0], spec.n_leaves,
                "sum")
    names = spec.leaf_names() if spec is not None else None

    def emit(v):
        guilty = _guilty_leaves(names, v["leaf_nf"]) if names else []
        w._emit(name, -1, v["maxabs"], v["nonfinite"], v["norm"],
                extra={"leaves": guilty} if guilty else None)
    w._submit(stats, emit)
    return flat
