"""Dynamic and static loss scaling as a state machine over device scalars
(counterpart of ``apex_tpu/amp/scaler.py``).

The reference's ``apex/amp/scaler.py`` mutates its scale and reads the
overflow flag on the host once a step. Here, as in the JAX package, the
scaler is a pure function of a :class:`LossScaleState` of 0-dim device
tensors, and an overflow never leaves the card: ``found_inf`` is the
optimizers' noop flag, and :meth:`LossScaler.update_scale` backs the
scale off (or grows it) with device selects. Only ``state_dict`` reads
the state on the host (checkpointing).

The flat-buffer methods run on kernels: :meth:`LossScaler.unscale_flat`
is one ``multi_tensor_scale_flat`` sweep with per-row flags (the flat
gradient lifecycle's one upcast), :meth:`LossScaler.found_inf_flat` one
fused non-finite reduction. With ``numerics=`` (a ``(NumericsMonitor,
NumericsState)`` pair of ``apex_tpu_torch.telemetry.numerics``) the
unscales hand their per-leaf or per-row non-finite flags to the monitor
(overflow provenance at no extra sweep), and :meth:`LossScaler.update_scale`
folds the update into a ``metrics=`` or ``numerics=`` state, as the JAX
package's scaler does.
"""
from __future__ import annotations

from typing import Any, NamedTuple, Optional, Tuple

import torch

from .._device import resolve_device
from ..ops.multi_tensor import (
    multi_tensor_axpby,
    multi_tensor_scale,
    update_scale_hysteresis,
)
from ..multi_tensor_apply.packing import DEFAULT_CHUNK, BucketBuffers
from ..ops.packed_optimizer import multi_tensor_scale_flat

Tree = Any

_FP32_MAX = torch.finfo(torch.float32).max


class LossScaleState(NamedTuple):
    """The scaler's state, 0-dim tensors on one device: ``unskipped`` is
    the reference's growth counter, ``hysteresis`` the overflow allowance
    left (``update_scale_hysteresis.cu``), ``consecutive_skips`` the
    skipped steps in a row."""

    loss_scale: torch.Tensor  # fp32
    unskipped: torch.Tensor  # int32
    hysteresis: torch.Tensor  # int32
    found_inf: torch.Tensor  # bool, an overflow in the current step
    consecutive_skips: torch.Tensor  # int32


class LossScaler:
    """Static or dynamic loss scaler (``apex/amp/scaler.py:33-60``).

    ``loss_scale`` is a number (static) or ``"dynamic"``: the scale then
    starts at ``init_scale``, grows by ``scale_factor`` after
    ``scale_window`` clean steps, backs off by ``1 / scale_factor`` on an
    overflow once ``hysteresis`` overflows are spent, and stays within
    ``[min_loss_scale, max_loss_scale]``."""

    def __init__(self, loss_scale="dynamic", init_scale: float = 2.0 ** 16,
                 scale_factor: float = 2.0, scale_window: int = 2000,
                 min_loss_scale: Optional[float] = None,
                 max_loss_scale: float = 2.0 ** 24, hysteresis: int = 1):
        self.dynamic = loss_scale == "dynamic"
        self._init_scale = (float(init_scale) if self.dynamic
                            else float(loss_scale))
        self.scale_factor = float(scale_factor)
        self.scale_window = int(scale_window)
        self.min_loss_scale = min_loss_scale
        self.max_loss_scale = float(max_loss_scale)
        self.hysteresis = int(hysteresis)

    # -- state ------------------------------------------------------------
    def _state(self, device, loss_scale: float, unskipped: int,
               hysteresis: int, consecutive_skips: int) -> LossScaleState:
        def t(v, dtype):
            return torch.tensor(v, dtype=dtype, device=device)
        return LossScaleState(
            loss_scale=t(loss_scale, torch.float32),
            unskipped=t(unskipped, torch.int32),
            hysteresis=t(hysteresis, torch.int32),
            found_inf=t(False, torch.bool),
            consecutive_skips=t(consecutive_skips, torch.int32))

    def init_state(self, device=None) -> LossScaleState:
        """The first state, on the card unless ``device`` names another."""
        return self._state(resolve_device(device), self._init_scale, 0,
                           self.hysteresis, 0)

    # -- step-time ops (no host read) -------------------------------------
    def scale_loss(self, state: LossScaleState,
                   loss: torch.Tensor) -> torch.Tensor:
        """``loss * scale`` (``apex/amp/handle.py:107-113``)."""
        return loss * state.loss_scale.to(loss.dtype)

    def unscale(self, state: LossScaleState, grads: Tree, out_dtype=None,
                numerics=None):
        """Gradients times 1 / scale, recording an overflow
        (``multi_tensor_scale``). Returns ``(grads, state)``; with
        ``numerics=(monitor, nstate)`` the per-leaf non-finite flags of
        the same sweep go to ``monitor.observe`` and the result is
        ``(grads, state, nstate)``."""
        inv = 1.0 / state.loss_scale
        if numerics is None:
            out, found = multi_tensor_scale(grads, inv, out_dtype=out_dtype)
            return out, state._replace(found_inf=state.found_inf | found)
        monitor, nstate = numerics
        out, found, leaf_flags = multi_tensor_scale(
            grads, inv, out_dtype=out_dtype, per_tensor=True)
        nstate = monitor.observe(nstate, leaf_nonfinite=leaf_flags)
        return out, state._replace(found_inf=state.found_inf | found), nstate

    def unscale_flat(self, state: LossScaleState, flat_grads,
                     out_dtype=None, numerics=None, *,
                     chunk_size: int = DEFAULT_CHUNK):
        """Unscale a packed flat gradient buffer in one
        ``multi_tensor_scale_flat(per_row_flags=True)`` sweep, recording
        an overflow; ``out_dtype=torch.float32`` makes this sweep the
        gradients' one upcast. ``flat_grads`` is the buffer or the
        ``BucketBuffers`` of the bucketed all-reduce (concatenated
        first); ``chunk_size`` goes to the sweep, which validates it, and
        changes nothing. Returns ``(flat, state)``; with
        ``numerics=(monitor, nstate)`` (the monitor built from the
        buffer's ``PackSpec``) the sweep's per-row flags become per-leaf
        provenance and the result is ``(flat, state, nstate)``."""
        if isinstance(flat_grads, BucketBuffers):
            flat_grads = (flat_grads.buffers[0]
                          if len(flat_grads.buffers) == 1
                          else torch.cat(flat_grads.buffers))
        out, found, row_bad = multi_tensor_scale_flat(
            flat_grads, 1.0 / state.loss_scale, out_dtype,
            per_row_flags=True, chunk_size=chunk_size)
        new_state = state._replace(found_inf=state.found_inf | found)
        if numerics is None:
            return out, new_state
        monitor, nstate = numerics
        return out, new_state, monitor.observe(nstate,
                                               row_nonfinite=row_bad)

    def found_inf_flat(self, state: LossScaleState,
                       flat_grads) -> LossScaleState:
        """Record an overflow from flat SCALED gradients without unscaling
        them: one fused non-finite reduction per buffer (``flat_grads``
        a buffer, or an object with ``buffers``: the ``BucketBuffers``
        of the bucketed all-reduce, read bucket by bucket). The verdict is
        :meth:`unscale_flat`'s while the scale is at least 1; below 1 a
        finite ``g`` can overflow under ``1 / scale``, so ``|g| > fp32_max
        * scale`` also counts (never true at or above scale 1)."""
        bufs = (flat_grads.buffers if hasattr(flat_grads, "buffers")
                else (flat_grads,))
        lim = _FP32_MAX * state.loss_scale.to(torch.float32)
        found = state.found_inf
        for b in bufs:
            bad = ~torch.isfinite(b) | (b.to(torch.float32).abs() > lim)
            found = found | bad.any()
        return state._replace(found_inf=found)

    def unscale_with_stashed(self, state: LossScaleState,
                             new_scaled_grads: Tree, stashed_grads: Tree
                             ) -> Tuple[Tree, LossScaleState]:
        """``new / scale + stashed`` (``multi_tensor_axpby``): gradient
        accumulation across backwards (``apex/amp/scaler.py:152-196``)."""
        out, found = multi_tensor_axpby(1.0 / state.loss_scale, 1.0,
                                        new_scaled_grads, stashed_grads)
        return out, state._replace(found_inf=state.found_inf | found)

    def update_scale(self, state: LossScaleState, metrics=None,
                     numerics=None):
        """The end-of-step scale adjustment (``apex/amp/scaler.py:197-216``):
        consumes ``found_inf`` and clears it. Static mode only clears the
        flag and counts the skips.

        With ``metrics=`` (a telemetry ``MetricsState``) the update is
        folded into its cumulative skip and growth counters; with
        ``numerics=`` (a ``NumericsState``) the consumed flag, the old and
        new scales and the skip run feed the anomaly rules. Device
        arithmetic either way. Returns ``new_state`` alone, or
        ``(new_state, metrics)``, ``(new_state, numerics)``, ``(new_state,
        metrics, numerics)`` matching what was passed."""
        new_state = self._update_scale(state)
        out = (new_state,)
        if metrics is not None:
            from ..telemetry.metrics import observe_scale_update

            out += (observe_scale_update(metrics, state.found_inf,
                                         state.loss_scale,
                                         new_state.loss_scale),)
        if numerics is not None:
            from ..telemetry.numerics import (
                observe_scale_update as numerics_scale_update,
            )

            out += (numerics_scale_update(
                numerics, state.found_inf, state.loss_scale,
                new_state.loss_scale,
                consecutive_skips=new_state.consecutive_skips),)
        return out if len(out) > 1 else new_state

    def _update_scale(self, state: LossScaleState) -> LossScaleState:
        found = state.found_inf
        # the run of skipped steps: a clean step resets it
        consec = torch.where(found, state.consecutive_skips + 1,
                             torch.zeros_like(state.consecutive_skips))
        cleared = torch.zeros_like(found)
        if not self.dynamic:
            return state._replace(found_inf=cleared,
                                  consecutive_skips=consec)
        scale, unskipped, hyst = update_scale_hysteresis(
            state.loss_scale, state.unskipped, state.hysteresis, found,
            growth_factor=self.scale_factor,
            backoff_factor=1.0 / self.scale_factor,
            growth_interval=self.scale_window, hysteresis=self.hysteresis)
        scale = torch.clamp_max(scale, self.max_loss_scale)
        if self.min_loss_scale is not None:
            scale = torch.clamp_min(scale, float(self.min_loss_scale))
        return LossScaleState(loss_scale=scale, unskipped=unskipped,
                              hysteresis=hyst, found_inf=cleared,
                              consecutive_skips=consec)

    def loss_scale(self, state: LossScaleState) -> torch.Tensor:
        return state.loss_scale

    # -- checkpointing (``apex/amp/frontend.py:365-404`` parity) -----------
    def state_dict(self, state: LossScaleState) -> dict:
        return {
            "loss_scale": float(state.loss_scale),
            "unskipped": int(state.unskipped),
            "hysteresis": int(state.hysteresis),
            "consecutive_skips": int(state.consecutive_skips),
            "dynamic": self.dynamic,
        }

    def load_state_dict(self, sd: dict, device=None) -> LossScaleState:
        """A state from :meth:`state_dict`'s dict, on the card unless
        ``device`` names another."""
        return self._state(resolve_device(device), float(sd["loss_scale"]),
                           int(sd.get("unskipped", 0)),
                           int(sd.get("hysteresis", self.hysteresis)),
                           int(sd.get("consecutive_skips", 0)))
