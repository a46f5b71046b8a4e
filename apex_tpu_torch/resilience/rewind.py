"""Last-good rewind: a host-side ring of good states + anomaly triggers
(counterpart of ``apex_tpu/resilience/rewind.py``).

The amp scaler's only failure response is skip-and-halve; hysteresis
absorbs a burst of overflows, but a *poisoned data window* (corrupt
shard, a batch of garbage tokens) outlives it: the scale collapses to
floor, every step skips, and the run is dead while still "training".
The numerics monitor's anomaly engine detects this (``scaler_stall`` — the
consecutive-skip budget — and ``scale_collapse``); this module is the
response: rewind to the last known-good state and jump the data stream
past the poison.

Mechanics:

- :meth:`RewindController.offer` — called at a cadence from the loop:
  when the step is healthy, push a host snapshot (no alias of a live
  tensor, so in-place optimizer updates cannot reach it) into a
  ring of the last ``keep`` good states (for a packed optimizer the
  whole snapshot is a few contiguous flat-buffer memcpys); when the
  scaler's consecutive-skip counter crosses ``skip_budget``, mark a
  rewind pending.
- event trigger — the controller IS a recorder sink: put it in the
  ``MultiRecorder`` fan-out behind ``numerics.drain`` and an async
  ``scaler_stall`` / ``scale_collapse`` anomaly event marks the rewind
  pending with no extra host reads at all.
- :meth:`RewindController.rewind` — hand back the newest good snapshot
  (on ``device=`` when given), advance the data iterator past the poisoned window
  (``skip_batches``, default: everything consumed since the snapshot),
  emit one structured ``rewind`` event through the recorder, and hand
  the restored :class:`TrainState` back to the loop.

``max_rewinds`` bounds the pathology where the poison is not in the
data: after that many rewinds the controller raises instead of looping
forever over the same window.
"""
from __future__ import annotations

from typing import Optional

from .._device import resolve_device
from ..telemetry.recorder import stamp_wall
from .state import TrainState, host_snapshot, to_device

#: anomaly kinds (telemetry.numerics drain events) that trigger a rewind
_TRIGGER_KINDS = ("scaler_stall", "scale_collapse")


class RewindExhaustedError(RuntimeError):
    """More rewinds than ``max_rewinds`` — the instability is not a
    transient data problem; stop instead of thrashing."""


class _Snapshot:
    __slots__ = ("step", "state", "data_position")

    def __init__(self, step: int, state, data_position: Optional[int]):
        self.step = step
        self.state = state
        self.data_position = data_position


class RewindController:
    """Ring of last-good states + the decision to go back to one.

    - ``keep``: ring depth (how many good snapshots to hold).
    - ``skip_budget``: consecutive skipped (overflowed) steps tolerated
      before a rewind — aligned with the scaler's
      ``consecutive_skips`` counter and the numerics engine's
      ``max_consecutive_skips`` threshold.
    - ``snapshot_every``: minimum step spacing between ring entries.
      Each accepted snapshot is a BLOCKING card->host copy of the full
      state (~5 GB for the 345M step's bf16 params and packed fp32 Adam
      state), so the cadence is the cost knob: the default of 10
      amortizes it; ``1`` snapshots every healthy offer and is for tests
      and tiny models.
    - ``recorder``: sink for the structured ``rewind`` event.
    - ``max_rewinds``: hard cap before :class:`RewindExhaustedError`.
    """

    def __init__(
        self,
        *,
        keep: int = 2,
        skip_budget: int = 8,
        snapshot_every: int = 10,
        recorder=None,
        max_rewinds: int = 3,
        tag: Optional[str] = None,
    ):
        self.keep = int(keep)
        self.skip_budget = int(skip_budget)
        self.snapshot_every = max(1, int(snapshot_every))
        self.max_rewinds = int(max_rewinds)
        self.tag = tag
        from .retry import as_record

        self._record = as_record(recorder)
        self._ring: list[_Snapshot] = []
        self._pending: Optional[str] = None  # trigger description
        self.rewinds = 0

    # -- recorder interface: anomaly events mark a rewind pending ----------
    def record(self, rec: dict) -> None:
        """Duck-typed sink: fan the numerics drain into this controller
        (e.g. ``MultiRecorder(jsonl, controller)``) and the anomaly
        events trigger the rewind with zero extra host reads."""
        if (rec.get("event") == "anomaly"
                and rec.get("kind") in _TRIGGER_KINDS):
            self._pending = str(rec.get("kind"))

    @property
    def rewind_pending(self) -> bool:
        return self._pending is not None

    def request_rewind(self, reason: str = "manual") -> None:
        self._pending = reason

    # -- loop integration --------------------------------------------------
    def offer(self, state: TrainState, *, healthy=None,
              consecutive_skips=None) -> None:
        """Consider ``state`` for the good-ring; arm the trigger.

        Pass either ``healthy`` (a host bool the loop already knows) or
        ``consecutive_skips`` — the scaler's counter, read here as ONE
        scalar card->host read at the offer cadence (the documented
        sync; offer every N steps to amortize). A healthy state is
        ring-pushed (subject to ``snapshot_every`` spacing); a counter
        at/over ``skip_budget`` marks a rewind pending.
        """
        if (healthy is None) == (consecutive_skips is None):
            raise ValueError(
                "pass exactly one of healthy= or consecutive_skips=")
        if consecutive_skips is not None:
            skips = int(consecutive_skips)
            healthy = skips == 0
            if skips >= self.skip_budget:
                self._pending = (
                    f"consecutive_skips {skips} >= budget {self.skip_budget}")
        if bool(healthy):
            self._push(state)

    def _push(self, state: TrainState) -> None:
        step = int(state.step)
        if self._ring and step - self._ring[-1].step < self.snapshot_every:
            return
        pos = None
        if isinstance(state.data, dict) and "position" in state.data:
            pos = int(state.data["position"])
        snap = _Snapshot(
            step, host_snapshot(state._replace(data=None)), pos)
        self._ring.append(snap)
        if len(self._ring) > self.keep:
            self._ring.pop(0)

    def rewind(
        self,
        *,
        data_iter=None,
        skip_batches: Optional[int] = None,
        current_step: Optional[int] = None,
        device=None,
    ) -> TrainState:
        """Restore the newest good snapshot and jump the data stream.

        ``data_iter`` (a :class:`~apex_tpu_torch.resilience.state.
        ResumableIterator`) is left where it currently stands — already
        past the poisoned batches — plus ``skip_batches`` extra (default
        0: the consumed-but-skipped window IS the advance; pass more to
        margin around the poison). Emits one ``rewind`` event and
        returns the restored :class:`TrainState`: a copy of the snapshot
        on ``device``, the card unless ``device='cpu'`` is given (the
        ``rng``, a generator's state, stays on the host). The ring keeps
        its own, so the packed optimizers' in-place updates of the
        restored state cannot reach it."""
        if not self._ring:
            raise RuntimeError("no good snapshot to rewind to")
        device = resolve_device(device)
        self.rewinds += 1
        if self.rewinds > self.max_rewinds:
            raise RewindExhaustedError(
                f"{self.rewinds} rewinds > max_rewinds={self.max_rewinds}; "
                "instability is not transient")
        trigger, self._pending = self._pending, None
        snap = self._ring[-1]
        new_data = None
        if data_iter is not None:
            if skip_batches:
                data_iter.skip(int(skip_batches))
            new_data = data_iter.state()
        # the generator state stays a host tensor (``set_state`` takes
        # no other); everything else goes to ``device``
        restored = to_device(snap.state._replace(data=new_data, rng=None),
                             device)
        restored = restored._replace(rng=to_device(snap.state.rng, "cpu"))
        if self._record is not None:
            rec = stamp_wall(
                  {"event": "rewind", "to_step": snap.step,
                   "trigger": trigger or "manual",
                   "rewinds": self.rewinds,
                   "snapshot_data_position": snap.data_position})
            if current_step is not None:
                rec["step"] = int(current_step)
            if new_data is not None:
                rec["data_position"] = new_data.get("position")
            if self.tag is not None:
                rec["tag"] = self.tag
            self._record(rec)
        return restored
