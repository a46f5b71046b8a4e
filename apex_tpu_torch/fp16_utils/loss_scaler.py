"""Legacy loss scalers (counterpart of
``apex_tpu/fp16_utils/loss_scaler.py``; reference
``apex/fp16_utils/loss_scaler.py``).

``LossScaler`` (static) and ``DynamicLossScaler`` with the classic
``has_overflow`` / ``update_scale`` / ``backward`` interface. The modern
engine is ``apex_tpu_torch.amp.LossScaler`` (a state of device scalars,
no host read); these classes keep the legacy host-driven interface: their
state lives on the Python object and ``has_overflow`` reads the device,
exactly how the originals were used.
"""
from __future__ import annotations

from typing import Any

import torch

from .._tree import leaf_paths, tree_flatten, tree_map

Tree = Any


def _nonfinite_leaf_flags(tree: Tree):
    """Per-leaf non-finite flags and the leaves' path names, from one
    host read for all of them: the legacy interface reads the device
    anyway, so reading the per-leaf flags in place of their any costs
    nothing more and names where an overflow came from."""
    leaves, treedef = tree_flatten(tree)
    pairs = [(p, l) for p, l in zip(leaf_paths(treedef), leaves)
             if isinstance(l, torch.Tensor)]
    if not pairs:
        return [], []
    flags = torch.stack([~torch.isfinite(l.float()).all()
                         for _, l in pairs]).cpu()
    return [p for p, _ in pairs], [bool(f) for f in flags]


def nonfinite_leaves(tree: Tree) -> list:
    """Names (tree paths) of the leaves holding an inf or a NaN. Reads
    the device: legacy-interface territory (inside a step use
    ``telemetry.numerics``)."""
    names, flags = _nonfinite_leaf_flags(tree)
    return [n for n, f in zip(names, flags) if f]


def _has_inf_or_nan(tree: Tree) -> bool:
    return any(_nonfinite_leaf_flags(tree)[1])


class LossScaler:
    """Static scaler (reference ``loss_scaler.py:8-58``)."""

    def __init__(self, scale: float = 1.0):
        self.cur_scale = scale

    def has_overflow(self, params: Tree) -> bool:
        return False

    @staticmethod
    def _has_inf_or_nan(x) -> bool:
        return False

    def update_scale(self, overflow: bool) -> None:
        pass

    @property
    def loss_scale(self) -> float:
        return self.cur_scale

    def scale_gradient(self, grads: Tree) -> Tree:
        return tree_map(lambda g: g * self.cur_scale, grads)

    def unscale_gradient(self, grads: Tree) -> Tree:
        inv = 1.0 / self.cur_scale
        return tree_map(lambda g: g * inv, grads)

    def backward(self, loss_and_grad_fn, *args):
        """Grads of ``scale * loss`` (the legacy ``scaled_loss.backward()``
        idiom)."""
        loss, grads = loss_and_grad_fn(*args)
        return loss, self.scale_gradient(grads)


class DynamicLossScaler(LossScaler):
    """Dynamic scaler (reference ``loss_scaler.py:60-164``): x2 every
    ``scale_window`` clean iterations, /2 on an overflow (never below 1)."""

    def __init__(self, init_scale: float = 2 ** 32,
                 scale_factor: float = 2.0, scale_window: int = 1000,
                 sink=None):
        super().__init__(init_scale)
        self.cur_iter = 0
        self.last_overflow_iter = -1
        self.scale_factor = scale_factor
        self.scale_window = scale_window
        # optional telemetry sink (.record(dict)): overflow provenance
        # events in the schema of telemetry.numerics' anomalies
        self.sink = sink
        self.last_overflow_leaves: list = []

    def has_overflow(self, grads: Tree) -> bool:
        names, flags = _nonfinite_leaf_flags(grads)
        self.last_overflow_leaves = [n for n, f in zip(names, flags) if f]
        return any(flags)

    @staticmethod
    def _has_inf_or_nan(x) -> bool:
        return _has_inf_or_nan(x)

    def update_scale(self, overflow: bool) -> None:
        if overflow:
            if self.sink is not None:
                self.sink.record({
                    "event": "anomaly", "kind": "nonfinite_grads",
                    "step": self.cur_iter,
                    "loss_scale": float(self.cur_scale),
                    "leaves": [{"name": n}
                               for n in self.last_overflow_leaves],
                })
            self.cur_scale = max(self.cur_scale / self.scale_factor, 1.0)
            self.last_overflow_iter = self.cur_iter
        elif (self.cur_iter - self.last_overflow_iter) % self.scale_window == 0:
            self.cur_scale *= self.scale_factor
        self.cur_iter += 1
