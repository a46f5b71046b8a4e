"""amp.initialize and the O0-O3 opt-level presets (counterpart of
``apex_tpu/amp/frontend.py``).

Reference: ``apex/amp/frontend.py``: ``Properties`` (``:9``), the four
``O0``-``O3`` preset objects (``:104-193``), ``initialize``
(``:197-362``) and scaler checkpointing (``:365-404``).

As in the JAX package the frontend is functional: torch amp mutates the
model and optimizer in place and hides the scaler's state in a global;
here ``initialize`` returns ``(params, optimizers, amp_state)``:

- ``params``: the parameter tree cast per the opt level (bf16/fp16 for
  O2/O3, with batchnorm-like leaves kept fp32 when
  ``keep_batchnorm_fp32``: the ``convert_network`` behaviour of
  ``apex/amp/_initialize.py:179-181``),
- ``optimizers``: the same objects, flipped to ``master_weights`` mode
  when the preset demands it (the fused optimizers' fp32 master path),
- ``amp_state``: the opt properties, one ``LossScaler`` and state per loss
  (``num_losses``, reference ``_initialize.py:229-233``), and the O1
  autocast context.

Typical use::

    params, opt, amp_state = amp.initialize(params, opt, opt_level="O2")
    fn = amp.scaled_value_and_grad(loss_fn, amp_state.scaler(0))
    loss, grads, sstate = fn(amp_state.scaler_state(0), params, batch)
    params, opt_state = opt.step(grads, opt_state, params,
                                 found_inf=sstate.found_inf)
    amp_state = amp_state.with_scaler_state(
        0, amp_state.scaler(0).update_scale(sstate))
"""
from __future__ import annotations

import dataclasses
from typing import Any, List, Optional, Tuple

import torch

from .._device import resolve_device
from .._tree import leaf_paths, tree_flatten, tree_unflatten
from . import amp as _amp_mod
from .scaler import LossScaler, LossScaleState

Tree = Any

_BN_MARKERS = ("batchnorm", "batch_norm", "bn", "norm_stats")


@dataclasses.dataclass
class Properties:
    """Mutable opt-level property bag (``apex/amp/frontend.py:9-101``)."""

    enabled: bool = True
    opt_level: Optional[str] = None
    cast_model_type: Optional[Any] = None  # torch dtype or None
    patch_functions: bool = False  # O1 autocast ("patch_torch_functions")
    keep_batchnorm_fp32: Optional[bool] = None
    master_weights: Optional[bool] = None
    loss_scale: Any = 1.0  # float or "dynamic"


def _o0(half_dtype):
    return Properties(opt_level="O0", cast_model_type=torch.float32,
                      patch_functions=False, keep_batchnorm_fp32=False,
                      master_weights=False, loss_scale=1.0)


def _o1(half_dtype):
    return Properties(opt_level="O1", cast_model_type=None,
                      patch_functions=True, keep_batchnorm_fp32=None,
                      master_weights=None, loss_scale="dynamic")


def _o2(half_dtype):
    return Properties(opt_level="O2", cast_model_type=half_dtype,
                      patch_functions=False, keep_batchnorm_fp32=True,
                      master_weights=True, loss_scale="dynamic")


def _o3(half_dtype):
    return Properties(opt_level="O3", cast_model_type=half_dtype,
                      patch_functions=False, keep_batchnorm_fp32=False,
                      master_weights=False, loss_scale=1.0)


opt_levels = {"O0": _o0, "O1": _o1, "O2": _o2, "O3": _o3}


def _is_bn_path(path: str) -> bool:
    s = path.lower()
    return any(m in s for m in _BN_MARKERS)


def cast_model(params: Tree, dtype: torch.dtype,
               keep_batchnorm_fp32: bool) -> Tree:
    """Cast float params to ``dtype``; optionally keep batchnorm-ish
    leaves fp32.

    The tree is walked as ``jax.tree_util`` walks it (dicts, lists,
    tuples, named tuples; ``None`` is an empty subtree). The batchnorm
    test is the JAX package's key-path heuristic over the leaf's path
    string (``['Bottleneck_0']['BatchNorm_0']['scale']``), standing in
    for the reference's module-class walk (``apex/fp16_utils/fp16util.py``
    ``convert_network``). A leaf already in its target dtype comes back
    as the same object (no copy)."""
    leaves, treedef = tree_flatten(params)
    out = []
    for path, x in zip(leaf_paths(treedef), leaves):
        if isinstance(x, torch.Tensor) and x.is_floating_point():
            target = (torch.float32
                      if keep_batchnorm_fp32 and _is_bn_path(path)
                      else dtype)
            x = x if x.dtype == target else x.to(target)
        out.append(x)
    return tree_unflatten(treedef, out)


def cast_params_for_inference(params: Tree, dtype: torch.dtype,
                              keep_batchnorm_fp32: bool = False) -> Tree:
    """One-shot inference cast: float leaves to ``dtype``, no master
    copies, no scaler.

    The serving-side entry into the O2 cast machinery: the SAME walk as
    :func:`cast_model` (float-leaf detection, the batchnorm key-path
    heuristic), named as what it is: a *deployment* cast with no
    optimizer to hold fp32 masters, so the cast params ARE the weights.
    Leaves already in the target dtype come back unchanged (the same
    object, no copy), so re-casting an already-cast tree (an engine
    restart, a second engine over the same weights) costs nothing."""
    return cast_model(params, dtype, keep_batchnorm_fp32)


def _tree_device(tree: Tree) -> torch.device:
    """The device of the first tensor leaf; the card when there is
    none."""
    for leaf in tree_flatten(tree)[0]:
        if isinstance(leaf, torch.Tensor):
            return leaf.device
    return resolve_device(None)


class AmpState:
    """Explicit replacement for the reference's ``_amp_state`` global."""

    def __init__(self, properties: Properties, scalers: List[LossScaler],
                 states: List[LossScaleState], half_dtype):
        self._properties = properties
        self._scalers = scalers
        self._states = list(states)
        self.half_dtype = half_dtype

    @property
    def opt_properties(self) -> Properties:
        return self._properties

    def scaler(self, loss_id: int = 0) -> LossScaler:
        return self._scalers[loss_id]

    def scaler_state(self, loss_id: int = 0) -> LossScaleState:
        return self._states[loss_id]

    def with_scaler_state(self, loss_id: int,
                          state: LossScaleState) -> "AmpState":
        new = AmpState(self._properties, self._scalers, list(self._states),
                       self.half_dtype)
        new._states[loss_id] = state
        return new

    def autocast(self):
        """The O1 context: the per-op cast lists patched while it is
        open (a no-op context at the other levels)."""
        return _amp_mod.autocast(enabled=self._properties.patch_functions,
                                 dtype=self.half_dtype)

    # ``apex/amp/frontend.py:365-404`` parity
    def state_dict(self) -> dict:
        return {f"loss_scaler{i}": s.state_dict(st)
                for i, (s, st) in enumerate(zip(self._scalers, self._states))}

    def load_state_dict(self, sd: dict) -> "AmpState":
        """A new state with each scaler's state loaded from ``sd``, on the
        device the current states lie on."""
        new_states = [
            s.load_state_dict(sd[f"loss_scaler{i}"],
                              device=self._states[i].loss_scale.device)
            for i, s in enumerate(self._scalers)]
        return AmpState(self._properties, self._scalers, new_states,
                        self.half_dtype)


def initialize(
    models: Tree,
    optimizers=None,
    opt_level: str = "O1",
    cast_model_type=None,
    patch_functions: Optional[bool] = None,
    keep_batchnorm_fp32: Optional[bool] = None,
    master_weights: Optional[bool] = None,
    loss_scale=None,
    num_losses: int = 1,
    half_dtype=torch.bfloat16,
    verbosity: int = 1,
    min_loss_scale: Optional[float] = None,
    max_loss_scale: float = 2.0 ** 24,
) -> Tuple[Tree, Any, AmpState]:
    """``amp.initialize`` (``apex/amp/frontend.py:197-362``), functional.

    ``models`` is a parameter tree (or a list of them); ``optimizers`` a
    fused optimizer (or a list). Explicit kwargs override the preset,
    exactly like the reference's Properties mutation. The scalers' states
    lie on the device of the params' first tensor (the card when the tree
    holds none)."""
    if opt_level not in opt_levels:
        raise RuntimeError(f"Unexpected optimization level {opt_level}")
    props = opt_levels[opt_level](half_dtype)
    if cast_model_type is not None:
        props.cast_model_type = cast_model_type
    if patch_functions is not None:
        props.patch_functions = patch_functions
    if keep_batchnorm_fp32 is not None:
        props.keep_batchnorm_fp32 = keep_batchnorm_fp32
    if master_weights is not None:
        props.master_weights = master_weights
    if loss_scale is not None:
        props.loss_scale = loss_scale

    models_list = models if isinstance(models, list) else [models]
    if props.cast_model_type is not None:
        models_list = [
            cast_model(m, props.cast_model_type,
                       bool(props.keep_batchnorm_fp32))
            for m in models_list]

    opts = optimizers if isinstance(optimizers, (list, tuple)) else (
        [optimizers] if optimizers is not None else [])
    if props.master_weights:
        for o in opts:
            if hasattr(o, "master_weights"):
                o.master_weights = True

    device = _tree_device(models_list)
    scalers = [LossScaler(loss_scale=props.loss_scale,
                          min_loss_scale=min_loss_scale,
                          max_loss_scale=max_loss_scale)
               for _ in range(num_losses)]
    states = [s.init_state(device) for s in scalers]
    amp_state = AmpState(props, scalers, states, half_dtype)

    out_models = models_list if isinstance(models, list) else models_list[0]
    out_opts = (optimizers
                if isinstance(optimizers, (list, tuple)) or optimizers is None
                else opts[0])
    return out_models, out_opts, amp_state


def state_dict(amp_state: AmpState) -> dict:
    return amp_state.state_dict()


def load_state_dict(amp_state: AmpState, sd: dict) -> AmpState:
    return amp_state.load_state_dict(sd)
