"""Carry a JAX-package parameter tree into the port.

``params_from_jax`` takes the ``init_gpt_params`` tree of
``apex_tpu/transformer/testing/standalone_transformer_lm.py`` after the
caller has turned every leaf into a numpy array (``np.asarray``; this
module imports no JAX) and returns the port's nested dict of tensors.

Layouts are kept as they are: weights are ``[out, in]``, which is
already ``F.linear``'s convention; ``qkv_w`` is ``[L, 3h, h]`` whose
output is laid out per head as ``[n, 3d]`` and then split into thirds
(q, k, v) — not ``[3, n, d]``. Layer weights stay stacked ``[L, ...]``.

``packed_state_from_jax`` carries a JAX ``PackedState`` (its leaves
turned into numpy arrays by the caller) into the port's
``optimizers.PackedState`` — Adam's and LAMB's with both moments, SGD's
with the momentum buffer alone, NovoGrad's with its per-leaf second
moment — so that both optimizers can start from the same non-zero
state. ``novograd_state_from_jax`` does the same for the pytree
``FusedNovoGradState`` and ``loss_scale_state_from_jax`` for the loss
scaler's ``LossScaleState``: a test can start both packages mid-run.
"""
from __future__ import annotations

from typing import Any, Mapping, Optional

import numpy as np
import torch


def _leaf(a: Any, device, dtype: Optional[torch.dtype]) -> torch.Tensor:
    arr = np.asarray(a)
    if arr.dtype.kind == "V" or arr.dtype.name == "bfloat16":
        # numpy has no native bf16: go through fp32, exactly
        arr = arr.astype(np.float32)
    t = torch.from_numpy(np.array(arr))  # a writable, contiguous copy
    if dtype is not None and t.is_floating_point():
        t = t.to(dtype)
    return t.to(device)


def params_from_jax(tree: Any, device="cpu",
                    dtype: Optional[torch.dtype] = None) -> Any:
    """Nested dict of numpy arrays -> the same nested dict of tensors on
    ``device`` (floating leaves cast to ``dtype`` when given)."""
    if isinstance(tree, dict):
        return {k: params_from_jax(v, device, dtype) for k, v in tree.items()}
    return _leaf(tree, device, dtype)


def packed_state_from_jax(state: Mapping[str, Any], spec, device="cpu"):
    """A JAX ``PackedState`` as the port's ``PackedState`` over ``spec``
    (the port's ``PackSpec`` of the same parameter tree).

    ``state`` holds numpy arrays under ``step``, ``exp_avg``,
    ``exp_avg_sq`` and ``master_params`` (either of the last two None or
    absent when the JAX state has none: SGD keeps no ``exp_avg_sq``;
    NovoGrad's is ``(n_leaves,)``) and the JAX spec's layout under
    ``offsets``, ``shapes`` and ``total``. The layouts must be equal — the same leaf order and
    offsets — or the flat buffers would not line up, and this raises."""
    from .optimizers._packed import PackedState

    jax_layout = (tuple(int(o) for o in state["offsets"]),
                  tuple(tuple(int(d) for d in s) for s in state["shapes"]),
                  int(state["total"]))
    port_layout = (spec.offsets, spec.shapes, spec.total)
    if jax_layout != port_layout:
        raise ValueError(
            "the JAX PackedState's layout differs from the port's PackSpec "
            f"(offsets/shapes/total {jax_layout[2]} vs {port_layout[2]})")

    def flat(name):
        a = state.get(name)
        return None if a is None else _leaf(a, device, torch.float32)

    return PackedState(
        step=torch.tensor(int(np.asarray(state["step"])), dtype=torch.int32,
                          device=device),
        exp_avg=flat("exp_avg"), exp_avg_sq=flat("exp_avg_sq"),
        master_params=flat("master_params"), spec=spec)


def novograd_state_from_jax(state: Mapping[str, Any], device="cpu"):
    """A JAX pytree ``FusedNovoGradState`` (``step``; ``exp_avg`` and
    ``exp_avg_sq`` nested dicts of numpy arrays, the latter 0-dim) as the
    port's ``FusedNovoGradState``."""
    from .optimizers.fused_novograd import FusedNovoGradState

    return FusedNovoGradState(
        step=torch.tensor(int(np.asarray(state["step"])), dtype=torch.int32,
                          device=device),
        exp_avg=params_from_jax(state["exp_avg"], device, torch.float32),
        exp_avg_sq=params_from_jax(state["exp_avg_sq"], device,
                                   torch.float32))


def loss_scale_state_from_jax(state: Mapping[str, Any], device="cpu"):
    """A JAX ``LossScaleState`` (its fields as numpy scalars under their
    names) as the port's ``LossScaleState`` on ``device``."""
    from .amp.scaler import LossScaleState

    def t(name, dtype):
        return torch.tensor(np.asarray(state[name]).item(), dtype=dtype,
                            device=device)
    return LossScaleState(
        loss_scale=t("loss_scale", torch.float32),
        unskipped=t("unskipped", torch.int32),
        hysteresis=t("hysteresis", torch.int32),
        found_inf=t("found_inf", torch.bool),
        consecutive_skips=t("consecutive_skips", torch.int32))
