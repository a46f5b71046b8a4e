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
scaler's ``LossScaleState``, ``numerics_state_from_jax`` and
``metrics_state_from_jax`` for the telemetry states: a test can start
both packages mid-run.

``resnet_params_from_jax`` carries the imagenet example's flax
``params`` and ``batch_stats`` into the port's ResNet
(``examples/imagenet/resnet.py``): the key paths stay flax's, HWIO conv
kernels become ``[out, in, kh, kw]`` (channels-last in memory) and
``[in, out]`` dense kernels ``[out, in]``; ``resnet_params_to_jax`` is
its inverse (numpy, flax layouts). ``fused_sgd_state_from_jax`` carries
a pytree ``FusedSGDState`` (momentum buffers and masters through a
caller-given tree map, ``resnet_params_from_jax``'s for the ResNet).

``fp8_state_from_jax`` carries the delayed-scaling state of
``apex_tpu/fused_dense/fp8.py`` (an ``Fp8DenseState``, or the GPT's dict
of stacked ones) into ``fused_dense.fp8``'s, and
``fused_adam_swa_state_from_jax`` openfold's ``FusedAdamSWAState``. The
``FusedDense``, ``FusedDenseGeluDense`` and ``MLP`` modules keep flax's
parameter names: their flax params load through :func:`params_from_jax`
and ``load_state_dict``.

The single-device contribs: ``conv_kernel_from_jax`` turns an HWIO conv
kernel into torch's ``[out, in, kh, kw]`` (channels-last in memory), the
layout ``contrib.conv_bias_relu`` takes; ``bottleneck_state_from_jax``
turns the flax ``Bottleneck``'s ``params`` and ``batch_stats`` into a
state dict of ``contrib.bottleneck.Bottleneck``; ``fused_adam_state_from_jax``
carries a pytree ``FusedAdamState`` (the legacy contrib Adam's too). The
groupbn ``(params, state)`` dicts and the RNN models' parameter trees
(dicts and lists) go through :func:`params_from_jax` as they are.

The multi-rank parts: ``spatial_bottleneck_state_from_jax`` does for
the flax ``SpatialBottleneck`` what ``bottleneck_state_from_jax`` does
for ``Bottleneck``; ``distributed_fused_adam_state_from_jax`` cuts a JAX
ZeRO state (Adam's or LAMB's, global ``(padded,)`` buffers) into one
rank's shards; ``tp_serving_params_from_jax`` cuts a full GPT tree for
one rank of a tensor-parallel serving engine.
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
    """Nested dicts and lists of numpy arrays (the RNN models' trees hold
    lists) -> the same nesting of tensors on ``device`` (floating leaves
    cast to ``dtype`` when given)."""
    if isinstance(tree, dict):
        return {k: params_from_jax(v, device, dtype) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        out = [params_from_jax(v, device, dtype) for v in tree]
        return out if isinstance(tree, list) else tuple(out)
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


def _tensor(a: Any, dtype: torch.dtype, device) -> torch.Tensor:
    return torch.from_numpy(np.array(np.asarray(a))).to(device, dtype)


def numerics_state_from_jax(state: Mapping[str, Any], device="cpu"):
    """A JAX ``NumericsState`` (its fields as numpy arrays under their
    names) as the port's ``NumericsState`` on ``device``: the per-leaf
    statistics, the EWMA, a latched ``first_bad_step``; ``step`` becomes
    the host integer the port keeps."""
    from .telemetry.numerics import NumericsState

    kinds = {"ewma_steps": torch.int32, "first_bad_step": torch.int32,
             "consecutive_skips": torch.int32,
             "prev_consecutive_skips": torch.int32,
             "overflow": torch.bool, "spike": torch.bool}
    fields = {name: _tensor(state[name], kinds.get(name, torch.float32),
                            device)
              for name in NumericsState._fields if name != "step"}
    return NumericsState(step=int(np.asarray(state["step"])), **fields)


def metrics_state_from_jax(state: Mapping[str, Any], device="cpu"):
    """A JAX ``MetricsState`` (fields as numpy scalars) as the port's
    ``MetricsState``: the two step counters as host integers, the rest
    0-dim tensors on ``device``."""
    from .telemetry.metrics import MetricsState

    ints = ("overflow_skips", "scale_growths")
    fields = {name: _tensor(state[name], torch.int32 if name in ints
                            else torch.float32, device)
              for name in MetricsState._fields
              if name not in ("total_steps", "window_steps", "last_drain_t")}
    return MetricsState(total_steps=int(np.asarray(state["total_steps"])),
                        window_steps=int(np.asarray(state["window_steps"])),
                        **fields)


def _resnet_leaf(key: str, t: torch.Tensor, to_port: bool) -> torch.Tensor:
    if key != "kernel":
        return t
    if t.dim() == 4:  # HWIO <-> OIHW
        if to_port:
            return t.permute(3, 2, 0, 1).contiguous(
                memory_format=torch.channels_last)
        return t.permute(2, 3, 1, 0)
    if t.dim() == 2:  # [in, out] <-> [out, in]
        return t.t().contiguous() if to_port else t.t()
    return t


def _resnet_map(tree: Any, fn, key: str = "") -> Any:
    if isinstance(tree, dict):
        return {k: _resnet_map(v, fn, k) for k, v in tree.items()}
    return fn(key, tree)


def resnet_params_from_jax(params: Any, batch_stats: Any = None,
                           device="cpu", dtype: Optional[torch.dtype] = None):
    """The imagenet example's flax ``params`` (and ``batch_stats``), numpy
    leaves, as the port's ResNet trees on ``device``: ``(params,
    batch_stats)`` (``batch_stats`` None when not given). Float leaves are
    cast to ``dtype`` when given; bf16 leaves arrive exactly."""
    def leaf(key, a):
        return _resnet_leaf(key, _leaf(a, "cpu", dtype), True).to(device)

    p = _resnet_map(params, leaf)
    s = None if batch_stats is None else params_from_jax(batch_stats,
                                                         device)
    return p, s


def resnet_params_to_jax(tree: Any) -> Any:
    """A port ResNet tree (params, or a tree of the same structure such as
    momentum buffers) as numpy arrays in flax's layouts; bf16 leaves come
    back as float32 arrays (numpy has no bf16)."""
    def leaf(key, t):
        t = _resnet_leaf(key, t.detach().cpu(), False)
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.contiguous().numpy()
    return _resnet_map(tree, leaf)


def fused_sgd_state_from_jax(state: Mapping[str, Any], device="cpu",
                             tree_from_jax=None):
    """A JAX pytree ``FusedSGDState`` (``step``, ``momentum_buffer`` and
    ``master_params``, numpy leaves, the last None without masters) as the
    port's ``FusedSGDState``; ``tree_from_jax(tree, device)`` maps the
    trees (default :func:`params_from_jax` in fp32)."""
    from .optimizers.fused_sgd import FusedSGDState

    if tree_from_jax is None:
        def tree_from_jax(tree, dev):
            return params_from_jax(tree, dev, torch.float32)
    masters = state.get("master_params")
    return FusedSGDState(
        step=torch.tensor(int(np.asarray(state["step"])), dtype=torch.int32,
                          device=device),
        momentum_buffer=tree_from_jax(state["momentum_buffer"], device),
        master_params=(None if masters is None
                       else tree_from_jax(masters, device)))


def fp8_state_from_jax(state: Any, device="cpu"):
    """A JAX ``Fp8DenseState`` (fields ``x``, ``w``, ``g``, each an
    ``Fp8TensorMeta`` of ``amax_history`` and ``scale``, or ``g`` None;
    leaves numpy or anything ``np.asarray`` takes), or a dict of them
    (the GPT's ``{name: stacked state}``), as the port's, in fp32."""
    from .fused_dense.fp8 import Fp8DenseState, Fp8TensorMeta

    if isinstance(state, Mapping):
        return {k: fp8_state_from_jax(v, device) for k, v in state.items()}

    def meta(m):
        if m is None:
            return None
        return Fp8TensorMeta(
            amax_history=_tensor(m.amax_history, torch.float32, device),
            scale=_tensor(m.scale, torch.float32, device))
    return Fp8DenseState(x=meta(state.x), w=meta(state.w), g=meta(state.g))


def fused_adam_swa_state_from_jax(state: Any, device="cpu"):
    """A JAX ``FusedAdamSWAState`` (``step``, ``n_averaged``, moment
    trees of numpy leaves) as the port's; the moments in fp32."""
    from .contrib.openfold.fused_adam_swa import FusedAdamSWAState

    return FusedAdamSWAState(
        step=_tensor(state.step, torch.int32, device),
        n_averaged=_tensor(state.n_averaged, torch.int32, device),
        exp_avg=params_from_jax(state.exp_avg, device, torch.float32),
        exp_avg_sq=params_from_jax(state.exp_avg_sq, device, torch.float32))


def conv_kernel_from_jax(kernel: Any, device="cpu",
                         dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """An HWIO conv kernel as ``[out, in, kh, kw]``, channels-last in
    memory (the layout cuDNN takes with NHWC activations)."""
    t = _leaf(kernel, "cpu", dtype).permute(3, 2, 0, 1)
    return t.contiguous(memory_format=torch.channels_last).to(device)


def bottleneck_state_from_jax(params: Any, batch_stats: Any = None,
                              device="cpu") -> dict:
    """The flax ``Bottleneck``'s ``params`` (and ``batch_stats``) as a
    state dict of the port's ``contrib.bottleneck.Bottleneck``:
    ``conv1.kernel`` (HWIO -> ``[out, in, kh, kw]``), ``bn1.scale``,
    ``bn1.bias``, ``bn1.mean``, ``bn1.var``, ... Without ``batch_stats``
    only the parameters (load with ``strict=False``)."""
    out = {}
    for name, leaves in params.items():
        for key, a in leaves.items():
            out[f"{name}.{key}"] = (conv_kernel_from_jax(a, device)
                                    if key == "kernel"
                                    else _leaf(a, device, None))
    for name, leaves in (batch_stats or {}).items():
        for key, a in leaves.items():
            out[f"{name}.{key}"] = _leaf(a, device, None)
    return out


def fused_adam_state_from_jax(state: Any, device="cpu"):
    """A JAX pytree ``FusedAdamState`` (``step``, the moment trees and
    ``master_params``, numpy leaves or anything ``np.asarray`` takes) as
    the port's, the moments and masters in fp32."""
    from .optimizers.fused_adam import FusedAdamState

    masters = state.master_params
    return FusedAdamState(
        step=_tensor(state.step, torch.int32, device),
        exp_avg=params_from_jax(state.exp_avg, device, torch.float32),
        exp_avg_sq=params_from_jax(state.exp_avg_sq, device, torch.float32),
        master_params=(None if masters is None
                       else params_from_jax(masters, device, torch.float32)))


def spatial_bottleneck_state_from_jax(params: Any, batch_stats: Any = None,
                                      device="cpu") -> dict:
    """The flax ``SpatialBottleneck``'s ``params`` (and ``batch_stats``)
    as a state dict of the port's ``contrib.bottleneck.SpatialBottleneck``:
    the module-level ``conv2_kernel`` and each ``conv*.kernel`` HWIO ->
    ``[out, in, kh, kw]``, the sync BatchNorms' ``scale`` / ``bias`` and
    ``mean`` / ``var``. Without ``batch_stats`` only the parameters (load
    with ``strict=False``)."""
    top = {k: v for k, v in params.items() if not isinstance(v, Mapping)}
    out = bottleneck_state_from_jax(
        {k: v for k, v in params.items() if isinstance(v, Mapping)},
        batch_stats, device)
    for name, a in top.items():
        out[name] = conv_kernel_from_jax(a, device)
    return out


def distributed_fused_adam_state_from_jax(state: Any, rank: int, world: int,
                                          device="cpu"):
    """A JAX ``DistributedFusedAdamState`` or ``DistributedFusedLAMBState``
    (its global ``(padded,)`` buffers as numpy arrays, or anything
    ``np.asarray`` takes) as the state rank ``rank`` of a group of
    ``world`` holds in the port: its ``(padded / world,)`` slice of each
    buffer, the step replicated."""
    from .contrib.optimizers import (
        DistributedFusedAdamState,
        DistributedFusedLAMBState,
    )

    def cut(a, dtype):
        if a is None:
            return None
        flat = np.asarray(a).reshape(-1)
        if flat.shape[0] % world:
            raise ValueError(f"buffer of {flat.shape[0]} elements does not "
                             f"split into {world} shards")
        n = flat.shape[0] // world
        return _tensor(flat[rank * n:(rank + 1) * n], dtype, device)

    fields = dict(
        step=_tensor(state.step, torch.int32, device),
        exp_avg=cut(state.exp_avg, torch.float32),
        exp_avg_sq=cut(state.exp_avg_sq, torch.float32),
        param_shard=cut(state.param_shard, torch.float32))
    if hasattr(state, "segment_ids"):
        return DistributedFusedLAMBState(
            **fields, segment_ids=cut(state.segment_ids, torch.int32))
    return DistributedFusedAdamState(**fields)


def tp_serving_params_from_jax(params: Any, rank: int, tp: int,
                               device="cpu", dtype=None) -> Any:
    """A full ``init_gpt_params`` tree of the JAX package (numpy leaves)
    cut for rank ``rank`` of a tensor-parallel serving engine of ``tp``
    ranks (``serving.engine.tp_rank_params``: QKV and fc1 column-parallel
    by whole heads, proj and fc2 row-parallel, everything else, the word
    embedding included, replicated)."""
    from .serving.engine import tp_rank_params

    return tp_rank_params(params_from_jax(params, device, dtype), tp, rank)
