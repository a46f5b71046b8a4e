"""DistributedFusedAdam: ZeRO-2 Adam over a process group (counterpart
of ``apex_tpu/contrib/optimizers/distributed_fused_adam.py``).

The reference's moving parts and their spellings here:

==========================================================  ==================
reference mechanism                                          here
==========================================================  ==================
params flattened into fixed-size buckets                     one padded flat
                                                             fp32 buffer
                                                             (``ShardedLayout``)
bucketed ``reduce_scatter_tensor`` grad sync overlapped      one
with backward via hooks                                      ``reduce_scatter_
                                                             tensor`` a step
optional all-reduce over the redundant group                 ``all_reduce``
                                                             over the
                                                             redundant group
shard-local multi-tensor Adam kernel                         plain PyTorch
                                                             over the flat
                                                             shard (the JAX
                                                             package's plain
                                                             XLA update)
param ``all_gather`` overlapped with next forward            one
                                                             ``all_gather_into
                                                             _tensor`` a step
grad-norm / clip / unscale integration                       ``max_grad_norm``
                                                             + ``grad_scale``/
                                                             ``found_inf``
v1 (gather-on-root) / v2 (per-rank shard) checkpoints        ``state_dict``
                                                             v1/v2 formats
==========================================================  ==================

A rank is a process: ``init`` and ``step`` run on every rank of the
``distributed_axis`` group, and a rank's state holds only its own
``(shard_size,)`` slice of each buffer (the JAX state is the global
``(padded,)`` array sharded by ``state_specs()``)::

    opt = DistributedFusedAdam(lr=1e-3, distributed_size=world)
    state = opt.init(params)            # this rank's shards
    grads = ...                         # this rank's local gradients
    params, state = opt.step(grads, state, params)

``distributed_axis`` and ``redundant_axis`` name ``parallel_state`` axes
(or are ``ProcessGroup``s): the axis's group once model parallelism is
initialised, else the default group; with no process group, a world of
1 (every collective the identity). The overlap and bucketing arguments
configure the reference's hooks and streams and are accepted and
ignored, as in the JAX package.
"""
from __future__ import annotations

from typing import Any, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ...optimizers._common import lr_tensor, resolve_scale, skip_on_overflow
from ._sharded import Pytree, ShardAxis, ShardedLayout, check_axis


class DistributedFusedAdamState(NamedTuple):
    step: torch.Tensor  # i32 scalar, replicated
    exp_avg: torch.Tensor  # (shard_size,) this rank's shard
    exp_avg_sq: torch.Tensor  # (shard_size,) this rank's shard
    param_shard: Optional[torch.Tensor]  # fp32 masters when store_params


def _div(x: torch.Tensor, v: float) -> torch.Tensor:
    """``x / v`` as a true division (a divisor on ``x``'s device, which
    no kernel turns into a reciprocal multiply)."""
    return x / torch.full((), v, dtype=x.dtype, device=x.device)


class DistributedFusedAdam:
    """ZeRO-2 Adam / AdamW (see the module docstring).

    ``distributed_size`` is the size of the group the state is sharded
    over; it must equal the size ``distributed_axis`` resolves to.
    ``redundant_axis`` names a group the reduced gradients are further
    summed (and averaged) over; the state is replicated along it."""

    def __init__(
        self,
        lr: float = 1e-3,
        bias_correction: bool = True,
        betas: Tuple[float, float] = (0.9, 0.999),
        eps: float = 1e-8,
        adam_w_mode: bool = True,
        weight_decay: float = 0.0,
        amsgrad: bool = False,
        *,
        distributed_size: int,
        distributed_axis: Any = "data",
        redundant_axis: Any = None,
        dtype=torch.float32,
        grad_sync_dtype=None,
        param_sync_dtype=None,
        average_grad_sync: bool = True,
        overlap_grad_sync: bool = True,
        overlap_param_sync: bool = False,
        bucket_cap_mb: float = 100.0,
        pipeline_size: int = 2,
        contiguous_param_buffer: bool = False,
        contiguous_grad_buffer: bool = False,
        store_params: bool = True,
        store_param_remainders: bool = False,
        max_grad_norm: float = 0.0,
        capturable: bool = True,
    ):
        if amsgrad:
            raise RuntimeError("DistributedFusedAdam does not support AMSGrad.")
        if store_param_remainders:
            raise NotImplementedError(
                "store_param_remainders is a CUDA bit-packing trick; "
                "store_params=True already holds exact fp32 masters.")
        del overlap_grad_sync, overlap_param_sync, bucket_cap_mb, pipeline_size
        del contiguous_param_buffer, contiguous_grad_buffer, capturable
        self.lr = lr
        self.bias_correction = bias_correction
        self.betas = betas
        self.eps = eps
        self.adam_w_mode = adam_w_mode
        self.weight_decay = weight_decay
        self.distributed_size = int(distributed_size)
        self.distributed_axis = distributed_axis
        self.redundant_axis = redundant_axis
        self.dtype = dtype
        self.grad_sync_dtype = grad_sync_dtype or dtype
        self.param_sync_dtype = param_sync_dtype or dtype
        self.average_grad_sync = average_grad_sync
        self.store_params = store_params
        self.max_grad_norm = max_grad_norm
        self._layout: Optional[ShardedLayout] = None
        self._device = None
        self._axes: Optional[Tuple[ShardAxis, Optional[ShardAxis]]] = None

    # -- layout and groups -------------------------------------------------
    def layout_for(self, params: Pytree) -> ShardedLayout:
        if self._layout is None:
            self._layout = ShardedLayout(params, self.distributed_size)
            from ..._tree import tree_leaves

            self._device = tree_leaves(params)[0].device
        return self._layout

    def _groups(self) -> Tuple[ShardAxis, Optional[ShardAxis]]:
        """The distributed axis (checked against ``distributed_size``)
        and the redundant one, resolved once."""
        if self._axes is None:
            ax = ShardAxis(self.distributed_axis)
            check_axis(ax, self.distributed_size, "distributed_size")
            red = (ShardAxis(self.redundant_axis)
                   if self.redundant_axis is not None else None)
            self._axes = (ax, red)
        return self._axes

    @property
    def shard_index(self) -> int:
        """This rank's shard on the distributed axis."""
        return self._groups()[0].index

    def _local(self, flat: torch.Tensor) -> torch.Tensor:
        return self._layout.shard_of(flat, self.shard_index)

    def init(self, params: Pytree) -> DistributedFusedAdamState:
        """This rank's state: zero moments and, with ``store_params``,
        the fp32 master shard cut from ``params``."""
        layout = self.layout_for(params)
        dev = self._device
        zeros = torch.zeros((layout.shard_size,), dtype=torch.float32,
                            device=dev)
        return DistributedFusedAdamState(
            step=torch.zeros((), dtype=torch.int32, device=dev),
            exp_avg=zeros,
            exp_avg_sq=zeros.clone(),
            param_shard=self._local(layout.flatten(params, torch.float32))
            if self.store_params else None,
        )

    def state_specs(self) -> DistributedFusedAdamState:
        """The dim each state field is split along over the distributed
        axis (0), or None where it is replicated (the JAX
        ``PartitionSpec`` tree's counterpart)."""
        return DistributedFusedAdamState(
            step=None, exp_avg=0, exp_avg_sq=0,
            param_shard=0 if self.store_params else None)

    # -- grad sync ---------------------------------------------------------
    def _reduce_grads(self, grads: Pytree, layout: ShardedLayout, inv_scale):
        """flatten -> reduce-scatter over the distributed group (->
        all-reduce over the redundant group) -> fp32, unscaled, averaged
        local shard, in the JAX package's order."""
        ax, red = self._groups()
        flat = layout.flatten(grads, self.grad_sync_dtype)
        denom = 1.0
        if self.average_grad_sync:
            denom *= self.distributed_size
        shard = ax.reduce_scatter(flat)
        if red is not None:
            if self.average_grad_sync:
                denom *= red.size
            shard = red.all_reduce(shard)
        shard = shard.to(torch.float32) * inv_scale
        if denom != 1.0:
            shard = _div(shard, denom)
        return shard

    def _clip_coef(self, grad_shard: torch.Tensor) -> torch.Tensor:
        """The global grad-norm clip factor from the sharded grads: the
        shard's squared norm, all-reduced."""
        one = torch.ones((), dtype=torch.float32, device=grad_shard.device)
        if self.max_grad_norm <= 0:
            return one
        ax = self._groups()[0]
        sq = ax.all_reduce((grad_shard.to(torch.float32) ** 2).sum())
        norm = torch.sqrt(sq)
        coef = (torch.full((), self.max_grad_norm, dtype=torch.float32,
                           device=norm.device) / norm.clamp_min(1e-12))
        return torch.minimum(one, coef)

    # -- shared shard plumbing (DistributedFusedLAMB too) -------------------
    def _param_shard_f32(self, state, params, layout: ShardedLayout):
        """The fp32 master shard: stored state, or this rank's slice of
        the replicated params when ``store_params=False``."""
        if self.store_params:
            return state.param_shard
        return self._local(layout.flatten(params, torch.float32))

    def _gather_params(self, new_p32, params, layout: ShardedLayout):
        """all-gather the updated shards and rebuild the param tree."""
        gathered = self._groups()[0].all_gather(
            new_p32.to(self.param_sync_dtype))
        return layout.unflatten(gathered)

    def _bias_corrections(self, new_step: torch.Tensor):
        beta1, beta2 = self.betas
        if not self.bias_correction:
            one = torch.ones((), dtype=torch.float32,
                             device=new_step.device)
            return one, one
        t = new_step.to(torch.float32)
        return 1.0 - beta1 ** t, 1.0 - beta2 ** t

    # -- step --------------------------------------------------------------
    def _stepped(self, grads, state, params, lr, wd, inv_scale):
        layout = self.layout_for(params)
        g = self._reduce_grads(grads, layout, inv_scale)
        g = g * self._clip_coef(g)
        p32 = self._param_shard_f32(state, params, layout)

        beta1, beta2 = self.betas
        new_step = state.step + 1
        lr = lr_tensor(lr, g.device)
        bc1, bc2 = self._bias_corrections(new_step)
        if not self.adam_w_mode and wd != 0.0:
            g = g + wd * p32
        m = beta1 * state.exp_avg + (1.0 - beta1) * g
        v = beta2 * state.exp_avg_sq + (1.0 - beta2) * g * g
        update = (m / bc1) / (torch.sqrt(v / bc2) + self.eps)
        if self.adam_w_mode and wd != 0.0:
            update = update + wd * p32
        new_p32 = p32 - lr * update
        new_params = self._gather_params(new_p32, params, layout)
        new_state = DistributedFusedAdamState(
            step=new_step.to(torch.int32),
            exp_avg=m,
            exp_avg_sq=v,
            param_shard=new_p32 if self.store_params else None,
        )
        return new_params, new_state

    def step(
        self,
        grads: Pytree,
        state: DistributedFusedAdamState,
        params: Pytree,
        lr=None,
        weight_decay: Optional[float] = None,
        found_inf: Optional[torch.Tensor] = None,
        grad_scale=None,
    ) -> Tuple[Pytree, DistributedFusedAdamState]:
        """One ZeRO-2 step on every rank of the group: returns the
        gathered params and this rank's new state. With ``found_inf``
        set, the step's collectives still run on every rank and a
        device-side select keeps the old params and state."""
        lr = self.lr if lr is None else lr
        wd = self.weight_decay if weight_decay is None else weight_decay
        self.layout_for(params)  # fixes the device
        inv_scale = resolve_scale(grad_scale, self._device)
        return skip_on_overflow(
            found_inf,
            lambda: self._stepped(grads, state, params, lr, wd, inv_scale),
            (params, state),
        )

    # -- checkpointing -----------------------------------------------------
    def _collect(self, buf: torch.Tensor) -> np.ndarray:
        """This rank's shard gathered across the group: the global
        ``(padded,)`` array on every rank."""
        return self._groups()[0].all_gather(buf.detach()).cpu().numpy()

    def state_dict(self, state: DistributedFusedAdamState, format: str = "v2"):
        """Host-side checkpoint dict, the JAX package's arrays, collected
        across the group (every rank calls it): ``v2`` per-shard
        ``(n_shards, shard_size)`` arrays, ``v1`` dense ``(padded,)``."""
        layout = self._layout
        if layout is None:
            raise RuntimeError("state_dict before init/step: layout unknown")
        if format not in ("v1", "v2"):
            raise ValueError(f"unknown checkpoint format {format!r} (want 'v1'/'v2')")

        def pack(buf):
            a = self._collect(buf)
            return a.reshape(layout.n_shards, layout.shard_size) if format == "v2" else a

        out = {
            "format": format,
            "step": int(state.step),
            "exp_avg": pack(state.exp_avg),
            "exp_avg_sq": pack(state.exp_avg_sq),
        }
        if self.store_params:
            out["param_shard"] = pack(state.param_shard)
        return out

    def load_state_dict(self, sd) -> DistributedFusedAdamState:
        """This rank's state from either checkpoint format: its own slice
        of each array."""
        layout = self._layout
        if layout is None:
            raise RuntimeError("load_state_dict before init/layout_for")

        def unpack(a):
            flat = torch.as_tensor(np.asarray(a, np.float32).reshape(-1))
            return self._local(flat).to(self._device)

        if self.store_params and "param_shard" not in sd:
            raise ValueError(
                "checkpoint has no param_shard but store_params=True — it was "
                "written by an optimizer configured with store_params=False")
        return DistributedFusedAdamState(
            step=torch.tensor(int(sd["step"]), dtype=torch.int32,
                              device=self._device),
            exp_avg=unpack(sd["exp_avg"]),
            exp_avg_sq=unpack(sd["exp_avg_sq"]),
            param_shard=unpack(sd["param_shard"]) if self.store_params else None,
        )
