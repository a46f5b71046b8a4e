"""DistributedFusedLAMB: ZeRO-2 LAMB over a process group (counterpart
of ``apex_tpu/contrib/optimizers/distributed_fused_lamb.py``).

The substrate of :class:`DistributedFusedAdam` (see its module for the
mechanism map). The LAMB-specific part is the per-tensor trust ratio
``||p|| / ||update||``: every element of a shard is scaled by a ratio
over its whole tensor, whose other elements live on other ranks. Each
rank sums ``p^2`` and ``u^2`` per leaf over its slice of the flat buffer
(a leaf's positions are one contiguous range, so each sum is one
reduction over a slice, into ``n_leaves + 1`` segments, the last one
the padding; an ``index_add_`` over the per-position leaf ids would
accumulate a leaf of millions of elements into one float through
atomics and lose the norms' precision), one ``all_reduce`` over the
group gives the exact per-tensor squared norms, and the ratio is
gathered back per position through the segment ids: O(shard) work, no
full params on any rank.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from ...optimizers._common import lr_tensor, resolve_scale, skip_on_overflow
from ._sharded import Pytree
from .distributed_fused_adam import DistributedFusedAdam


class DistributedFusedLAMBState(NamedTuple):
    step: torch.Tensor  # i32 scalar, replicated
    exp_avg: torch.Tensor  # (shard_size,) this rank's shard
    exp_avg_sq: torch.Tensor  # (shard_size,) this rank's shard
    param_shard: Optional[torch.Tensor]  # fp32 masters
    segment_ids: torch.Tensor  # (shard_size,) i32 leaf ids, this rank's


class DistributedFusedLAMB(DistributedFusedAdam):
    """ZeRO-2 LAMB: the grad-sync / shard / gather / checkpoint machinery
    of :class:`DistributedFusedAdam` with the two-phase LAMB update of
    ``optimizers.FusedLAMB`` (global-norm clip, bias-corrected moments
    with ``grad_averaging``, per-tensor trust ratios, ``use_nvlamb``).
    ``clip_after_ar=True`` is the only mode: the norm is always taken
    over the fully reduced gradients."""

    def __init__(
        self,
        lr: float = 1e-3,
        bias_correction: bool = True,
        betas: Tuple[float, float] = (0.9, 0.999),
        eps: float = 1e-6,
        weight_decay: float = 0.01,
        *,
        adam_w_mode: bool = True,
        grad_averaging: bool = True,
        max_grad_norm: float = 1.0,
        use_nvlamb: bool = False,
        **kw,
    ):
        super().__init__(
            lr=lr,
            bias_correction=bias_correction,
            betas=betas,
            eps=eps,
            adam_w_mode=adam_w_mode,
            weight_decay=weight_decay,
            max_grad_norm=max_grad_norm,
            **kw,
        )
        self.grad_averaging = grad_averaging
        self.use_nvlamb = use_nvlamb
        self._global_scale = None

    def init(self, params: Pytree) -> DistributedFusedLAMBState:
        base = super().init(params)
        return DistributedFusedLAMBState(
            *base, segment_ids=self._local_segment_ids())

    def _local_segment_ids(self) -> torch.Tensor:
        return self._local(self._layout.segment_ids()).to(self._device)

    def _segment_sums(self, x: torch.Tensor) -> torch.Tensor:
        """``(n_leaves + 1,)``: the sum of this rank's shard ``x`` over each
        leaf's positions (and the padding's, last), one reduction a
        range."""
        layout = self._layout
        lo, hi = layout.shard_bounds(self.shard_index)
        edges = layout.offsets + [layout.padded]
        sums = []
        for a, b in zip(edges[:-1], edges[1:]):
            a, b = max(lo, a) - lo, min(hi, b) - lo
            sums.append(x[a:b].sum() if a < b else x.new_zeros(()))
        return torch.stack(sums)

    def state_specs(self) -> DistributedFusedLAMBState:
        return DistributedFusedLAMBState(
            *super().state_specs(), segment_ids=0)

    def _stepped(self, grads, state, params, lr, wd, inv_scale):
        layout = self.layout_for(params)
        g = self._reduce_grads(grads, layout, inv_scale)
        g = g * self._clip_coef(g)  # clip_after_ar: norm of reduced grads
        p32 = self._param_shard_f32(state, params, layout)

        beta1, beta2 = self.betas
        beta3 = 1.0 - beta1 if self.grad_averaging else 1.0
        new_step = state.step + 1
        lr = lr_tensor(lr, g.device)
        bc1, bc2 = self._bias_corrections(new_step)

        if not self.adam_w_mode and wd != 0.0:
            g = g + wd * p32
        m = beta1 * state.exp_avg + beta3 * g
        v = beta2 * state.exp_avg_sq + (1.0 - beta2) * g * g
        update = (m / bc1) / (torch.sqrt(v / bc2) + self.eps)
        if self.adam_w_mode and wd != 0.0:
            update = update + wd * p32

        if wd != 0.0 or self.use_nvlamb:
            # per-tensor ||p||, ||update||: shard-local segment sums, one
            # all-reduce of both over the group
            seg = state.segment_ids.long()
            sums = self._groups()[0].all_reduce(torch.stack(
                [self._segment_sums(p32 * p32),
                 self._segment_sums(update * update)]))
            w_norm = torch.sqrt(sums[0])
            u_norm = torch.sqrt(sums[1])
            ratios = torch.where((w_norm > 0) & (u_norm > 0),
                                 w_norm / u_norm.clamp_min(1e-30), 1.0)
            ratio = ratios[seg]
        else:
            ratio = torch.ones((), dtype=torch.float32, device=p32.device)

        new_p32 = p32 - lr * ratio * update
        new_params = self._gather_params(new_p32, params, layout)
        new_state = DistributedFusedLAMBState(
            step=new_step.to(torch.int32),
            exp_avg=m,
            exp_avg_sq=v,
            param_shard=new_p32 if self.store_params else None,
            segment_ids=state.segment_ids,
        )
        return new_params, new_state

    def step(
        self,
        grads: Pytree,
        state: DistributedFusedLAMBState,
        params: Pytree,
        lr=None,
        weight_decay: Optional[float] = None,
        found_inf: Optional[torch.Tensor] = None,
        grad_scale=None,
    ) -> Tuple[Pytree, DistributedFusedLAMBState]:
        lr = self.lr if lr is None else lr
        wd = self.weight_decay if weight_decay is None else weight_decay
        if grad_scale is None and self._global_scale is not None:
            grad_scale = self._global_scale
        self.layout_for(params)  # fixes the device
        inv_scale = resolve_scale(grad_scale, self._device)
        return skip_on_overflow(
            found_inf,
            lambda: self._stepped(grads, state, params, lr, wd, inv_scale),
            (params, state),
        )

    # ``set_global_scale``: the stored scale is the default grad_scale of
    # later step() calls (an explicit grad_scale argument wins)
    def set_global_scale(self, scale):
        self._global_scale = torch.as_tensor(scale, dtype=torch.float32)

    @property
    def global_scale(self):
        if self._global_scale is not None:
            return self._global_scale
        return torch.ones((), dtype=torch.float32)

    def load_state_dict(self, sd) -> DistributedFusedLAMBState:
        """This rank's state; the segment ids are rebuilt from the
        layout (they are not checkpointed)."""
        if self._layout is None:
            raise RuntimeError("load_state_dict before init/layout_for")
        base = super().load_state_dict(sd)
        return DistributedFusedLAMBState(
            *base, segment_ids=self._local_segment_ids())
