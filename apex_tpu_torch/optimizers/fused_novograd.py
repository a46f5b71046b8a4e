"""FusedNovoGrad: NovoGrad with a layer-wise second moment (counterpart of
``apex_tpu/optimizers/fused_novograd.py``).

The second moment ``exp_avg_sq`` is one scalar per tensor: the running
average of the gradient's squared norm, the L2 norm (``norm_type=2``) or
the max norm (``norm_type=0``, squared). It starts at 0 (``init_zero``)
or at the first step's norm. Per element, ``g / (sqrt(v) + eps)`` (plus
``wd * p`` with ``reg_inside_moment``) enters the first moment, with
``beta3 = 1 - beta1`` under ``grad_averaging``; the update is the
bias-corrected first moment (plus ``wd * p`` otherwise). ``grad_scale``
and ``found_inf`` are the kernel's ``inv_scale`` and noop flag.

The pytree path (``packed=False``) is plain PyTorch per leaf, as the JAX
package's is plain XLA. ``packed=True`` keeps the first moment in a flat
buffer and the second as a ``(n_leaves,)`` vector
(:class:`~apex_tpu_torch.optimizers._packed.PackedState`), and runs a
step as two kernel sweeps, the JAX package's structure: the gradient's
per-row sums of squares, or max |g| in the inf-norm mode
(``packed_row_reduce``); a per-leaf sum (or max) of the rows over each
leaf's contiguous rows (``PackSpec.row_segments``, on the device, in a
fixed order) gives the layer-wise norms and the new ``v``; then the
elementwise stage with the denominator given per row
(``packed_novograd_apply``), which updates the first moment in place.
``found_inf`` rides into it as its noop flag; ``v`` and the step count,
computed outside the kernel, are kept by a select on the device. No
value of a step is read on the host.
"""
from __future__ import annotations

from typing import Any, NamedTuple, Optional, Tuple

import torch

from .._tree import tree_leaves, tree_map
from ..ops.packed_optimizer import packed_novograd_apply, packed_row_reduce
from ._common import (
    FusedOptimizer,
    lr_tensor,
    multi_tree_update,
    resolve_scale,
    skip_on_overflow,
    tree_zeros_like,
)
from ._packed import PackedState, as_flat_grads, packed_init

Tree = Any


def leaf_norms_sq(flat_g: torch.Tensor, spec, norm_type: int,
                  inv_scale=1.0) -> torch.Tensor:
    """Each leaf's squared gradient norm, fp32 ``(n_leaves,)``, from one
    row-reduce sweep over the packed gradients times ``inv_scale``: the
    sum of squares (``norm_type=2``) or the squared max |g| (0), reduced
    over each leaf's contiguous rows (``PackSpec.row_segments``) in a
    fixed order, unlike a scatter; the padding rows' segment is cut
    off."""
    lengths, _ = spec.row_segments(flat_g.device)
    if norm_type == 2:
        rows = packed_row_reduce(flat_g, op="sqsum", inv_scale=inv_scale)
        norms = torch.segment_reduce(rows, "sum", lengths=lengths,
                                     unsafe=True)
    else:
        rows = packed_row_reduce(flat_g, op="maxabs", inv_scale=inv_scale)
        norms = torch.segment_reduce(rows, "max", lengths=lengths,
                                     unsafe=True) ** 2
    return norms[:spec.n_leaves]


def row_denominators(v: torch.Tensor, spec, eps: float) -> torch.Tensor:
    """``sqrt(v[leaf]) + eps`` for every ROW of the packed buffer, fp32
    ``(n_rows,)``; the padding rows get 1 (their gradient is 0)."""
    denom = torch.sqrt(v) + eps
    return torch.cat([denom, denom.new_ones(1)]).index_select(
        0, spec.row_segments(v.device)[1])


class FusedNovoGradState(NamedTuple):
    step: torch.Tensor  # int32 device scalar
    exp_avg: Tree  # fp32, elementwise
    exp_avg_sq: Tree  # fp32 0-dim tensor per leaf


class FusedNovoGrad(FusedOptimizer):
    def __init__(self, lr: float = 1e-3, bias_correction: bool = True,
                 betas: Tuple[float, float] = (0.95, 0.98),
                 eps: float = 1e-8, weight_decay: float = 0.0,
                 amsgrad: bool = False, reg_inside_moment: bool = False,
                 grad_averaging: bool = True, norm_type: int = 2,
                 init_zero: bool = False, set_grad_none: bool = True,
                 packed: bool = False,
                 packed_chunk_size: Optional[int] = None):
        if amsgrad:
            raise RuntimeError(
                "FusedNovoGrad does not support the AMSGrad variant.")
        if norm_type not in (0, 2):
            raise RuntimeError(f"FusedNovoGrad only supports l2/inf norm "
                               f"now, got {norm_type}")
        del set_grad_none  # parity: the functional step keeps no .grad
        self.lr = lr
        self.bias_correction = bias_correction
        self.betas = betas
        self.eps = eps
        self.weight_decay = weight_decay
        self.reg_inside_moment = reg_inside_moment
        self.grad_averaging = grad_averaging
        self.norm_type = norm_type
        self.init_zero = init_zero
        self.packed = packed
        self.packed_chunk_size = packed_chunk_size

    def init(self, params: Tree):
        dev = tree_leaves(params)[0].device
        if self.packed:
            state = packed_init(params, chunk_size=self.packed_chunk_size,
                                per_leaf_exp_avg_sq=True)
            state.spec.row_segments(dev)  # copied to the device once
            return state
        return FusedNovoGradState(
            step=torch.zeros((), dtype=torch.int32, device=dev),
            exp_avg=tree_zeros_like(params, torch.float32),
            exp_avg_sq=tree_map(lambda p: torch.zeros(
                (), dtype=torch.float32, device=p.device), params))

    def _hyper(self, step: torch.Tensor):
        """``(new_step, beta3, bc1, first)`` of the step after ``step``."""
        beta1 = self.betas[0]
        beta3 = 1.0 - beta1 if self.grad_averaging else 1.0
        new_step = step + 1
        bc1 = (1.0 - torch.pow(beta1, new_step.to(torch.float32))
               if self.bias_correction
               else torch.ones((), dtype=torch.float32, device=step.device))
        return new_step, beta3, bc1, step == 0

    def _new_v(self, v, gnorm_sq, first):
        beta2 = self.betas[1]
        avg = beta2 * v + (1.0 - beta2) * gnorm_sq
        # the reference materialises v as the first step's norm
        return avg if self.init_zero else torch.where(first, gnorm_sq, avg)

    def _stepped(self, grads, state: FusedNovoGradState, params, lr,
                 inv_scale):
        beta1 = self.betas[0]
        new_step, beta3, bc1, first = self._hyper(state.step)
        lr = lr_tensor(lr, state.step.device)
        wd = self.weight_decay

        def leaf(g, p, m, v):
            g = g.to(torch.float32) * inv_scale
            p32 = p.to(torch.float32)
            gnorm_sq = ((g * g).sum() if self.norm_type == 2
                        else g.abs().amax() ** 2)
            new_v = self._new_v(v, gnorm_sq, first)
            moment_in = g / (torch.sqrt(new_v) + self.eps)
            if wd != 0.0 and self.reg_inside_moment:
                moment_in = moment_in + wd * p32
            new_m = beta1 * m + beta3 * moment_in
            update = new_m / bc1
            if wd != 0.0 and not self.reg_inside_moment:
                update = update + wd * p32
            return p32 - lr * update, new_m, new_v

        p32s, ms, vs = multi_tree_update(leaf, 3, grads, params,
                                         state.exp_avg, state.exp_avg_sq)
        new_params = tree_map(lambda p32, p: p32.to(p.dtype), p32s, params)
        return new_params, FusedNovoGradState(step=new_step, exp_avg=ms,
                                              exp_avg_sq=vs)

    def _packed_stepped(self, grads, state: PackedState, params, lr,
                        inv_scale, found_inf):
        """Two sweeps over the flat buffers; ``found_inf`` is the
        elementwise sweep's noop flag (the first moment is updated in
        place) and holds ``v`` and the step count by a select."""
        spec = state.spec
        new_step, beta3, bc1, first = self._hyper(state.step)
        flat_g = as_flat_grads(grads, spec)
        dev = flat_g.device
        new_v = self._new_v(state.exp_avg_sq, leaf_norms_sq(
            flat_g, spec, self.norm_type, inv_scale), first)
        p_out, _ = packed_novograd_apply(
            flat_g, state.exp_avg, spec.pack(params, torch.float32),
            row_denominators(new_v, spec, self.eps),
            param_dtype=spec.common_dtype(),
            lr=lr_tensor(lr, dev), bc1=bc1, inv_scale=inv_scale,
            noop=found_inf, beta1=self.betas[0], beta3=beta3,
            wd=self.weight_decay, reg_inside_moment=self.reg_inside_moment)
        if found_inf is not None:
            skip = torch.as_tensor(found_inf).to(dev, torch.bool)
            new_step = torch.where(skip, state.step, new_step)
            new_v = torch.where(skip, state.exp_avg_sq, new_v)
        return spec.unpack(p_out), PackedState(
            step=new_step, exp_avg=state.exp_avg, exp_avg_sq=new_v,
            master_params=None, spec=spec)

    def step(self, grads: Tree, state, params: Tree, lr=None,
             found_inf: Optional[torch.Tensor] = None, grad_scale=None):
        lr = self.lr if lr is None else lr
        inv_scale = resolve_scale(grad_scale, state.step.device)
        if self.packed:
            return self._packed_stepped(grads, state, params, lr, inv_scale,
                                        found_inf)
        return skip_on_overflow(
            found_inf,
            lambda: self._stepped(grads, state, params, lr, inv_scale),
            (params, state))
