"""Fused Adam + stochastic weight averaging, the OpenFold training step
(counterpart of ``apex_tpu/contrib/openfold/fused_adam_swa.py``).

Per parameter, one step (a) runs the Adam update on the fp32 master,
(b) writes the compute copy (bf16 in OpenFold) and (c) folds the fresh
master into the SWA average: ``swa = param`` on the first averaged
step, else ``swa += (1 - decay) * (param - swa)``. Three Adam math
modes, as the reference's: ``ApexAdam`` and ``PyTorchAdam`` add the
weight decay to the gradient, ``ApexAdamW`` to the update; ``PyTorchAdam``
folds the bias corrections into the step size and the denominator. The
bias corrections ``1 - beta**t`` are fp32 tensors, as the JAX package
computes them. The JAX package has no Pallas kernel here (XLA fuses the
pytree transform), so the port is plain PyTorch too; the step is
functional, as in the JAX package: the four trees go in and come out.
"""
from __future__ import annotations

import enum
from typing import Any, NamedTuple, Tuple

import torch

from ..._tree import tree_flatten, tree_leaves, tree_map, tree_unflatten

Tree = Any


class AdamMathType(enum.Enum):
    ApexAdam = 0
    ApexAdamW = 1
    PyTorchAdam = 2


class FusedAdamSWAState(NamedTuple):
    step: torch.Tensor  # int32
    n_averaged: torch.Tensor  # int32
    exp_avg: Tree  # fp32 moments
    exp_avg_sq: Tree


class FusedAdamSWA:
    """The reference optimizer, functional: :meth:`step` takes and
    returns the three parameter banks (fp32 masters, compute copies, SWA
    averages). ``swa_decay_rate`` is the average's decay; the first
    step copies."""

    def __init__(self, swa_decay_rate: float, lr: float = 1e-3,
                 bias_correction: bool = True,
                 betas: Tuple[float, float] = (0.9, 0.999),
                 eps: float = 1e-8,
                 adam_math_mode: AdamMathType = AdamMathType.PyTorchAdam,
                 weight_decay: float = 0.0):
        if not isinstance(adam_math_mode, AdamMathType):
            raise ValueError(f"Unknown Adam math mode {adam_math_mode}")
        self.swa_decay_rate = swa_decay_rate
        self.lr = lr
        self.bias_correction = bias_correction
        self.betas = betas
        self.eps = eps
        self.adam_math_mode = adam_math_mode
        self.weight_decay = weight_decay

    def init(self, params: Tree) -> FusedAdamSWAState:
        """Zero fp32 moments and counts, on the params' device."""
        dev = tree_leaves(params)[0].device
        zeros = lambda: tree_map(  # noqa: E731
            lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                  device=p.device), params)
        count = lambda: torch.zeros((), dtype=torch.int32,  # noqa: E731
                                    device=dev)
        return FusedAdamSWAState(step=count(), n_averaged=count(),
                                 exp_avg=zeros(), exp_avg_sq=zeros())

    def step(self, grads: Tree, state: FusedAdamSWAState, params: Tree,
             compute_params: Tree, swa_params: Tree, lr=None):
        """One fused Adam + SWA step. ``params`` are the fp32 masters;
        the gradients may be in the compute dtype (loaded as fp32).
        Returns ``(params, compute_params, swa_params, state)``."""
        dev = state.step.device
        lr = torch.as_tensor(self.lr if lr is None else lr,
                             dtype=torch.float32, device=dev)
        b1, b2 = self.betas
        t = state.step + 1
        tf = t.float()
        one = torch.ones((), dtype=torch.float32, device=dev)
        if self.bias_correction:
            c1 = 1.0 - torch.pow(torch.full_like(one, b1), tf)
            c2 = 1.0 - torch.pow(torch.full_like(one, b2), tf)
        else:
            c1 = c2 = one
        wd = self.weight_decay
        mode = self.adam_math_mode
        decay = self.swa_decay_rate
        first = state.n_averaged == 0

        def leaf(p, g, m, v, cp, sp):
            p32 = p.float()
            g32 = g.float()
            if mode in (AdamMathType.ApexAdam, AdamMathType.PyTorchAdam):
                g32 = g32 + wd * p32
            m = b1 * m + (1.0 - b1) * g32
            v = b2 * v + (1.0 - b2) * g32 * g32
            if mode == AdamMathType.PyTorchAdam:
                denom = torch.sqrt(v) / torch.sqrt(c2) + self.eps
                new_p = p32 - (lr / c1) * (m / denom)
            else:
                update = (m / c1) / (torch.sqrt(v / c2) + self.eps)
                if mode == AdamMathType.ApexAdamW:
                    update = update + wd * p32
                new_p = p32 - lr * update
            sp32 = sp.float()
            new_sp = torch.where(first, new_p,
                                 sp32 + (1.0 - decay) * (new_p - sp32))
            return (new_p.to(p.dtype), m, v, new_p.to(cp.dtype),
                    new_sp.to(sp.dtype))

        flat_p, treedef = tree_flatten(params)
        outs = [leaf(*args) for args in zip(
            flat_p, tree_leaves(grads), tree_leaves(state.exp_avg),
            tree_leaves(state.exp_avg_sq), tree_leaves(compute_params),
            tree_leaves(swa_params))]

        def unflat(i):
            return tree_unflatten(treedef, [o[i] for o in outs])

        new_state = FusedAdamSWAState(
            step=t, n_averaged=state.n_averaged + 1,
            exp_avg=unflat(1), exp_avg_sq=unflat(2))
        return unflat(0), unflat(3), unflat(4), new_state
