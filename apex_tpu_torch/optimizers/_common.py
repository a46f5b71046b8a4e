"""Shared machinery for the fused optimizers (counterpart of
``apex_tpu/optimizers/_common.py``).

Every optimizer follows the JAX package's functional protocol, so tests
drive both packages the same way::

    opt = FusedAdam(lr=1e-3, ...)
    state = opt.init(params)
    new_params, new_state = opt.step(grads, state, params,
                                     found_inf=..., grad_scale=...)

``params`` is a tree (nested dicts) of tensors; moments are fp32. The
overflow flag ``found_inf`` stays a device tensor: where JAX wrapped the
update in ``lax.cond``, the port selects between the new and the old
values on the device (:func:`skip_on_overflow`) or hands the flag to the
kernel (the packed path), and never reads it on the host.
"""
from __future__ import annotations

from typing import Any, Callable, Optional, Tuple

import torch

from .._tree import tree_flatten, tree_map, tree_unflatten

Tree = Any


def tree_zeros_like(tree: Tree, dtype=torch.float32) -> Tree:
    return tree_map(lambda x: torch.zeros(x.shape, dtype=dtype or x.dtype,
                                          device=x.device), tree)


def tree_f32(tree: Tree) -> Tree:
    """fp32 copies of every leaf (always a copy, never an alias)."""
    return tree_map(lambda x: x.to(torch.float32, copy=True), tree)


def multi_tree_update(fn: Callable, n_out: int, grads: Tree, *trees: Tree):
    """Map ``fn(g, *leaves) -> n_out-tuple`` over grads and parallel
    trees, returning ``n_out`` trees shaped like ``grads``."""
    gl, treedef = tree_flatten(grads)
    leaf_lists = []
    for t in trees:
        tl = tree_flatten(t)[0]
        if len(tl) != len(gl):
            raise ValueError(
                f"tree mismatch: grads have {len(gl)} leaves, companion "
                f"tree has {len(tl)}")
        leaf_lists.append(tl)
    outs = [fn(g, *leaves) for g, *leaves in zip(gl, *leaf_lists)]
    return tuple(tree_unflatten(treedef, [o[i] for o in outs])
                 for i in range(n_out))


def skip_on_overflow(found_inf: Optional[torch.Tensor],
                     do_step: Callable[[], Tuple[Tree, Tree]],
                     unchanged: Tuple[Tree, Tree]):
    """Run ``do_step`` unless ``found_inf`` — the noop_flag contract.

    ``do_step`` must not update anything in place. With ``found_inf``
    None the step is unconditional; otherwise both results exist and a
    device-side select keeps the old leaves where the flag is set, so
    the flag is never read on the host."""
    if found_inf is None:
        return do_step()
    new = do_step()
    old_leaves, _ = tree_flatten(unchanged)
    new_leaves, treedef = tree_flatten(new)
    flag = torch.as_tensor(found_inf).to(torch.bool)
    out = [o if o is n else torch.where(flag.to(n.device), o, n)
           for n, o in zip(new_leaves, old_leaves)]
    return tree_unflatten(treedef, out)


def resolve_scale(grad_scale, device) -> torch.Tensor:
    """A grad (loss) scale argument as an fp32 inverse multiplier, a
    0-dim tensor on ``device``."""
    if grad_scale is None:
        return torch.ones((), dtype=torch.float32, device=device)
    if isinstance(grad_scale, torch.Tensor):
        return 1.0 / grad_scale.to(device=device, dtype=torch.float32)
    return torch.full((), 1.0 / float(grad_scale), dtype=torch.float32,
                      device=device)
