"""ASP, automatic 2:4 sparsity, over parameter trees (counterpart of
``apex_tpu/contrib/sparsity/asp.py``).

The functional spelling of the JAX package: a tree of masks and a
wrapped step function in place of the reference's mask buffers and
patched ``optimizer.step``::

    asp = ASP(mask_calculator="m4n2_1d",
              whitelist=lambda path, p: p.dim() == 2 and "embed" not in path)
    masks = asp.compute_sparse_masks(params)
    params = asp.apply_masks(params, masks)
    step = asp.wrap_step(opt.step, masks)
    new_params, new_state = step(grads, state, params)

The whitelist gets each leaf's path spelled as the JAX package spells it
(``_path_str``): dict keys and sequence indices joined by ``"/"``
(``"layers/qkv_w"``, ``"blocks/0/w"``), so a whitelist written for the
JAX package picks the same leaves. A named tuple's fields, which JAX
keys by attribute, spell ``"None"`` there and here alike.
``allow_permutation=True`` raises, as in the JAX package.
"""
from __future__ import annotations

from typing import Any, Callable, Optional, Union

import torch

from ..._tree import tree_map
from .sparse_masklib import create_mask

Tree = Any


def _is_namedtuple(t) -> bool:
    return isinstance(t, tuple) and hasattr(type(t), "_fields")


def _map_with_path(fn: Callable[[str, torch.Tensor], Any], tree: Tree,
                   path=()) -> Tree:
    """``jax.tree_util.tree_map_with_path`` with the JAX package's path
    strings; dicts in sorted-key order, ``None`` an empty subtree."""
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, tree[k], path + (str(k),))
                for k in sorted(tree)}
    if _is_namedtuple(tree):
        return type(tree)(*(_map_with_path(fn, x, path + ("None",))
                            for x in tree))
    if isinstance(tree, (list, tuple)):
        out = [_map_with_path(fn, x, path + (str(i),))
               for i, x in enumerate(tree)]
        return out if isinstance(tree, list) else tuple(out)
    if tree is None:
        return None
    return fn("/".join(path), tree)


class ASP:
    """The tree-functional ASP manager.

    Args:
        mask_calculator: a pattern (``"m4n2_1d"``) or a callable
            ``param -> mask``.
        whitelist: ``(path_str, param) -> bool``; default: every param of
            rank >= 2 whose last dim is a multiple of 4.
        allow_permutation: must be False.
    """

    def __init__(self, mask_calculator: Union[str, Callable] = "m4n2_1d",
                 whitelist: Optional[Callable[[str, torch.Tensor],
                                              bool]] = None,
                 verbosity: int = 0, allow_permutation: bool = False):
        if allow_permutation:
            raise NotImplementedError(
                "automatic graph-wide permutation (the reference's torch.fx "
                "permutation_lib pass) has no jaxpr analogue; run "
                "contrib.sparsity.channel_swap_search offline and apply the "
                "permutation with apply_permutation_C/K, then use ASP with "
                "allow_permutation=False"
            )
        if isinstance(mask_calculator, str):
            pattern = mask_calculator
            self._calc = lambda p: create_mask(p, pattern)
        else:
            self._calc = mask_calculator
        self._whitelist = whitelist or (
            lambda path, p: p.dim() >= 2 and p.shape[-1] % 4 == 0)
        self.verbosity = verbosity

    def compute_sparse_masks(self, params: Tree) -> Tree:
        """A 0/1 mask for each whitelisted leaf, ones for the rest."""
        def leaf(path, p):
            if self._whitelist(path, p):
                return self._calc(p)
            return torch.ones_like(p)
        return _map_with_path(leaf, params)

    def apply_masks(self, params: Tree, masks: Tree) -> Tree:
        return tree_map(lambda p, m: p * m, params, masks)

    def wrap_step(self, step_fn: Callable, masks: Tree) -> Callable:
        """``step(grads, state, params, **kw) -> (params, state)`` with the
        masks re-applied to the returned params (the reference's patched
        ``optimizer.step``)."""
        def stepped(grads, state, params, **kw):
            new_params, new_state = step_fn(grads, state, params, **kw)
            return self.apply_masks(new_params, masks), new_state
        return stepped
