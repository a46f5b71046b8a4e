"""Nested-container trees of tensors, flattened in the JAX package's
order.

``jax.tree_util`` flattens a dict in sorted-key order, a list, tuple or
named tuple in order, and ``None`` as an empty subtree;
:func:`tree_flatten` does the same, so a flat buffer laid out from a
tree of tensors has the same leaf order and offsets as the JAX
package's (``PackSpec``) and optimizer state can be compared, or
carried, element by element.
"""
from __future__ import annotations

from typing import Any, Callable, List, Tuple

import torch

Tree = Any

#: the structure of a tree: ("dict", keys, children) / ("list", n,
#: children) / ("tuple", type, children) / ("none",) / ("leaf",)
TreeDef = Tuple


def tree_flatten(tree: Tree) -> Tuple[List[Any], TreeDef]:
    leaves: List[Any] = []

    def walk(t):
        if isinstance(t, dict):
            keys = tuple(sorted(t))
            return ("dict", keys, tuple(walk(t[k]) for k in keys))
        if isinstance(t, list):
            return ("list", len(t), tuple(walk(x) for x in t))
        if isinstance(t, tuple):  # the type keeps a named tuple's class
            return ("tuple", type(t), tuple(walk(x) for x in t))
        if t is None:
            return ("none",)
        leaves.append(t)
        return ("leaf",)

    return leaves, walk(tree)


def tree_unflatten(treedef: TreeDef, leaves) -> Tree:
    it = iter(leaves)

    def build(td):
        kind = td[0]
        if kind == "leaf":
            return next(it)
        if kind == "none":
            return None
        if kind == "dict":
            return {k: build(c) for k, c in zip(td[1], td[2])}
        items = [build(c) for c in td[2]]
        if kind == "list":
            return items
        cls = td[1]
        return cls(*items) if cls is not tuple else tuple(items)

    return build(treedef)


def tree_leaves(tree: Tree) -> List[Any]:
    return tree_flatten(tree)[0]


def tree_map(fn: Callable, tree: Tree, *rest: Tree) -> Tree:
    leaves, treedef = tree_flatten(tree)
    others = [tree_leaves(r) for r in rest]
    for o in others:
        if len(o) != len(leaves):
            raise ValueError(f"tree mismatch: {len(leaves)} leaves vs "
                             f"{len(o)}")
    return tree_unflatten(treedef, [fn(*xs) for xs in zip(leaves, *others)])


def leaf_paths(treedef: TreeDef) -> List[str]:
    """Path strings in flatten order, in ``jax.tree_util.keystr``'s
    format (``['layers']['qkv_w']``, ``[0]``)."""
    out: List[str] = []

    def walk(td, prefix):
        kind = td[0]
        if kind == "leaf":
            out.append(prefix)
        elif kind == "dict":
            for k, c in zip(td[1], td[2]):
                walk(c, f"{prefix}[{k!r}]")
        elif kind in ("list", "tuple"):
            for i, c in enumerate(td[2]):
                walk(c, f"{prefix}[{i}]")

    walk(treedef, "")
    return out


def value_and_grad(fn: Callable[[Tree], torch.Tensor], params: Tree,
                   **kw) -> Tuple[torch.Tensor, Tree]:
    """``(fn(params), d fn / d params)`` as trees of the same structure —
    the port's ``jax.value_and_grad`` for a scalar loss. Every leaf is
    taken as a fresh leaf tensor sharing the parameter's storage
    (``detach``: no copy), so the caller's tensors are never given a
    ``.grad`` or replaced; a leaf the loss does not reach gets zeros."""
    leaves, treedef = tree_flatten(params)
    live = [p.detach().requires_grad_(True) for p in leaves]
    loss = fn(tree_unflatten(treedef, live), **kw)
    grads = torch.autograd.grad(loss, live, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(live, grads)]
    return loss.detach(), tree_unflatten(treedef, grads)
