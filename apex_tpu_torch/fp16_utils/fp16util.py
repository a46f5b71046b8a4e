"""Tree casting helpers for manual mixed precision (counterpart of
``apex_tpu/fp16_utils/fp16util.py``).

Reference: ``apex/fp16_utils/fp16util.py``: module-walking converters
(``network_to_half``, ``convert_network`` keeping BatchNorm fp32,
``FP16Model``) and the master-param bookkeeping (``prep_param_lists``,
``master_params_to_model_params``, ``model_grads_to_master_grads``).

As in the JAX package, models are parameter trees, so "walking the
module tree" becomes mapping over leaves with a path predicate; bf16 is
the default half dtype (fp16 supported for parity).
"""
from __future__ import annotations

from typing import Any, Callable, Optional, Tuple

import torch

from .._tree import leaf_paths, tree_flatten, tree_map, tree_unflatten

Tree = Any

#: path substrings kept in fp32 by convert_network: the tree analogue of
#: the reference's "leave torch.nn.modules.batchnorm._BatchNorm in fp32"
#: (fp16util.py:30-42)
DEFAULT_FP32_PATH_PATTERNS = ("batch_stats", "batchnorm", "bn", "norm")


def _is_float(leaf) -> bool:
    return isinstance(leaf, torch.Tensor) and leaf.is_floating_point()


def _cast_floats(tree: Tree, dtype) -> Tree:
    return tree_map(lambda l: l.to(dtype) if _is_float(l) else l, tree)


def tofp16(tree: Tree, dtype=torch.bfloat16) -> Tree:
    """Cast every float leaf (reference ``tofp16`` ``fp16util.py:18-21``)."""
    return _cast_floats(tree, dtype)


def network_to_half(tree: Tree, dtype=torch.bfloat16) -> Tree:
    """Reference ``network_to_half`` (``fp16util.py:44-50``): everything
    to half, norm layers included (use :func:`convert_network` to keep
    them fp32)."""
    return tofp16(tree, dtype)


def convert_network(tree: Tree, dtype=torch.bfloat16,
                    keep_fp32: Optional[Callable[[str], bool]] = None
                    ) -> Tree:
    """Cast float leaves to ``dtype``, keeping norm-like params fp32.

    Reference ``convert_network`` (``fp16util.py:53-62``): BatchNorm
    modules stay fp32. ``keep_fp32`` receives the leaf's key path string
    (``['layer']['bn']['scale']``); the default matches
    :data:`DEFAULT_FP32_PATH_PATTERNS`."""
    if keep_fp32 is None:
        def keep_fp32(path: str) -> bool:
            p = path.lower()
            return any(pat in p for pat in DEFAULT_FP32_PATH_PATTERNS)

    leaves, treedef = tree_flatten(tree)
    out = [leaf.to(dtype) if _is_float(leaf) and not keep_fp32(path)
           else leaf for path, leaf in zip(leaf_paths(treedef), leaves)]
    return tree_unflatten(treedef, out)


class FP16Model:
    """Reference ``FP16Model`` (``fp16util.py:65-77``): wraps an apply
    function so inputs are cast to half and the network runs in half."""

    def __init__(self, apply_fn: Callable, dtype=torch.bfloat16):
        self.apply_fn = apply_fn
        self.dtype = dtype

    def __call__(self, params: Tree, *inputs, **kwargs):
        half_inputs = tofp16(inputs, self.dtype)
        return self.apply_fn(network_to_half(params, self.dtype),
                             *half_inputs, **kwargs)


def prep_param_lists(params: Tree) -> Tuple[Tree, Tree]:
    """(model params, fp32 master copies): reference ``prep_param_lists``
    (``fp16util.py:80-120``; the flat-master option collapses into the
    tree). The masters are always copies, never aliases."""
    masters = tree_map(
        lambda l: l.to(torch.float32, copy=True) if _is_float(l) else l,
        params)
    return params, masters


def master_params_to_model_params(model_params: Tree,
                                  master_params: Tree) -> Tree:
    """Masters cast to the model's dtypes (reference ``fp16util.py:123-140``)."""
    return tree_map(lambda m, p: m.to(p.dtype) if _is_float(p) else m,
                    master_params, model_params)


def model_grads_to_master_grads(model_grads: Tree) -> Tree:
    """Grads upcast to fp32 (reference ``fp16util.py:143-160``)."""
    return _cast_floats(model_grads, torch.float32)


def to_python_float(t) -> float:
    """Reference ``to_python_float`` (``fp16util.py:163-167``); reads the
    device."""
    return float(t.item()) if isinstance(t, torch.Tensor) else float(t)
