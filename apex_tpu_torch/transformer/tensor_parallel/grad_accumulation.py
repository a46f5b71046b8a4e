"""fp32 ``main_grad`` accumulation (counterpart of
``apex_tpu/transformer/tensor_parallel/grad_accumulation.py``).

The reference's ``fused_weight_gradient_mlp_cuda.wgrad_gemm_accum_fp32``
writes each weight-gradient GEMM into a persistent fp32 ``main_grad``
buffer with ``beta = 1``, so a loop over microbatches computes in bf16 or
fp16 and accumulates in fp32. Here:

- :func:`wgrad_gemm_accum_fp32` / ``_fp16``: ``main_grad += dY^T X`` in
  place, one ``addmm_`` (cuBLAS on the card; the JAX package leaves the
  same GEMM to XLA), the operands in fp32 for the fp32 buffer;
- :func:`accumulate_main_grads`: a loop over the leading microbatch axis
  adding each microbatch's gradients into the fp32 buffers in place, so
  one microbatch's gradients are alive at a time.
"""
from __future__ import annotations

from typing import Any, Callable, Optional

import torch

from ..._tree import tree_flatten, tree_leaves, tree_map, tree_unflatten

Tree = Any


def _rows(t: torch.Tensor) -> torch.Tensor:
    return t.reshape(-1, t.shape[-1])


def wgrad_gemm_accum_fp32(total_input: torch.Tensor,
                          grad_output: torch.Tensor,
                          main_grad: torch.Tensor) -> torch.Tensor:
    """``main_grad += grad_output^T @ total_input`` in place, in fp32:
    ``total_input [..., in]``, ``grad_output [..., out]`` (the same
    leading dims), ``main_grad [out, in]`` fp32 (any other dtype raises,
    as the reference does). Returns ``main_grad``."""
    if main_grad.dtype != torch.float32:
        raise ValueError(
            f"wgrad_gemm_accum_fp32 requires an fp32 main_grad buffer, got "
            f"{main_grad.dtype} (use wgrad_gemm_accum_fp16 for half "
            f"buffers)")
    return main_grad.addmm_(_rows(grad_output).float().t(),
                            _rows(total_input).float())


def wgrad_gemm_accum_fp16(total_input: torch.Tensor,
                          grad_output: torch.Tensor,
                          main_grad: torch.Tensor) -> torch.Tensor:
    """The half-buffer form: the GEMM accumulates in fp32, the sum with
    the buffer is rounded to the buffer's dtype in place. Returns
    ``main_grad``."""
    dw = torch.mm(_rows(grad_output).float().t(), _rows(total_input).float())
    return main_grad.copy_((main_grad.float() + dw).to(main_grad.dtype))


def init_main_grads(params: Tree) -> Tree:
    """fp32 zero buffers shaped like ``params``, on their devices."""
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params)


def accumulate_main_grads(grad_fn: Callable, params: Tree,
                          microbatches: Tree,
                          main_grads: Optional[Tree] = None) -> Tree:
    """Add ``grad_fn(params, microbatch)`` (a gradient tree of any
    dtype) for every microbatch along the leading axis of
    ``microbatches`` into the fp32 ``main_grads`` in place (zeros by
    default; buffers of another dtype raise) and return them. Each
    microbatch's gradients are consumed before the next is computed."""
    if main_grads is None:
        main_grads = init_main_grads(params)
    else:
        bad = [b.dtype for b in tree_leaves(main_grads)
               if b.dtype != torch.float32]
        if bad:
            raise ValueError(
                f"main_grads must be fp32 buffers (got {bad[0]}); the fp32 "
                "accumulation across microbatches is the point of this API")
    leaves, treedef = tree_flatten(microbatches)
    n = leaves[0].shape[0]
    acc = tree_leaves(main_grads)
    for i in range(n):
        micro = tree_unflatten(treedef, [t[i] for t in leaves])
        _add_into(acc, grad_fn(params, micro))
    return main_grads


def _add_into(acc, grads: Tree) -> None:
    """``acc[i] += grads[i]`` in fp32; the gradients die on return."""
    for a, g in zip(acc, tree_leaves(grads)):
        a.add_(g.float())
