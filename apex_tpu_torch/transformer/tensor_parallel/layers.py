"""Tensor-parallel layers (counterpart of
``apex_tpu/transformer/tensor_parallel/layers.py``).

Each layer is the ``mappings`` collectives around a local GEMM over this
rank's weight shard: ``[out/tp, in]`` for the column-parallel linear,
``[out, in/tp]`` for the row-parallel one, ``[vocab/tp, hidden]`` for the
embedding. The GEMM is ``F.linear`` (cuBLAS on the card), in the
promoted dtype of the input and the weight and rounded to the input's
dtype, as the JAX einsum with fp32 accumulation is; with an fp8 state it
is ``fused_dense.fp8_fused_dense_qgrad``'s e4m3 / e5m2 recipe over the
shard, the amaxes MAX-reduced over ``fp8_amax_reduction_axes`` or, when
model parallelism is initialised, over its amax group (which must then
exist: ``initialize_model_parallel(..., use_fp8_=True)``).

``async_tensor_model_parallel_allreduce`` and
``gradient_accumulation_fusion`` configure the reference's overlap of
the backward collective with the weight-gradient GEMM and its fused
accumulation into ``main_grad``; they are accepted and have no effect,
as in the JAX package (the fp32 accumulation lives in
``grad_accumulation.py``).

The functional cores take and return shards; the ``nn.Module`` s build
their shard with a per-rank init stream (:func:`init_affine_weight_shard`)
and return the cores' ``(out, out_bias, new_fp8_state)``.
"""
from __future__ import annotations

import math
from typing import Callable, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..._device import resolve_device
from .. import parallel_state
from . import mappings
from .random import _MODEL_PARALLEL_RNG_TRACKER_NAME, get_rng_state_tracker
from .random import model_parallel_rng_key
from .utils import VocabUtility, divide


def _maybe_fp8_gemm(x_par, weight, dtype, fp8_state, fp8_grad_carrier,
                    fp8_amax_reduction_axes, fp8_margin):
    """The shard GEMM of both parallel linears: ``(out, new_fp8_state or
    None)``."""
    if fp8_state is None:
        ct = torch.promote_types(x_par.dtype, weight.dtype)
        return F.linear(x_par.to(ct), weight.to(ct)).to(dtype), None
    from ...fused_dense.fp8 import fp8_fused_dense_qgrad

    axes = fp8_amax_reduction_axes
    if axes is None and parallel_state.model_parallel_is_initialized():
        # the reference asserts that fp8 runs with the amax group; scales
        # that differ by rank would defeat the recipe
        parallel_state.get_amax_reduction_group()
        axes = (parallel_state.DATA_AXIS, parallel_state.TENSOR_AXIS)
    out, new_state = fp8_fused_dense_qgrad(
        x_par, weight, None, fp8_state, fp8_grad_carrier,
        margin=fp8_margin, amax_reduction_axes=axes)
    return out.to(dtype), new_state


def column_parallel_linear(
    x: torch.Tensor,
    weight: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    *,
    axis_name: Optional[str] = None,
    gather_output: bool = True,
    sequence_parallel_enabled: bool = False,
    skip_bias_add: bool = False,
    async_tensor_model_parallel_allreduce: bool = True,
    gradient_accumulation_fusion: bool = False,
    fp8_state=None,
    fp8_grad_carrier=None,
    fp8_amax_reduction_axes=None,
    fp8_margin: float = 0.0,
):
    """``x @ A^T`` with ``A`` split along its output dim: the input is
    copied into the tensor region (identity forward, all-reduce backward)
    or, under sequence parallelism, all-gathered along the sequence dim
    (reduce-scatter backward), then multiplied by the shard ``[out/tp,
    in]``; the bias shard is added unless ``skip_bias_add``; with
    ``gather_output`` the output is all-gathered along its last dim.
    Returns ``(out, out_bias, new_fp8_state)``: ``out_bias`` is the bias
    with ``skip_bias_add``, else None; the fp8 slot is None without
    ``fp8_state``."""
    del async_tensor_model_parallel_allreduce, gradient_accumulation_fusion
    if sequence_parallel_enabled:
        if gather_output:
            raise RuntimeError("gather_output is incompatible with sequence "
                               "parallelism")
        x_par = mappings.gather_from_sequence_parallel_region(x, axis_name,
                                                              True)
    else:
        x_par = mappings.copy_to_tensor_model_parallel_region(x, axis_name)
    out, new_fp8 = _maybe_fp8_gemm(x_par, weight, x.dtype, fp8_state,
                                   fp8_grad_carrier, fp8_amax_reduction_axes,
                                   fp8_margin)
    if bias is not None and not skip_bias_add:
        out = out + bias
    if gather_output:
        out = mappings.gather_from_tensor_model_parallel_region(out,
                                                                axis_name)
    return out, (bias if skip_bias_add else None), new_fp8


def row_parallel_linear(
    x: torch.Tensor,
    weight: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    *,
    axis_name: Optional[str] = None,
    input_is_parallel: bool = False,
    sequence_parallel_enabled: bool = False,
    skip_bias_add: bool = False,
    gradient_accumulation_fusion: bool = False,
    fp8_state=None,
    fp8_grad_carrier=None,
    fp8_amax_reduction_axes=None,
    fp8_margin: float = 0.0,
):
    """``x @ A^T`` with ``A`` split along its input dim: the shard GEMM
    with ``[out, in/tp]`` (the input split along its last dim first
    unless ``input_is_parallel``), then the partial outputs all-reduced
    or, under sequence parallelism, reduce-scattered along the sequence
    dim; the bias is added after the reduction, once. Under sequence
    parallelism the bias meets only this rank's rows, so it enters
    through the copy into the region: its gradient is summed over the
    ranks in the backward, as the JAX package's autodiff sums it. Returns
    ``(out, out_bias, new_fp8_state)`` as :func:`column_parallel_linear`."""
    del gradient_accumulation_fusion
    if input_is_parallel:
        x_par = x
    else:
        if sequence_parallel_enabled:
            raise RuntimeError("sequence parallelism requires "
                               "input_is_parallel")
        x_par = mappings.scatter_to_tensor_model_parallel_region(x,
                                                                 axis_name)
    out_par, new_fp8 = _maybe_fp8_gemm(x_par, weight, x.dtype, fp8_state,
                                       fp8_grad_carrier,
                                       fp8_amax_reduction_axes, fp8_margin)
    if sequence_parallel_enabled:
        out = mappings.reduce_scatter_to_sequence_parallel_region(out_par,
                                                                  axis_name)
    else:
        out = mappings.reduce_from_tensor_model_parallel_region(out_par,
                                                                axis_name)
    if bias is not None and not skip_bias_add:
        if sequence_parallel_enabled:
            bias = mappings.copy_to_tensor_model_parallel_region(bias,
                                                                 axis_name)
        out = out + bias
    return out, (bias if skip_bias_add else None), new_fp8


def vocab_parallel_embedding(ids: torch.Tensor, weight: torch.Tensor, *,
                             axis_name: Optional[str] = None) -> torch.Tensor:
    """Embedding lookup with the vocab split over the tensor group: ids
    outside this rank's ``[start, end)`` read row 0 and are zeroed, and
    the partial embeddings are all-reduced (each id lies in one rank's
    range)."""
    _, world, rank, _ = mappings.axis_world(axis_name)
    start, end = VocabUtility.vocab_range_from_per_partition_vocab_size(
        weight.shape[0], rank, world)
    ids = ids.long()
    mask = (ids < start) | (ids >= end)
    local = F.embedding(torch.where(mask, 0, ids - start), weight)
    local = local.masked_fill(mask.unsqueeze(-1), 0.0)
    return mappings.reduce_from_tensor_model_parallel_region(local, axis_name)


def lecun_normal(generator: torch.Generator, shape, dtype=torch.float32
                 ) -> torch.Tensor:
    """flax's ``lecun_normal``: a normal truncated at two standard
    deviations, variance ``1 / fan_in`` (the last dim of an ``[out, in]``
    weight), drawn on the generator's device."""
    fan_in = shape[-1] if len(shape) > 1 else shape[0]
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    t = torch.empty(shape, dtype=torch.float32, device=generator.device)
    nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=generator)
    return (t * std).to(dtype)


def normal_init(stddev: float = 1.0) -> Callable:
    """flax's ``normal(stddev)`` as an init method."""
    def init(generator, shape, dtype=torch.float32):
        return (torch.randn(shape, generator=generator,
                            device=generator.device) * stddev).to(dtype)
    return init


def init_affine_weight_shard(key, init_method: Callable,
                             local_shape: Tuple[int, ...],
                             axis_name: Optional[str] = None,
                             dtype=torch.float32) -> torch.Tensor:
    """A weight shard drawn by ``init_method(generator, shape, dtype)``
    from a stream that differs by tensor-parallel rank
    (:func:`model_parallel_rng_key` of ``key``, a generator or a seed),
    the reference's per-partition init under the tracker's fork."""
    gen = model_parallel_rng_key(key, axis_name)
    if not isinstance(gen, torch.Generator):
        gen = torch.Generator().manual_seed(gen)
    return init_method(gen, tuple(local_shape), dtype)


def _init_generator(generator):
    """The module's init stream: ``generator``, else a fork of the
    tracker's model-parallel stream when it exists, else a host generator
    seeded from torch's default one."""
    if generator is not None:
        return generator
    tracker = get_rng_state_tracker()
    if _MODEL_PARALLEL_RNG_TRACKER_NAME in tracker.states_:
        with tracker.fork() as g:
            return g
    return torch.Generator().manual_seed(
        int(torch.randint(0, 2 ** 62, ())))


def _param(t: torch.Tensor, device) -> nn.Parameter:
    return nn.Parameter(t.to(resolve_device(device)))


class ColumnParallelLinear(nn.Module):
    """:func:`column_parallel_linear` over this rank's ``[out/tp, in]``
    shard (and ``[out/tp]`` bias, zeros). ``device`` None is the card."""

    def __init__(self, input_size: int, output_size: int, bias: bool = True,
                 gather_output: bool = True,
                 init_method: Callable = lecun_normal,
                 skip_bias_add: bool = False,
                 sequence_parallel_enabled: bool = False,
                 gradient_accumulation_fusion: bool = False,
                 params_dtype=torch.float32,
                 axis_name: Optional[str] = None, *, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        world = mappings.axis_world(axis_name)[1]
        out_local = divide(output_size, world)
        self.input_size, self.output_size = input_size, output_size
        self.gather_output = gather_output
        self.skip_bias_add = skip_bias_add
        self.sequence_parallel_enabled = sequence_parallel_enabled
        self.gradient_accumulation_fusion = gradient_accumulation_fusion
        self.axis_name = axis_name
        self.weight = _param(init_affine_weight_shard(
            _init_generator(generator), init_method, (out_local, input_size),
            axis_name, params_dtype), device)
        self.bias = _param(torch.zeros(out_local, dtype=params_dtype),
                           device) if bias else None

    def forward(self, x):
        return column_parallel_linear(
            x, self.weight, self.bias, axis_name=self.axis_name,
            gather_output=self.gather_output,
            sequence_parallel_enabled=self.sequence_parallel_enabled,
            skip_bias_add=self.skip_bias_add,
            gradient_accumulation_fusion=self.gradient_accumulation_fusion)


class RowParallelLinear(nn.Module):
    """:func:`row_parallel_linear` over this rank's ``[out, in/tp]``
    shard and the full ``[out]`` bias (zeros). ``device`` None is the
    card."""

    def __init__(self, input_size: int, output_size: int, bias: bool = True,
                 input_is_parallel: bool = False,
                 init_method: Callable = lecun_normal,
                 skip_bias_add: bool = False,
                 sequence_parallel_enabled: bool = False,
                 gradient_accumulation_fusion: bool = False,
                 params_dtype=torch.float32,
                 axis_name: Optional[str] = None, *, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        world = mappings.axis_world(axis_name)[1]
        in_local = divide(input_size, world)
        self.input_size, self.output_size = input_size, output_size
        self.input_is_parallel = input_is_parallel
        self.skip_bias_add = skip_bias_add
        self.sequence_parallel_enabled = sequence_parallel_enabled
        self.gradient_accumulation_fusion = gradient_accumulation_fusion
        self.axis_name = axis_name
        self.weight = _param(init_affine_weight_shard(
            _init_generator(generator), init_method, (output_size, in_local),
            axis_name, params_dtype), device)
        self.bias = _param(torch.zeros(output_size, dtype=params_dtype),
                           device) if bias else None

    def forward(self, x):
        return row_parallel_linear(
            x, self.weight, self.bias, axis_name=self.axis_name,
            input_is_parallel=self.input_is_parallel,
            sequence_parallel_enabled=self.sequence_parallel_enabled,
            skip_bias_add=self.skip_bias_add,
            gradient_accumulation_fusion=self.gradient_accumulation_fusion)


class VocabParallelEmbedding(nn.Module):
    """:func:`vocab_parallel_embedding` over this rank's ``[vocab/tp,
    hidden]`` shard (flax's ``normal(1.0)`` by default). ``device`` None
    is the card."""

    def __init__(self, num_embeddings: int, embedding_dim: int,
                 init_method: Callable = normal_init(1.0),
                 params_dtype=torch.float32,
                 axis_name: Optional[str] = None, *, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        world = mappings.axis_world(axis_name)[1]
        self.num_embeddings, self.embedding_dim = num_embeddings, \
            embedding_dim
        self.axis_name = axis_name
        self.weight = _param(init_affine_weight_shard(
            _init_generator(generator), init_method,
            (divide(num_embeddings, world), embedding_dim), axis_name,
            params_dtype), device)

    def forward(self, ids):
        return vocab_parallel_embedding(ids, self.weight,
                                        axis_name=self.axis_name)
