"""The packed optimizer sweeps: CUDA kernels for Hopper, each beside its
plain PyTorch version (counterpart of ``apex_tpu/ops/packed_optimizer.py``).

The optimizer state lives in contiguous 1-D fp32 buffers laid out by
``multi_tensor_apply.packing.PackSpec`` (whole ``ROW``-element rows).
Each sweep reads every buffer once and writes every output once:

- :func:`packed_adam_apply` — unscale (``inv_scale``), the ``noop``
  overflow flag, Adam or AdamW and the master -> parameter-dtype recast
  in one pass (``csrc/packed_adam.cu``);
- :func:`packed_sgd_apply` — momentum SGD with dampening, nesterov and
  weight decay before or after the momentum (``csrc/packed_sgd.cu``);
- :func:`packed_row_reduce` — per-row sum of squares or max |x| of
  ``x * inv_scale`` (``csrc/packed_lamb.cu``), under
  :func:`multi_tensor_l2norm_flat`;
- :func:`packed_lamb_stage1` / :func:`packed_scale_update` — LAMB's
  moments and unratioed update with per-row norm partials, then the
  per-row trust-ratio apply and recast (``csrc/packed_lamb.cu``);
- :func:`packed_novograd_apply` — NovoGrad's elementwise stage with the
  layer-wise denominator given per row (``csrc/packed_novograd.cu``);
- :func:`multi_tensor_scale_flat` / :func:`multi_tensor_axpby_flat` —
  the ``amp_C`` utility sweeps over a flat buffer of any length, with
  non-finite flags per row or for the whole buffer
  (``csrc/packed_flat.cu``): the loss scaler's unscale and the clip's
  scale.
- :func:`packed_row_stats` — per row, the sum of squares, the largest
  magnitude and the count of non-finite elements of ``x * inv_scale`` in
  one read (``csrc/packed_row_stats.cu``): the numerics monitor's
  observation of a flat gradient buffer.

Each kernel replaces the TPU kernel of the function of the same name;
``*_reference`` is its plain version, written op by op in the order of
the JAX module's XLA fallback. On CUDA tensors a wrapper launches its
kernel (or raises), on CPU tensors it runs the plain version.

In place: where the JAX kernels aliased the moments and the masters to
their outputs, these wrappers update the given buffers where they lie
(on both routes) and return them. Every scalar that a step computes on
the device (``lr``, bias corrections, ``inv_scale``, ``clip``,
``first_run``, ``noop``) may be a device tensor: the kernels read it on
the card, so a step never waits on the host to pass it. With ``noop``
set, a sweep leaves its state buffers as they were and its parameter
output is the recast source.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from .. import _build, _device
from .._build import dtype_code as _code
from ..multi_tensor_apply.packing import DEFAULT_CHUNK, ROW, _round_up


def _scalar(x, device) -> torch.Tensor:
    """A python number or a 0-dim tensor as a 0-dim fp32 tensor on
    ``device``, with no host read and no copy from the host (a number
    becomes a fill on the device)."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=torch.float32).reshape(())
    return torch.full((), float(x), dtype=torch.float32, device=device)


def _rows(kernel: str, n: int) -> int:
    if n % ROW:
        raise ValueError(f"{kernel}: flat buffers must be whole {ROW}-element "
                         f"rows (PackSpec layout), got {n}")
    return n // ROW


def _check_flat(kernel: str, n: int, io=(), f32=()) -> None:
    """``io``: tensors that may be fp32, bf16 or fp16 (gradients,
    parameter outputs); ``f32``: ``(name, tensor)`` fp32 state. Each must be a
    contiguous 1-D buffer of ``n`` elements on a 16-byte boundary."""
    for t in io:
        if t.dtype not in _build.DTYPE_CODE:
            raise TypeError(f"{kernel} kernel takes f32/bf16/f16 gradients "
                            f"and parameters, got {t.dtype}")
    for name, t in f32:
        if t.dtype != torch.float32:
            raise ValueError(f"{kernel}: {name} must be fp32, got {t.dtype}")
    for t in (*io, *(t for _, t in f32)):
        if t.shape != (n,) or not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{kernel} kernel needs contiguous 1-D 16-byte "
                             f"aligned buffers of {n} elements, got "
                             f"{tuple(t.shape)}")


def _noop_ptr(noop: Optional[torch.Tensor]):
    return None if noop is None else noop.data_ptr()


def _skip(noop, dev) -> Optional[torch.Tensor]:
    return None if noop is None else _scalar(noop, dev) >= 0.5


def packed_adam_reference(flat_g, flat_m, flat_v, flat_src, *, param_dtype,
                          lr, bc1, bc2, inv_scale=1.0, noop=None,
                          beta1=0.9, beta2=0.999, eps=1e-8, wd=0.0,
                          adam_w_mode=True):
    """Plain version: ``(p_out, new_m, new_v, new_master)`` as new
    tensors, one rounded fp32 operation per elementwise op (the JAX
    module's XLA-fallback math)."""
    dev = flat_g.device
    g = flat_g.float() * _scalar(inv_scale, dev)
    p32 = flat_src.float()
    if not adam_w_mode and wd != 0.0:
        g = g + wd * p32
    new_m = beta1 * flat_m + (1.0 - beta1) * g
    new_v = beta2 * flat_v + ((1.0 - beta2) * g) * g
    u = (new_m / _scalar(bc1, dev)) / (
        torch.sqrt(new_v / _scalar(bc2, dev)) + eps)
    if adam_w_mode and wd != 0.0:
        u = u + wd * p32
    new_p = p32 - _scalar(lr, dev) * u
    skip = _skip(noop, dev)
    if skip is not None:
        new_p = torch.where(skip, p32, new_p)
        new_m = torch.where(skip, flat_m, new_m)
        new_v = torch.where(skip, flat_v, new_v)
    return new_p.to(param_dtype), new_m, new_v, new_p


def _launch(flat_g, flat_m, flat_v, flat_src, p_out, lr, bc1, bc2, inv,
            noop, beta1, beta2, eps, wd, adam_w_mode, write_mv,
            write_master):
    n = flat_g.numel()
    _rows("packed_adam", n)
    _check_flat("packed_adam", n, io=(flat_g, p_out),
                f32=(("m", flat_m), ("v", flat_v), ("src", flat_src)))
    dev = flat_g.device
    lib = _build.kernels()
    rc = lib.apex_packed_adam(
        flat_g.data_ptr(), flat_m.data_ptr(), flat_v.data_ptr(),
        flat_src.data_ptr(), p_out.data_ptr(), lr.data_ptr(),
        bc1.data_ptr(), bc2.data_ptr(), inv.data_ptr(), _noop_ptr(noop), n,
        beta1, 1.0 - beta1, beta2, 1.0 - beta2, eps, wd, int(adam_w_mode),
        int(write_mv), int(write_master), _code(flat_g),
        _code(p_out), dev.index,
        _build.current_stream(dev))
    _build.check(rc, "packed_adam")
    _device.LAUNCHES["packed_adam"] += 1


def packed_adam_apply(flat_g: torch.Tensor, flat_m: torch.Tensor,
                      flat_v: torch.Tensor, flat_src: torch.Tensor, *,
                      param_dtype: torch.dtype, lr, bc1, bc2,
                      inv_scale=1.0, noop=None, beta1: float = 0.9,
                      beta2: float = 0.999, eps: float = 1e-8,
                      wd: float = 0.0, adam_w_mode: bool = True,
                      write_mv: bool = True, write_master: bool = True,
                      chunk_size: int = DEFAULT_CHUNK
                      ) -> Tuple[torch.Tensor, Optional[torch.Tensor],
                                 Optional[torch.Tensor],
                                 Optional[torch.Tensor]]:
    """One fused pass: unscale + Adam/AdamW + master -> param recast.

    Returns ``(p_out, m | None, v | None, master | None)``; m, v (when
    ``write_mv``) and the fp32 source (when ``write_master``) are the
    given buffers, updated in place. ``write_mv=False`` is the fork's
    ``no_update_mv`` mode: m and v only feed this step's update. With
    ``noop`` true every output equals its input (``p_out`` =
    recast(src)); ``noop`` is read on the device. ``chunk_size`` is
    validated (:func:`_chunk`) and changes nothing."""
    _chunk(chunk_size)
    dev = flat_g.device
    if _device.kernel_route(flat_g, flat_m, flat_v, flat_src):
        p_out = torch.empty(flat_g.numel(), dtype=param_dtype, device=dev)
        _launch(flat_g.contiguous(), flat_m, flat_v, flat_src, p_out,
                _scalar(lr, dev), _scalar(bc1, dev), _scalar(bc2, dev),
                _scalar(inv_scale, dev),
                None if noop is None else _scalar(noop, dev), beta1, beta2,
                eps, wd, adam_w_mode, write_mv, write_master)
    else:
        p_out, new_m, new_v, new_p = packed_adam_reference(
            flat_g, flat_m, flat_v, flat_src, param_dtype=param_dtype,
            lr=lr, bc1=bc1, bc2=bc2, inv_scale=inv_scale, noop=noop,
            beta1=beta1, beta2=beta2, eps=eps, wd=wd,
            adam_w_mode=adam_w_mode)
        if write_mv:
            flat_m.copy_(new_m)
            flat_v.copy_(new_v)
        if write_master:
            flat_src.copy_(new_p)
    return (p_out, flat_m if write_mv else None,
            flat_v if write_mv else None,
            flat_src if write_master else None)


# ---------------------------------------------------------------------------
# momentum SGD
# ---------------------------------------------------------------------------

def packed_sgd_reference(flat_g, flat_buf, flat_src, *, param_dtype, lr,
                         first_run, inv_scale=1.0, noop=None,
                         momentum=0.0, dampening=0.0, nesterov=False,
                         wd=0.0, wd_after_momentum=False):
    """Plain version: ``(p_out, new_buf, new_master)`` as new tensors, in
    the JAX module's XLA-fallback order."""
    dev = flat_g.device
    g = flat_g.float() * _scalar(inv_scale, dev)
    p32 = flat_src.float()
    d_p = g
    if wd != 0.0 and not wd_after_momentum:
        d_p = d_p + wd * p32
    if momentum != 0.0:
        new_buf = torch.where(_scalar(first_run, dev) >= 0.5, d_p,
                              momentum * flat_buf + (1.0 - dampening) * d_p)
        d_p = d_p + momentum * new_buf if nesterov else new_buf
    else:
        new_buf = flat_buf
    if wd != 0.0 and wd_after_momentum:
        d_p = d_p + wd * p32
    new_p = p32 - _scalar(lr, dev) * d_p
    skip = _skip(noop, dev)
    if skip is not None:
        new_p = torch.where(skip, p32, new_p)
        new_buf = torch.where(skip, flat_buf, new_buf)
    return new_p.to(param_dtype), new_buf, new_p


def packed_sgd_apply(flat_g: torch.Tensor, flat_buf: torch.Tensor,
                     flat_src: torch.Tensor, *, param_dtype: torch.dtype, lr,
                     first_run, inv_scale=1.0, noop=None,
                     momentum: float = 0.0, dampening: float = 0.0,
                     nesterov: bool = False, wd: float = 0.0,
                     wd_after_momentum: bool = False,
                     write_master: bool = True,
                     chunk_size: int = DEFAULT_CHUNK
                     ) -> Tuple[torch.Tensor, torch.Tensor,
                                Optional[torch.Tensor]]:
    """One fused pass of momentum SGD (``multi_tensor_sgd_kernel.cu``'s
    4-list variant). Returns ``(p_out, buf, master | None)``: the
    momentum buffer (when ``momentum != 0``) and the fp32 source (when
    ``write_master``) are the given buffers, updated in place.
    ``first_run`` (the step count is 0) materialises the buffer as the
    gradient; it and ``noop`` are read on the device. ``chunk_size`` is
    validated (:func:`_chunk`) and changes nothing."""
    _chunk(chunk_size)
    dev = flat_g.device
    if _device.kernel_route(flat_g, flat_buf, flat_src):
        n = flat_g.numel()
        _rows("packed_sgd", n)
        flat_g = flat_g.contiguous()
        p_out = torch.empty(n, dtype=param_dtype, device=dev)
        _check_flat("packed_sgd", n, io=(flat_g, p_out),
                    f32=(("buf", flat_buf), ("src", flat_src)))
        lr, first, inv = (_scalar(x, dev) for x in (lr, first_run,
                                                    inv_scale))
        noop = None if noop is None else _scalar(noop, dev)
        rc = _build.kernels().apex_packed_sgd(
            flat_g.data_ptr(), flat_buf.data_ptr(), flat_src.data_ptr(),
            p_out.data_ptr(), lr.data_ptr(), first.data_ptr(),
            inv.data_ptr(), _noop_ptr(noop), n, momentum, 1.0 - dampening,
            wd, int(nesterov), int(wd_after_momentum), int(write_master),
            _code(flat_g), _code(p_out), dev.index,
            _build.current_stream(dev))
        _build.check(rc, "packed_sgd")
        _device.LAUNCHES["packed_sgd"] += 1
    else:
        p_out, new_buf, new_p = packed_sgd_reference(
            flat_g, flat_buf, flat_src, param_dtype=param_dtype, lr=lr,
            first_run=first_run, inv_scale=inv_scale, noop=noop,
            momentum=momentum, dampening=dampening, nesterov=nesterov,
            wd=wd, wd_after_momentum=wd_after_momentum)
        if momentum != 0.0:
            flat_buf.copy_(new_buf)
        if write_master:
            flat_src.copy_(new_p)
    return p_out, flat_buf, flat_src if write_master else None


# ---------------------------------------------------------------------------
# LAMB: the row reduce and the two stages
# ---------------------------------------------------------------------------

def packed_row_reduce_reference(flat, *, op="sqsum", inv_scale=1.0):
    """Plain version of :func:`packed_row_reduce`."""
    x = flat.reshape(-1, ROW).float() * _scalar(inv_scale, flat.device)
    return (x * x).sum(dim=1) if op == "sqsum" else x.abs().amax(dim=1)


def packed_row_reduce(flat: torch.Tensor, *, op: str = "sqsum",
                      inv_scale=1.0, chunk_size: int = DEFAULT_CHUNK
                      ) -> torch.Tensor:
    """Per-ROW reduction of ``flat * inv_scale`` in one sweep
    (``multi_tensor_l2norm_kernel.cu``'s per-chunk stage): ``sqsum``
    (sum of squares, the partials of L2 norms) or ``maxabs`` (max |x|; a
    NaN row gives NaN). Returns fp32 ``(rows,)``. The kernel's row sums
    take one fixed order, so they are the same from run to run.
    ``chunk_size`` is validated (:func:`_chunk`) and changes nothing."""
    _chunk(chunk_size)
    if op not in ("sqsum", "maxabs"):
        raise ValueError(f"unknown row reduction {op!r}")
    if not _device.kernel_route(flat):
        return packed_row_reduce_reference(flat, op=op, inv_scale=inv_scale)
    dev = flat.device
    rows = _rows("packed_row_reduce", flat.numel())
    flat = flat.contiguous()
    _check_flat("packed_row_reduce", flat.numel(), io=(flat,))
    out = torch.empty(rows, dtype=torch.float32, device=dev)
    inv = _scalar(inv_scale, dev)
    rc = _build.kernels().apex_packed_row_reduce(
        flat.data_ptr(), out.data_ptr(), inv.data_ptr(), rows,
        int(op == "maxabs"), _code(flat), dev.index,
        _build.current_stream(dev))
    _build.check(rc, "packed_row_reduce")
    _device.LAUNCHES["packed_row_reduce"] += 1
    return out


def multi_tensor_l2norm_flat(flat: torch.Tensor, *, inv_scale=1.0,
                             chunk_size: int = DEFAULT_CHUNK
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Global L2 norm of ``flat * inv_scale`` (any length, zero-padded to
    whole rows) in one sweep. Returns ``(norm, row_sq)``: the per-ROW
    partials of the input's rows, which a segmented sum over
    ``PackSpec.row_segments`` turns into per-tensor norms.
    ``chunk_size`` is validated (:func:`_chunk`) and changes nothing."""
    _chunk(chunk_size)
    n = flat.numel()
    rows = -(-n // ROW)
    if rows * ROW != n:
        flat = torch.cat([flat, flat.new_zeros(rows * ROW - n)])
    row_sq = packed_row_reduce(flat, op="sqsum", inv_scale=inv_scale)
    return torch.sqrt(row_sq.sum()), row_sq


multi_tensor_l2norm_flat.accepts_chunk_size = True


def packed_lamb_stage1_reference(flat_g, flat_m, flat_v, flat_src, *, clip,
                                 bc1, bc2, inv_scale=1.0, noop=None,
                                 beta1=0.9, beta2=0.999, beta3=0.1, eps=1e-6,
                                 wd=0.01, adam_w_mode=True):
    """Plain version: ``(u, new_m, new_v, row_u_sq, row_p_sq)`` as new
    tensors, in the JAX module's XLA-fallback order."""
    dev = flat_g.device
    g = flat_g.float() * _scalar(inv_scale, dev) / _scalar(clip, dev)
    p32 = flat_src.float()
    if not adam_w_mode and wd != 0.0:
        g = g + wd * p32
    new_m = beta1 * flat_m + beta3 * g
    new_v = beta2 * flat_v + (1.0 - beta2) * g * g
    u = (new_m / _scalar(bc1, dev)) / (
        torch.sqrt(new_v / _scalar(bc2, dev)) + eps)
    if adam_w_mode and wd != 0.0:
        u = u + wd * p32
    skip = _skip(noop, dev)
    if skip is not None:
        new_m = torch.where(skip, flat_m, new_m)
        new_v = torch.where(skip, flat_v, new_v)
    u2 = (u.reshape(-1, ROW) ** 2).sum(dim=1)
    p2 = (p32.reshape(-1, ROW) ** 2).sum(dim=1)
    return u, new_m, new_v, u2, p2


def packed_lamb_stage1(flat_g: torch.Tensor, flat_m: torch.Tensor,
                       flat_v: torch.Tensor, flat_src: torch.Tensor, *,
                       clip, bc1, bc2, inv_scale=1.0, noop=None,
                       beta1: float = 0.9, beta2: float = 0.999,
                       beta3: float = 0.1, eps: float = 1e-6,
                       wd: float = 0.01, adam_w_mode: bool = True,
                       chunk_size: int = DEFAULT_CHUNK):
    """LAMB stage 1 (``multi_tensor_lamb.cu`` stage 1 and the per-tensor
    norm kernel, fused): moments and the unratioed update in one sweep,
    with per-ROW sums of squares of the update and of the fp32 source —
    a segmented sum over ``PackSpec.row_segments`` turns those into the
    trust ratios' norms. Returns ``(u, m, v, row_u_sq, row_p_sq)``: u a
    new buffer, m and v the given ones, updated in place unless
    ``noop``. ``chunk_size`` is validated (:func:`_chunk`) and changes
    nothing."""
    _chunk(chunk_size)
    dev = flat_g.device
    if not _device.kernel_route(flat_g, flat_m, flat_v, flat_src):
        u, new_m, new_v, u2, p2 = packed_lamb_stage1_reference(
            flat_g, flat_m, flat_v, flat_src, clip=clip, bc1=bc1, bc2=bc2,
            inv_scale=inv_scale, noop=noop, beta1=beta1, beta2=beta2,
            beta3=beta3, eps=eps, wd=wd, adam_w_mode=adam_w_mode)
        flat_m.copy_(new_m)
        flat_v.copy_(new_v)
        return u, flat_m, flat_v, u2, p2
    n = flat_g.numel()
    rows = _rows("packed_lamb_stage1", n)
    flat_g = flat_g.contiguous()
    u = torch.empty(n, dtype=torch.float32, device=dev)
    _check_flat("packed_lamb_stage1", n, io=(flat_g,),
                f32=(("m", flat_m), ("v", flat_v), ("src", flat_src),
                     ("u", u)))
    row_u = torch.empty(rows, dtype=torch.float32, device=dev)
    row_p = torch.empty(rows, dtype=torch.float32, device=dev)
    inv, clip, bc1, bc2 = (_scalar(x, dev) for x in (inv_scale, clip, bc1,
                                                     bc2))
    noop = None if noop is None else _scalar(noop, dev)
    rc = _build.kernels().apex_packed_lamb_stage1(
        flat_g.data_ptr(), flat_m.data_ptr(), flat_v.data_ptr(),
        flat_src.data_ptr(), u.data_ptr(), row_u.data_ptr(),
        row_p.data_ptr(), inv.data_ptr(), clip.data_ptr(), bc1.data_ptr(),
        bc2.data_ptr(), _noop_ptr(noop), rows, beta1, beta2, beta3,
        1.0 - beta2, eps, wd, int(adam_w_mode), _code(flat_g),
        dev.index, _build.current_stream(dev))
    _build.check(rc, "packed_lamb_stage1")
    _device.LAUNCHES["packed_lamb_stage1"] += 1
    return u, flat_m, flat_v, row_u, row_p


def packed_scale_update_reference(flat_u, flat_src, row_coef, *,
                                  param_dtype, lr, noop=None):
    """Plain version: ``(p_out, new_master)`` as new tensors."""
    dev = flat_u.device
    coef = torch.repeat_interleave(row_coef, ROW)
    p32 = flat_src.float()
    new_p = p32 - _scalar(lr, dev) * coef * flat_u
    skip = _skip(noop, dev)
    if skip is not None:
        new_p = torch.where(skip, p32, new_p)
    return new_p.to(param_dtype), new_p


def packed_scale_update(flat_u: torch.Tensor, flat_src: torch.Tensor,
                        row_coef: torch.Tensor, *, param_dtype: torch.dtype,
                        lr, noop=None, write_master: bool = True,
                        chunk_size: int = DEFAULT_CHUNK
                        ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """LAMB stage 2 (``multi_tensor_lamb.cu`` stage 2): ``p32 - (lr *
    coef[row]) * u`` with one coefficient per ROW (the trust ratios),
    recast to ``param_dtype`` in the same sweep. Returns ``(p_out,
    master | None)``: the fp32 source, updated in place when
    ``write_master`` (and not ``noop``). ``chunk_size`` is validated
    (:func:`_chunk`) and changes nothing."""
    _chunk(chunk_size)
    dev = flat_u.device
    if not _device.kernel_route(flat_u, flat_src, row_coef):
        p_out, new_p = packed_scale_update_reference(
            flat_u, flat_src, row_coef, param_dtype=param_dtype, lr=lr,
            noop=noop)
        if write_master:
            flat_src.copy_(new_p)
        return p_out, flat_src if write_master else None
    n = flat_u.numel()
    rows = _rows("packed_scale_update", n)
    p_out = torch.empty(n, dtype=param_dtype, device=dev)
    _check_flat("packed_scale_update", n, io=(p_out,),
                f32=(("u", flat_u), ("src", flat_src)))
    if row_coef.dtype != torch.float32 or row_coef.shape != (rows,) or \
            not row_coef.is_contiguous():
        raise ValueError(f"packed_scale_update: row_coef must be contiguous "
                         f"fp32 ({rows},), got {row_coef.dtype} "
                         f"{tuple(row_coef.shape)}")
    lr = _scalar(lr, dev)
    noop = None if noop is None else _scalar(noop, dev)
    rc = _build.kernels().apex_packed_scale_update(
        flat_u.data_ptr(), flat_src.data_ptr(), row_coef.data_ptr(),
        p_out.data_ptr(), lr.data_ptr(), _noop_ptr(noop), rows,
        int(write_master), _code(p_out), dev.index,
        _build.current_stream(dev))
    _build.check(rc, "packed_scale_update")
    _device.LAUNCHES["packed_scale_update"] += 1
    return p_out, flat_src if write_master else None


# ---------------------------------------------------------------------------
# NovoGrad
# ---------------------------------------------------------------------------

def packed_novograd_reference(flat_g, flat_m, flat_src, row_denom, *,
                              param_dtype, lr, bc1, inv_scale=1.0, noop=None,
                              beta1=0.95, beta3=0.05, wd=0.0,
                              reg_inside_moment=False):
    """Plain version: ``(p_out, new_m)`` as new tensors, in the JAX
    module's XLA-fallback order."""
    dev = flat_g.device
    g = flat_g.float() * _scalar(inv_scale, dev)
    p32 = flat_src.float()
    moment_in = g / torch.repeat_interleave(row_denom, ROW)
    if wd != 0.0 and reg_inside_moment:
        moment_in = moment_in + wd * p32
    new_m = beta1 * flat_m + beta3 * moment_in
    u = new_m / _scalar(bc1, dev)
    if wd != 0.0 and not reg_inside_moment:
        u = u + wd * p32
    new_p = p32 - _scalar(lr, dev) * u
    skip = _skip(noop, dev)
    if skip is not None:
        new_p = torch.where(skip, p32, new_p)
        new_m = torch.where(skip, flat_m, new_m)
    return new_p.to(param_dtype), new_m


def packed_novograd_apply(flat_g: torch.Tensor, flat_m: torch.Tensor,
                          flat_src: torch.Tensor, row_denom: torch.Tensor, *,
                          param_dtype: torch.dtype, lr, bc1, inv_scale=1.0,
                          noop=None, beta1: float = 0.95, beta3: float = 0.05,
                          wd: float = 0.0, reg_inside_moment: bool = False,
                          chunk_size: int = DEFAULT_CHUNK
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """NovoGrad's elementwise stage (``multi_tensor_novograd.cu``) with the
    layer-wise denominator ``row_denom`` (fp32 ``(rows,)``: sqrt of the
    leaf's second moment plus eps) given per ROW. Returns ``(p_out, m)``:
    ``p_out`` a new buffer in ``param_dtype``, ``m`` the given buffer,
    updated in place unless ``noop``; ``flat_src`` is read only. ``lr``,
    ``bc1``, ``inv_scale`` and ``noop`` are read on the device.
    ``chunk_size`` is validated (:func:`_chunk`) and changes nothing."""
    _chunk(chunk_size)
    dev = flat_g.device
    if not _device.kernel_route(flat_g, flat_m, flat_src, row_denom):
        p_out, new_m = packed_novograd_reference(
            flat_g, flat_m, flat_src, row_denom, param_dtype=param_dtype,
            lr=lr, bc1=bc1, inv_scale=inv_scale, noop=noop, beta1=beta1,
            beta3=beta3, wd=wd, reg_inside_moment=reg_inside_moment)
        flat_m.copy_(new_m)
        return p_out, flat_m
    n = flat_g.numel()
    rows = _rows("packed_novograd", n)
    flat_g = flat_g.contiguous()
    p_out = torch.empty(n, dtype=param_dtype, device=dev)
    _check_flat("packed_novograd", n, io=(flat_g, p_out),
                f32=(("m", flat_m), ("src", flat_src)))
    if row_denom.dtype != torch.float32 or row_denom.shape != (rows,) or \
            not row_denom.is_contiguous():
        raise ValueError(f"packed_novograd: row_denom must be contiguous "
                         f"fp32 ({rows},), got {row_denom.dtype} "
                         f"{tuple(row_denom.shape)}")
    lr, bc1, inv = (_scalar(x, dev) for x in (lr, bc1, inv_scale))
    noop = None if noop is None else _scalar(noop, dev)
    rc = _build.kernels().apex_packed_novograd(
        flat_g.data_ptr(), flat_m.data_ptr(), flat_src.data_ptr(),
        row_denom.data_ptr(), p_out.data_ptr(), lr.data_ptr(),
        bc1.data_ptr(), inv.data_ptr(), _noop_ptr(noop), n, beta1, beta3,
        wd, int(reg_inside_moment), _code(flat_g), _code(p_out),
        dev.index, _build.current_stream(dev))
    _build.check(rc, "packed_novograd")
    _device.LAUNCHES["packed_novograd"] += 1
    return p_out, flat_m


# ---------------------------------------------------------------------------
# the amp_C utility sweeps over flat buffers: scale and axpby
# ---------------------------------------------------------------------------

def _pad_to_rows(flat: torch.Tensor, chunk_size: Optional[int] = None
                 ) -> Tuple[torch.Tensor, int]:
    """Zero-pad a 1-D buffer to a ROW multiple, and further to a chunk
    multiple with ``chunk_size`` (the JAX module's helper: zeros are
    neutral for every op here, finite and scaled to 0). Returns
    ``(padded, n)``."""
    n = flat.shape[0]
    total = _round_up(max(n, 1), ROW)
    if chunk_size:
        total = _round_up(total, _round_up(int(chunk_size), ROW))
    if total != n:
        flat = torch.cat([flat, flat.new_zeros(total - n)])
    return flat, n


def _chunk(chunk_size) -> int:
    """``chunk_size`` read as the JAX module's ``_block_rows`` and
    ``_pad_to_rows`` read it (``int(chunk_size)``), and refused where
    they would divide by zero or pad backwards: it must be at least one
    element. Every sweep of this module takes it (the four flat ops for
    the applier's sake, ``accepts_chunk_size``); their results do not
    depend on it, since the JAX ops cut their outputs back to the
    input's rows and the CUDA sweeps here size their grids from the
    buffer's rows alone."""
    n = int(chunk_size)
    if n < 1:
        raise ValueError(f"chunk_size must be a positive number of "
                         f"elements, got {chunk_size!r}")
    return n


def _flat_dtype(kernel: str, dtype: torch.dtype) -> None:
    if dtype not in _build.DTYPE_CODE:
        raise TypeError(f"{kernel} kernel takes f32/bf16/f16 buffers, got "
                        f"{dtype}")


def packed_row_stats_reference(flat, *, inv_scale=1.0):
    """Plain version of :func:`packed_row_stats`, the JAX module's XLA
    fallback (zero padding to whole rows adds nothing to any of the
    three)."""
    padded, _ = _pad_to_rows(flat)
    x = padded.reshape(-1, ROW).float() * _scalar(inv_scale, flat.device)
    return ((x * x).sum(dim=1), x.abs().amax(dim=1),
            (~torch.isfinite(x)).sum(dim=1, dtype=torch.float32))


def packed_row_stats(flat: torch.Tensor, *, inv_scale=1.0,
                     chunk_size: int = DEFAULT_CHUNK
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(row_sq, row_maxabs, row_nonfinite)`` of ``flat * inv_scale`` in
    ONE sweep over a 1-D buffer of any length: per ROW (the last one cut
    at the buffer's end) the sum of squares, the largest magnitude and the
    exact count of non-finite elements, each fp32 ``(rows,)`` — the
    numerics monitor's observation pass. The reductions are raw: a
    non-finite element makes its row's sum and max nan or inf. A segmented
    sum or max over a ``PackSpec``'s row-aligned leaves turns the rows into
    per-tensor statistics. ``inv_scale`` is read on the device.
    ``chunk_size`` is validated (:func:`_chunk`) and changes nothing."""
    _chunk(chunk_size)
    if not _device.kernel_route(flat):
        return packed_row_stats_reference(flat, inv_scale=inv_scale)
    _flat_dtype("packed_row_stats", flat.dtype)
    dev = flat.device
    n = flat.numel()
    flat = flat.contiguous()
    _check_flat("packed_row_stats", n, io=(flat,))
    out = torch.empty((3, -(-n // ROW)), dtype=torch.float32, device=dev)
    inv = _scalar(inv_scale, dev)
    rc = _build.kernels().apex_packed_row_stats(
        flat.data_ptr(), out[0].data_ptr(), out[1].data_ptr(),
        out[2].data_ptr(), inv.data_ptr(), n, _code(flat), dev.index,
        _build.current_stream(dev))
    _build.check(rc, "packed_row_stats")
    _device.LAUNCHES["packed_row_stats"] += 1
    return out[0], out[1], out[2]


packed_row_stats.accepts_chunk_size = True


def multi_tensor_scale_flat_reference(flat, scale, out_dtype=None, *,
                                      per_row_flags=False):
    """Plain version of :func:`multi_tensor_scale_flat`, the JAX module's
    XLA fallback (the flags of a buffer padded to whole chunks, cut back
    to the input's rows)."""
    out_dtype = out_dtype or flat.dtype
    scale = _scalar(scale, flat.device)
    if not per_row_flags:
        out32 = flat.float() * scale
        return out32.to(out_dtype), ~torch.isfinite(out32).all()
    padded, n = _pad_to_rows(flat, DEFAULT_CHUNK)
    pad32 = padded.float() * scale
    row_bad = ~torch.isfinite(pad32).reshape(-1, ROW).all(dim=1)
    row_bad = row_bad[:-(-n // ROW)]
    return pad32[:n].to(out_dtype), row_bad.any(), row_bad


def multi_tensor_scale_flat(flat: torch.Tensor, scale, out_dtype=None, *,
                            per_row_flags: bool = False,
                            chunk_size: int = DEFAULT_CHUNK):
    """``out = flat * scale`` with non-finite flagging, one sweep over a
    1-D buffer of any length (``csrc/multi_tensor_scale_kernel.cu``).
    Returns ``(out, found_inf)``, or with ``per_row_flags`` ``(out,
    found_inf, row_bad)``: ``row_bad`` bool ``(rows,)`` over the input's
    ROW-sized rows (the last one cut at the input's end), which a
    ``PackSpec``'s row-aligned leaves turn into the non-finite leaves.
    The test is made on the fp32 product, before the cast to
    ``out_dtype`` (default: the input's). ``scale`` is read on the
    device; ``found_inf`` is a 0-dim bool tensor there. ``chunk_size``
    is validated (:func:`_chunk`) and changes nothing."""
    _chunk(chunk_size)
    if not _device.kernel_route(flat):
        return multi_tensor_scale_flat_reference(
            flat, scale, out_dtype, per_row_flags=per_row_flags)
    out_dtype = out_dtype or flat.dtype
    _flat_dtype("scale_flat", flat.dtype)
    _flat_dtype("scale_flat", out_dtype)
    dev = flat.device
    n = flat.numel()
    flat = flat.contiguous()
    out = torch.empty(n, dtype=out_dtype, device=dev)
    _check_flat("scale_flat", n, io=(flat, out))
    found = torch.zeros(1, dtype=torch.uint8, device=dev)
    row_bad = (torch.empty(-(-n // ROW), dtype=torch.uint8, device=dev)
               if per_row_flags else None)
    scale = _scalar(scale, dev)
    rc = _build.kernels().apex_scale_flat(
        flat.data_ptr(), out.data_ptr(), scale.data_ptr(),
        None if row_bad is None else row_bad.data_ptr(), found.data_ptr(),
        n, _code(flat), _code(out), dev.index,
        _build.current_stream(dev))
    _build.check(rc, "scale_flat")
    _device.LAUNCHES["scale_flat"] += 1
    found_inf = found.view(torch.bool).reshape(())
    if not per_row_flags:
        return out, found_inf
    return out, found_inf, row_bad.view(torch.bool)


multi_tensor_scale_flat.accepts_chunk_size = True


def multi_tensor_axpby_flat_reference(a, b, flat_x, flat_y, out_dtype=None):
    """Plain version of :func:`multi_tensor_axpby_flat`."""
    dev = flat_x.device
    out32 = (_scalar(a, dev) * flat_x.float()
             + _scalar(b, dev) * flat_y.float())
    return out32.to(out_dtype or flat_x.dtype), ~torch.isfinite(out32).all()


def multi_tensor_axpby_flat(a, b, flat_x: torch.Tensor,
                            flat_y: torch.Tensor, out_dtype=None, *,
                            chunk_size: int = DEFAULT_CHUNK
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``out = a * x + b * y`` with non-finite flagging, one sweep over
    two 1-D buffers of any (equal) length
    (``csrc/multi_tensor_axpby_kernel.cu``). Returns ``(out,
    found_inf)``; ``out`` in ``out_dtype`` (default: x's), ``a`` and
    ``b`` read on the device. ``chunk_size`` is validated
    (:func:`_chunk`) and changes nothing."""
    _chunk(chunk_size)
    if flat_x.shape != flat_y.shape:
        raise ValueError(f"axpby buffers must match: {tuple(flat_x.shape)} "
                         f"vs {tuple(flat_y.shape)}")
    if not _device.kernel_route(flat_x, flat_y):
        return multi_tensor_axpby_flat_reference(a, b, flat_x, flat_y,
                                                 out_dtype)
    out_dtype = out_dtype or flat_x.dtype
    for dt in (flat_x.dtype, flat_y.dtype, out_dtype):
        _flat_dtype("axpby_flat", dt)
    dev = flat_x.device
    n = flat_x.numel()
    flat_x, flat_y = flat_x.contiguous(), flat_y.contiguous()
    out = torch.empty(n, dtype=out_dtype, device=dev)
    _check_flat("axpby_flat", n, io=(flat_x, flat_y, out))
    found = torch.zeros(1, dtype=torch.uint8, device=dev)
    a, b = _scalar(a, dev), _scalar(b, dev)
    rc = _build.kernels().apex_axpby_flat(
        flat_x.data_ptr(), flat_y.data_ptr(), out.data_ptr(), a.data_ptr(),
        b.data_ptr(), found.data_ptr(), n, _code(flat_x),
        _code(flat_y), _code(out), dev.index,
        _build.current_stream(dev))
    _build.check(rc, "axpby_flat")
    _device.LAUNCHES["axpby_flat"] += 1
    return out, found.view(torch.bool).reshape(())


multi_tensor_axpby_flat.accepts_chunk_size = True
