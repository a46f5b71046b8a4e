"""Packed Adam / AdamW: one sweep over flat buffers per step — a CUDA
kernel for Hopper and its plain PyTorch version (counterpart of
``apex_tpu/ops/packed_optimizer.py``'s ``packed_adam_apply``).

The optimizer state lives in contiguous 1-D fp32 buffers laid out by
``multi_tensor_apply.packing.PackSpec``. One launch reads the gradient,
m, v and the fp32 source (masters) once, and writes the parameter
output, m, v and the masters once: unscale (``inv_scale``), the
``noop`` overflow flag, Adam or AdamW, and the master -> parameter-dtype
recast in one pass. The kernel is ``csrc/packed_adam.cu`` (it replaces
the TPU kernel of ``packed_adam_apply``); :func:`packed_adam_reference`
is the plain version (the JAX module's XLA-fallback math).

In place: where the JAX kernel aliased m, v and the masters to its
outputs, this wrapper updates the given buffers where they lie (on both
routes) and returns them. ``lr``, ``bc1``, ``bc2``, ``inv_scale`` and
``noop`` may be device scalars: the kernel reads them on the card, so a
step never waits on the host to pass them.

The other packed sweeps (SGD, LAMB, NovoGrad, row statistics, scale,
axpby) are not ported yet (ROADMAP.md, queue B).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from .. import _build, _device
from ..multi_tensor_apply.packing import ROW


def _scalar(x, device) -> torch.Tensor:
    """A python number or a 0-dim tensor as a 0-dim fp32 tensor on
    ``device``, with no host read and no copy from the host (a number
    becomes a fill on the device)."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=torch.float32).reshape(())
    return torch.full((), float(x), dtype=torch.float32, device=device)


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
    if noop is not None:
        skip = _scalar(noop, dev) >= 0.5
        new_p = torch.where(skip, p32, new_p)
        new_m = torch.where(skip, flat_m, new_m)
        new_v = torch.where(skip, flat_v, new_v)
    return new_p.to(param_dtype), new_m, new_v, new_p


def _launch(flat_g, flat_m, flat_v, flat_src, p_out, lr, bc1, bc2, inv,
            noop, beta1, beta2, eps, wd, adam_w_mode, write_mv,
            write_master):
    n = flat_g.numel()
    if n % ROW:
        raise ValueError(f"flat buffers must be whole {ROW}-element rows "
                         f"(PackSpec layout), got {n}")
    if flat_g.dtype not in (torch.float32, torch.bfloat16) or \
            p_out.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"packed_adam kernel takes f32/bf16 grads and "
                        f"params, got {flat_g.dtype} / {p_out.dtype}")
    for name, t in (("m", flat_m), ("v", flat_v), ("src", flat_src)):
        if t.dtype != torch.float32 or t.shape != (n,):
            raise ValueError(f"{name} must be fp32 ({n},), got {t.dtype} "
                             f"{tuple(t.shape)}")
    for t in (flat_g, flat_m, flat_v, flat_src, p_out):
        if t.dim() != 1 or not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError("packed_adam kernel needs contiguous 1-D "
                             "16-byte aligned buffers")
    dev = flat_g.device
    lib = _build.kernels()
    rc = lib.apex_packed_adam(
        flat_g.data_ptr(), flat_m.data_ptr(), flat_v.data_ptr(),
        flat_src.data_ptr(), p_out.data_ptr(), lr.data_ptr(),
        bc1.data_ptr(), bc2.data_ptr(), inv.data_ptr(),
        None if noop is None else noop.data_ptr(), n, beta1, 1.0 - beta1,
        beta2, 1.0 - beta2, eps, wd, int(adam_w_mode), int(write_mv),
        int(write_master), int(flat_g.dtype == torch.bfloat16),
        int(p_out.dtype == torch.bfloat16), dev.index,
        _build.current_stream(dev))
    _build.check(rc, "packed_adam")
    _device.LAUNCHES["packed_adam"] += 1


def packed_adam_apply(flat_g: torch.Tensor, flat_m: torch.Tensor,
                      flat_v: torch.Tensor, flat_src: torch.Tensor, *,
                      param_dtype: torch.dtype, lr, bc1, bc2,
                      inv_scale=1.0, noop=None, beta1: float = 0.9,
                      beta2: float = 0.999, eps: float = 1e-8,
                      wd: float = 0.0, adam_w_mode: bool = True,
                      write_mv: bool = True, write_master: bool = True
                      ) -> Tuple[torch.Tensor, Optional[torch.Tensor],
                                 Optional[torch.Tensor],
                                 Optional[torch.Tensor]]:
    """One fused pass: unscale + Adam/AdamW + master -> param recast.

    Returns ``(p_out, m | None, v | None, master | None)``; m, v (when
    ``write_mv``) and the fp32 source (when ``write_master``) are the
    given buffers, updated in place. ``write_mv=False`` is the fork's
    ``no_update_mv`` mode: m and v only feed this step's update. With
    ``noop`` true every output equals its input (``p_out`` =
    recast(src)); ``noop`` is read on the device."""
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
