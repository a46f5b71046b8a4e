"""LayerNorm and RMSNorm forward and backward: CUDA kernels for Hopper and
their plain PyTorch versions (counterpart of ``apex_tpu/ops/layer_norm.py``).

Inputs are viewed as ``[rows, hidden]``; statistics (mean, rstd) are
fp32 per row for any input dtype, the variance is the centred two-pass
form, ``y`` takes the input's dtype and ``dx`` the incoming gradient's.
The kernels are in ``csrc/layer_norm.cu``: the forward replaces the TPU
kernel ``_ln_fwd_pallas``, the backward ``_ln_bwd_pallas``, each launch
planned on the host (:func:`norm_fwd_plan`, :func:`norm_bwd_plan`);
:func:`layer_norm_reference` and :func:`layer_norm_bwd_reference` are
the plain versions.

:func:`layer_norm` is a ``torch.autograd.Function`` that saves ``(x, mu,
rstd)`` as the JAX custom VJP does. Route (``_device.kernel_route``): a
CUDA tensor goes through the kernels, a CPU tensor through the plain
versions. Under ``torch.no_grad`` (serving) only the forward kernel runs.
The forward is the custom op :data:`LAYER_NORM_FWD`, so a selective
recompute policy can keep its outputs instead of replaying it.

RMSNorm is the same in both respects: :func:`rms_norm` over the kernels
that replace ``_rms_fwd_pallas`` and ``_rms_bwd_pallas`` (same source),
with :func:`rms_norm_reference` and :func:`rms_norm_bwd_reference`, its
forward the custom op :data:`RMS_NORM_FWD`. With ``memory_efficient``
either norm saves its output instead of its input, and the backward
rebuilds x-hat from it in fp32 (``(y - b) / w``, ``w`` clamped away from
0 with its sign kept) and hands it to the backward kernel as x-hat
(``x_is_xhat``). The backward kernels take any width.
"""
from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Tuple

import torch

from .. import _build, _device
from .._build import dtype_code as _code


def layer_norm_reference(x2d: torch.Tensor, w: torch.Tensor,
                         b: torch.Tensor, eps: float
                         ) -> Tuple[torch.Tensor, torch.Tensor,
                                    torch.Tensor]:
    """Plain version: ``(y, mu [rows, 1], rstd [rows, 1])`` with fp32
    statistics — the math of ``_ln_fwd_xla`` / the TPU kernel."""
    x = x2d.float()
    mu = x.mean(dim=1, keepdim=True)
    xc = x - mu
    var = (xc * xc).mean(dim=1, keepdim=True)
    rstd = torch.rsqrt(var + eps)
    y = xc * rstd * w.float() + b.float()
    return y.to(x2d.dtype), mu, rstd


def layer_norm_bwd_reference(dy2d: torch.Tensor, x2d: torch.Tensor,
                             mu: torch.Tensor, rstd: torch.Tensor,
                             w: torch.Tensor, x_is_xhat: bool = False
                             ) -> Tuple[torch.Tensor, torch.Tensor,
                                        torch.Tensor]:
    """Plain version of the backward: ``(dx, dgamma, dbeta)``, dx in
    dy's dtype and the parameter gradients fp32 ``[hidden]`` — the math
    of ``_ln_bwd_xla`` / ``_ln_bwd_kernel``. With ``x_is_xhat``, ``x2d``
    is the normalized input itself (``mu`` is not read)."""
    dy = dy2d.float()
    xhat = x2d.float() if x_is_xhat else (x2d.float() - mu) * rstd
    wdy = dy * w.float()
    c1 = (xhat * wdy).mean(dim=1, keepdim=True)
    c2 = wdy.mean(dim=1, keepdim=True)
    dx = ((wdy - xhat * c1 - c2) * rstd).to(dy2d.dtype)
    return dx, (dy * xhat).sum(dim=0), dy.sum(dim=0)


def rms_norm_reference(x2d: torch.Tensor, w: torch.Tensor, eps: float
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the RMSNorm forward: ``(y, rstd [rows, 1])``, the
    statistic fp32 — the math of ``_rms_fwd_xla`` / the TPU kernel."""
    x = x2d.float()
    rstd = torch.rsqrt((x * x).mean(dim=1, keepdim=True) + eps)
    return (x * rstd * w.float()).to(x2d.dtype), rstd


def rms_norm_bwd_reference(dy2d: torch.Tensor, x2d: torch.Tensor,
                           rstd: torch.Tensor, w: torch.Tensor,
                           x_is_xhat: bool = False
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the RMSNorm backward: ``(dx, dgamma)``, dx in dy's
    dtype and dgamma fp32 ``[hidden]`` — the math of ``_rms_bwd_xla``."""
    dy = dy2d.float()
    xhat = x2d.float() if x_is_xhat else x2d.float() * rstd
    wdy = dy * w.float()
    c1 = (xhat * wdy).mean(dim=1, keepdim=True)
    dx = ((wdy - xhat * c1) * rstd).to(dy2d.dtype)
    return dx, (dy * xhat).sum(dim=0)


#: the backward kernels' register tier: rows up to this width are walked by
#: teams of warps that hold the row in registers (``csrc/layer_norm.cu``,
#: ``kTier``); wider rows by a block a row
BWD_TIER = 8192
#: warps of a block of the team kernel, and of the column pass
_BWD_WARPS = 8
#: columns of a column-pass block, and the row groups of its warps
_BWD_COLS = 8
#: quads of 4 columns a lane holds at most where wider teams can take the
#: row: at [8192, 1024] fp32 teams of 4 warps at 2 quads ran the fastest of
#: 1-4 warps (H100 80GB HBM3, 700 W), their registers letting 3 blocks an SM
_BWD_LANE_QUADS = 2
#: team-kernel blocks an SM holds at once, by quads a lane: its registers
#: on sm_90a (ptxas: 47-63 at 1 quad, 64-77 at 2, 113-127 at 4, 184-226
#: at 8) against 65,536 an SM at 256 threads a block
_BWD_RESIDENT = {1: 4, 2: 3, 4: 2, 8: 1}


class NormBwdPlan(NamedTuple):
    """The backward kernels' first launch: ``blocks`` blocks (one partial
    row each) of ``rows_per_block`` contiguous rows; a team of
    ``warps_per_row`` warps a row, each lane owning ``quads`` quads of 4
    columns (``warps_per_row`` 0: rows wider than :data:`BWD_TIER`, a block
    a row)."""
    blocks: int
    rows_per_block: int
    warps_per_row: int
    quads: int


def _pow2_at_least(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


def norm_bwd_plan(rows: int, hidden: int, n_sms: int) -> NormBwdPlan:
    """Plan of the backward kernels for ``rows >= 1`` rows of ``hidden``
    columns on a card of ``n_sms`` SMs; it depends on nothing else, so
    one card sums in one order every time. Up to :data:`BWD_TIER`
    columns a lane holds at most :data:`_BWD_LANE_QUADS` quads while a
    team of 8 warps can take the row, more (up to 8, 32 columns) past
    that; the rows are shared by one wave of blocks, as many an SM as
    the kernel's registers let stay resident, every block at least one
    row. Wider rows take ``rows / 256`` rows a block (1 to 32), so that a
    few wide rows still fill the card."""
    if hidden > BWD_TIER:
        rpb = min(32, max(1, rows // 256))
        return NormBwdPlan(-(-rows // rpb), rpb, 0, 0)
    quads = min(_BWD_LANE_QUADS, _pow2_at_least(-(-hidden // 128)))
    wpr = _pow2_at_least(-(-hidden // (128 * quads)))
    if wpr > _BWD_WARPS:  # 8 warps a row, each lane holding more quads
        quads = _pow2_at_least(-(-hidden // (128 * _BWD_WARPS)))
        wpr = _BWD_WARPS
    teams = _BWD_WARPS // wpr
    blocks = max(1, min(_BWD_RESIDENT[quads] * n_sms, -(-rows // teams)))
    rpb = -(-rows // blocks)
    return NormBwdPlan(-(-rows // rpb), rpb, wpr, quads)


#: the forward team kernels' widest row (``csrc/layer_norm.cu``,
#: ``kFwdTier``): 8 warps of 32 lanes holding at most
#: :data:`_FWD_LANE_COLS` columns each; wider rows take a block a row
FWD_TIER = 8192
#: warps of a forward team-kernel block
_FWD_WARPS = 8
#: columns a lane holds at most (``kLaneCols``): 8 vectors of 16 bytes in
#: fp32, 4 in bf16 / fp16. A lane holds as many before wider teams take
#: the row: at [8192, 1024] a warp a row at 32 columns a lane ran the
#: fastest one-wave LayerNorm plan in bf16 and came within 4 % of the
#: fastest plan of any team shape (1-8 warps, 4-32 columns) in the other
#: cases, without a prefetch of the next row (H100 80GB HBM3, 700 W;
#: tools/torch_norm_fwd_sweep.py)
_FWD_LANE_COLS = 32
#: forward team-kernel blocks an SM holds at once, by (element bytes,
#: vectors a lane), from the kernels' registers on sm_90a (ptxas) against
#: 65,536 an SM at 256 threads a block. LayerNorm: fp32 39 / 48 / 64 / 123
#: at 1 / 2 / 4 / 8 vectors; bf16 48 / 79 / 127 and fp16 48 / 64 / 117 at
#: 1 / 2 / 4.
_FWD_RESIDENT = {(4, 1): 6, (4, 2): 5, (4, 4): 4, (4, 8): 2,
                 (2, 1): 5, (2, 2): 3, (2, 4): 2}
#: as :data:`_FWD_RESIDENT` for RMSNorm (no mean, no b): fp32 30 / 38 /
#: 42 / 76; bf16 32 / 48 / 80 and fp16 32 / 40 / 60
_RMS_FWD_RESIDENT = {(4, 1): 8, (4, 2): 6, (4, 4): 5, (4, 8): 3,
                     (2, 1): 8, (2, 2): 5, (2, 4): 3}


class NormFwdPlan(NamedTuple):
    """The forward kernels' launch: ``blocks`` blocks of ``rows_per_block``
    contiguous rows; a team of ``warps_per_row`` warps a row, each lane
    holding ``vecs`` vectors of 16 bytes (8 columns in bf16 / fp16, 4 in
    fp32; ``warps_per_row`` 0: rows wider than :data:`FWD_TIER`, a block
    a row)."""
    blocks: int
    rows_per_block: int
    warps_per_row: int
    vecs: int


@functools.lru_cache(maxsize=1024)
def norm_fwd_plan(rows: int, hidden: int, n_sms: int, elem_bytes: int,
                  rms: bool = False) -> NormFwdPlan:
    """Plan of the forward kernels (RMSNorm's with ``rms``) for ``rows >=
    1`` rows of ``hidden`` columns of ``elem_bytes`` bytes (4, or 2 for
    bf16 / fp16) on a card of ``n_sms`` SMs; it depends on nothing else,
    and is cached, since every layer of a model asks for the same few.
    Up to :data:`FWD_TIER` columns the narrowest team whose lanes hold at
    most :data:`_FWD_LANE_COLS` columns takes a row (a warp up to 1024
    columns), widened while its blocks would not give every SM one (few
    rows: the serving steps' 8 and 64), each lane as few vectors as cover
    the row; the rows are shared by one wave of blocks, as many an SM as
    the kernel's registers let stay resident, every block at least one
    row. Wider rows take a block each."""
    if hidden > FWD_TIER:
        return NormFwdPlan(rows, 1, 0, 0)
    most = _FWD_LANE_COLS * elem_bytes // 16  # vectors a lane at most
    nvec = -(-hidden // (16 // elem_bytes))  # 16-byte vectors of a row
    wpr = _pow2_at_least(-(-nvec // (32 * most)))
    while wpr < _FWD_WARPS and 32 * wpr < nvec and \
            -(-rows // (_FWD_WARPS // wpr)) < n_sms:
        wpr *= 2
    vecs = _pow2_at_least(-(-nvec // (32 * wpr)))
    teams = _FWD_WARPS // wpr
    resident = (_RMS_FWD_RESIDENT if rms else _FWD_RESIDENT)[
        (elem_bytes, vecs)]
    blocks = max(1, min(resident * n_sms, -(-rows // teams)))
    rpb = -(-rows // blocks)
    return NormFwdPlan(-(-rows // rpb), rpb, wpr, vecs)


def _norm_bwd_partitioned(dy2d: torch.Tensor, x2d: torch.Tensor,
                          mu: Optional[torch.Tensor], rstd: torch.Tensor,
                          w: torch.Tensor, plan: NormBwdPlan,
                          x_is_xhat: bool = False):
    """Plain model of the backward kernels under ``plan``: dx as the plain
    backward; each parameter gradient summed in the kernels' order. A
    block's team ``t`` adds its rows ``r0 + t, r0 + t + teams, ...`` in
    turn, the teams' sums are added in team order into the block's partial
    row; in the column pass row group ``g`` of warp ``k`` adds the partial
    rows ``4 k + g``, then every 32nd, a warp's groups add as ``(g0 + g1)
    + (g2 + g3)`` and the warps' sums in warp order. ``mu`` None is
    RMSNorm: ``(dx, dgamma)``; else ``(dx, dgamma, dbeta)``."""
    if mu is None:
        dx, _ = rms_norm_bwd_reference(dy2d, x2d, rstd, w, x_is_xhat)
        xhat = x2d.float() if x_is_xhat else x2d.float() * rstd
    else:
        dx, _, _ = layer_norm_bwd_reference(dy2d, x2d, mu, rstd, w,
                                            x_is_xhat)
        xhat = x2d.float() if x_is_xhat else (x2d.float() - mu) * rstd
    dy = dy2d.float()
    rows, hidden = dy.shape
    teams = 1 if plan.warps_per_row == 0 else \
        _BWD_WARPS // plan.warps_per_row
    grads = []
    for term in [dy * xhat] + ([] if mu is None else [dy]):
        part = term.new_zeros(plan.blocks, hidden)
        for b in range(plan.blocks):
            r0 = b * plan.rows_per_block
            r1 = min(rows, r0 + plan.rows_per_block)
            for t in range(teams):
                s = term.new_zeros(hidden)
                for r in range(r0 + t, r1, teams):
                    s = s + term[r]
                part[b] = part[b] + s
        groups = 32 // _BWD_COLS
        total = term.new_zeros(hidden)
        for k in range(_BWD_WARPS):
            g = [term.new_zeros(hidden) for _ in range(groups)]
            for i in range(groups):
                for r in range(groups * k + i, plan.blocks,
                               groups * _BWD_WARPS):
                    g[i] = g[i] + part[r]
            total = total + ((g[0] + g[1]) + (g[2] + g[3]))
        grads.append(total)
    return (dx, *grads)


def _check_kernel_args(x2d, tensors) -> None:
    hidden = x2d.shape[1]
    if x2d.dtype not in _build.DTYPE_CODE:
        raise TypeError(
            f"layer_norm kernel takes f32/bf16/f16 x, got {x2d.dtype}")
    for name, t in tensors:
        if t.dtype != torch.float32 or tuple(t.shape) != (hidden,):
            raise ValueError(
                f"{name} must be fp32 [{hidden}], got {t.dtype} "
                f"{tuple(t.shape)}")
    for t in (x2d, *(t for _, t in tensors)):
        if not t.is_contiguous():
            raise ValueError("layer_norm kernel needs contiguous tensors")


def _launch(x2d: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
            eps: float, plan: Optional[NormFwdPlan] = None
            ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Launch the forward kernel on CUDA tensors: x ``[rows, hidden]``
    fp32, bf16 or fp16, w/b fp32 ``[hidden]``, all contiguous. ``plan``
    defaults to :func:`norm_fwd_plan` for the card."""
    rows, hidden = x2d.shape
    _check_kernel_args(x2d, (("weight", w), ("bias", b)))
    dev = x2d.device
    y = torch.empty_like(x2d)
    mu = torch.empty((rows, 1), dtype=torch.float32, device=dev)
    rstd = torch.empty((rows, 1), dtype=torch.float32, device=dev)
    if rows == 0:
        return y, mu, rstd
    lib = _build.kernels()
    plan = plan or norm_fwd_plan(rows, hidden, _build.sm_count(dev.index),
                                 x2d.element_size())
    rc = lib.apex_layer_norm_fwd(
        x2d.data_ptr(), w.data_ptr(), b.data_ptr(), y.data_ptr(),
        mu.data_ptr(), rstd.data_ptr(), rows, hidden, float(eps),
        _code(x2d), *plan, dev.index, _build.current_stream(dev))
    _build.check(rc, "layer_norm_fwd")
    _device.LAUNCHES["layer_norm_fwd"] += 1
    return y, mu, rstd


def _check_bwd_args(dy2d, x2d, stats) -> None:
    rows = x2d.shape[0]
    if dy2d.dtype not in _build.DTYPE_CODE or \
            dy2d.shape != x2d.shape or not dy2d.is_contiguous():
        raise ValueError(
            f"dy must be a contiguous f32/bf16/f16 {tuple(x2d.shape)} "
            f"tensor, got {dy2d.dtype} {tuple(dy2d.shape)}")
    if torch.float32 not in (x2d.dtype, dy2d.dtype) \
            and x2d.dtype != dy2d.dtype:
        raise TypeError(f"the backward kernels take dy and x in one dtype "
                        f"or either in fp32, got dy {dy2d.dtype} and x "
                        f"{x2d.dtype}")
    for name, t in stats:
        if t.dtype != torch.float32 or t.numel() != rows \
                or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous fp32 [{rows}, 1]")


def _launch_bwd(dy2d: torch.Tensor, x2d: torch.Tensor, mu: torch.Tensor,
                rstd: torch.Tensor, w: torch.Tensor, x_is_xhat: bool = False,
                plan: Optional[NormBwdPlan] = None
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Launch the backward kernels on CUDA tensors: dy and x ``[rows,
    hidden]`` fp32, bf16 or fp16 (x the fp32 x-hat with ``x_is_xhat``),
    mu/rstd fp32 ``[rows, 1]``, w fp32; any hidden. ``plan`` defaults to
    :func:`norm_bwd_plan` for the card."""
    rows, hidden = x2d.shape
    _check_kernel_args(x2d, (("weight", w),))
    _check_bwd_args(dy2d, x2d, (("mu", mu), ("rstd", rstd)))
    dev = x2d.device
    dx = torch.empty_like(dy2d)
    if rows == 0:
        return dx, *torch.zeros((2, hidden), dtype=torch.float32, device=dev)
    grads = torch.empty((2, hidden), dtype=torch.float32, device=dev)
    lib = _build.kernels()
    plan = plan or norm_bwd_plan(rows, hidden, _build.sm_count(dev.index))
    part = torch.empty((2, plan.blocks, hidden), dtype=torch.float32,
                       device=dev)
    rc = lib.apex_layer_norm_bwd(
        dy2d.data_ptr(), x2d.data_ptr(), mu.data_ptr(), rstd.data_ptr(),
        w.data_ptr(), dx.data_ptr(), part[0].data_ptr(),
        part[1].data_ptr(), grads[0].data_ptr(), grads[1].data_ptr(),
        rows, hidden, _code(dy2d),
        _code(x2d), int(x_is_xhat), *plan, dev.index,
        _build.current_stream(dev))
    _build.check(rc, "layer_norm_bwd")
    _device.LAUNCHES["layer_norm_bwd"] += 1
    return dx, grads[0], grads[1]


def _launch_rms(x2d: torch.Tensor, w: torch.Tensor, eps: float,
                plan: Optional[NormFwdPlan] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the RMSNorm forward kernel on CUDA tensors: x ``[rows,
    hidden]`` fp32, bf16 or fp16, w fp32 ``[hidden]``, both contiguous;
    ``plan`` as in :func:`_launch`."""
    rows, hidden = x2d.shape
    _check_kernel_args(x2d, (("weight", w),))
    dev = x2d.device
    y = torch.empty_like(x2d)
    rstd = torch.empty((rows, 1), dtype=torch.float32, device=dev)
    if rows == 0:
        return y, rstd
    plan = plan or norm_fwd_plan(rows, hidden, _build.sm_count(dev.index),
                                 x2d.element_size(), rms=True)
    rc = _build.kernels().apex_rms_norm_fwd(
        x2d.data_ptr(), w.data_ptr(), y.data_ptr(), rstd.data_ptr(), rows,
        hidden, float(eps), _code(x2d), *plan, dev.index,
        _build.current_stream(dev))
    _build.check(rc, "rms_norm_fwd")
    _device.LAUNCHES["rms_norm_fwd"] += 1
    return y, rstd


def _launch_rms_bwd(dy2d: torch.Tensor, x2d: torch.Tensor,
                    rstd: torch.Tensor, w: torch.Tensor,
                    x_is_xhat: bool = False,
                    plan: Optional[NormBwdPlan] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the RMSNorm backward kernels on CUDA tensors, as
    :func:`_launch_bwd` without mu and dbeta."""
    rows, hidden = x2d.shape
    _check_kernel_args(x2d, (("weight", w),))
    _check_bwd_args(dy2d, x2d, (("rstd", rstd),))
    dev = x2d.device
    dx = torch.empty_like(dy2d)
    if rows == 0:
        return dx, torch.zeros(hidden, dtype=torch.float32, device=dev)
    dw = torch.empty(hidden, dtype=torch.float32, device=dev)
    lib = _build.kernels()
    plan = plan or norm_bwd_plan(rows, hidden, _build.sm_count(dev.index))
    part = torch.empty((plan.blocks, hidden), dtype=torch.float32,
                       device=dev)
    rc = lib.apex_rms_norm_bwd(
        dy2d.data_ptr(), x2d.data_ptr(), rstd.data_ptr(), w.data_ptr(),
        dx.data_ptr(), part.data_ptr(), dw.data_ptr(), rows, hidden,
        _code(dy2d), _code(x2d),
        int(x_is_xhat), *plan, dev.index, _build.current_stream(dev))
    _build.check(rc, "rms_norm_bwd")
    _device.LAUNCHES["rms_norm_bwd"] += 1
    return dx, dw


#: the forwards as named ops, which the selective recompute policies of
#: ``standalone_transformer_lm`` save (the JAX policy's
#: ``apex_tpu_layer_norm_fwd`` and ``apex_tpu_rms_norm_fwd``)
LAYER_NORM_FWD = "apex_tpu_torch::layer_norm_fwd"
RMS_NORM_FWD = "apex_tpu_torch::rms_norm_fwd"


def _fwd_impl(x2d: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
              eps: float):
    if _device.kernel_route(x2d, weight, bias):
        return _launch(x2d.contiguous(), weight.float().contiguous(),
                       bias.float().contiguous(), eps)
    return layer_norm_reference(x2d, weight, bias, eps)


def _rms_fwd_impl(x2d: torch.Tensor, weight: torch.Tensor, eps: float):
    if _device.kernel_route(x2d, weight):
        return _launch_rms(x2d.contiguous(), weight.float().contiguous(),
                           eps)
    return rms_norm_reference(x2d, weight, eps)


_fwd_op = torch.library.custom_op(
    LAYER_NORM_FWD, _fwd_impl, mutates_args=(),
    schema="(Tensor x, Tensor weight, Tensor bias, float eps) "
           "-> (Tensor, Tensor, Tensor)")
_rms_fwd_op = torch.library.custom_op(
    RMS_NORM_FWD, _rms_fwd_impl, mutates_args=(),
    schema="(Tensor x, Tensor weight, float eps) -> (Tensor, Tensor)")


def layer_norm_fwd(x: torch.Tensor, weight: torch.Tensor,
                   bias: torch.Tensor, eps: float = 1e-5):
    """``(y, mu [rows, 1], rstd [rows, 1])`` over the last dim, rows
    being every leading index of ``x``."""
    y, mu, rstd = _fwd_op(x.reshape(-1, x.shape[-1]), weight, bias, eps)
    return y.reshape(x.shape), mu, rstd


def layer_norm_bwd(dy: torch.Tensor, x: torch.Tensor, mu: torch.Tensor,
                   rstd: torch.Tensor, weight: torch.Tensor,
                   x_is_xhat: bool = False):
    """``(dx, dgamma, dbeta)`` for the LayerNorm over the last dim whose
    forward saved ``(x, mu, rstd)`` (or, with ``x_is_xhat``, whose
    normalized input ``x`` was rebuilt in fp32); dx has ``x``'s shape and
    ``dy``'s dtype, the parameter gradients are fp32 ``[hidden]``."""
    hidden = x.shape[-1]
    x2d = x.reshape(-1, hidden)
    dy2d = dy.reshape(-1, hidden)
    if _device.kernel_route(dy2d, x2d, mu, rstd, weight):
        dx, dw, db = _launch_bwd(dy2d.contiguous(), x2d.contiguous(),
                                 mu.contiguous(), rstd.contiguous(),
                                 weight.float().contiguous(), x_is_xhat)
    else:
        dx, dw, db = layer_norm_bwd_reference(dy2d, x2d, mu, rstd, weight,
                                              x_is_xhat)
    return dx.reshape(x.shape), dw, db


def rms_norm_fwd(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-5):
    """``(y, rstd [rows, 1])`` of the RMSNorm over the last dim."""
    y, rstd = _rms_fwd_op(x.reshape(-1, x.shape[-1]), weight, eps)
    return y.reshape(x.shape), rstd


def rms_norm_bwd(dy: torch.Tensor, x: torch.Tensor, rstd: torch.Tensor,
                 weight: torch.Tensor, x_is_xhat: bool = False):
    """``(dx, dgamma)`` for the RMSNorm over the last dim, as
    :func:`layer_norm_bwd` without mu and dbeta."""
    hidden = x.shape[-1]
    x2d = x.reshape(-1, hidden)
    dy2d = dy.reshape(-1, hidden)
    if _device.kernel_route(dy2d, x2d, rstd, weight):
        dx, dw = _launch_rms_bwd(dy2d.contiguous(), x2d.contiguous(),
                                 rstd.contiguous(),
                                 weight.float().contiguous(), x_is_xhat)
    else:
        dx, dw = rms_norm_bwd_reference(dy2d, x2d, rstd, weight, x_is_xhat)
    return dx.reshape(x.shape), dw


def _clamp_by_magnitude(w: torch.Tensor, floor: float) -> torch.Tensor:
    """|w| kept at least ``floor``, its sign kept (the reference's guard
    for the memory-efficient inverse of the affine)."""
    mag = torch.clamp_min(w.abs(), floor)
    return torch.where(w < 0, -mag, mag)


def _xhat_from_y(y: torch.Tensor, weight: torch.Tensor,
                 bias: Optional[torch.Tensor], eps: float) -> torch.Tensor:
    """x-hat rebuilt in fp32 from a norm's output: ``(y - b) / w`` with
    ``w`` clamped away from 0 (``bias`` None for RMSNorm). Never rounded
    back to y's dtype."""
    yf = y.float()
    if bias is not None:
        yf = yf - bias.float()
    return yf / _clamp_by_magnitude(weight.float(), eps)


class _LayerNorm(torch.autograd.Function):
    """The JAX package's ``layer_norm`` custom VJP: the forward saves
    ``(x, mu, rstd)``, or with ``memory_efficient`` ``(y, mu, rstd)``
    from which the backward rebuilds x-hat; the backward is the backward
    kernel (or its plain version on the CPU)."""

    @staticmethod
    def forward(ctx, x, weight, bias, eps, memory_efficient):
        y, mu, rstd = layer_norm_fwd(x, weight, bias, eps)
        # the bias only where the backward reads it (each saved tensor is
        # one more detach under a recompute policy)
        if memory_efficient:
            ctx.save_for_backward(y, weight, mu, rstd, bias)
        else:
            ctx.save_for_backward(x, weight, mu, rstd)
        ctx.eps, ctx.memory_efficient = eps, memory_efficient
        ctx.bias_dtype = bias.dtype
        return y

    @staticmethod
    def backward(ctx, dy):
        xy, weight, mu, rstd, *bias = ctx.saved_tensors
        if ctx.memory_efficient:
            x = _xhat_from_y(xy, weight, bias[0], ctx.eps)
        else:
            x = xy
        dx, dw, db = layer_norm_bwd(dy, x, mu, rstd, weight,
                                    x_is_xhat=ctx.memory_efficient)
        return dx, dw.to(weight.dtype), db.to(ctx.bias_dtype), None, None


class _RMSNorm(torch.autograd.Function):
    """The JAX package's ``rms_norm`` custom VJP: the forward is the custom
    op :data:`RMS_NORM_FWD` and saves ``(x, rstd)`` (``(y, rstd)`` with
    ``memory_efficient``); the backward is the backward kernel."""

    @staticmethod
    def forward(ctx, x, weight, eps, memory_efficient):
        y, rstd = rms_norm_fwd(x, weight, eps)
        ctx.save_for_backward(y if memory_efficient else x, weight, rstd)
        ctx.eps, ctx.memory_efficient = eps, memory_efficient
        return y

    @staticmethod
    def backward(ctx, dy):
        xy, weight, rstd = ctx.saved_tensors
        if ctx.memory_efficient:
            x = _xhat_from_y(xy, weight, None, ctx.eps)
        else:
            x = xy
        dx, dw = rms_norm_bwd(dy, x, rstd, weight,
                              x_is_xhat=ctx.memory_efficient)
        return dx, dw.to(weight.dtype), None, None


def _flat_hidden(x: torch.Tensor, normalized_ndim: int) -> int:
    hidden = 1
    for d in x.shape[x.ndim - normalized_ndim:]:
        hidden *= d
    return hidden


def _ones(hidden: int, x: torch.Tensor) -> torch.Tensor:
    return torch.ones(hidden, dtype=torch.float32, device=x.device)


def layer_norm(x: torch.Tensor, weight: Optional[torch.Tensor],
               bias: Optional[torch.Tensor], eps: float = 1e-5, *,
               normalized_ndim: int = 1,
               memory_efficient: bool = False) -> torch.Tensor:
    """Fused LayerNorm over the trailing ``normalized_ndim`` dims (the
    JAX package's ``layer_norm``), differentiable in ``x``, ``weight``
    and ``bias``. ``weight``/``bias`` ``None`` is the non-affine norm.
    ``memory_efficient`` keeps the output instead of the input for the
    backward."""
    hidden = _flat_hidden(x, normalized_ndim)
    x2 = x.reshape(*x.shape[:x.ndim - normalized_ndim], hidden)
    if weight is None:
        weight, bias = _ones(hidden, x), torch.zeros(
            hidden, dtype=torch.float32, device=x.device)
    elif bias is None:
        bias = torch.zeros_like(weight)
    y = _LayerNorm.apply(x2, weight.reshape(hidden), bias.reshape(hidden),
                         eps, memory_efficient)
    return y.reshape(x.shape)


def rms_norm(x: torch.Tensor, weight: Optional[torch.Tensor],
             eps: float = 1e-5, *, normalized_ndim: int = 1,
             memory_efficient: bool = False) -> torch.Tensor:
    """Fused RMSNorm over the trailing ``normalized_ndim`` dims (the JAX
    package's ``rms_norm``, arXiv:1910.07467), differentiable in ``x``
    and ``weight``; ``weight`` ``None`` is the non-affine norm."""
    hidden = _flat_hidden(x, normalized_ndim)
    x2 = x.reshape(*x.shape[:x.ndim - normalized_ndim], hidden)
    w = _ones(hidden, x) if weight is None else weight.reshape(hidden)
    return _RMSNorm.apply(x2, w, eps, memory_efficient).reshape(x.shape)
