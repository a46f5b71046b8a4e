"""1-D halo exchangers for spatial parallelism (counterpart of
``apex_tpu/contrib/bottleneck/halo_exchangers.py``).

The reference's four ``left_right_halo_exchange`` implementations
(NoComm, AllGather, SendRecv over raw NCCL, Peer over CUDA-IPC memory)
swap conv halos between the ranks holding adjacent slabs of an image's
height. The JAX package spells them as ``ppermute`` shifts over a mesh
axis; here a slab is a process and the shifts are ``torch.distributed``
point-to-point ops over the axis's group:

- :class:`HaloExchangerSendRecv`: one ``batch_isend_irecv`` of the two
  hops (``transformer.pipeline_parallel.p2p_communication.exchange``;
  on a gloo group CUDA tensors are staged through pinned host memory);
- :class:`HaloExchangerAllGather`: one ``all_gather_into_tensor`` of
  both halos, then the neighbours' picked out;
- :class:`HaloExchangerPeer`: the SendRecv pair (``peer_pool`` and
  ``numSM`` are accepted and ignored, as in the JAX package);
- :class:`HaloExchangerNoComm`: the local halos crossed over, no
  exchange (a baseline, as the reference warns).

The chains are open: the returned ``left_input_halo`` is the left
neighbour's ``right_output_halo`` (zeros on the first rank) and
``right_input_halo`` the right neighbour's ``left_output_halo`` (zeros
on the last rank). JAX's autodiff transposes ``ppermute`` by itself;
here each exchange is an ``autograd.Function`` whose backward sends each
halo's gradient back the way it came (SendRecv: the same two hops the
other way, zeros at the edges; AllGather: the all-gather's transpose, a
``reduce_scatter_tensor``).

The axis: ``axis_name`` may be a ``ProcessGroup``, or a
``parallel_state`` axis name once model parallelism is initialised;
any other name (``"spatial"``, the default) is the default group, the
whole world. Without a process group the world is 1: both inputs are
zeros.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.distributed as dist

from ...transformer.pipeline_parallel.p2p_communication import (
    AxisGroup,
    exchange,
)


def spatial_group(axis_name):
    """What ``axis_name`` resolves to for the spatial collectives: a
    ``ProcessGroup`` as it is; a ``parallel_state`` axis name as that
    axis once model parallelism is initialised; any other name the
    default group (``dist.group.WORLD``); None without a process group
    (a world of 1)."""
    if not (dist.is_available() and dist.is_initialized()):
        return None
    if isinstance(axis_name, dist.ProcessGroup):
        return axis_name
    from ...transformer import parallel_state as ps

    if (ps.model_parallel_is_initialized() and axis_name in (
            ps.PIPELINE_AXIS, ps.DATA_AXIS, ps.TENSOR_AXIS)):
        return axis_name
    return dist.group.WORLD


def _axis(axis_name) -> Optional[AxisGroup]:
    group = spatial_group(axis_name)
    return None if group is None else AxisGroup(group)


def _send_recv(ax: Optional[AxisGroup], left_out: torch.Tensor,
               right_out: torch.Tensor):
    """The two open-chain hops: ``right_out`` to the right neighbour
    (arriving as its left input), ``left_out`` to the left one; zeros
    where a rank has no neighbour."""
    left_in = torch.zeros_like(right_out, memory_format=torch.contiguous_format)
    right_in = torch.zeros_like(left_out, memory_format=torch.contiguous_format)
    if ax is None or ax.size == 1:
        return left_in, right_in
    i, last = ax.index, ax.size - 1
    sends, recvs = [], []
    if i < last:
        sends.append((right_out, i + 1, 0))
        recvs.append((right_in, i + 1, 1))
    if i > 0:
        sends.append((left_out, i - 1, 1))
        recvs.append((left_in, i - 1, 0))
    exchange(ax, sends, recvs)
    return left_in, right_in


class _SendRecvExchange(torch.autograd.Function):
    @staticmethod
    def forward(ctx, left_out, right_out, ax):
        ctx.ax = ax
        return _send_recv(ax, left_out, right_out)

    @staticmethod
    def backward(ctx, g_left_in, g_right_in):
        # my left output arrived as my left neighbour's right input: its
        # gradient comes back from the left, and likewise on the right —
        # the same two hops with the gradients as the outputs
        g_left_out, g_right_out = _send_recv(ctx.ax, g_left_in.contiguous(),
                                             g_right_in.contiguous())
        return g_left_out, g_right_out, None


def _gather_pick(ax: Optional[AxisGroup], both: torch.Tensor):
    """``both`` ``[2, ...]`` (left, right output halos) all-gathered to
    ``[size, 2, ...]``; the left neighbour's right halo and the right
    neighbour's left halo, zeros at the edges."""
    if ax is None or ax.size == 1:
        z = torch.zeros_like(both[0])
        return z, z.clone()
    size, i = ax.size, ax.index
    allh = both.new_empty((size * both.shape[0],) + tuple(both.shape[1:]))
    dist.all_gather_into_tensor(allh, both.contiguous(), group=ax.group)
    allh = allh.view((size,) + tuple(both.shape))
    left_in = allh[(i - 1) % size, 1]
    right_in = allh[(i + 1) % size, 0]
    if i == 0:
        left_in = torch.zeros_like(left_in)
    if i == size - 1:
        right_in = torch.zeros_like(right_in)
    return left_in, right_in


class _AllGatherExchange(torch.autograd.Function):
    @staticmethod
    def forward(ctx, left_out, right_out, ax):
        ctx.ax = ax
        return _gather_pick(ax, torch.stack([left_out, right_out]))

    @staticmethod
    def backward(ctx, g_left_in, g_right_in):
        ax = ctx.ax
        if ax is None or ax.size == 1:
            return torch.zeros_like(g_left_in), torch.zeros_like(g_right_in), None
        size, i = ax.size, ax.index
        # the transpose of gather-then-pick: scatter my picks' gradients
        # into the [size, 2, ...] gathered layout, then reduce-scatter
        g = g_left_in.new_zeros((size, 2) + tuple(g_left_in.shape))
        if i > 0:
            g[i - 1, 1] = g_left_in
        if i < size - 1:
            g[i + 1, 0] = g_right_in
        mine = g.new_empty((2,) + tuple(g_left_in.shape))
        dist.reduce_scatter_tensor(mine, g.view((size * 2,) + mine.shape[1:]),
                                   group=ax.group)
        return mine[0], mine[1], None


class HaloExchanger:
    """Base: the open chain over ``axis_name`` (reference ``:11-24``)."""

    def __init__(self, axis_name="spatial"):
        self.axis_name = axis_name

    def left_right_halo_exchange(
        self, left_output_halo: torch.Tensor, right_output_halo: torch.Tensor
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        raise NotImplementedError


class HaloExchangerNoComm(HaloExchanger):
    """Communication-free swap (reference ``:26-35``): the local halos
    crossed over. NOT a real exchange — a performance baseline only."""

    def left_right_halo_exchange(self, left_output_halo, right_output_halo):
        return right_output_halo, left_output_halo


class HaloExchangerSendRecv(HaloExchanger):
    """Neighbour send / receive (reference ``:69-88``): the two hops in
    one ``batch_isend_irecv``."""

    def left_right_halo_exchange(self, left_output_halo, right_output_halo):
        return _SendRecvExchange.apply(left_output_halo.contiguous(),
                                       right_output_halo.contiguous(),
                                       _axis(self.axis_name))


class HaloExchangerAllGather(HaloExchanger):
    """All-gather both halos and pick the neighbours' (reference
    ``:37-67``): the same result as SendRecv through one collective."""

    def left_right_halo_exchange(self, left_output_halo, right_output_halo):
        return _AllGatherExchange.apply(left_output_halo, right_output_halo,
                                        _axis(self.axis_name))


class HaloExchangerPeer(HaloExchangerSendRecv):
    """Reference ``:90-126``: CUDA-IPC peer-memory push / pull. Here the
    SendRecv pair; ``peer_pool`` / ``explicit_nhwc`` / ``numSM`` are
    accepted and ignored, as in the JAX package."""

    def __init__(self, axis_name="spatial", peer_pool=None,
                 explicit_nhwc: bool = True, numSM: int = 0):
        del peer_pool, explicit_nhwc, numSM
        super().__init__(axis_name)


def halo_pad_1d(
    x: torch.Tensor,
    halo: int,
    exchanger: Optional[HaloExchanger] = None,
    *,
    axis: int = 1,
) -> torch.Tensor:
    """Pad a spatially sharded tensor with its neighbours' halos along
    ``axis`` (the sharded H dim of an NHWC slab): ``halo`` rows of the
    left neighbour prepended and ``halo`` rows of the right neighbour
    appended (zeros at the chain's ends), ready for a conv that is VALID
    along ``axis`` and reproduces the unsharded SAME conv."""
    if exchanger is None:
        exchanger = HaloExchangerSendRecv()
    if not 0 < halo <= x.shape[axis]:
        raise ValueError(
            f"halo ({halo}) must be in (0, local shard size "
            f"{x.shape[axis]}] — a larger halo needs multi-hop exchange"
        )
    # my top rows are my LEFT output halo; bottom rows my RIGHT output halo
    left_out = x.narrow(axis, 0, halo)
    right_out = x.narrow(axis, x.shape[axis] - halo, halo)
    left_in, right_in = exchanger.left_right_halo_exchange(left_out, right_out)
    return torch.cat([left_in.to(x.dtype), x, right_in.to(x.dtype)],
                     dim=axis)
