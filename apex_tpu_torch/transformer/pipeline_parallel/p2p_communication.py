"""Stage-to-stage tensor exchange for pipeline parallelism (counterpart of
``apex_tpu/transformer/pipeline_parallel/p2p_communication.py``).

The JAX functions are ``ppermute`` rotations over the ``pipeline`` mesh
axis: every stage sends to its neighbour and receives from the other in
one collective, and "send" and "recv" are the same op. Here a stage is a
process, and each function is the same rotation spelt as ``torch.
distributed`` point-to-point ops: one ``P2POp`` send to the next (or
previous) stage and one receive from the other, issued together through
``batch_isend_irecv`` over the axis's process group and waited on, for
every leaf of the tree (a leaf's shape and dtype is the message's: every
stage passes the same shapes, as in the JAX package). The returned tree
is what this stage received.

:func:`exchange` is the transport under both these rotations and the
schedules' per-tick messages (and the ring hops of
``transformer.context_parallel``): a batch of sends and receives to
group-local peer indices. Its transport is decided by the group's
backend, not by trying: gloo's send and receive read and write host
memory only, so on a gloo group a CUDA tensor is staged through a pinned
host buffer (the send copies it out, the receive copies it back in);
NCCL takes the device tensors as they lie. :data:`P2P_COUNTS` counts the
ops, the staged ones and the bytes moved since
:func:`reset_p2p_counts`.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from ..._tree import tree_flatten, tree_unflatten
from .. import parallel_state

Pytree = Any

#: point-to-point ops issued (sends and receives), those staged through
#: host memory, and the bytes sent, since :func:`reset_p2p_counts`
P2P_COUNTS: Dict[str, int] = {"ops": 0, "staged": 0, "bytes": 0}


def reset_p2p_counts() -> None:
    for k in P2P_COUNTS:
        P2P_COUNTS[k] = 0


def p2p_counts() -> Dict[str, int]:
    return dict(P2P_COUNTS)


class AxisGroup:
    """A resolved axis: its process group (None: the default group),
    size, this process's index on it and the global ranks of its
    members in index order. ``active`` is False without a process group
    (a world of 1: no op runs)."""

    def __init__(self, axis_name):
        from ...parallel.distributed import axis_group

        self.group, self.size = axis_group(axis_name)
        self.active = dist.is_available() and dist.is_initialized()
        if not self.active:
            self.index, self.members = 0, [0]
            return
        if self.group is None:
            self.index = dist.get_rank()
            self.members = list(range(self.size))
        else:
            self.index = dist.get_rank(self.group)
            self.members = list(dist.get_process_group_ranks(self.group))

    @property
    def staged(self) -> bool:
        """Whether CUDA tensors go through host memory (a gloo group)."""
        return self.active and dist.get_backend(self.group) == "gloo"

    def next(self) -> int:
        return (self.index + 1) % self.size

    def prev(self) -> int:
        return (self.index - 1) % self.size


def _axis(axis_name) -> str:
    return axis_name if axis_name is not None \
        else parallel_state.PIPELINE_AXIS


def _pinned(like: torch.Tensor) -> torch.Tensor:
    return torch.empty(like.shape, dtype=like.dtype, pin_memory=True)


def exchange(ax: AxisGroup,
             sends: Sequence[Tuple[torch.Tensor, int, int]],
             recvs: Sequence[Tuple[torch.Tensor, int, int]]) -> None:
    """Send each ``(tensor, peer index, tag)`` of ``sends`` and receive
    into each ``(buffer, peer index, tag)`` of ``recvs`` over ``ax``'s
    group in one ``batch_isend_irecv``, and wait for all of them. Every
    peer must issue the matching ops in the same order for each pair and
    direction (the schedules and rotations issue one message a pair and
    direction and tag). On a gloo group CUDA tensors are staged through
    pinned host buffers."""
    if not sends and not recvs:
        return
    staged = ax.staged
    ops, back = [], []
    for buf, peer, tag in recvs:
        if not buf.is_contiguous():
            raise ValueError("a receive buffer must be contiguous")
        if staged and buf.is_cuda:
            host = _pinned(buf)
            back.append((buf, host))
            buf = host
            P2P_COUNTS["staged"] += 1
        ops.append(dist.P2POp(dist.irecv, buf, ax.members[peer], ax.group,
                              tag))
    for t, peer, tag in sends:
        t = t.detach().contiguous()
        if staged and t.is_cuda:
            t = _pinned(t).copy_(t)
            P2P_COUNTS["staged"] += 1
        P2P_COUNTS["bytes"] += t.numel() * t.element_size()
        ops.append(dist.P2POp(dist.isend, t, ax.members[peer], ax.group,
                              tag))
    P2P_COUNTS["ops"] += len(ops)
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    for buf, host in back:
        buf.copy_(host)


def _rotate(tree: Pytree, axis_name, shift: int) -> Pytree:
    """Every leaf sent ``shift`` (+1 or -1) stages along the ring and
    the leaf received from the other side returned; the identity on a
    world of 1."""
    ax = AxisGroup(_axis(axis_name))
    leaves, treedef = tree_flatten(tree)
    if not ax.active or ax.size == 1:
        return tree
    dst = ax.next() if shift > 0 else ax.prev()
    src = ax.prev() if shift > 0 else ax.next()
    out = [torch.empty(t.shape, dtype=t.dtype, device=t.device)
           for t in leaves]
    exchange(ax, [(t, dst, i) for i, t in enumerate(leaves)],
             [(o, src, i) for i, o in enumerate(out)])
    return tree_unflatten(treedef, out)


def send_forward(output_tensor: Pytree, axis_name: Optional[str] = None
                 ) -> Pytree:
    """Rotate activations one stage forward; returns what this stage
    received from its predecessor (the reference's ``send_forward`` and
    ``recv_forward`` in one exchange)."""
    return _rotate(output_tensor, axis_name, +1)


def send_backward(input_tensor_grad: Pytree, axis_name: Optional[str] = None
                  ) -> Pytree:
    """Rotate gradients one stage backward (``send_backward`` +
    ``recv_backward``)."""
    return _rotate(input_tensor_grad, axis_name, -1)


# The reference's receive-only calls are the same rotations, named for
# call-site parity, as in the JAX package.
recv_forward = send_forward
recv_backward = send_backward


def send_forward_recv_backward(output_tensor: Pytree,
                               input_tensor_grad: Pytree,
                               axis_name: Optional[str] = None):
    """Both rotations; returns ``(recv_from_prev, recv_from_next)``."""
    return (send_forward(output_tensor, axis_name),
            send_backward(input_tensor_grad, axis_name))


def send_backward_recv_forward(input_tensor_grad: Pytree,
                               output_tensor: Pytree,
                               axis_name: Optional[str] = None):
    """Returns ``(recv_from_next, recv_from_prev)``."""
    return (send_backward(input_tensor_grad, axis_name),
            send_forward(output_tensor, axis_name))


def send_forward_recv_forward(output_tensor: Pytree,
                              axis_name: Optional[str] = None) -> Pytree:
    return send_forward(output_tensor, axis_name)


def send_backward_recv_backward(input_tensor_grad: Pytree,
                                axis_name: Optional[str] = None) -> Pytree:
    return send_backward(input_tensor_grad, axis_name)


def send_forward_backward_recv_forward_backward(
        output_tensor: Pytree, input_tensor_grad: Pytree,
        axis_name: Optional[str] = None):
    """Returns ``(recv_from_prev, recv_from_next)``."""
    return (send_forward(output_tensor, axis_name),
            send_backward(input_tensor_grad, axis_name))

