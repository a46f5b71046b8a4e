"""Shared schedule machinery (counterpart of
``apex_tpu/transformer/pipeline_parallel/schedules/common.py``): model
building, the tick hook, the parity-kwarg warnings and the eager
executor every pipelined schedule runs on.

The stage contract is the JAX package's: ``stage_fn(stage_params,
hidden) -> hidden`` runs one microbatch through one chunk of this stage
(the output has the input's shape and dtype: the messages between
stages are that shape), ``loss_fn(hidden, extra) -> scalar`` runs on the
last stage's final chunk, ``inputs [n_micro, ...]`` enter stage 0's
first chunk and ``extras`` (a tree with leading ``n_micro``) are the
loss's inputs. Where JAX differentiates a scan of ``ppermute`` ticks,
a stage here is a process and a schedule is an ordered list of
forward (F) and backward (B) actions of (microbatch, chunk) items on
each stage:

- the JAX order of the stream: item ``u`` is microbatch ``(u // (vpp
  pp)) pp + u % pp`` on chunk ``(u // pp) % vpp``; chunk ``c`` of stage
  ``s`` holds global layer block ``c pp + s``, and the last stage's
  output of chunk ``c < vpp - 1`` goes on to stage 0's chunk ``c + 1``;
- F runs the stage with autograd on a fresh leaf of its input and keeps
  the graph (with ``checkpoint_stages`` the stage under
  ``torch.utils.checkpoint``: only its inputs are kept); on the last
  stage's final chunk it also runs the loss, scaled by ``1 / n_micro``
  and by ``grad_scaler``;
- B runs ``torch.autograd.backward`` of that graph under the cotangent
  the next stage sent back (the loss itself on the last stage), as the
  reference's ``backward_step``: the chunk parameters' gradients are
  summed in fp32 and returned, the input's gradient goes to the previous
  stage, and any other tensor that requires grad and that the stage or
  the loss closes over (a head's weights on the last stage) accumulates
  its ``.grad`` over the microbatches, as a parameter's does in the
  reference.

:func:`plan` lays the stages' action lists out on global ticks: each
tick every stage runs its next action whose input has arrived, and the
messages of the tick (each stage's output to the stage that consumes
it) are then exchanged in one ``batch_isend_irecv`` a stage
(``p2p_communication.exchange``). Every stage computes the same plan
from ``(pp, vpp, n_micro)`` and its own order, so the sends and
receives of a tick pair up and no stage can wait on another out of
order. The stage that runs no action in a tick takes part in its
exchanges only.
"""
from __future__ import annotations

import functools
import warnings
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch
import torch.distributed as dist
from torch.utils.checkpoint import checkpoint

from ...._tree import tree_flatten, tree_map, tree_unflatten
from ... import parallel_state
from ..p2p_communication import AxisGroup, exchange

Pytree = Any


def build_model(
    model_provider_func: Callable,
    wrap_with_ddp: bool = True,
    virtual_pipeline_model_parallel_size: Optional[int] = None,
    model_type=None,
    *args,
    **kwargs,
) -> List[Any]:
    """This rank's model chunk(s) (reference ``common.py:30-151``): with
    virtual pipelining one a virtual rank, ``parallel_state``'s virtual
    rank set during each construction. ``wrap_with_ddp`` has no wrapper
    here (gradient sync is ``parallel.sync_gradients``, applied by the
    caller); accepted for parity."""
    del model_type, wrap_with_ddp
    if (parallel_state.get_pipeline_model_parallel_world_size() > 1
            and virtual_pipeline_model_parallel_size is not None):
        model = []
        for i in range(virtual_pipeline_model_parallel_size):
            parallel_state.set_virtual_pipeline_model_parallel_rank(i)
            model.append(model_provider_func(*args, **kwargs))
        parallel_state.set_virtual_pipeline_model_parallel_rank(0)
        return model
    return [model_provider_func(*args, **kwargs)]


def emit_tick(hook, t, rank, active_f, active_b) -> None:
    """Call a tick hook (a callable, or an object with ``.hook``) with
    ``(t, rank, active_f, active_b)``: the schedule's tick, this stage,
    whether it ran a forward and whether a backward in it. Host values
    of the host's schedule: no device sync."""
    if hook is None:
        return
    cb = getattr(hook, "hook", hook)
    cb(t, rank, active_f, active_b)


_warned_hook_autodiff: set = set()


def warn_hook_under_autodiff(fn_name: str) -> None:
    """The JAX package's one-time warning that a tick hook on its
    differentiated scan does not fire. Every schedule here runs its
    ticks on the host and calls the hook, so nothing calls this; kept
    for the JAX module's names."""
    if fn_name in _warned_hook_autodiff:
        return
    _warned_hook_autodiff.add(fn_name)
    warnings.warn(f"{fn_name}: tick_hook under autodiff", stacklevel=3)


# kwargs the reference schedules take whose mechanics the eager executor
# owns (shapes, streams, buffer deallocation): silently ignorable
_MECHANICAL_PARITY_KWARGS = frozenset({
    "tensor_shape", "decoder_sequence_length", "dtype",
    "async_comm", "sync_batch_comm",
    "num_micro_batches_with_partial_activation_checkpoints",
    "deallocate_pipeline_outputs", "sequence_parallel_enabled",
})
_warned_parity_kwargs: set = set()


def warn_ignored_parity_kwargs(fn_name: str, parity_kwargs: dict) -> None:
    """Warn once per (function, kwarg) for an accepted and ignored kwarg
    with a semantic weight (``custom_sync_context_handler``, ...); the
    mechanical ones and falsy values stay silent."""
    for k, v in parity_kwargs.items():
        if not v or k in _MECHANICAL_PARITY_KWARGS:
            continue
        key = (fn_name, k)
        if key in _warned_parity_kwargs:
            continue
        _warned_parity_kwargs.add(key)
        warnings.warn(
            f"{fn_name}: ignoring parity kwarg {k}={v!r} — this semantic "
            "option has no effect in the PyTorch implementation",
            stacklevel=3)


# ---------------------------------------------------------------------------
# the executor
# ---------------------------------------------------------------------------

F, B = "F", "B"
Action = Tuple[str, int, int]  # (kind, microbatch, chunk)


def stream_item(u: int, pp: int, vpp: int) -> Tuple[int, int]:
    """``(microbatch, chunk)`` of stream item ``u``."""
    g, rem = divmod(u, vpp * pp)
    c, i = divmod(rem, pp)
    return g * pp + i, c


def _f_src(r: int, c: int, pp: int) -> Optional[Tuple[int, int]]:
    """``(stage, chunk)`` whose forward feeds F(·, c) on stage r; None:
    the input is injected."""
    if r > 0:
        return r - 1, c
    return (pp - 1, c - 1) if c > 0 else None


def _f_dst(r: int, c: int, pp: int, vpp: int) -> Optional[Tuple[int, int]]:
    """``(stage, chunk)`` that consumes F(·, c) of stage r; None: the
    model's output (the loss)."""
    if r < pp - 1:
        return r + 1, c
    return (0, c + 1) if c < vpp - 1 else None


def gpipe_order(r: int, pp: int, vpp: int, n: int, forward: bool = True,
                backward: bool = True) -> List[Action]:
    """Every forward in stream order, then every backward in reverse: the
    order of the JAX scan schedule and its transpose."""
    items = [stream_item(u, pp, vpp) for u in range(n * vpp)]
    out = [(F, m, c) for m, c in items] if forward else []
    if backward:
        out += [(B, m, c) for m, c in reversed(items)]
    return out


def one_f_one_b_order(r: int, pp: int, vpp: int, n: int) -> List[Action]:
    """The reference's 1F1B order on stage ``r``: warm-up forwards, then
    one forward and one backward at a time, then the cool-down
    backwards. Non-interleaved (``vpp == 1``): ``pp - r - 1`` warm-up
    forwards, so at most ``pp - r`` microbatches are in flight
    (``fwd_bwd_pipelining_without_interleaving.py:241-597``); interleaved:
    ``2 (pp - r - 1) + (vpp - 1) pp`` warm-up forwards over the stream,
    backwards walking the chunks in reverse
    (``fwd_bwd_pipelining_with_interleaving.py``)."""
    total = n * vpp
    if vpp == 1:
        warm = min(pp - r - 1, total)
    else:
        warm = min(2 * (pp - r - 1) + (vpp - 1) * pp, total)

    def fwd(k):
        m, c = stream_item(k, pp, vpp)
        return F, m, c

    def bwd(k):
        m, c = stream_item(k, pp, vpp)
        return B, m, vpp - 1 - c

    out = [fwd(k) for k in range(warm)]
    for i in range(total - warm):
        out += [fwd(warm + i), bwd(i)]
    out += [bwd(k) for k in range(total - warm, total)]
    return out


@functools.lru_cache(maxsize=64)
def _plan(orders: Tuple[Tuple[Action, ...], ...], pp: int, vpp: int,
          forwards_done: bool):
    done = set()
    pos = [0] * pp
    ticks = []
    while any(pos[r] < len(orders[r]) for r in range(pp)):
        acts = {}
        for r in range(pp):
            if pos[r] >= len(orders[r]):
                continue
            kind, m, c = orders[r][pos[r]]
            if kind == F:
                src = _f_src(r, c, pp)
                ready = src is None or (src[0], F, m, src[1]) in done
            else:
                dst = _f_dst(r, c, pp, vpp)
                if dst is None:
                    ready = forwards_done or (r, F, m, c) in done
                else:
                    ready = (dst[0], B, m, dst[1]) in done
            if ready:
                acts[r] = (kind, m, c)
        if not acts:
            raise RuntimeError("pipeline schedule cannot make progress: "
                               "no stage's next action has its input")
        msgs = []
        for r, (kind, m, c) in sorted(acts.items()):
            done.add((r, kind, m, c))
            pos[r] += 1
            if kind == F:
                dst = _f_dst(r, c, pp, vpp)
                if dst is not None:
                    msgs.append((F, r, dst[0], m, dst[1]))
            else:
                src = _f_src(r, c, pp)
                if src is not None:
                    msgs.append((B, r, src[0], m, src[1]))
        ticks.append((acts, tuple(msgs)))
    return tuple(ticks)


def plan(orders, pp: int, vpp: int, forwards_done: bool = False):
    """The global ticks of the stages' action lists ``orders`` (one list
    a stage): a tuple of ``(actions {stage: action}, messages)``, a
    message ``(kind, src stage, dst stage, microbatch, chunk of the
    receiving action)``. ``forwards_done``: the last stage's backwards
    need no forward in this plan (their forwards ran in an earlier one).
    Raises where no stage can run (an order that would deadlock)."""
    return _plan(tuple(tuple(o) for o in orders), pp, vpp, forwards_done)


class ScheduleRun:
    """One pipelined pass of this stage over ``n`` microbatches: the
    chunk parameters as leaves, the saved graphs, the fp32 gradient
    sums, the loss, the input gradients and the message buffers, and
    :meth:`run` to execute a plan's ticks.

    ``mode``: ``"loss"`` (the last stage's final chunk runs ``loss_fn``;
    its backward seeds from the loss), ``"outputs"`` (it keeps the
    outputs ``[n, ...]`` and its backward seeds from their cotangents,
    the differentiable ``pipeline_rounds``). ``train`` False runs the
    forwards under ``torch.no_grad``."""

    def __init__(self, stage_fn, loss_fn, stage_params, inputs, extras,
                 axis_name, num_chunks: int, checkpoint_stages: bool,
                 grad_scaler=None, mode: str = "loss", train: bool = True,
                 want_dinputs: bool = True, tick_hook=None):
        self.ax = AxisGroup(axis_name if axis_name is not None
                            else parallel_state.PIPELINE_AXIS)
        self.pp, self.rank = self.ax.size, self.ax.index
        self.vpp = int(num_chunks)
        if self.vpp < 1:
            raise ValueError(f"num_chunks must be >= 1, got {num_chunks}")
        self.n = inputs.shape[0]
        if self.vpp > 1 and self.n % self.pp != 0:
            raise ValueError(
                f"interleaved schedule requires n_micro ({self.n}) divisible "
                f"by the pipeline size (reference asserts the same)")
        self.stage_fn, self.loss_fn = stage_fn, loss_fn
        self.inputs, self.extras = inputs, extras
        self.checkpoint_stages = checkpoint_stages
        self.grad_scaler, self.mode, self.train = grad_scaler, mode, train
        self.want_dinputs, self.tick_hook = want_dinputs, tick_hook
        leaves, self.treedef = tree_flatten(stage_params)
        self.param_leaves = leaves
        if self.vpp == 1:
            chunks = [leaves]
        else:
            chunks = [[p[c] for p in leaves] for c in range(self.vpp)]
        self.chunks = [[p.detach().requires_grad_(train) for p in ch]
                       for ch in chunks]
        self.acc: List[Optional[List[Optional[torch.Tensor]]]] = \
            [None] * self.vpp
        self.saved: Dict[Tuple[int, int], tuple] = {}
        self.buf: Dict[Tuple[str, int, int], torch.Tensor] = {}
        self.loss = torch.zeros((), dtype=torch.float32,
                                device=inputs.device)
        self.outs = torch.zeros_like(inputs) if mode == "outputs" else None
        self.d_outs = None
        self.dinputs = torch.zeros_like(inputs) \
            if (train and want_dinputs) else None

    # -- one stage call -----------------------------------------------------
    def _stage(self, c: int, x: torch.Tensor) -> torch.Tensor:
        leaves = self.chunks[c]
        if self.train and self.checkpoint_stages:
            td, fn = self.treedef, self.stage_fn
            return checkpoint(
                lambda xx, *ls: fn(tree_unflatten(td, list(ls)), xx),
                x, *leaves, use_reentrant=False)
        return self.stage_fn(tree_unflatten(self.treedef, leaves), x)

    def _final(self, c: int) -> bool:
        return self.rank == self.pp - 1 and c == self.vpp - 1

    def _forward(self, m: int, c: int) -> Optional[torch.Tensor]:
        injected = self.rank == 0 and c == 0
        x = self.inputs[m] if injected else self.buf.pop((F, m, c))
        if self.train:
            x = x.detach().requires_grad_(not injected or self.want_dinputs)
            with torch.enable_grad():
                y = self._stage(c, x)
        else:
            with torch.no_grad():
                y = self._stage(c, x)
        if y.shape != self.inputs.shape[1:] or y.dtype != self.inputs.dtype:
            raise TypeError(
                "stage_fn must map activations to the same shape/dtype "
                f"(stages are homogeneous across ranks): got "
                f"{self.inputs.dtype}{list(self.inputs.shape[1:])} -> "
                f"{y.dtype}{list(y.shape)}. Cast inside the stage so the "
                "pipeline messages carry one dtype.")
        if not self._final(c):
            if self.train:
                self._keep(m, c, x, y)
            return y.detach()
        if self.mode == "outputs":
            self.outs[m] = y.detach()
            if self.train:
                self._keep(m, c, x, y)
            return None
        ex = tree_map(lambda e: e[m], self.extras)
        with torch.set_grad_enabled(self.train):
            val = self.loss_fn(y, ex) / self.n
            if self.grad_scaler is not None:
                val = self.grad_scaler(val)
        self.loss = self.loss + val.detach().float()
        if self.train:
            self._keep(m, c, x, val)
        return None

    def _keep(self, m, c, x, root):
        self.saved[(m, c)] = (x, root)

    def _backward(self, m: int, c: int) -> Optional[torch.Tensor]:
        x, root = self.saved.pop((m, c))
        if not self._final(c):
            dy = self.buf.pop((B, m, c))
        elif self.mode == "outputs":
            dy = self.d_outs[m]
        else:
            dy = None
        # the reference's backward_step: torch.autograd.backward, every
        # leaf the graph reaches accumulating .grad (the input's, the
        # chunk's parameters, and any parameter the stage or the loss
        # closes over, such as a head on the last stage)
        torch.autograd.backward(root, grad_tensors=dy)
        dx = x.grad if x.requires_grad else None
        if self.acc[c] is None:
            self.acc[c] = [None] * len(self.chunks[c])
        acc = self.acc[c]
        for i, leaf in enumerate(self.chunks[c]):
            g = leaf.grad
            if g is None:
                continue
            leaf.grad = None
            acc[i] = g.float() if acc[i] is None else acc[i].add_(g.float())
        if self.rank == 0 and c == 0:
            if self.dinputs is not None and dx is not None:
                self.dinputs[m] = dx
            return None
        if dx is None:
            dx = torch.zeros_like(x)
        return dx

    # -- the ticks ------------------------------------------------------------
    def run(self, orders_fn, forwards_done: bool = False) -> None:
        """Execute the plan of ``orders_fn(stage, pp, vpp, n)`` (every
        stage's order is computed here, so every stage holds the same
        plan)."""
        pp, vpp, me = self.pp, self.vpp, self.rank
        orders = [orders_fn(r, pp, vpp, self.n) for r in range(pp)]
        template = self.inputs[0]
        for t, (acts, msgs) in enumerate(plan(orders, pp, vpp,
                                              forwards_done)):
            act = acts.get(me)
            out = None
            if act is not None:
                kind, m, c = act
                out = self._forward(m, c) if kind == F \
                    else self._backward(m, c)
            if self.tick_hook is not None:
                emit_tick(self.tick_hook, t, me,
                          act is not None and act[0] == F,
                          act is not None and act[0] == B)
            sends, recvs = [], []
            for kind, src, dst, m, c in msgs:
                tag = 0 if kind == F else 1
                if src == me:
                    sends.append((out, dst, tag))
                if dst == me:
                    buf = torch.empty(template.shape,
                                      dtype=template.dtype,
                                      device=template.device)
                    self.buf[(kind, m, c)] = buf
                    recvs.append((buf, src, tag))
            exchange(self.ax, sends, recvs)

    # -- results --------------------------------------------------------------
    def _sum(self, t: torch.Tensor) -> torch.Tensor:
        if self.ax.active and self.pp > 1:
            dist.all_reduce(t, group=self.ax.group)
        return t

    def reduced_loss(self) -> torch.Tensor:
        """The last stage's loss, summed over the stages (zeros
        elsewhere): the same value on every stage."""
        return self._sum(self.loss.clone())

    def reduced_dinputs(self) -> Optional[torch.Tensor]:
        """Stage 0's input gradients on every stage."""
        return None if self.dinputs is None else self._sum(self.dinputs)

    def grads(self) -> Pytree:
        """The parameters' gradients (fp32 sums, in the parameters'
        dtype; a chunk axis leading with ``vpp > 1``)."""
        out = []
        for i, p in enumerate(self.param_leaves):
            per = []
            for c in range(self.vpp):
                g = None if self.acc[c] is None else self.acc[c][i]
                ref = self.chunks[c][i]
                per.append(torch.zeros(ref.shape, dtype=torch.float32,
                                       device=ref.device) if g is None
                           else g)
            g = per[0] if self.vpp == 1 else torch.stack(per)
            out.append(g.to(p.dtype))
        return tree_unflatten(self.treedef, out)
