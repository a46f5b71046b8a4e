"""The collectives of tensor-parallel serving, and their record.

The JAX engine runs its step programs under ``shard_map`` over a
``(tensor,)`` submesh and reduces with ``psum`` / ``pmax`` / ``pmin`` /
``all_gather`` over the named axis. Here every rank of a
``torch.distributed`` group is a process running the same programs, and
:class:`TPComm` issues those collectives over the group: ``psum`` is an
``all_reduce`` SUM, ``pmax`` / ``pmin`` are ``all_reduce`` MAX / MIN,
``all_gather`` one ``all_gather_into_tensor`` (concatenated
shard-major along the last dim). A ``tp_axis`` argument of the serving
functions may be a :class:`TPComm`, a ``parallel_state`` axis name or a
``ProcessGroup`` (:meth:`TPComm.of`; a name resolves through
``parallel.distributed.axis_group``).

Every collective names its **site** (``attn_tail``, ``mlp_tail``,
``sampler_sum``, ...). Two records come of that:

- :attr:`TPComm.issued`: the collectives this rank has issued, by kind
  (``all_reduce_sum``, ``all_reduce_max``, ``all_reduce_min``,
  ``all_gather``, ``broadcast``) and their bytes: what a step costs;
- a program record (:meth:`TPComm.recording`): each site once with its
  kind and output bytes, however often the program issues it. The
  engine records each program's live steps into one and holds it
  against the sites the serving modules declare (``TP_SITES`` of
  ``decode_model`` and ``sampling``): the JAX ``comm_volume`` walker's
  count of a program's equations, which counts a layer loop's body
  once. Its ``program_comm_volume`` and ``psum_per_program`` read both.

:meth:`TPComm.any_host` is the group's verdict on a per-rank host flag
(the engine's hang watchdog), so every rank leaves a step together.
"""
from __future__ import annotations

import contextlib
from collections import Counter
from typing import Any, Dict, Optional

import torch
import torch.distributed as dist

#: the op kinds of the program record, named as the JAX primitives are
_PRIMITIVE = {"all_reduce_sum": "psum", "all_reduce_max": "pmax",
              "all_reduce_min": "pmin", "all_gather": "all_gather"}


class TPComm:
    """The tensor-parallel collectives over one group: ``size`` ranks,
    this one ``rank``; ``group`` None is the default group. ``active``
    False (no process group) is a world of 1 where nothing is issued."""

    def __init__(self, group=None, size: int = 1, rank: int = 0,
                 active: bool = True, axis: str = "tensor"):
        self.group = group
        self.size = int(size)
        self.rank = int(rank)
        self.active = bool(active)
        self.axis = axis
        self.issued: Counter = Counter()
        self.issued_bytes: Counter = Counter()
        self._sites: Optional[Dict[str, Any]] = None

    @classmethod
    def of(cls, tp_axis) -> Optional["TPComm"]:
        """A ``tp_axis`` argument as a :class:`TPComm` (None stays None)."""
        if tp_axis is None or isinstance(tp_axis, TPComm):
            return tp_axis
        from ..transformer.tensor_parallel.mappings import axis_world

        group, world, rank, active = axis_world(tp_axis)
        name = tp_axis if isinstance(tp_axis, str) else "tensor"
        return cls(group, world, rank, active, axis=name)

    # -- records -----------------------------------------------------------
    @contextlib.contextmanager
    def recording(self, sites: Dict[str, Any]):
        """Record into ``sites`` the sites issued inside the block, each
        once: ``{site: (kind, output bytes)}`` (a record taken over many
        steps keeps the first bytes of each site)."""
        self._sites = sites
        try:
            yield sites
        finally:
            self._sites = None

    def _note(self, site: str, kind: str, out: torch.Tensor) -> None:
        nbytes = out.numel() * out.element_size()
        self.issued[kind] += 1
        self.issued_bytes[kind] += nbytes
        if self._sites is not None:
            self._sites.setdefault(site, (kind, nbytes))

    def volume(self, declared: Dict[str, str],
               sites: Dict[str, Any]) -> Dict[str, Dict]:
        """A program's ``declared`` sites (``{site: kind}``) as ``{primitive:
        {count, bytes, axes}}``, the JAX ``comm_volume`` report's shape;
        the bytes are the live record ``sites``' (None while a declared
        site has not been issued). Raises if the record holds a site
        that is not declared."""
        stray = set(sites) - set(declared)
        if stray:
            raise RuntimeError(f"collective sites {sorted(stray)} issued "
                               "but not declared in TP_SITES")
        out: Dict[str, Dict] = {}
        for site, kind in declared.items():
            a = out.setdefault(_PRIMITIVE[kind],
                               {"count": 0, "bytes": 0, "axes": [self.axis]})
            a["count"] += 1
            seen = sites.get(site)
            a["bytes"] = (None if seen is None or a["bytes"] is None
                          else a["bytes"] + seen[1])
        return dict(sorted(out.items()))

    def reset_issued(self) -> None:
        self.issued.clear()
        self.issued_bytes.clear()

    # -- collectives -------------------------------------------------------
    def _all_reduce(self, x: torch.Tensor, op, kind: str,
                    site: str) -> torch.Tensor:
        out = x.contiguous().clone()
        if self.active:
            dist.all_reduce(out, op=op, group=self.group)
        self._note(site, kind, out)
        return out

    def psum(self, x: torch.Tensor, site: str) -> torch.Tensor:
        """The sum over the ranks, in ``x``'s dtype."""
        return self._all_reduce(x, dist.ReduceOp.SUM, "all_reduce_sum", site)

    def pmax(self, x: torch.Tensor, site: str) -> torch.Tensor:
        return self._all_reduce(x, dist.ReduceOp.MAX, "all_reduce_max", site)

    def pmin(self, x: torch.Tensor, site: str) -> torch.Tensor:
        return self._all_reduce(x, dist.ReduceOp.MIN, "all_reduce_min", site)

    def all_gather(self, x: torch.Tensor, site: str) -> torch.Tensor:
        """``[R, k]`` from every rank -> ``[R, size * k]``, shard-major
        along the last dim (``all_gather(axis=1, tiled=True)``)."""
        x = x.contiguous()
        R, k = x.shape
        if self.active:
            out = x.new_empty((self.size * R, k))
            dist.all_gather_into_tensor(out, x, group=self.group)
        else:
            out = x
        self._note(site, "all_gather", out)
        return out.view(self.size, R, k).permute(1, 0, 2).reshape(
            R, self.size * k)

    def broadcast_host(self, t: torch.Tensor, src_rank: int = 0) -> None:
        """Broadcast a small host tensor in place from group rank
        ``src_rank`` (the engine's clock readings; not a program's
        collective, so it enters only :attr:`issued`)."""
        if not self.active:
            return
        src = (src_rank if self.group is None
               else dist.get_global_rank(self.group, src_rank))
        self._host_op(t, lambda x: dist.broadcast(x, src=src,
                                                  group=self.group))
        self.issued["broadcast"] += 1
        self.issued_bytes["broadcast"] += t.numel() * t.element_size()

    def any_host(self, flag: bool) -> bool:
        """Whether ``flag`` holds on any rank of the group (an
        ``all_reduce`` MAX of one host int; not a program's collective,
        so it enters only :attr:`issued`, as ``host_verdict``)."""
        if not self.active:
            return bool(flag)
        t = torch.tensor([int(bool(flag))], dtype=torch.int32)
        self._host_op(t, lambda x: dist.all_reduce(
            x, op=dist.ReduceOp.MAX, group=self.group))
        self.issued["host_verdict"] += 1
        self.issued_bytes["host_verdict"] += t.numel() * t.element_size()
        return bool(t[0])

    def _host_op(self, t: torch.Tensor, op) -> None:
        """``op`` on the host tensor ``t`` in place (through the device
        on NCCL, which takes device tensors only)."""
        if dist.get_backend(self.group) == "nccl":
            dev = t.to(f"cuda:{torch.cuda.current_device()}")
            op(dev)
            t.copy_(dev.cpu())
        else:
            op(t)
