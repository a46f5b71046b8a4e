"""Checkpoint save and load of a tree of tensors (counterpart of
``apex_tpu/checkpoint.py``).

The JAX package writes through orbax/tensorstore. The port writes a
directory of its own format, with no pickle, so that loading executes
nothing that the file names:

- ``arrays.bin``: every tensor leaf's raw bytes at 64-byte aligned
  offsets, written by the host IO engine (``ops.hostio.write_arrays``;
  card tensors go through one pinned staging buffer);
- ``index.json``: the tree's structure — dicts (string keys), lists,
  tuples, the port's named-tuple state types by their module and name,
  ``None``, the packed optimizer state (its flat buffers and the
  ``PackSpec``'s template shapes, dtypes and chunk size) — with each
  tensor leaf's path, dtype, shape and offset, and Python scalars
  (``bool``, ``int``, ``float``, ``str``) inline.

API::

    save_checkpoint(path, {"params": params, "opt_state": state, "step": 3})
    restored = load_checkpoint(path)                  # CPU tensors
    restored = load_checkpoint(path, target=tree)     # onto tree's devices

Durability, as in the JAX package: ``save_checkpoint`` stages the write
in a same-directory ``<path>.tmp-<pid>``, flushes every file and
directory of it (:func:`fsync_tree`), renames it over ``path`` and
flushes the parent directory, so a crash mid-write never leaves a half
tree at ``path``. Stale staging trees of dead writers are swept first
(:func:`stale_writer`). ``load_checkpoint`` turns storage failures (a
missing or unreadable index, a truncated ``arrays.bin``, a leaf running
past the end of it) into :class:`CheckpointCorruptError`, the cause
attached.
"""
from __future__ import annotations

import glob
import importlib
import json
import os
import re
import shutil
from typing import Any, Optional

import numpy as np
import torch

from ._tree import tree_unflatten
from .multi_tensor_apply.packing import ROW, PackSpec
from .ops import hostio
from .optimizers._packed import PackedState

Tree = Any

FORMAT = "apex_tpu_torch.checkpoint"
VERSION = 1
ARRAYS = "arrays.bin"
INDEX = "index.json"


class CheckpointCorruptError(RuntimeError):
    """A checkpoint exists at ``path`` but cannot be restored: a missing
    or unreadable index, a truncated or missing ``arrays.bin``, a leaf
    past the end of the file. The original exception rides as
    ``__cause__``."""

    def __init__(self, path: str, cause: Optional[BaseException] = None):
        self.path = path
        detail = f": {type(cause).__name__}: {cause}" if cause else ""
        super().__init__(f"corrupt or unreadable checkpoint at {path}{detail}")


def fsync_file(path: str) -> None:
    """Flush one file's data and metadata to stable storage."""
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def fsync_dir(path: str) -> None:
    """Flush a directory's entries (creations and renames inside it);
    skipped where directories cannot be opened or flushed."""
    flags = os.O_RDONLY | getattr(os, "O_DIRECTORY", 0)
    try:
        fd = os.open(path, flags)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass  # some filesystems refuse directory fsync; best effort
    finally:
        os.close(fd)


def fsync_tree(path: str) -> None:
    """Flush a staged checkpoint tree, every file then every directory,
    bottom up, before the rename that commits it."""
    for dirpath, _dirnames, filenames in os.walk(path, topdown=False):
        for fn in filenames:
            try:
                fsync_file(os.path.join(dirpath, fn))
            except OSError:
                pass  # vanished or unreadable entries are best effort
        fsync_dir(dirpath)


def stale_writer(pid: int) -> bool:
    """True when a ``*.tmp-<pid>`` staging tree cannot still be being
    written: the pid is this process's or no longer exists. A pid that
    cannot be probed (EPERM) counts as live. Only meaningful for local
    pids."""
    if pid == os.getpid():
        return True
    try:
        os.kill(pid, 0)
        return False
    except ProcessLookupError:
        return True
    except OSError:
        return False


# ---------------------------------------------------------------------------
# the index: a tree's structure as JSON, tensor leaves collected in order
# ---------------------------------------------------------------------------

def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).replace("torch.", "")


def _dtype(name: str) -> torch.dtype:
    dtype = getattr(torch, name, None)
    if not isinstance(dtype, torch.dtype):
        raise ValueError(f"unknown dtype {name!r}")
    return dtype


def _keystr(key) -> str:
    return f"[{key!r}]"


def _encode(tree, path: str, leaves: list):
    """The JSON node of ``tree``; its tensors appended to ``leaves``."""
    if isinstance(tree, torch.Tensor):
        leaves.append(tree.detach())
        return {"tensor": len(leaves) - 1, "path": path,
                "dtype": _dtype_name(tree.dtype), "shape": list(tree.shape)}
    if tree is None:
        return {"none": True}
    if isinstance(tree, (bool, int, float, str)):
        return {"scalar": tree, "type": type(tree).__name__}
    if isinstance(tree, dict):
        for k in tree:
            if not isinstance(k, str):
                raise TypeError(f"checkpoint dict keys must be str, got "
                                f"{k!r} at {path or 'the root'}")
        return {"dict": [[k, _encode(tree[k], path + _keystr(k), leaves)]
                         for k in sorted(tree)]}
    if isinstance(tree, PackedState):
        spec = tree.spec
        template = tree_unflatten(spec.treedef, [
            torch.empty(shape, dtype=dtype, device="meta")
            for shape, dtype in zip(spec.shapes, spec.dtypes)])
        return {"packed_state": {
            f: _encode(getattr(tree, f), f"{path}.{f}", leaves)
            for f in ("step", "exp_avg", "exp_avg_sq", "master_params")},
            "spec": {"chunk_size": spec.chunk_size, "align": spec.align,
                     "bucket_elems": spec.bucket_elems,
                     "template": _encode_meta(template, f"{path}.spec")}}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        cls = type(tree)
        if not cls.__module__.startswith("apex_tpu_torch."):
            raise TypeError(f"named tuple {cls.__qualname__} at "
                            f"{path or 'the root'} is not a state type of "
                            f"apex_tpu_torch")
        return {"namedtuple": f"{cls.__module__}:{cls.__qualname__}",
                "fields": list(cls._fields),
                "values": [_encode(v, f"{path}[{i}]", leaves)
                           for i, v in enumerate(tree)]}
    if isinstance(tree, (list, tuple)):
        kind = "list" if isinstance(tree, list) else "tuple"
        return {kind: [_encode(v, f"{path}[{i}]", leaves)
                       for i, v in enumerate(tree)]}
    raise TypeError(f"cannot checkpoint a {type(tree).__name__} at "
                    f"{path or 'the root'}")


def _encode_meta(tree, path: str):
    """A template tree of meta tensors: shapes and dtypes, no bytes."""
    leaves: list = []
    node = _encode(tree, path, leaves)

    def strip(n):
        if isinstance(n, dict):
            if "tensor" in n:
                return {"meta": True, "dtype": n["dtype"],
                        "shape": n["shape"]}
            return {k: strip(v) for k, v in n.items()}
        if isinstance(n, list):
            return [strip(v) for v in n]
        return n

    return strip(node)


def _named_tuple(name: str):
    module, _, qualname = name.partition(":")
    if not module.startswith("apex_tpu_torch."):
        raise ValueError(f"named tuple type {name!r} is not of "
                         f"apex_tpu_torch")
    cls = importlib.import_module(module)
    for part in qualname.split("."):
        cls = getattr(cls, part)
    if not (isinstance(cls, type) and issubclass(cls, tuple)
            and hasattr(cls, "_fields")):
        raise ValueError(f"{name!r} is not a named tuple type")
    return cls


def _decode(node, tensors: list, target=None, *, has_target=False):
    """Rebuild a tree from its index node; ``tensors`` are the loaded
    leaves in index order (already placed as ``target`` asks)."""
    if "tensor" in node:
        return tensors[node["tensor"]]
    if "meta" in node:
        return torch.empty(node["shape"], dtype=_dtype(node["dtype"]),
                           device="meta")
    if "none" in node:
        return None
    if "scalar" in node:
        return node["scalar"]
    if "dict" in node:
        return {k: _decode(v, tensors, target[k] if has_target else None,
                           has_target=has_target)
                for k, v in node["dict"]}
    if "packed_state" in node:
        fields = {f: _decode(v, tensors,
                             getattr(target, f) if has_target else None,
                             has_target=has_target)
                  for f, v in node["packed_state"].items()}
        if has_target:
            spec = target.spec
        else:
            s = node["spec"]
            spec = PackSpec(_decode(s["template"], tensors),
                            align=s.get("align", ROW),
                            chunk_size=s["chunk_size"],
                            bucket_elems=s.get("bucket_elems"))
        return PackedState(spec=spec, **fields)
    if "namedtuple" in node:
        cls = _named_tuple(node["namedtuple"])
        return cls(*[_decode(v, tensors,
                             target[i] if has_target else None,
                             has_target=has_target)
                     for i, v in enumerate(node["values"])])
    for kind in ("list", "tuple"):
        if kind in node:
            items = [_decode(v, tensors, target[i] if has_target else None,
                             has_target=has_target)
                     for i, v in enumerate(node[kind])]
            return items if kind == "list" else tuple(items)
    raise ValueError(f"unknown index node {sorted(node)}")


def _tensor_nodes(node, out: list) -> list:
    """The index's tensor nodes in leaf order."""
    if isinstance(node, dict):
        if "tensor" in node:
            out.append(node)
            return out
        if "spec" in node and "packed_state" in node:
            _tensor_nodes(node["packed_state"], out)
            return out
        for k, v in node.items():
            if k != "spec":
                _tensor_nodes(v, out)
    elif isinstance(node, list):
        for v in node:
            _tensor_nodes(v, out)
    return out


def _target_leaves(node, target, out: list) -> list:
    """The target's leaves matched to the index's tensor nodes, in leaf
    order; raises ``ValueError`` where the structures differ."""
    if "tensor" in node:
        if not isinstance(target, torch.Tensor) or \
                list(target.shape) != node["shape"]:
            raise ValueError(
                f"target leaf at {node['path'] or '<root>'} is not a tensor "
                f"of the saved shape {node['shape']}")
        out.append(target)
    elif "dict" in node:
        if not isinstance(target, dict) or \
                sorted(target) != [k for k, _ in node["dict"]]:
            raise ValueError("target does not match the checkpoint's "
                             "structure (dict keys)")
        for k, v in node["dict"]:
            _target_leaves(v, target[k], out)
    elif "packed_state" in node:
        if not isinstance(target, PackedState):
            raise ValueError("target does not match the checkpoint's "
                             "structure (packed optimizer state)")
        for f, v in node["packed_state"].items():
            _target_leaves(v, getattr(target, f), out)
    else:
        for kind in ("namedtuple", "list", "tuple"):
            if kind in node:
                items = node["values"] if kind == "namedtuple" else node[kind]
                if not isinstance(target, (list, tuple)) or \
                        len(target) != len(items):
                    raise ValueError("target does not match the "
                                     "checkpoint's structure "
                                     f"({kind} length)")
                for v, t in zip(items, target):
                    _target_leaves(v, t, out)
    return out


# ---------------------------------------------------------------------------
# save and load
# ---------------------------------------------------------------------------

def _write_tree(dirpath: str, index: dict, leaves: list,
                threads: Optional[int] = None) -> None:
    os.makedirs(dirpath, exist_ok=True)
    offsets, total = hostio.layout(leaves)
    data = os.path.join(dirpath, ARRAYS)
    with open(data, "wb"):
        pass  # an empty tree still has its (empty) arrays file
    if leaves:
        hostio.write_arrays(data, leaves, offsets,
                            **({} if threads is None else
                               {"threads": threads}))
    for node, off in zip(_tensor_nodes(index["tree"], []), offsets):
        node["offset"] = off
    index["nbytes"] = total
    with open(os.path.join(dirpath, INDEX), "w") as f:
        json.dump(index, f)


def save_checkpoint(path: str, state: Tree, *, overwrite: bool = True,
                    staged: bool = True,
                    threads: Optional[int] = None) -> None:
    """Write a tree of tensors and scalars to the directory ``path``.

    Staged (the default): the tree lands in ``<path>.tmp-<pid>``, is
    flushed, and is renamed over ``path``; on any failure the partial
    tree is removed and whatever was at ``path`` stays as it was.
    ``overwrite=False`` raises ``FileExistsError`` before anything is
    written when ``path`` exists. ``staged=False`` writes straight into
    ``path``, for callers whose ``path`` already lies inside their own
    uncommitted staging directory. ``threads``: the host IO engine's
    writer threads (its default when None)."""
    path = os.path.abspath(path)
    if not overwrite and os.path.exists(path):
        # fail before staging the (possibly many-GB) write
        raise FileExistsError(
            f"checkpoint exists at {path} and overwrite=False")
    leaves: list = []
    # encoding first: an unsupported leaf fails before anything is written
    index = {"format": FORMAT, "version": VERSION,
             "tree": _encode(state, "", leaves)}
    if not staged:
        if os.path.exists(path):
            shutil.rmtree(path)
        _write_tree(path, index, leaves, threads)
        fsync_tree(path)
        return
    tmp = f"{path}.tmp-{os.getpid()}"
    # sweep stale partials: ours, and any whose writer pid is dead
    for stale in glob.glob(glob.escape(path) + ".tmp-*"):
        m = re.search(r"\.tmp-(\d+)$", os.path.basename(stale))
        if m is not None and stale_writer(int(m.group(1))):
            shutil.rmtree(stale, ignore_errors=True)
    try:
        _write_tree(tmp, index, leaves, threads)
        fsync_tree(tmp)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    if os.path.exists(path):
        if not overwrite:  # appeared during the write
            shutil.rmtree(tmp, ignore_errors=True)
            raise FileExistsError(
                f"checkpoint exists at {path} and overwrite=False")
        # the one window that is not atomic: the old tree goes before the
        # new one is renamed in
        shutil.rmtree(path)
    os.rename(tmp, path)
    fsync_dir(os.path.dirname(path))


def _read_index(path: str) -> dict:
    with open(os.path.join(path, INDEX)) as f:
        index = json.load(f)
    if index.get("format") != FORMAT:
        raise ValueError(f"{INDEX} is not an {FORMAT} index")
    return index


def load_checkpoint(path: str, target: Optional[Tree] = None) -> Tree:
    """Read a checkpoint.

    Without ``target``: the saved structure with CPU tensors. With
    ``target``, a matching
    tree: each tensor leaf lands on the target leaf's device and in its
    dtype; scalars come back as saved, and a packed optimizer state
    takes the target's ``PackSpec``.

    Raises ``FileNotFoundError`` when nothing exists at ``path`` and
    :class:`CheckpointCorruptError` when something does but cannot be
    read back; a ``target`` that does not match the saved structure
    raises ``ValueError``."""
    path = os.path.abspath(path)
    if not os.path.exists(path):
        raise FileNotFoundError(f"no checkpoint at {path}")
    try:
        index = _read_index(path)
        nodes = _tensor_nodes(index["tree"], [])
        data = os.path.join(path, ARRAYS)
        size = hostio.file_size(data)
        for n in nodes:
            nbytes = int(np.prod(n["shape"], dtype=np.int64)) \
                * _dtype(n["dtype"]).itemsize
            if n["offset"] + nbytes > size:
                raise ValueError(
                    f"leaf {n['path'] or '<root>'} runs to byte "
                    f"{n['offset'] + nbytes} of a {size}-byte {ARRAYS}")
    except Exception as e:
        raise CheckpointCorruptError(path, e) from e
    specs = [(tuple(n["shape"]), _dtype(n["dtype"])) for n in nodes]
    has_target = target is not None
    if has_target:
        want = _target_leaves(index["tree"], target, [])
        out = [torch.empty(shape, dtype=dtype, device=t.device)
               for (shape, dtype), t in zip(specs, want)]
    else:
        out = [torch.empty(shape, dtype=dtype) for shape, dtype in specs]
    try:
        if out:
            hostio.read_arrays(data, None, [n["offset"] for n in nodes],
                               out=out)
    except Exception as e:
        raise CheckpointCorruptError(path, e) from e
    if has_target:
        out = [t if t.dtype == w.dtype else t.to(w.dtype)
               for t, w in zip(out, want)]
    return _decode(index["tree"], out, target, has_target=has_target)
