"""Casting helpers and the cast cache of one autocast region (counterpart
of ``apex_tpu/amp/utils.py``).

Reference: ``apex/amp/utils.py:90-122``, the fp16 cast cache that casts
a tensor once per iteration however often the region uses it. Here the
cache lives for one ``autocast`` context: repeated casts of the same
tensor object to the same dtype return the first cast's result, and with
it one node of the autograd graph. The key is ``id(x)``, so the cache
keeps each source alive until the context exits and no id can be reused
inside it. Unlike a JAX array, a tensor can change in place under the
same id (``h += y``): each entry also holds the source's version counter,
and a cast of a changed tensor casts it again and replaces the entry.
Inference tensors have no version counter and are never cached.
"""
from __future__ import annotations

import functools

import torch

_LOW_SOURCE = (torch.float32, torch.float64)
_HALF = (torch.float16, torch.bfloat16)


def is_float_array(x) -> bool:
    return isinstance(x, torch.Tensor) and x.is_floating_point()


def maybe_cast(x, dtype, cache: dict | None = None):
    """Cast floating tensors to ``dtype``; pass everything else through."""
    if not is_float_array(x) or x.dtype == dtype:
        return x
    if cache is None or x.is_inference():
        return x.to(dtype)
    key = (id(x), str(dtype))
    hit = cache.get(key)
    if hit is not None and hit[0] == x._version:
        return hit[1]
    out = x.to(dtype)
    if hit is None:
        # keep the source alive so id() keys stay unique for the region
        cache.setdefault("__refs__", []).append(x)
    cache[key] = (x._version, out)
    return out


def maybe_low_precision(x, dtype=torch.bfloat16, cache=None):
    """fp32/fp64 -> low precision (reference ``utils.py`` maybe_half)."""
    if is_float_array(x) and x.dtype in _LOW_SOURCE:
        return maybe_cast(x, dtype, cache)
    return x


def maybe_float(x, cache=None):
    """fp16/bf16 -> fp32 (reference ``utils.py`` maybe_float)."""
    if is_float_array(x) and x.dtype in _HALF:
        return maybe_cast(x, torch.float32, cache)
    return x


def widest_float(args, kwargs):
    """The widest floating dtype among the tensors of ``args`` and
    ``kwargs`` (None when there is none): the target of a promote cast."""
    dtypes = [t.dtype for t in _tensors([args, kwargs])
              if t.is_floating_point()]
    return functools.reduce(torch.promote_types, dtypes) if dtypes else None


def _tensors(obj):
    if isinstance(obj, torch.Tensor):
        yield obj
    elif isinstance(obj, (list, tuple)):
        for o in obj:
            yield from _tensors(o)
    elif isinstance(obj, dict):
        for o in obj.values():
            yield from _tensors(o)


def _map(fn, obj):
    """``fn`` over the tensors of ``obj``, rebuilding dicts, lists, tuples
    and named tuples around them; any other object (``torch.Size``, a
    number, a callable) comes back as it is."""
    if isinstance(obj, torch.Tensor):
        return fn(obj)
    if isinstance(obj, list):
        return [_map(fn, o) for o in obj]
    if type(obj) is tuple:
        return tuple(_map(fn, o) for o in obj)
    if isinstance(obj, tuple) and hasattr(obj, "_fields"):
        return type(obj)(*(_map(fn, o) for o in obj))
    if isinstance(obj, dict):
        return {k: _map(fn, v) for k, v in obj.items()}
    return obj


def casted_args(cast_fn, args, kwargs, cache=None):
    def cast(t):
        return cast_fn(t, cache=cache)
    return ([_map(cast, a) for a in args],
            {k: _map(cast, v) for k, v in kwargs.items()})
