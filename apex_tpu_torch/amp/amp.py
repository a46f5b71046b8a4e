"""O1 autocast: registry-driven per-op casting (counterpart of
``apex_tpu/amp/amp.py``).

Reference: ``apex/amp/amp.py:74`` + ``apex/amp/wrap.py``: the torch
namespaces are patched at ``amp.init()`` and stay patched. As in the JAX
package, the patching here is scoped: ``autocast()`` replaces the listed
attributes of ``torch``, ``torch.linalg``, ``torch.nn.functional`` and
``torch.special`` for the duration of the context and restores them on
exit, so outside it nothing is touched. A call made inside the context
through one of those attributes casts its floating tensor arguments (per
op: low precision, fp32, or the widest of its arguments) and records the
casts in the autograd graph, so gradients come back in each input's
dtype. Operators and tensor methods are not patched (see
``lists/torch_overrides.py``).

Example::

    with amp.autocast(dtype=torch.bfloat16):
        y = model_apply(params, x)   # convs in bf16, softmax/log in fp32
"""
from __future__ import annotations

import contextlib
import functools
import threading
from typing import Callable, List, Tuple

import torch

from . import utils
from .lists import torch_overrides

_EXTRA_LOW_PRECISION: List[Tuple[object, str]] = []
_EXTRA_FP32: List[Tuple[object, str]] = []
_EXTRA_PROMOTE: List[Tuple[object, str]] = []
_local = threading.local()
_MARK = "__apex_tpu_torch_wrapped__"


def register_half_function(module, name: str) -> None:
    """Add (module, name) to the low-precision list (``apex/amp/amp.py``
    parity)."""
    _EXTRA_LOW_PRECISION.append((module, name))


register_bf16_function = register_half_function


def register_float_function(module, name: str) -> None:
    _EXTRA_FP32.append((module, name))


def register_promote_function(module, name: str) -> None:
    """Add (module, name) to the promote-cast list: its float arguments
    are cast to the widest float dtype among them (torch, unlike JAX,
    does not promote every op natively)."""
    _EXTRA_PROMOTE.append((module, name))


def _promote(t, cache=None, dtype=None):
    return utils.maybe_cast(t, dtype, cache) if dtype is not None else t


def _wrap(orig: Callable, cast_fn, cache, promote: bool = False) -> Callable:
    @functools.wraps(orig)
    def wrapper(*args, **kwargs):
        if getattr(_local, "depth", 0):
            # ops called from inside another wrapped op keep their dtypes
            return orig(*args, **kwargs)
        _local.depth = 1
        try:
            fn = (functools.partial(
                _promote, dtype=utils.widest_float(args, kwargs))
                if promote else cast_fn)
            new_args, new_kwargs = utils.casted_args(fn, args, kwargs, cache)
            return orig(*new_args, **new_kwargs)
        finally:
            _local.depth = 0

    setattr(wrapper, _MARK, orig)
    return wrapper


def _lists():
    return (
        (list(torch_overrides.LOW_PRECISION_FUNCS) + _EXTRA_LOW_PRECISION,
         "low", False),
        (list(torch_overrides.FP32_FUNCS) + _EXTRA_FP32, "fp32", False),
        (list(torch_overrides.PROMOTE_CAST_FUNCS) + _EXTRA_PROMOTE, None,
         True),
    )


@contextlib.contextmanager
def autocast(enabled: bool = True, dtype=torch.bfloat16,
             cache_casts: bool = True):
    """Scoped O1 patching of the registered function lists.

    ``dtype`` is the low-precision compute type (bf16 by default, as in
    the JAX package; fp16 accepted). ``cache_casts`` mirrors the
    reference's fp16 cast cache (``apex/amp/utils.py:90``)."""
    if not enabled:
        yield
        return

    cache: dict = {} if cache_casts else None
    casts = {"low": functools.partial(utils.maybe_low_precision, dtype=dtype),
             "fp32": utils.maybe_float, None: None}
    saved = []
    try:
        for entries, kind, promote in _lists():
            for module, name in entries:
                orig = getattr(module, name)
                if getattr(orig, _MARK, None) is not None:
                    continue
                saved.append((module, name, orig))
                setattr(module, name, _wrap(orig, casts[kind], cache,
                                            promote))
        yield
    finally:
        for module, name, orig in reversed(saved):
            setattr(module, name, orig)
        if cache is not None:
            cache.clear()


@contextlib.contextmanager
def disable_casts():
    """Escape hatch mirroring ``apex.amp.handle.disable_casts``: restores
    the original functions inside an ``autocast`` region."""
    restored = []
    for entries, _, _ in _lists():
        for module, name in entries:
            cur = getattr(module, name)
            orig = getattr(cur, _MARK, None)
            if orig is not None:
                restored.append((module, name, cur))
                setattr(module, name, orig)
    try:
        yield
    finally:
        for module, name, wrapped in restored:
            setattr(module, name, wrapped)
