"""Process-global args, timers and microbatch calculator (counterpart of
``apex_tpu/transformer/testing/global_vars.py``); the timers are
``pipeline_parallel._timers.Timers``."""
from __future__ import annotations

from ..microbatches import build_num_microbatches_calculator
from ..pipeline_parallel._timers import Timers, _Timer  # noqa: F401
from .arguments import parse_args

_GLOBAL_ARGS = None
_GLOBAL_NUM_MICROBATCHES_CALCULATOR = None
_GLOBAL_TIMERS = None


def _ensure_var_is_initialized(var, name):
    if var is None:
        raise RuntimeError(f"{name} is not initialized")


def _ensure_var_is_not_initialized(var, name):
    if var is not None:
        raise RuntimeError(f"{name} is already initialized")


def get_args():
    _ensure_var_is_initialized(_GLOBAL_ARGS, "args")
    return _GLOBAL_ARGS


def get_num_microbatches():
    return _GLOBAL_NUM_MICROBATCHES_CALCULATOR.get()


def get_current_global_batch_size():
    return _GLOBAL_NUM_MICROBATCHES_CALCULATOR.get_current_global_batch_size()


def update_num_microbatches(consumed_samples, consistency_check=True):
    _GLOBAL_NUM_MICROBATCHES_CALCULATOR.update(consumed_samples,
                                               consistency_check)


def get_timers():
    _ensure_var_is_initialized(_GLOBAL_TIMERS, "timers")
    return _GLOBAL_TIMERS


def set_global_variables(extra_args_provider=None, args_defaults=None,
                         ignore_unknown_args=True, override_args=None):
    """Parse the args, build the microbatch calculator (when both batch
    sizes are given) and the timers; returns the args."""
    args = _parse_args(extra_args_provider, args_defaults,
                       ignore_unknown_args, override_args)
    if args.micro_batch_size is not None and \
            args.global_batch_size is not None:
        _build_num_microbatches_calculator(args)
    _set_timers()
    return args


def _parse_args(extra_args_provider=None, defaults=None,
                ignore_unknown_args=True, override_args=None):
    global _GLOBAL_ARGS
    _ensure_var_is_not_initialized(_GLOBAL_ARGS, "args")
    _GLOBAL_ARGS = parse_args(extra_args_provider, defaults,
                              ignore_unknown_args, override_args)
    return _GLOBAL_ARGS


def _build_num_microbatches_calculator(args):
    global _GLOBAL_NUM_MICROBATCHES_CALCULATOR
    _ensure_var_is_not_initialized(_GLOBAL_NUM_MICROBATCHES_CALCULATOR,
                                   "num microbatches calculator")
    _GLOBAL_NUM_MICROBATCHES_CALCULATOR = build_num_microbatches_calculator(
        args.rank, args.rampup_batch_size, args.global_batch_size,
        args.micro_batch_size, args.data_parallel_size)


def _set_timers():
    global _GLOBAL_TIMERS
    _ensure_var_is_not_initialized(_GLOBAL_TIMERS, "timers")
    _GLOBAL_TIMERS = Timers()


def destroy_global_vars():
    global _GLOBAL_ARGS, _GLOBAL_NUM_MICROBATCHES_CALCULATOR, _GLOBAL_TIMERS
    _GLOBAL_ARGS = None
    _GLOBAL_NUM_MICROBATCHES_CALCULATOR = None
    _GLOBAL_TIMERS = None
