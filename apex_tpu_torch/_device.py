"""The port's one device rule and one kernel-selection rule.

Counterpart of ``apex_tpu/ops/flash_decode.py::_kernel_ok`` minus the
TPU and interpreter branches. There is no environment switch and no
``use_kernel=`` override:

- an entry point (``ServingEngine``) runs on the card unless the caller
  names another device: :func:`resolve_device` turns ``None`` into
  ``cuda`` and raises when no CUDA device exists;
- a kernel wrapper takes its route from where its tensors lie
  (:func:`kernel_route`): CUDA tensors go through the hand-written
  kernel or the call raises, CPU tensors go through the plain PyTorch
  version. No ``try`` falls back from one to the other.

Every wrapper adds one to its entry in :data:`LAUNCHES` right where it
launches its kernel, so a run can show that its main path went through
the kernels (``chip_smoke.py`` zeroes the counts before the path and
reads them after). The keys: ``flash_decode`` (serving),
``layer_norm_fwd``/``_bwd``, ``rms_norm_fwd``/``_bwd``,
``flash_attn_fwd``/``_bwd``, the packed
optimizer sweeps ``packed_adam``, ``packed_sgd``, ``packed_row_reduce``,
``packed_lamb_stage1``, ``packed_scale_update`` and ``packed_novograd``,
the numerics monitor's row statistics ``packed_row_stats``, the flat
utility sweeps ``scale_flat`` and ``axpby_flat``, the fused block
tails
``bias_gelu_fwd``/``_bwd``, ``bias_dropout_residual_fwd``/``_bwd``,
``residual_ln_fwd``/``_bwd``, and the fused softmax ``softmax_fwd``
(causal or unmasked), ``softmax_masked_fwd`` and ``softmax_bwd``. A
forward output that a selective recompute policy hands back from its
cache launches nothing and counts nothing. One key counts a library
call, not a kernel of the port: ``fp8_gemm``, the cuBLASLt fp8 GEMM
(``torch._scaled_mm``) of ``fused_dense.fp8``, counted at its call
site.
"""
from __future__ import annotations

from typing import Dict, Optional, Union

import torch

#: kernel name -> launches since the last :func:`reset_launch_counts`
LAUNCHES: Dict[str, int] = {
    "flash_decode": 0, "layer_norm_fwd": 0, "layer_norm_bwd": 0,
    "rms_norm_fwd": 0, "rms_norm_bwd": 0, "packed_row_stats": 0,
    "flash_attn_fwd": 0, "flash_attn_bwd": 0, "packed_adam": 0,
    "packed_sgd": 0, "packed_row_reduce": 0, "packed_lamb_stage1": 0,
    "packed_scale_update": 0, "packed_novograd": 0, "scale_flat": 0,
    "axpby_flat": 0,
    "bias_gelu_fwd": 0, "bias_gelu_bwd": 0,
    "bias_dropout_residual_fwd": 0, "bias_dropout_residual_bwd": 0,
    "residual_ln_fwd": 0, "residual_ln_bwd": 0,
    "softmax_fwd": 0, "softmax_masked_fwd": 0, "softmax_bwd": 0,
    "fp8_gemm": 0,
}


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def launch_counts() -> Dict[str, int]:
    return dict(LAUNCHES)


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """``None`` means the card; any other value is taken as given."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: apex_tpu_torch entry points run on the "
                "GPU by default; pass device='cpu' to run the plain "
                "PyTorch path on the CPU")
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(device)


def kernel_route(*tensors: torch.Tensor) -> bool:
    """True when every tensor lies on one CUDA device (launch the
    kernel), False when every tensor lies on the CPU (run the plain
    version). Anything else raises."""
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(
            f"tensors lie on several devices: {sorted(map(str, devices))}")
    dev = devices.pop()
    if dev.type == "cuda":
        return True
    if dev.type == "cpu":
        return False
    raise ValueError(f"no kernel route for device {dev}")
