"""contrib.fmha (counterpart of ``apex_tpu/contrib/fmha``): fused
multi-head attention over packed variable-length sequences, the
reference's packed-qkv calling convention over
:func:`apex_tpu_torch.ops.flash_attention.flash_attention_varlen`."""
from .fmha import FMHA, fmha_varlen

__all__ = ["FMHA", "fmha_varlen"]
