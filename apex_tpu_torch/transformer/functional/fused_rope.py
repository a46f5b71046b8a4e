"""Rotary positional embeddings in the sbhd / cached / thd / 2d layouts
(counterpart of ``apex_tpu/transformer/functional/fused_rope.py``).

NeoX-style rotate-half RoPE on the first ``d2`` dims of the head dim,
the rest passed through:

    out[d] = t[d]·cos(f[s,d]) + rot(t)[d]·sin(f[s,d]),   d < d2
    rot(t)[d] = -t[d + d2/2]  if d < d2/2  else  t[d - d2/2]
    out[d] = t[d]                                         d ≥ d2

in fp32, rounded once to ``t``'s dtype. The JAX package has no Pallas
kernel here (XLA fuses the elementwise chain), so the port is plain
PyTorch too. Autograd gives the rotation's gradient for ``t`` and the
gradients for ``freqs``, ``cos`` and ``sin`` as well, as JAX's autodiff
does (the reference CUDA op returns none for them).
"""
from __future__ import annotations

import torch


def _rotate_half(t: torch.Tensor) -> torch.Tensor:
    """NeoX rotate-half: ``[-x2, x1]`` for ``t`` split in halves on the
    last dim."""
    d2 = t.shape[-1]
    x1, x2 = t[..., : d2 // 2], t[..., d2 // 2:]
    return torch.cat([-x2, x1], dim=-1)


def _apply_rope(t: torch.Tensor, cos: torch.Tensor,
                sin: torch.Tensor) -> torch.Tensor:
    """RoPE on the first ``d2 = cos.shape[-1]`` dims, the rest passed
    through."""
    d, d2 = t.shape[-1], cos.shape[-1]
    t_rope = t[..., :d2]
    out = (t_rope.float() * cos
           + _rotate_half(t_rope).float() * sin).to(t.dtype)
    if d > d2:
        out = torch.cat([out, t[..., d2:]], dim=-1)
    return out


def fused_apply_rotary_pos_emb(t: torch.Tensor,
                               freqs: torch.Tensor) -> torch.Tensor:
    """RoPE on ``t [s, b, h, d]`` with float ``freqs [s, 1, 1, d2]``
    (reference ``FusedRoPEFunc``; its ``transpose_output_memory`` is a
    memory-format knob the JAX package omits)."""
    return _apply_rope(t, torch.cos(freqs), torch.sin(freqs))


def fused_apply_rotary_pos_emb_cached(t: torch.Tensor, cos_: torch.Tensor,
                                      sin_: torch.Tensor) -> torch.Tensor:
    """RoPE on ``t [s, b, h, d]`` with precomputed ``cos_`` and ``sin_
    [s, 1, 1, d2]`` (reference ``FusedRoPECachedFunc``)."""
    return _apply_rope(t, cos_.float(), sin_.float())


def fused_apply_rotary_pos_emb_thd(t: torch.Tensor, cu_seqlens: torch.Tensor,
                                   freqs: torch.Tensor) -> torch.Tensor:
    """RoPE on packed ``t [total_tokens, h, d]`` where positions restart
    at every ``cu_seqlens`` boundary (``cu_seqlens [b + 1]``, cumulative
    lengths; reference ``FusedRoPETHDFunc``): a token's position is its
    index less the start of its sequence, found by a sorted search."""
    tok = torch.arange(t.shape[0], device=t.device, dtype=cu_seqlens.dtype)
    seq_id = torch.searchsorted(cu_seqlens, tok, right=True) - 1
    pos = tok - cu_seqlens[seq_id]
    f = freqs.reshape(freqs.shape[0], -1)[pos.long()]  # [total, d2]
    return _apply_rope(t, torch.cos(f)[:, None, :],
                       torch.sin(f)[:, None, :])


def fused_apply_rotary_pos_emb_2d(t: torch.Tensor, img_h: int, img_w: int,
                                  cos_h: torch.Tensor, sin_h: torch.Tensor,
                                  cos_w: torch.Tensor,
                                  sin_w: torch.Tensor) -> torch.Tensor:
    """2-D RoPE on ``t [b, s, h, d]`` with ``s == img_h * img_w``: the
    height frequencies rotate the first ``d/2`` of the head dim, the
    width frequencies the second (``cos_h``/``sin_h [1, H >= img_h, 1,
    d/2]``, ``cos_w``/``sin_w [1, W >= img_w, 1, d/2]``; reference
    ``FusedRoPE2DFunc``)."""
    b, s, h, d = t.shape
    if s != img_h * img_w:
        raise ValueError(f"sequence length {s} must equal img_h * img_w = "
                         f"{img_h * img_w}")
    x = t.reshape(b, img_h, img_w, h, d)
    first, second = x[..., : d // 2], x[..., d // 2:]
    ch = cos_h[:, :img_h, None, :, :].float()  # [1, img_h, 1, 1, d/2]
    sh = sin_h[:, :img_h, None, :, :].float()
    cw = cos_w[:, None, :img_w, :, :].float()  # [1, 1, img_w, 1, d/2]
    sw = sin_w[:, None, :img_w, :, :].float()
    out = torch.cat([_apply_rope(first, ch, sh), _apply_rope(second, cw, sw)],
                    dim=-1)
    return out.reshape(b, s, h, d)
