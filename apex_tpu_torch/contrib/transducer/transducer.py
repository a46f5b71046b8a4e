"""The transducer (RNN-T) joint and loss (counterpart of
``apex_tpu/contrib/transducer/transducer.py``).

**Joint**: ``out[b, t, u] = f[b, t] + g[b, u]``, then the optional ReLU
and dropout, optionally packed to ``[packed_batch, H]`` without the
don't-care region (``t >= f_len`` or ``u >= g_len``): each valid ``(b, t,
u)`` scatters to row ``start_b + t * g_len[b] + u`` (``start_b`` from
``batch_offset = cumsum(f_len * g_len)``), the rest to a spare row that
is dropped, and the keep-mask packs alike. The dropout's keep-mask draws
from a ``torch.Generator`` (passed as ``dropout_key``, the JAX package's
PRNG key's place), so it differs from the JAX package's draws: the two
agree exactly at dropout 0.

**Loss**: the per-utterance negative log-likelihood (Graves 2012) over
fp32 ``log_softmax`` of the logits:

    alpha[t, u] = logaddexp(alpha[t-1, u] + blank[t-1, u],
                            alpha[t, u-1] + emit[t, u-1])

with row 0 plain adds of emissions, column 0 blanks only, ``-1e30`` for
the emissions of positions ``u >= y_len``, and ``loss = -(alpha[f_len-1,
y_len] + blank[f_len-1, y_len])``. The JAX package scans over T with an
inner scan over U, T x U sequential steps. Each ``alpha[t, u]`` needs only
``alpha[t-1, u]`` and ``alpha[t, u-1]``, both on the anti-diagonal
``t + u - 1``, so the port sweeps the anti-diagonals: T + U - 2 vector
steps over ``[B, T]``, each cell computed from the JAX package's operands
in its order. The operands are laid out by diagonal once (a gather);
cells outside the ``T x U`` grid carry finite filler that no grid cell
reads. Autograd through the sweep gives the gradient.
"""
from __future__ import annotations

from typing import List, Optional

import torch

_NEG_INF = -1e30


# ---------------------------------------------------------------------------
# joint
# ---------------------------------------------------------------------------


def _starts(batch_offset: torch.Tensor) -> torch.Tensor:
    return torch.cat([torch.zeros(1, dtype=batch_offset.dtype,
                                  device=batch_offset.device),
                      batch_offset[:-1]])


def transducer_joint(f: torch.Tensor, g: torch.Tensor, f_len: torch.Tensor,
                     g_len: torch.Tensor, *, pack_output: bool = False,
                     relu: bool = False, dropout_prob: float = 0.0,
                     dropout_key: Optional[torch.Generator] = None,
                     batch_offset: Optional[torch.Tensor] = None,
                     packed_batch: int = 0, return_mask: bool = False):
    """``f [B, T, H] + g [B, U, H]`` broadcast to ``[B, T, U, H]`` with the
    optional ReLU / dropout epilogue, optionally packed (``batch_offset``
    and ``packed_batch`` required). ``return_mask=True`` also returns the
    ReLU / dropout keep-mask (packed like the output)."""
    b, t, h = f.shape
    u = g.shape[1]
    out = f[:, :, None, :] + g[:, None, :, :]

    mask = None
    if relu:
        mask = (out > 0).to(out.dtype)
        out = out * mask
    if dropout_prob > 0.0:
        if dropout_key is None:
            raise ValueError("dropout_prob > 0 requires dropout_key")
        keep = torch.empty(out.shape, dtype=out.dtype,
                           device=out.device).bernoulli_(
            1.0 - dropout_prob, generator=dropout_key)
        out = out * keep / (1.0 - dropout_prob)
        mask = keep if mask is None else mask * keep
    if not pack_output:
        return (out, mask) if return_mask else out

    if batch_offset is None or packed_batch == 0:
        raise ValueError(
            "batch_offset and packed_batch are required when packing")
    dev = out.device
    starts = _starts(batch_offset)
    tt = torch.arange(t, device=dev)[None, :, None]
    uu = torch.arange(u, device=dev)[None, None, :]
    valid = (tt < f_len[:, None, None]) & (uu < g_len[:, None, None])
    dest = starts[:, None, None] + tt * g_len[:, None, None] + uu
    dest = torch.where(valid, dest, packed_batch).reshape(-1)

    def pack(v):
        rows = torch.zeros(packed_batch + 1, h, dtype=v.dtype, device=dev)
        return rows.index_put((dest,), v.reshape(-1, h))[:packed_batch]

    if return_mask:
        return pack(out), (None if mask is None else pack(mask))
    return pack(out)


class TransducerJoint:
    """The reference's ``TransducerJoint`` module. ``opt`` and
    ``fwd_tile_size`` pick CUDA tilings: ignored. Dropout applies when
    ``training`` and draws from ``dropout_key`` (a ``torch.Generator``);
    with ``probe_mask`` the latest call's mask is kept in
    ``mask_probe``."""

    def __init__(self, pack_output=False, relu=False, dropout=False, opt=1,
                 fwd_tile_size=4, dropout_prob=0.0, probe_mask=False):
        del opt, fwd_tile_size
        self.pack_output = pack_output
        self.relu = relu
        self.dropout = dropout
        self.dropout_prob = dropout_prob
        masked = relu or dropout
        self.mask_probe: Optional[List] = [] if masked and probe_mask else None

    def __call__(self, f, g, f_len, g_len, batch_offset=None, packed_batch=0,
                 *, training=True, dropout_key=None):
        use_dropout = self.dropout and training
        probe = self.mask_probe is not None
        out = transducer_joint(
            f, g, f_len, g_len, pack_output=self.pack_output, relu=self.relu,
            dropout_prob=self.dropout_prob if use_dropout else 0.0,
            dropout_key=dropout_key, batch_offset=batch_offset,
            packed_batch=packed_batch, return_mask=probe)
        if probe:
            out, mask = out
            self.mask_probe.clear()
            if mask is not None:
                self.mask_probe.append(mask)
        return out


# ---------------------------------------------------------------------------
# loss
# ---------------------------------------------------------------------------


def _by_diagonal(a: torch.Tensor, n_diag: int) -> torch.Tensor:
    """``[B, T, U]`` -> ``[D, B, T]`` with ``out[d, b, t] = a[b, t, d - t]``
    where ``0 <= d - t < U``, else ``_NEG_INF``."""
    bsz, t, u = a.shape
    d = torch.arange(n_diag, device=a.device)[:, None]
    uu = d - torch.arange(t, device=a.device)[None, :]  # [D, T]
    inside = (uu >= 0) & (uu < u)
    idx = uu.clamp(0, u - 1).t()[None].expand(bsz, t, n_diag)  # [B, T, D]
    out = torch.gather(a, 2, idx).permute(2, 0, 1)
    return torch.where(inside[:, None, :], out, _NEG_INF)


def transducer_loss(x: torch.Tensor, label: torch.Tensor,
                    f_len: torch.Tensor, y_len: torch.Tensor, blank_idx: int,
                    *, fuse_softmax_backward: bool = True,
                    return_alphas: bool = False):
    """Per-utterance RNN-T loss ``[B]`` of logits ``x [B, T, U, V]`` (``U =
    max y_len + 1``), labels ``[B, U-1]``; ``return_alphas`` also returns
    ``alpha [B, T, U]``. ``fuse_softmax_backward`` is the reference's
    kernel switch: accepted."""
    del fuse_softmax_backward
    bsz, t_max, u_max, _ = x.shape
    dev = x.device
    logp = torch.log_softmax(x.to(torch.float32), dim=-1)
    lp_blank = logp[..., blank_idx]  # [B, T, U]
    lab = torch.nn.functional.pad(label, (0, u_max - label.shape[1]))
    lp_emit = torch.gather(
        logp, 3, lab[:, None, :, None].expand(bsz, t_max, u_max, 1)
        .to(torch.int64))[..., 0]
    uu = torch.arange(u_max, device=dev)[None, None, :]
    lp_emit = torch.where(uu < y_len[:, None, None], lp_emit, _NEG_INF)

    n_diag = t_max + u_max - 1
    blank_d = _by_diagonal(lp_blank, n_diag)  # [D, B, T]
    emit_d = _by_diagonal(lp_emit, n_diag)
    tt = torch.arange(t_max, device=dev)
    filler = torch.full((bsz, 1), _NEG_INF, device=dev)
    diag = torch.where(tt[None, :] == 0, 0.0, _NEG_INF).expand(
        bsz, t_max)  # diagonal 0: alpha[0, 0] = 0
    diags = [diag]
    for d in range(1, n_diag):
        # alpha[t-1, u] + blank[t-1, u]: diagonal d-1 at t-1
        below = torch.cat([filler, (diag + blank_d[d - 1])[:, :-1]], dim=1)
        # alpha[t, u-1] + emit[t, u-1]: diagonal d-1 at t
        left = diag + emit_d[d - 1]
        both = torch.logaddexp(below, left)
        # row 0 (t = 0): emissions only; column 0 (t = d): blanks only
        diag = torch.where(tt == 0, left, torch.where(tt == d, below, both))
        diags.append(diag)
    alphas = torch.stack(diags)  # [D, B, T]

    bidx = torch.arange(bsz, device=dev)
    t_last = (f_len - 1).clamp(0, t_max - 1).to(torch.int64)
    u_last = y_len.clamp(0, u_max - 1).to(torch.int64)
    a_term = alphas[t_last + u_last, bidx, t_last]
    lp_term = lp_blank[bidx, t_last, u_last]
    losses = -(a_term + lp_term)
    if return_alphas:
        # alpha[b, t, u] = diagonal t + u at t
        dd = (tt[:, None] + torch.arange(u_max, device=dev)[None, :])
        grid = alphas[dd, :, tt[:, None].expand(t_max, u_max)]  # [T, U, B]
        return losses, grid.permute(2, 0, 1)
    return losses


class TransducerLoss:
    """The reference's ``TransducerLoss`` module. ``packed_input`` takes
    ``x`` as ``[total, V]`` with ``batch_offset = cumsum(f_len * (y_len +
    1))`` and ``max_f_len``; it is unpacked to ``[B, max_f_len, U, V]``
    (don't-care positions zero) before the loss. ``debug_list`` receives
    the latest call's alphas ``[B, T, U]``."""

    def __init__(self, fuse_softmax_backward=True, opt=1, packed_input=False):
        del opt
        self.fuse_softmax_backward = fuse_softmax_backward
        self.packed_input = packed_input

    def __call__(self, x, label, f_len, y_len, blank_idx, batch_offset=None,
                 max_f_len=None, debug_list=None):
        if self.packed_input:
            if batch_offset is None or max_f_len is None:
                raise ValueError(
                    "batch_offset and max_f_len are required for packed input"
                )
            b = f_len.shape[0]
            u_max = label.shape[1] + 1
            v = x.shape[-1]
            dev = x.device
            starts = _starts(batch_offset)
            tt = torch.arange(max_f_len, device=dev)[None, :, None]
            uu = torch.arange(u_max, device=dev)[None, None, :]
            src = starts[:, None, None] + tt * (y_len + 1)[:, None, None] + uu
            valid = (tt < f_len[:, None, None]) & (uu <= y_len[:, None, None])
            src = torch.where(valid, src, 0)
            dense = x[src.reshape(-1)].reshape(b, max_f_len, u_max, v)
            x = torch.where(valid[..., None], dense,
                            torch.zeros((), dtype=dense.dtype, device=dev))
        out = transducer_loss(
            x, label, f_len, y_len, blank_idx,
            fuse_softmax_backward=self.fuse_softmax_backward,
            return_alphas=debug_list is not None)
        if debug_list is not None:
            losses, alphas = out
            debug_list.clear()
            debug_list.append(alphas)
            return losses
        return out
