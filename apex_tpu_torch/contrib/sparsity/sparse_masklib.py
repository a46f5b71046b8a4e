"""m:n structured-sparsity masks (counterpart of
``apex_tpu/contrib/sparsity/sparse_masklib.py``).

``mn_1d_best`` views a matrix as rows of ``m``-element groups, scores
every valid m:n keep-pattern by the sum of the kept ``|w|`` and takes
the first best pattern a group (``argmax``). The JAX package scores with
a matmul, ``groups @ patterns.T``; on the card that would be a cuBLAS
GEMM that may round in TF32, and a rounded score flips ``argmax`` on a
near tie. Here each score is the kept values added one by one, left to
right: for the 2:4 pattern one fp32 addition of two non-negative values,
which rounds the same on every device and equals the matmul's (its other
terms are exact zeros), so the masks are equal bit for bit across
devices and against the JAX package.

``create_mask`` dispatches on rank and prunes along the input-channel
direction as the JAX package does: 1D -> (1, n); 2D (K, C) along C; 3D
(K, C, R) as (K*R, C); 4D (K, C, R, S) as (R*S*K, C). Masks come back in
the tensor's dtype (1.0 / 0.0).
"""
from __future__ import annotations

from itertools import permutations

import numpy as np
import torch
import torch.nn.functional as F


def _valid_patterns(m: int, n: int) -> np.ndarray:
    base = [1.0] * n + [0.0] * (m - n)
    pats = sorted(set(permutations(base)))
    return np.asarray(pats, np.float32)


def mn_1d_best(matrix: torch.Tensor, m: int, n: int) -> torch.Tensor:
    """Best m:n pattern per m-element group along the last dim."""
    rows, cols = matrix.shape
    pad = (-cols) % m
    mat = F.pad(matrix.to(torch.float32), (0, pad))
    groups = mat.abs().reshape(-1, m)
    pats = _valid_patterns(m, n)
    scores = []
    for pat in pats:
        kept = np.flatnonzero(pat)
        s = groups[:, kept[0]]
        for j in kept[1:]:
            s = s + groups[:, j]
        scores.append(s)
    best = torch.argmax(torch.stack(scores, dim=1), dim=1)
    patterns = torch.from_numpy(pats).to(matrix.device)
    return patterns[best].reshape(rows, cols + pad)[:, :cols]


def m4n2_1d(mat, density=0.5):
    del density  # fixed by the 4:2 pattern (reference signature)
    return mn_1d_best(mat, 4, 2)


_PATTERN_FUNCS = {"m4n2_1d": m4n2_1d}


def create_mask(tensor: torch.Tensor, pattern: str = "m4n2_1d",
                density: float = 0.5) -> torch.Tensor:
    """The reference's ``create_mask``: a 0/1 mask in the tensor's dtype,
    pruned along the input-channel direction."""
    if pattern not in _PATTERN_FUNCS:
        raise ValueError(f"unknown sparsity pattern {pattern!r}")
    func = _PATTERN_FUNCS[pattern]
    t = tensor.to(torch.float32)
    shape = tensor.shape
    if t.dim() == 1:
        mask = func(t.reshape(1, -1), density).reshape(shape)
    elif t.dim() == 2:  # linear (K, C): prune along C
        mask = func(t, density)
    elif t.dim() == 3:  # conv1d (K, C, R): prune along C
        k, c, r = shape
        tm = t.permute(0, 2, 1).reshape(k * r, c)
        mask = func(tm, density).reshape(k, r, c).permute(0, 2, 1)
    elif t.dim() == 4:  # conv2d (K, C, R, S): prune along C
        k, c, r, s = shape
        tm = t.permute(2, 3, 0, 1).reshape(r * s * k, c)
        mask = func(tm, density).reshape(r, s, k, c).permute(2, 3, 0, 1)
    else:
        raise ValueError(f"unsupported tensor rank {t.dim()}")
    return mask.to(tensor.dtype).contiguous()
