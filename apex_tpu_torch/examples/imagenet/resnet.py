"""The ResNet family over a parameter tree (counterpart of
``examples/imagenet/resnet.py``).

The JAX example is a flax module; this one is functional: a
:class:`ResNet` describes the architecture and :meth:`ResNet.apply` runs
it over ``params`` and ``batch_stats`` trees whose key paths are flax's
(``conv_init``, ``bn_init``, ``Bottleneck_3/BatchNorm_2/scale``,
``downsample_conv``, ``fc/kernel``, ...), so amp's key-path batchnorm
heuristic, the tree order and the optimizer state line up with the JAX
package's leaf for leaf. Layouts are torch's: conv kernels
``[out, in, kh, kw]`` (``torch.channels_last`` in memory, the tensor
cores' layout on the card), dense kernels ``[out, in]``; images NCHW,
channels-last in memory. ``convert.resnet_params_from_jax`` carries a
flax tree across.

The dtype flow is flax's, written out (torch does not promote inside a
convolution or a matmul):

- every conv computes in the dtype of the network's input (flax
  ``Conv(dtype=x.dtype)``): input and kernel are cast to it, so under O2
  the convs run in bf16 over bf16 kernels;
- every BatchNorm computes in fp32 (fp64 for an fp64 input:
  :func:`stat_dtype`) and **outputs fp32**
  (``BatchNorm(dtype=float32)``): its statistics are fp32, it normalises
  with the biased batch variance computed as E[x^2] - E[x]^2 (flax's
  ``use_fast_variance``), and its running statistics update as ``0.9 *
  running + 0.1 * batch`` with that **biased** variance, where
  ``F.batch_norm``'s own update would take the unbiased one
  (:class:`_BatchNormTrain`); so under O2 the activations between convs
  are fp32 (twice the bytes of bf16 ones) and each conv casts its input;
- the classifier is ``Dense(dtype=float32)``: fp32 input, the (bf16
  under O2) kernel cast to fp32.

``build_model(sync_bn=True)`` swaps each BatchNorm for the JAX example's
SyncBatchNorm adapter (``_SyncBNShim``): ``parallel.sync_batch_norm``
synced over the data-parallel ranks, momentum 0.1, the statistics in
fp32 but the output in the conv's dtype (bf16 under O2), as there.

The convs and the classifier are called through the module attributes
(``F.conv2d``, ``F.linear``) at call time, so the O1 autocast's patches
apply, as flax reaches ``lax.conv_general_dilated`` and
``lax.dot_general`` by attribute. Padding is flax's ``"SAME"``
(``_same_pads``): a stride-2 3x3 conv over an even size pads 0 before
and 1 after, where torchvision's ResNet pads 1 and 1.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Sequence, Tuple

import torch
import torch.nn.functional as F

from ...parallel.sync_batchnorm import sync_batch_norm

Tree = Dict[str, Any]

#: flax BatchNorm's momentum and epsilon (``resnet.py:build_model``)
BN_MOMENTUM = 0.9
BN_EPS = 1e-5
#: the JAX example's SyncBatchNorm adapter's momentum (``resnet.py:173``)
SYNC_BN_MOMENTUM = 0.1
_EXPANSION = {"BasicBlock": 1, "Bottleneck": 4}

_ARCHS = {
    "resnet18": ((2, 2, 2, 2), "BasicBlock"),
    "resnet34": ((3, 4, 6, 3), "BasicBlock"),
    "resnet50": ((3, 4, 6, 3), "Bottleneck"),
    "resnet101": ((3, 4, 23, 3), "Bottleneck"),
    "resnet152": ((3, 8, 36, 3), "Bottleneck"),
}


def model_names():
    return sorted(_ARCHS)


def _same_pads(size: int, k: int, s: int) -> Tuple[int, int]:
    """flax/XLA ``"SAME"`` padding of one spatial dim: (before, after)."""
    out = -(-size // s)
    total = max((out - 1) * s + k - size, 0)
    return total // 2, total - total // 2


def _conv(x, kernel, stride: int, dtype, pads=None):
    """A bias-free conv in ``dtype`` (flax ``Conv(dtype=...)``): input and
    kernel cast to it; ``pads`` ((top, bottom), (left, right)) or flax's
    ``"SAME"``."""
    k = kernel.shape[-1]
    if pads is None:
        pads = (_same_pads(x.shape[2], k, stride),
                _same_pads(x.shape[3], k, stride))
    (t, b), (l, r) = pads
    x = x.to(dtype)
    if t == b and l == r:
        return F.conv2d(x, kernel.to(dtype), None, stride, (t, l))
    return F.conv2d(F.pad(x, (l, r, t, b)), kernel.to(dtype), None, stride)


def _per_channel(v):
    return v[:, None, None]


def stat_dtype(dtype: torch.dtype) -> torch.dtype:
    """The dtype the BatchNorm and the classifier compute in: fp32, or
    fp64 for an fp64 input (flax's "at least float32"; JAX runs without
    fp64, the port's fp64 runs serve as a reference)."""
    return torch.promote_types(dtype, torch.float32)


class _BatchNormTrain(torch.autograd.Function):
    """flax's training BatchNorm over NCHW with fp32 statistics and
    output: ``mean`` and ``var = max(E[x^2] - mean^2, 0)`` per channel
    (the biased variance, ``use_fast_variance``), ``y = (x - mean) *
    (rsqrt(var + eps) * scale) + bias``; returns ``(y, mean, var)``, the
    last two without gradient. The backward is the closed form of the
    same function's derivative (the variance's term vanishes where the
    clamp is active, as ``jnp.maximum``'s does), so only ``x`` in its own
    dtype and per-channel vectors are kept for it, where autograd through
    the same forward ops keeps the fp32 input and the centred input: on
    ResNet-50 O2 bf16 at batch 256, autograd's step peaked at 38.0 GiB
    against 21.9-22.6 and took 358 ms against 265-270 (one H100 80GB
    HBM3 at 700 W, ``tools/torch_resnet_bn_ab.py``). A non-finite input gives
    what flax gives (inf - inf in the variance: NaN)."""

    @staticmethod
    def forward(ctx, x, scale, bias, eps):
        xf = x.to(scale.dtype)
        mean = xf.mean(_DIMS)
        diff = (xf * xf).mean(_DIMS) - mean * mean
        var = diff.clamp_min(0.0)
        rstd = torch.rsqrt(var + eps)
        y = (xf - _per_channel(mean)) * _per_channel(rstd * scale) \
            + _per_channel(bias)
        ctx.save_for_backward(x, scale, mean, rstd, diff > 0)
        ctx.mark_non_differentiable(mean, var)
        return y, mean, var

    @staticmethod
    def backward(ctx, gy, _gmean, _gvar):
        x, scale, mean, rstd, live = ctx.saved_tensors
        n = x.numel() // x.shape[1]
        xhat = (x.to(scale.dtype) - _per_channel(mean)) * _per_channel(rstd)
        gsum = gy.sum(_DIMS)
        gxhat = (gy * xhat).sum(_DIMS)
        dx = _per_channel(scale * rstd) * (
            gy - _per_channel(gsum / n)
            - xhat * _per_channel(gxhat * live / n))
        return dx.to(x.dtype), gxhat, gsum, None


_DIMS = (0, 2, 3)


def _batch_norm(x, p: Tree, stats: Tree, train: bool, new_stats: Tree,
                name: str, sync_axis=None):
    """flax ``BatchNorm(dtype=float32)`` over NCHW: fp32 statistics and
    output. In training the batch statistics normalise and the running
    ones update into ``new_stats[name]`` (no gradient flows into them);
    in evaluation the running ones normalise.

    With ``sync_axis`` (``build_model(sync_bn=True)``) it is the JAX
    example's SyncBatchNorm instead (``parallel.sync_batch_norm`` over
    that axis, momentum 0.1): the statistics and the input gradient's
    sums synced across the data-parallel ranks in the closed-form
    backward of ``SyncBatchNormFunction``, two-pass variance, the
    unbiased variance into the running one, the output in ``x``'s
    dtype."""
    if sync_axis is not None:
        y, new_rm, new_rv = sync_batch_norm(
            x, p["scale"], p["bias"], stats["mean"], stats["var"],
            training=train, momentum=SYNC_BN_MOMENTUM, eps=BN_EPS,
            axis_name=sync_axis if train else None, channel_last=False)
        if train:
            new_stats[name] = {"mean": new_rm, "var": new_rv}
        return y
    ct = stat_dtype(x.dtype)
    scale, bias = p["scale"].to(ct), p["bias"].to(ct)
    if not train:
        mul = torch.rsqrt(stats["var"].to(ct) + BN_EPS) * scale
        return (x.to(ct) - _per_channel(stats["mean"].to(ct))) \
            * _per_channel(mul) + _per_channel(bias)
    y, mean, var = _BatchNormTrain.apply(x, scale, bias, BN_EPS)
    new_stats[name] = {
        "mean": BN_MOMENTUM * stats["mean"] + (1 - BN_MOMENTUM) * mean,
        "var": BN_MOMENTUM * stats["var"] + (1 - BN_MOMENTUM) * var}
    return y


@dataclasses.dataclass(frozen=True)
class ResNet:
    stage_sizes: Sequence[int]
    block: str  # "BasicBlock" or "Bottleneck"
    num_classes: int = 1000
    num_filters: int = 64
    #: the JAX example's ``sync_bn``: SyncBatchNorm over ``bn_axis_name``
    sync_bn: bool = False
    bn_axis_name: str = "data"

    def blocks(self):
        """``(name, features, stride, in_channels, out_channels)`` of every
        block in order, named as flax names them (``Bottleneck_0`` ...)."""
        exp = _EXPANSION[self.block]
        cin, idx = self.num_filters, 0
        for i, count in enumerate(self.stage_sizes):
            feats = self.num_filters * 2 ** i
            for j in range(count):
                stride = 2 if i > 0 and j == 0 else 1
                yield (f"{self.block}_{idx}", feats, stride, cin,
                       feats * exp)
                cin, idx = feats * exp, idx + 1

    def _convs(self, feats: int, stride: int, cin: int, cout: int):
        """``(conv name, kernel size, stride, in, out)`` of one block's main
        branch, then its norms' names (the last zero-initialised)."""
        if self.block == "Bottleneck":
            convs = [("Conv_0", 1, 1, cin, feats),
                     ("Conv_1", 3, stride, feats, feats),
                     ("Conv_2", 1, 1, feats, cout)]
        else:
            convs = [("Conv_0", 3, stride, cin, feats),
                     ("Conv_1", 3, 1, feats, feats)]
        # flax names an unnamed norm by its module class: BatchNorm, or
        # the JAX example's SyncBatchNorm adapter
        norm = "_SyncBNShim" if self.sync_bn else "BatchNorm"
        return convs, [f"{norm}_{i}" for i in range(len(convs))]

    def _shapes(self) -> Tuple[Tree, Tree]:
        """The ``params`` and ``batch_stats`` trees' leaf shapes, in the
        port's layouts, with each BatchNorm scale's initial value."""
        def bn(c, one=1.0):
            return {"scale": ((c,), one), "bias": ((c,), 0.0)}

        params = {"conv_init": {"kernel": (self.num_filters, 3, 7, 7)},
                  "bn_init": bn(self.num_filters)}
        stats = {"bn_init": self.num_filters}
        for name, feats, stride, cin, cout in self.blocks():
            convs, norms = self._convs(feats, stride, cin, cout)
            blk, bst = {}, {}
            for (cname, k, _, ci, co), nname in zip(convs, norms):
                blk[cname] = {"kernel": (co, ci, k, k)}
                blk[nname] = bn(co, 0.0 if nname == norms[-1] else 1.0)
                bst[nname] = co
            if cin != cout or stride != 1:
                blk["downsample_conv"] = {"kernel": (cout, cin, 1, 1)}
                blk["downsample_bn"] = bn(cout)
                bst["downsample_bn"] = cout
            params[name], stats[name] = blk, bst
        feat = self.num_filters * 2 ** (len(self.stage_sizes) - 1) * \
            _EXPANSION[self.block]
        params["fc"] = {"kernel": (self.num_classes, feat),
                        "bias": ((self.num_classes,), 0.0)}
        return params, stats

    def init(self, generator: torch.Generator, device=None
             ) -> Tuple[Tree, Tree]:
        """Random ``(params, batch_stats)`` from ``generator``, with flax's
        initialiser families: lecun-normal kernels (a normal truncated at
        two standard deviations, std sqrt(1 / fan_in) / 0.8796...), BatchNorm
        scales one but zero on each block's last norm, biases zero; running
        means zero and variances one. Leaves are drawn in the tree's
        flatten order (sorted keys) on ``generator``'s device, fp32; conv
        kernels lie channels-last in memory."""
        dev = generator.device if device is None else torch.device(device)
        shapes, stat_shapes = self._shapes()

        def make(tree):
            out = {}
            for key in sorted(tree):
                v = tree[key]
                if isinstance(v, dict):
                    out[key] = make(v)
                elif key == "kernel":
                    t = torch.empty(v, device=generator.device)
                    fan_in = math.prod(v[1:])
                    std = math.sqrt(1.0 / fan_in) / .87962566103423978
                    torch.nn.init.trunc_normal_(t, 0.0, std, -2 * std,
                                                2 * std, generator=generator)
                    t = t.to(dev)
                    out[key] = (t.contiguous(memory_format=torch.channels_last)
                                if t.dim() == 4 else t)
                else:
                    shape, value = v
                    out[key] = torch.full(shape, value, device=dev)
            return out

        def stats(tree):
            return {k: stats(v) if isinstance(v, dict) else
                    {"mean": torch.zeros(v, device=dev),
                     "var": torch.ones(v, device=dev)}
                    for k, v in tree.items()}

        return make(shapes), stats(stat_shapes)

    def apply(self, params: Tree, batch_stats: Tree, x: torch.Tensor,
              train: bool = True):
        """Logits of NCHW images ``x`` (channels-last in memory on the
        card); in training also the updated ``batch_stats`` (``(logits,
        new_batch_stats)``, flax's ``mutable=["batch_stats"]``)."""
        dtype = x.dtype
        new = {}

        sync = self.bn_axis_name if self.sync_bn else None

        def norm(h, p, s, name, out):
            return _batch_norm(h, p[name], s[name], train, out, name, sync)

        h = _conv(x, params["conv_init"]["kernel"], 2, dtype,
                  ((3, 3), (3, 3)))
        h = F.relu(norm(h, params, batch_stats, "bn_init", new))
        h = F.max_pool2d(h, 3, 2, 1)
        for name, feats, stride, cin, cout in self.blocks():
            p, s, out = params[name], batch_stats[name], {}
            convs, norms = self._convs(feats, stride, cin, cout)
            y = h
            for i, ((cname, _, cstride, _, _), nname) in enumerate(
                    zip(convs, norms)):
                y = norm(_conv(y, p[cname]["kernel"], cstride, dtype), p, s,
                         nname, out)
                if i < len(convs) - 1:
                    y = F.relu(y)
            residual = h
            if "downsample_conv" in p:
                residual = norm(_conv(h, p["downsample_conv"]["kernel"],
                                      stride, dtype),
                                p, s, "downsample_bn", out)
            h = F.relu(y + residual)
            new[name] = out
        h = torch.mean(h, (2, 3))
        # classifier in fp32 (the example's `criterion(output.float())`)
        ct = stat_dtype(h.dtype)
        logits = F.linear(h.to(ct), params["fc"]["kernel"].to(ct),
                          params["fc"]["bias"].to(ct))
        return (logits, new) if train else logits


def build_model(arch: str, num_classes: int = 1000, sync_bn: bool = False,
                bn_axis_name: str = "data") -> ResNet:
    """A ResNet by name. ``sync_bn=True`` normalises with SyncBatchNorm
    over the data-parallel ranks of ``bn_axis_name`` (the JAX example's
    ``convert_syncbn_model`` path; its norms are named as flax names the
    JAX example's, ``_SyncBNShim_<i>``)."""
    if arch not in _ARCHS:
        raise ValueError(f"unknown arch {arch!r}; options {model_names()}")
    stages, block = _ARCHS[arch]
    return ResNet(stage_sizes=stages, block=block, num_classes=num_classes,
                  sync_bn=sync_bn, bn_axis_name=bn_axis_name)


def init_params(arch: str, generator: torch.Generator,
                num_classes: int = 1000, device=None) -> Tuple[Tree, Tree]:
    """``(params, batch_stats)`` of ``arch`` drawn from ``generator``
    (:meth:`ResNet.init`)."""
    return build_model(arch, num_classes).init(generator, device)
