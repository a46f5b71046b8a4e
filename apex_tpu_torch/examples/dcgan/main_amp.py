"""DCGAN with amp, two models and three losses, one scaler each: the
PyTorch port of ``examples/dcgan/main_amp.py``.

A generator and a discriminator trained adversarially under
``amp.initialize([paramsD, paramsG], [optD, optG], num_losses=3)``: three
separately scaled backwards a step (the discriminator on real images,
``loss_id`` 0, and on fakes, 1, their unscaled gradients summed; the
generator, 2), pytree ``FusedAdam`` for each model, each update skipped
on the device when its losses overflowed. The models are the JAX
script's flax modules as functions over trees with flax's names and
layouts (``Dense_0/kernel [in, out]``, convolution kernels HWIO, the
transposed convolution's kernel unflipped, SAME padding): NCHW inside,
NHWC at the edges, as flax's. Each layer's GEMM or convolution runs
without its bias, which is added after, so under O1 the cast product
meets an fp32 bias as in the JAX script. Synthetic data (uniform
images, normal latents) stands in for the reference's loaders::

    python -m apex_tpu_torch.examples.dcgan.main_amp --steps 20
    python -m apex_tpu_torch.examples.dcgan.main_amp --cpu 1 --steps 5

``--device`` picks any device (the card by default), ``--cpu N`` the
CPU. The weights are flax's default inits drawn from a
``torch.Generator`` seeded 0 and the data from one seeded 1, or, with
``--init``, an ``.npz`` file's arrays (``paramsD/<path>``,
``paramsG/<path>``, and ``real`` ``[steps, b, s, s, 3]`` and ``z``
``[steps, b, nz]``: the JAX script's draws, for a comparison). It prints
the JAX script's ``[it/steps] Loss_D d Loss_G g`` lines.
"""
from __future__ import annotations

import argparse
import math

import numpy as np
import torch
import torch.nn.functional as F

NC = 3


def parse(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--cpu", type=int, default=0)
    p.add_argument("--steps", type=int, default=20)
    p.add_argument("--batch", type=int, default=32)
    p.add_argument("--image-size", type=int, default=32)
    p.add_argument("--nz", type=int, default=100, help="latent dim")
    p.add_argument("--ngf", type=int, default=32)
    p.add_argument("--ndf", type=int, default=32)
    p.add_argument("--lr", type=float, default=2e-4)
    p.add_argument("--beta1", type=float, default=0.5)
    p.add_argument("--opt_level", default="O1")
    p.add_argument("--device", default=None,
                   help="torch device (default: the card)")
    p.add_argument("--init", default=None,
                   help=".npz with paramsD/, paramsG/, real and z in place "
                        "of the seeded draws")
    return p.parse_args(argv)


def _lecun(g, shape, fan_in, dev):
    """flax's ``lecun_normal``: a normal truncated at 2, variance
    ``1 / fan_in``."""
    t = torch.empty(shape)
    torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=g)
    return (t * (math.sqrt(1.0 / fan_in) / 0.87962566103423978)).to(dev)


def init_generator(g, nz, ngf, image_size, dev):
    """The JAX ``Generator``'s tree: ``Dense_0``, then GroupNorm and
    ConvTranspose pairs 0-2 (kernels 4 x 4, HWIO)."""
    s0 = image_size // 8
    p = {"Dense_0": {"kernel": _lecun(g, (nz, s0 * s0 * ngf * 4), nz, dev),
                     "bias": torch.zeros(s0 * s0 * ngf * 4, device=dev)}}
    cin = ngf * 4
    for i, cout in enumerate((ngf * 2, ngf, NC)):
        p[f"GroupNorm_{i}"] = {"scale": torch.ones(cin, device=dev),
                               "bias": torch.zeros(cin, device=dev)}
        p[f"ConvTranspose_{i}"] = {
            "kernel": _lecun(g, (4, 4, cin, cout), 16 * cin, dev),
            "bias": torch.zeros(cout, device=dev)}
        cin = cout
    return {"params": p}


def init_discriminator(g, ndf, image_size, dev):
    """The JAX ``Discriminator``'s tree: ``Conv_0``-``Conv_2`` (4 x 4,
    stride 2, HWIO) and ``Dense_0`` to one logit."""
    p, cin = {}, NC
    for i, cout in enumerate((ndf, ndf * 2, ndf * 4)):
        p[f"Conv_{i}"] = {"kernel": _lecun(g, (4, 4, cin, cout), 16 * cin,
                                           dev),
                          "bias": torch.zeros(cout, device=dev)}
        cin = cout
    flat = (image_size // 8) ** 2 * cin
    p["Dense_0"] = {"kernel": _lecun(g, (flat, 1), flat, dev),
                    "bias": torch.zeros(1, device=dev)}
    return {"params": p}


def _dense(x, p):
    return F.linear(x, p["kernel"].t()) + p["bias"]


def _conv(x, p):
    """flax ``Conv(4 x 4, strides 2, SAME)`` on NCHW (pads 1 and 1)."""
    y = F.conv2d(x, p["kernel"].permute(3, 2, 0, 1), stride=2, padding=1)
    return y + p["bias"].view(1, -1, 1, 1)


def _conv_transpose(x, p):
    """flax ``ConvTranspose(4 x 4, strides 2, SAME)`` on NCHW: the
    dilated input padded 2 and 2 and correlated with the kernel as it
    is, which is ``conv_transpose2d`` (a correlation with the flipped
    kernel) with the kernel flipped and padding 1."""
    w = p["kernel"].flip(0, 1).permute(2, 3, 0, 1)
    y = F.conv_transpose2d(x, w, stride=2, padding=1)
    return y + p["bias"].view(1, -1, 1, 1)


def _group_norm(x, p):
    return F.group_norm(x, 8, p["scale"], p["bias"], eps=1e-6)


def generator(params, z, image_size, ngf):
    """``[b, nz]`` -> NCHW images in (-1, 1)."""
    p = params["params"]
    s0 = image_size // 8
    x = _dense(z, p["Dense_0"]).reshape(z.shape[0], s0, s0, ngf * 4)
    x = x.permute(0, 3, 1, 2)
    for i in range(3):
        x = _conv_transpose(torch.relu(_group_norm(x, p[f"GroupNorm_{i}"])),
                            p[f"ConvTranspose_{i}"])
    return torch.tanh(x)


def discriminator(params, x):
    """NCHW images -> ``[b]`` logits (flattened in NHWC order, as flax)."""
    p = params["params"]
    for i in range(3):
        x = F.leaky_relu(_conv(x, p[f"Conv_{i}"]), 0.2)
    x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)
    return _dense(x, p["Dense_0"])[:, 0]


def bce_logits(logits, target: float):
    """BCE with logits, the JAX script's stable form."""
    return torch.mean(torch.clamp_min(logits, 0) - logits * target
                      + torch.log1p(torch.exp(-logits.abs())))


def _load(path, trees, dev):
    with np.load(path) as f:
        def walk(tree, prefix):
            if isinstance(tree, dict):
                return {k: walk(v, f"{prefix}/{k}") for k, v in tree.items()}
            return torch.from_numpy(np.asarray(f[prefix], np.float32)).to(dev)
        out = [walk(t, name) for name, t in trees]
        data = (torch.from_numpy(np.asarray(f["real"], np.float32)),
                torch.from_numpy(np.asarray(f["z"], np.float32)))
    return out, data


def main(argv=None):
    """Train; returns the ``(it, Loss_D, Loss_G)`` printed."""
    from ..._device import resolve_device
    from ...amp import (
        apply_updates_skip_on_overflow,
        initialize,
        scaled_value_and_grad,
    )
    from ...optimizers import FusedAdam

    args = parse(argv)
    if args.cpu and args.device not in (None, "cpu"):
        raise SystemExit(f"--cpu {args.cpu} runs on the CPU, not on "
                         f"--device {args.device}")
    dev = resolve_device("cpu" if args.cpu else args.device)
    size, nz, ngf, ndf = args.image_size, args.nz, args.ngf, args.ndf
    g = torch.Generator().manual_seed(0)
    paramsG = init_generator(g, nz, ngf, size, dev)
    paramsD = init_discriminator(g, ndf, size, dev)
    data = None
    if args.init is not None:
        (paramsD, paramsG), data = _load(
            args.init, (("paramsD", paramsD), ("paramsG", paramsG)), dev)

    optD = FusedAdam(lr=args.lr, betas=(args.beta1, 0.999))
    optG = FusedAdam(lr=args.lr, betas=(args.beta1, 0.999))
    [paramsD, paramsG], [optD, optG], amp_state = initialize(
        [paramsD, paramsG], [optD, optG], opt_level=args.opt_level,
        num_losses=3)
    stateD, stateG = optD.init(paramsD), optG.init(paramsG)
    scalers = [amp_state.scaler(i) for i in range(3)]
    sstates = [amp_state.scaler_state(i) for i in range(3)]

    def d_real_loss(pD, real):
        with amp_state.autocast():
            out = discriminator(pD, real)
        return bce_logits(out.float(), 1.0)

    def d_fake_loss(pD, fake):
        with amp_state.autocast():
            out = discriminator(pD, fake)
        return bce_logits(out.float(), 0.0)

    def g_loss(pG, pD, z):
        with amp_state.autocast():
            out = discriminator(pD, generator(pG, z, size, ngf))
        return bce_logits(out.float(), 1.0)

    grad_d_real = scaled_value_and_grad(d_real_loss, scalers[0])
    grad_d_fake = scaled_value_and_grad(d_fake_loss, scalers[1])
    grad_g = scaled_value_and_grad(g_loss, scalers[2])
    gdata = torch.Generator().manual_seed(1)
    printed = []
    for it in range(args.steps):
        if data is not None:
            real = data[0][it].permute(0, 3, 1, 2).to(dev)
            z = data[1][it].to(dev)
        else:
            real = (torch.rand((args.batch, NC, size, size), generator=gdata)
                    * 2 - 1).to(dev)
            z = torch.randn((args.batch, nz), generator=gdata).to(dev)
        s0, s1, s2 = sstates
        errD_real, gDr, s0 = grad_d_real(s0, paramsD, real)
        with torch.no_grad():
            fake = generator(paramsG, z, size, ngf)
        errD_fake, gDf, s1 = grad_d_fake(s1, paramsD, fake)
        gD = {"params": {k: {n: gDr["params"][k][n] + gDf["params"][k][n]
                             for n in v} for k, v in gDr["params"].items()}}
        found_d = torch.logical_or(s0.found_inf, s1.found_inf)
        newD, newSD = optD.step(gD, stateD, paramsD)
        paramsD = apply_updates_skip_on_overflow(paramsD, newD, found_d)
        stateD = apply_updates_skip_on_overflow(stateD, newSD, found_d)
        errG, gG, s2 = grad_g(s2, paramsG, paramsD, z)
        newG, newSG = optG.step(gG, stateG, paramsG)
        paramsG = apply_updates_skip_on_overflow(paramsG, newG, s2.found_inf)
        stateG = apply_updates_skip_on_overflow(stateG, newSG, s2.found_inf)
        sstates = [scalers[0].update_scale(s0), scalers[1].update_scale(s1),
                   scalers[2].update_scale(s2)]
        if it % 5 == 0 or it == args.steps - 1:
            d, gl = float(errD_real + errD_fake), float(errG)
            printed.append((it, d, gl))
            print(f"[{it}/{args.steps}] Loss_D {d:.4f} Loss_G {gl:.4f}",
                  flush=True)
    if not (np.isfinite(printed[-1][1]) and np.isfinite(printed[-1][2])):
        raise SystemExit(f"non-finite losses: {printed[-1]}")
    print("done.")
    return printed


if __name__ == "__main__":
    main()
