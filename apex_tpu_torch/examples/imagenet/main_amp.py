"""ImageNet training with amp: the PyTorch port of
``examples/imagenet/main_amp.py``, itself a port of Apex's
``examples/imagenet/main_amp.py``.

BASELINE config #1, ResNet-50 with amp O2 and FusedSGD on one card::

    python -m apex_tpu_torch.examples.imagenet.main_amp --synthetic \\
        --arch resnet50 --opt-level O2 -b 256

Kept from the JAX example: the flags, per-epoch train / validate, the
prec@1 / prec@5 ``AverageMeter``s, the ``Speed`` img/s prints, the lr
schedule (5-epoch warm-up, /10 at 30, 60 and 80), the checkpoint's keys,
synthetic uint8 NHWC batches with the same bytes from the same seed, and
the step: forward with batch statistics -> ``amp.scaled_value_and_grad``
-> the fused optimizer's step with ``found_inf`` -> the BatchNorm running
statistics kept on an overflow -> ``update_scale`` -> prec@1/5, with no
host read but the prints and the checkpoint.

Differences, by design:

- one device: ``--cpu N`` (a virtual N-device CPU mesh) becomes
  ``--device`` (the card by default, ``cpu`` for the plain path). A world
  size above 1 (``WORLD_SIZE``) and ``--sync_bn`` raise: DDP and
  SyncBatchNorm come with the distributed slice (ROADMAP.md, A6);
- the images reach the model NCHW, channels-last in memory: the uint8
  NHWC batch is permuted on the device inside :func:`_normalize` (a view,
  no copy), the layout the tensor cores' convolutions take;
- ``torch.backends.cudnn.benchmark`` is on unless ``--deterministic``
  (Apex's example sets it so), logged at start;
- the checkpoint pickles numpy trees in flax's layouts
  (``convert.resnet_params_to_jax``), so each package's file holds the
  same keys and shapes.
"""
from __future__ import annotations

import argparse
import os
import pickle
import time

import numpy as np
import torch
import torch.nn.functional as F

from ... import amp
from ..._device import resolve_device
from ..._tree import tree_map
from ...convert import resnet_params_from_jax, resnet_params_to_jax
from ...optimizers import FusedAdam, FusedSGD
from . import resnet as resnet_lib


def parse(argv=None):
    parser = argparse.ArgumentParser(description="PyTorch ImageNet Training")
    parser.add_argument("data", nargs="?", default=None,
                        help="path to dataset (omit with --synthetic)")
    parser.add_argument("--arch", "-a", default="resnet50",
                        choices=resnet_lib.model_names())
    parser.add_argument("--epochs", default=90, type=int)
    parser.add_argument("--start-epoch", default=0, type=int)
    parser.add_argument("-b", "--batch-size", default=256, type=int,
                        help="global batch size")
    parser.add_argument("--lr", "--learning-rate", default=0.1, type=float,
                        help="initial lr, scaled by global_batch/256 with "
                             "5-epoch warmup (reference behaviour)")
    parser.add_argument("--momentum", default=0.9, type=float)
    parser.add_argument("--weight-decay", "--wd", default=1e-4, type=float)
    parser.add_argument("--print-freq", "-p", default=10, type=int)
    parser.add_argument("--resume", default="", type=str)
    parser.add_argument("--evaluate", "-e", action="store_true")
    parser.add_argument("--prof", default=-1, type=int,
                        help="run only N iterations (profiling)")
    parser.add_argument("--deterministic", action="store_true")
    parser.add_argument("--sync_bn", action="store_true",
                        help="SyncBatchNorm across ranks (not ported yet)")
    parser.add_argument("--opt-level", type=str, default="O2")
    parser.add_argument("--keep-batchnorm-fp32", type=str, default=None)
    parser.add_argument("--loss-scale", type=str, default=None)
    parser.add_argument("--optimizer", choices=["sgd", "adam"], default="sgd",
                        help="FusedSGD (config #1) or FusedAdam (config #2)")
    parser.add_argument("--synthetic", action="store_true",
                        help="random data (throughput measurement)")
    parser.add_argument("--reuse-batches", default=0, type=int, metavar="N",
                        help="stage N synthetic batches on the device once "
                             "and cycle them (what a prefetching input "
                             "pipeline reaches in steady state)")
    parser.add_argument("--steps-per-epoch", default=100, type=int,
                        help="synthetic epoch length")
    parser.add_argument("--image-size", default=224, type=int)
    parser.add_argument("--num-classes", default=1000, type=int)
    parser.add_argument("--half-dtype", choices=["bfloat16", "float16"],
                        default="bfloat16")
    parser.add_argument("--device", default=None,
                        help="torch device (default: the card; 'cpu' runs "
                             "the plain path)")
    return parser.parse_args(argv)


class AverageMeter:
    """Reference ``main_amp.py:407-424``."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.val = 0.0
        self.avg = 0.0
        self.sum = 0.0
        self.count = 0

    def update(self, val, n=1):
        self.val = val
        self.sum += val * n
        self.count += n
        self.avg = self.sum / self.count


def accuracy_topk(logits: torch.Tensor, target: torch.Tensor, topk=(1, 5)):
    """prec@k over the batch (reference ``main_amp.py:427-440``), 0-dim
    device tensors."""
    maxk = max(topk)
    _, pred = torch.topk(logits, maxk, dim=1)
    correct = pred == target[:, None]
    return [100.0 * correct[:, :k].any(dim=1).float().mean() for k in topk]


def adjust_learning_rate(base_lr, epoch, step, len_epoch):
    """The reference schedule verbatim (``main_amp.py:470-486``)."""
    factor = epoch // 30
    if epoch >= 80:
        factor = factor + 1
    lr = base_lr * (0.1 ** factor)
    if epoch < 5:  # gradual warmup
        lr = lr * float(1 + step + epoch * len_epoch) / (5.0 * len_epoch)
    return lr


# ImageNet mean/std in 0..255 units: the reference's data_prefetcher
# normalises uint8 images on the GPU with these constants
# (``main_amp.py:204-209``); the host only ships uint8
_MEAN255 = np.array([0.485, 0.456, 0.406], np.float32) * 255.0
_STD255 = np.array([0.229, 0.224, 0.225], np.float32) * 255.0


def synthetic_batches(rng: np.random.Generator, n_steps, global_batch, size,
                      num_classes, dtype=None):
    """uint8 NHWC images and int32 labels, the JAX example's bytes for
    the same ``rng``."""
    del dtype  # images are uint8, like a real JPEG pipeline's fast_collate
    for _ in range(n_steps):
        x = rng.integers(0, 256, (global_batch, size, size, 3), dtype=np.uint8)
        y = rng.integers(0, num_classes, (global_batch,)).astype(np.int32)
        yield x, y


def _norm_consts(device):
    """The mean and std as tensors on ``device``: made once a step
    function, so no step copies them from the host."""
    return (torch.as_tensor(_MEAN255, device=device),
            torch.as_tensor(_STD255, device=device))


def _normalize(x: torch.Tensor, half_dtype, cast_input: bool, consts=None):
    """uint8 NHWC -> normalised float NCHW (channels-last in memory), on
    the device: the data_prefetcher analogue. ``consts``: the
    :func:`_norm_consts` of ``x``'s device."""
    mean, std = consts if consts is not None else _norm_consts(x.device)
    x = ((x.to(torch.float32) - mean) / std).permute(0, 3, 1, 2)
    return x.to(half_dtype) if cast_input else x


def _loss(logits, y):
    logp = F.log_softmax(logits.to(resnet_lib.stat_dtype(logits.dtype)),
                         dim=-1)
    return -torch.mean(torch.gather(logp, 1, y.long()[:, None]))


def make_train_step(model, optimizer, scaler, half_dtype, cast_input):
    """One train step at world size 1: forward with batch statistics ->
    scaled gradients -> the fused optimizer with the overflow skip -> the
    scale update. ``step(params, batch_stats, opt_state, scaler_state, x,
    y, lr) -> (params, batch_stats, opt_state, scaler_state, loss, prec1,
    prec5)``, every output on the device."""

    def loss_fn(params, batch_stats, x, y):
        logits, new_bstats = model.apply(params, batch_stats, x, train=True)
        return _loss(logits, y), (new_bstats, logits)

    grad_fn = amp.scaled_value_and_grad(loss_fn, scaler, has_aux=True)
    consts = {}

    def step(params, batch_stats, opt_state, scaler_state, x, y, lr):
        if x.device not in consts:
            consts[x.device] = _norm_consts(x.device)
        x = _normalize(x, half_dtype, cast_input, consts[x.device])
        (loss, (new_bstats, logits)), grads, sstate = grad_fn(
            scaler_state, params, batch_stats, x, y)
        found_inf = sstate.found_inf
        new_params, new_opt_state = optimizer.step(
            grads, opt_state, params, lr=lr, found_inf=found_inf)
        # the running statistics update only on non-overflow steps, like
        # the reference's skipped optimizer.step
        new_bstats = tree_map(lambda old, new: torch.where(found_inf, old, new),
                              batch_stats, new_bstats)
        new_sstate = scaler.update_scale(sstate)
        prec1, prec5 = accuracy_topk(logits, y)
        return (new_params, new_bstats, new_opt_state, new_sstate,
                loss, prec1, prec5)

    return step


def make_eval_step(model, half_dtype, cast_input):
    consts = {}

    def step(params, batch_stats, x, y):
        if x.device not in consts:
            consts[x.device] = _norm_consts(x.device)
        with torch.no_grad():
            x = _normalize(x, half_dtype, cast_input, consts[x.device])
            logits = model.apply(params, batch_stats, x, train=False)
            prec1, prec5 = accuracy_topk(logits, y)
            return _loss(logits, y), prec1, prec5

    return step


def _to_host(tree):
    """A tree of tensors as numpy arrays (float32 for bf16)."""
    def leaf(t):
        if not isinstance(t, torch.Tensor):
            return t
        t = t.detach().cpu()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()
    return tree_map(leaf, tree)


def _checkpoint_tree(tree):
    """A params-shaped tree (params, momentum buffers, masters) in flax's
    layouts; a named-tuple optimizer state field by field."""
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_checkpoint_tree(v) for v in tree))
    if isinstance(tree, dict):
        return resnet_params_to_jax(tree)
    return _to_host(tree)


def _from_checkpoint(tree, like, device):
    """Inverse of :func:`_checkpoint_tree` onto the dtypes of ``like``."""
    if isinstance(like, tuple) and hasattr(like, "_fields"):
        return type(like)(*(_from_checkpoint(t, l, device)
                            for t, l in zip(tree, like)))
    if isinstance(like, dict):
        new = resnet_params_from_jax(tree, device=device)[0]
        return tree_map(lambda n, o: n.to(o.dtype), new, like)
    if isinstance(like, torch.Tensor):
        return torch.as_tensor(np.asarray(tree), device=device).to(like.dtype)
    return tree


def main(args=None):
    args = args or parse()
    if not args.synthetic:
        raise SystemExit(
            "a real JPEG input pipeline is not wired up in this port: run "
            "with --synthetic; passing a data directory would otherwise "
            "silently train on noise")
    if int(os.environ.get("WORLD_SIZE", "1")) > 1:
        raise NotImplementedError(
            "a world size above 1 needs DDP, which comes with the "
            "distributed slice (ROADMAP.md, queue A6)")
    if args.data:
        print(f"note: ignoring data dir {args.data!r} (synthetic mode)")
    print("opt_level =", args.opt_level)
    print("keep_batchnorm_fp32 =", args.keep_batchnorm_fp32)
    print("loss_scale =", args.loss_scale)

    dev = resolve_device(args.device)
    kind = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
            else "cpu")
    print(f"devices: 1 x {kind}")
    if dev.type == "cuda":
        torch.backends.cudnn.benchmark = not args.deterministic
        torch.backends.cudnn.deterministic = args.deterministic
        print(f"cudnn.benchmark = {torch.backends.cudnn.benchmark}, "
              f"cudnn.allow_tf32 = {torch.backends.cudnn.allow_tf32}, "
              f"matmul.allow_tf32 = {torch.backends.cuda.matmul.allow_tf32}")

    half_dtype = (torch.bfloat16 if args.half_dtype == "bfloat16"
                  else torch.float16)
    seed = 0 if args.deterministic else int(time.time())
    rng = np.random.default_rng(seed)

    model = resnet_lib.build_model(args.arch, num_classes=args.num_classes,
                                   sync_bn=args.sync_bn)
    params, batch_stats = model.init(
        torch.Generator(device=dev).manual_seed(seed))

    # lr scaled by global batch / 256, as the reference (`main_amp.py:167`)
    base_lr = args.lr * float(args.batch_size) / 256.0

    if args.optimizer == "sgd":
        optimizer = FusedSGD(lr=base_lr, momentum=args.momentum,
                             weight_decay=args.weight_decay)
    else:
        optimizer = FusedAdam(lr=base_lr, weight_decay=args.weight_decay)

    kbn = None
    if args.keep_batchnorm_fp32 is not None:
        kbn = args.keep_batchnorm_fp32.lower() == "true"
    loss_scale = None
    if args.loss_scale is not None:
        loss_scale = ("dynamic" if args.loss_scale == "dynamic"
                      else float(args.loss_scale))

    params, optimizer, amp_state = amp.initialize(
        params, optimizer, opt_level=args.opt_level,
        keep_batchnorm_fp32=kbn, loss_scale=loss_scale,
        half_dtype=half_dtype)
    scaler = amp_state.scaler(0)
    scaler_state = amp_state.scaler_state(0)
    opt_state = optimizer.init(params)

    cast_input = amp_state.opt_properties.cast_model_type not in (
        None, torch.float32)
    train_step = make_train_step(model, optimizer, scaler, half_dtype,
                                 cast_input)
    eval_step = make_eval_step(model, half_dtype, cast_input)

    start_epoch = args.start_epoch
    resumed_best_prec1 = 0.0
    if args.resume:
        if os.path.isfile(args.resume):
            with open(args.resume, "rb") as f:
                ck = pickle.load(f)  # a file this script wrote
            params = _from_checkpoint(ck["params"], params, dev)
            batch_stats = _from_checkpoint(ck["batch_stats"], batch_stats,
                                           dev)
            opt_state = _from_checkpoint(ck["opt_state"], opt_state, dev)
            amp_state = amp_state.load_state_dict(ck["amp"])
            scaler_state = amp_state.scaler_state(0)
            start_epoch = ck["epoch"]
            resumed_best_prec1 = ck.get("best_prec1", 0.0)
            print(f"=> loaded checkpoint '{args.resume}' (epoch "
                  f"{start_epoch})")
        else:
            print(f"=> no checkpoint found at '{args.resume}'")

    def on_device(x, y):
        return (torch.from_numpy(x).to(dev),
                torch.from_numpy(y).to(dev))

    len_epoch = args.steps_per_epoch
    if args.reuse_batches:
        staged = [on_device(x, y) for x, y in synthetic_batches(
            rng, args.reuse_batches, args.batch_size, args.image_size,
            args.num_classes)]

        def batches():
            for i in range(len_epoch):
                yield staged[i % len(staged)]
    else:
        def batches():
            for x, y in synthetic_batches(rng, len_epoch, args.batch_size,
                                          args.image_size, args.num_classes):
                yield on_device(x, y)

    if args.evaluate:
        validate(eval_step, params, batch_stats, batches(), args)
        return

    best_prec1 = resumed_best_prec1
    for epoch in range(start_epoch, args.epochs):
        batch_time = AverageMeter()
        losses = AverageMeter()
        top1 = AverageMeter()
        top5 = AverageMeter()

        end = time.time()
        last_print = -1
        for i, (x, y) in enumerate(batches()):
            if args.prof >= 0 and i > args.prof:
                print("Profiling ended at iteration", i)
                break
            lr = adjust_learning_rate(base_lr, epoch, i, len_epoch)
            (params, batch_stats, opt_state, scaler_state,
             loss, prec1, prec5) = train_step(
                params, batch_stats, opt_state, scaler_state, x, y, lr)
            if i % args.print_freq == 0 or i == len_epoch - 1:
                loss = float(loss)  # reads the device: the step is done
                batch_time.update((time.time() - end) / (i - last_print))
                last_print = i
                losses.update(loss, args.batch_size)
                top1.update(float(prec1), args.batch_size)
                top5.update(float(prec5), args.batch_size)
                speed = args.batch_size / batch_time.val
                print(f"Epoch: [{epoch}][{i}/{len_epoch}]\t"
                      f"Time {batch_time.val:.3f} ({batch_time.avg:.3f})\t"
                      f"Speed {speed:.3f} "
                      f"({args.batch_size / max(batch_time.avg, 1e-9):.3f})\t"
                      f"Loss {losses.val:.10f} ({losses.avg:.4f})\t"
                      f"Prec@1 {top1.val:.3f} ({top1.avg:.3f})\t"
                      f"Prec@5 {top5.val:.3f} ({top5.avg:.3f})")
                end = time.time()

        prec1 = validate(eval_step, params, batch_stats, batches(), args)
        is_best = prec1 > best_prec1
        best_prec1 = max(prec1, best_prec1)
        ck = {
            "epoch": epoch + 1,
            "arch": args.arch,
            "params": _checkpoint_tree(params),
            "batch_stats": _to_host(batch_stats),
            "opt_state": _checkpoint_tree(opt_state),
            "amp": amp_state.with_scaler_state(0, scaler_state).state_dict(),
            "best_prec1": best_prec1,
        }
        with open("checkpoint.pkl", "wb") as f:
            pickle.dump(ck, f)
        if is_best:
            with open("model_best.pkl", "wb") as f:
                pickle.dump(ck, f)

    return best_prec1


def validate(eval_step, params, batch_stats, batches, args):
    losses = AverageMeter()
    top1 = AverageMeter()
    top5 = AverageMeter()
    end = time.time()
    last_print = -1
    for i, (x, y) in enumerate(batches):
        loss, prec1, prec5 = eval_step(params, batch_stats, x, y)
        losses.update(float(loss), args.batch_size)
        top1.update(float(prec1), args.batch_size)
        top5.update(float(prec5), args.batch_size)
        if i % args.print_freq == 0:
            dt = (time.time() - end) / (i - last_print)
            last_print = i
            print(f"Test: [{i}]\t"
                  f"Speed {args.batch_size / max(dt, 1e-9):.3f}\t"
                  f"Loss {losses.val:.4f} ({losses.avg:.4f})\t"
                  f"Prec@1 {top1.val:.3f} ({top1.avg:.3f})\t"
                  f"Prec@5 {top5.val:.3f} ({top5.avg:.3f})")
            end = time.time()
    print(f" * Prec@1 {top1.avg:.3f} Prec@5 {top5.avg:.3f}")
    return top1.avg


if __name__ == "__main__":
    main()
