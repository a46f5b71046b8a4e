"""The port's imagenet ResNet (``apex_tpu_torch.examples.imagenet``)
against the JAX package's (``examples/imagenet``), on the CPU: the model.

The flax weights are carried across with ``convert.resnet_params_from_jax``
and the same numpy-seeded images go through both:

- ResNet-18 at 16 and 32 px and ResNet-50 at 32 px, batch 4, 10
  classes, fp32: in training the logits, the loss, every gradient leaf
  and the new running statistics (flax's biased variance, E[x^2] -
  E[x]^2); in evaluation the logits;
- ``synthetic_batches``'s bytes, ``_normalize``, ``accuracy_topk``, the
  schedule, the initialiser families and the fp64 path.

The train steps, the overflow skip and the CLI are in
``test_torch_resnet_train.py``.

Tolerances: fp32 loss within 1e-5 relative; gradients within 1e-4 of
each leaf's largest entry for ResNet-18 at 32 px, and 1e-3 for ResNet-18
at 16 px and ResNet-50 at 32 px, whose last stage's BatchNorms normalise
over 4 values: there the JAX package's own fp32 gradients lie up to 2.9e-4
of a leaf's largest entry from an fp64 evaluation of the same net, the
port's up to 2.6e-4 (measured on both); logits within 1e-4 of the
largest entry (at 16 px the last stages normalise over 4 values too),
new statistics within 1e-5 (1e-4 at 16 px).
"""
import functools
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu_torch._tree import tree_leaves, tree_map, value_and_grad
from apex_tpu_torch.convert import (
    resnet_params_from_jax,
    resnet_params_to_jax,
)
from apex_tpu_torch.examples.imagenet import main_amp, resnet

_EXAMPLE_DIR = os.path.join(os.path.dirname(__file__), "..", "examples",
                            "imagenet")
sys.path.insert(0, os.path.abspath(_EXAMPLE_DIR))

import main_amp as jmain  # noqa: E402
import resnet as jresnet  # noqa: E402

CLASSES = 10


@pytest.fixture(autouse=True)
def _two_torch_threads():
    """Two intra-op threads a test: the suite runs several workers on the
    box's cores, and torch's default (one thread a core) in each makes
    every parallel op wait on oversubscribed threads."""
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)


def _np_tree(tree):
    return jax.tree_util.tree_map(
        lambda a: np.asarray(jnp.asarray(a).astype(jnp.float32))
        if jnp.issubdtype(jnp.asarray(a).dtype, jnp.floating)
        else np.asarray(a), tree)


def _close_per_leaf(jtree, ttree, tol, label):
    """Each leaf within ``tol`` of the JAX leaf's largest entry."""
    jl = jax.tree_util.tree_flatten_with_path(jtree)[0]
    tl = jax.tree_util.tree_leaves(ttree)
    assert len(jl) == len(tl), (label, len(jl), len(tl))
    worst = 0.0
    for (path, a), b in zip(jl, tl):
        a = np.asarray(a, np.float32)
        b = np.asarray(b, np.float32)
        assert a.shape == b.shape, (label, jax.tree_util.keystr(path))
        scale = max(float(np.abs(a).max()), 1e-30)
        err = float(np.abs(a - b).max()) / scale
        worst = max(worst, err)
        assert err <= tol, (label, jax.tree_util.keystr(path), err)
    return worst


@functools.lru_cache(maxsize=None)
def _jax_init_host(arch, size, seed=0):
    model = jresnet.build_model(arch, num_classes=CLASSES)
    v = jax.jit(lambda k: model.init(
        k, jnp.zeros((2, size, size, 3), jnp.float32), train=False))(
        jax.random.PRNGKey(seed))
    return model, jax.tree_util.tree_map(np.asarray, v)


def _jax_init(arch, size, seed=0):
    """A flax model and fresh ``(params, batch_stats)`` arrays (the train
    step donates its inputs, so each caller gets its own)."""
    model, v = _jax_init_host(arch, size, seed)
    v = jax.tree_util.tree_map(jnp.array, v)
    return model, v["params"], v["batch_stats"]


def _images(size, b=4, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, size, size, 3)).astype(np.float32)
    y = rng.integers(0, CLASSES, b).astype(np.int32)
    return x, y


def _nchw(x):
    return torch.from_numpy(x).permute(0, 3, 1, 2)


# ---------------------------------------------------------------------------
# the model: forward, backward, running statistics
# ---------------------------------------------------------------------------

CASES = [("resnet18", 16, 1e-3), ("resnet18", 32, 1e-4),
         ("resnet50", 32, 1e-3)]
#: the new running statistics: 1e-5 of the largest entry, 1e-4 where the
#: last stages normalise over 4 values
STATS_TOL = {16: 1e-4, 32: 1e-5}


@pytest.mark.parametrize("arch,size,gtol", CASES,
                         ids=[f"{a}-{s}px" for a, s, _ in CASES])
def test_train_forward_backward_matches_jax(arch, size, gtol):
    jm, params, bstats = _jax_init(arch, size)
    # every scale non-zero, so each block's last conv gets a gradient
    params = jax.tree_util.tree_map_with_path(
        lambda p, l: l + 0.1 if "scale" in jax.tree_util.keystr(p) else l,
        params)
    x, y = _images(size)

    def jloss(p):
        logits, upd = jm.apply({"params": p, "batch_stats": bstats}, x,
                               train=True, mutable=["batch_stats"])
        logp = jax.nn.log_softmax(logits)
        return (-jnp.mean(jnp.take_along_axis(logp, y[:, None], axis=1)),
                (logits, upd["batch_stats"]))

    (jl, (jlogits, jnew)), jg = jax.jit(
        jax.value_and_grad(jloss, has_aux=True))(params)

    tp, ts = resnet_params_from_jax(_np_tree(params), _np_tree(bstats))
    tm = resnet.build_model(arch, num_classes=CLASSES)
    out = {}

    def tloss(p):
        logits, new = tm.apply(p, ts, _nchw(x), train=True)
        out["logits"], out["new"] = logits, new
        return main_amp._loss(logits, torch.from_numpy(y))

    tl, tg = value_and_grad(tloss, tp)
    assert abs(float(tl) - float(jl)) <= 1e-5 * abs(float(jl))
    _close_per_leaf({"l": jlogits}, {"l": out["logits"].detach().numpy()},
                    1e-4, "logits")
    _close_per_leaf(jg, resnet_params_to_jax(tg), gtol, "grads")
    _close_per_leaf(jnew, resnet_params_to_jax(out["new"]),
                    STATS_TOL[size] if arch == "resnet18" else 1e-5,
                    "running stats")
    # the untouched statistics: only the trained ones moved
    assert jax.tree_util.tree_structure(jnew) == \
        jax.tree_util.tree_structure(resnet_params_to_jax(out["new"]))


def test_running_variance_is_biased():
    """The update takes the biased batch variance (flax), not the unbiased
    one ``F.batch_norm`` would fold into its running buffer."""
    tm = resnet.build_model("resnet18", num_classes=CLASSES)
    p, s = tm.init(torch.Generator().manual_seed(0))
    x, _ = _images(16, b=3)
    xt = _nchw(x)
    _, new = tm.apply(p, s, xt, train=True)
    h = torch.nn.functional.conv2d(xt, p["conv_init"]["kernel"], None, 2, 3)
    n = h.shape[0] * h.shape[2] * h.shape[3]
    biased = h.var((0, 2, 3), unbiased=False)
    want = 0.9 * 1.0 + 0.1 * biased
    torch.testing.assert_close(new["bn_init"]["var"], want, rtol=1e-5,
                               atol=1e-6)
    unbiased_want = 0.9 + 0.1 * biased * n / (n - 1)
    assert not torch.allclose(new["bn_init"]["var"], unbiased_want,
                              rtol=1e-6, atol=0)


@pytest.mark.parametrize("arch", ["resnet18", "resnet50"])
def test_eval_forward_matches_jax(arch):
    jm, params, bstats = _jax_init(arch, 32)
    rng = np.random.default_rng(3)
    # non-trivial running statistics
    bstats = jax.tree_util.tree_map_with_path(
        lambda p, l: l + (0.5 if "var" in jax.tree_util.keystr(p) else 0.1)
        * jnp.asarray(rng.random(l.shape), jnp.float32), bstats)
    x, _ = _images(32, seed=1)
    jlogits = jm.apply({"params": params, "batch_stats": bstats}, x,
                       train=False)
    tp, ts = resnet_params_from_jax(_np_tree(params), _np_tree(bstats))
    tlogits = resnet.build_model(arch, num_classes=CLASSES).apply(
        tp, ts, _nchw(x), train=False)
    _close_per_leaf({"l": jlogits}, {"l": tlogits.numpy()}, 1e-4, "logits")


# ---------------------------------------------------------------------------
# data, metrics, schedule, initialisers
# ---------------------------------------------------------------------------

def test_synthetic_batches_and_normalize_match_jax():
    jb = list(jmain.synthetic_batches(np.random.default_rng(7), 2, 4, 16, 10))
    tb = list(main_amp.synthetic_batches(np.random.default_rng(7), 2, 4, 16,
                                         10))
    for (jx, jy), (tx, ty) in zip(jb, tb):
        assert jx.dtype == tx.dtype == np.uint8
        np.testing.assert_array_equal(jx, tx)
        np.testing.assert_array_equal(jy, ty)
    x = jb[0][0]
    for cast in (False, True):
        jn = np.asarray(jmain._normalize(jnp.asarray(x), jnp.bfloat16, cast)
                        .astype(jnp.float32))
        tn = main_amp._normalize(torch.from_numpy(x), torch.bfloat16, cast)
        assert tn.dtype == (torch.bfloat16 if cast else torch.float32)
        assert tn.is_contiguous(memory_format=torch.channels_last)
        np.testing.assert_array_equal(
            jn, tn.float().permute(0, 2, 3, 1).numpy())


def test_accuracy_schedule_and_meter_match_jax():
    rng = np.random.default_rng(1)
    logits = rng.standard_normal((32, 10)).astype(np.float32)
    y = rng.integers(0, 10, 32).astype(np.int32)
    j1, j5 = jmain.accuracy_topk(jnp.asarray(logits), jnp.asarray(y))
    t1, t5 = main_amp.accuracy_topk(torch.from_numpy(logits),
                                    torch.from_numpy(y))
    assert (float(j1), float(j5)) == (float(t1), float(t5))
    for epoch, step in ((0, 0), (2, 7), (4, 99), (30, 0), (85, 3)):
        assert main_amp.adjust_learning_rate(0.1, epoch, step, 100) == \
            jmain.adjust_learning_rate(0.1, epoch, step, 100)
    jm, tm = jmain.AverageMeter(), main_amp.AverageMeter()
    for v, n in ((1.0, 2), (4.0, 1)):
        jm.update(v, n)
        tm.update(v, n)
    assert (jm.val, jm.avg, jm.sum, jm.count) == \
        (tm.val, tm.avg, tm.sum, tm.count)


def test_init_matches_flax_families():
    """Same tree, shapes and initialiser families as flax's init: the
    zero-initialised last norm of each block, zero biases, unit running
    variances, lecun-normal kernels truncated at two deviations."""
    _, params, bstats = _jax_init("resnet50", 32)
    tp, ts = resnet.init_params("resnet50", torch.Generator().manual_seed(0),
                                num_classes=CLASSES)
    jl = jax.tree_util.tree_flatten_with_path(params)[0]
    tj = resnet_params_to_jax(tp)
    for (path, a), b in zip(jl, jax.tree_util.tree_leaves(tj)):
        key = jax.tree_util.keystr(path)
        a = np.asarray(a)
        assert a.shape == b.shape and b.dtype == np.float32, key
        if "kernel" in key:
            fan_in = int(np.prod(a.shape[:-1]))
            std = np.sqrt(1.0 / fan_in) / .87962566103423978
            assert np.abs(b).max() <= 2 * std * (1 + 1e-6), key
            if a.size >= 20000:
                assert abs(b.std() / a.std() - 1) < 0.05, key
        else:
            np.testing.assert_array_equal(a, b)  # constant initialisers
    for a, b in zip(jax.tree_util.tree_leaves(bstats),
                    jax.tree_util.tree_leaves(resnet_params_to_jax(ts))):
        np.testing.assert_array_equal(np.asarray(a), b)
    assert tp["conv_init"]["kernel"].is_contiguous(
        memory_format=torch.channels_last)


def test_unknown_arch_raises():
    with pytest.raises(ValueError, match="unknown arch"):
        resnet.build_model("resnet7")
    assert resnet.model_names() == jresnet.model_names()


def test_fp64_input_computes_in_fp64():
    """The BatchNorm and the classifier compute in at least fp32 (flax's
    "at least float32"): an fp64 input and fp64 weights run in fp64 (the
    card's parity reference), and agree with the fp32 run."""
    tm = resnet.build_model("resnet18", num_classes=CLASSES)
    p, s = tm.init(torch.Generator().manual_seed(0))
    x = _nchw(_images(32)[0])
    l32, new32 = tm.apply(p, s, x, train=True)
    p64, s64 = (tree_map(lambda t: t.double(), t) for t in (p, s))
    l64, new64 = tm.apply(p64, s64, x.double(), train=True)
    assert l64.dtype == torch.float64
    assert all(t.dtype == torch.float64 for t in tree_leaves(new64))
    torch.testing.assert_close(l64.float(), l32, rtol=1e-4, atol=1e-4)
    assert main_amp._loss(l64, torch.zeros(4, dtype=torch.int32)).dtype == \
        torch.float64
