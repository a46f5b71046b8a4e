"""The port's O1 autocast against the JAX package's, on the CPU: the
counterparts of ``tests/test_amp_casts.py``.

Parametrised over ``lists/torch_overrides.JAX_COUNTERPART``: each
low-precision and fp32 entry, called under ``autocast`` on fp32, bf16
and fp16 inputs, gives the output dtype its JAX counterpart gives under
the JAX package's ``autocast`` on the same inputs (an entry without a
counterpart: its category's dtype). Then unlisted ops and ``sqrt`` /
``square`` keep the input dtype, the backward returns each input's
dtype, the cast cache leaves gradients unchanged, every entry patches
and restores, the lists cover the surface sizes the JAX test pins,
the promote lists (native and cast), ``disable_casts`` and the
``register_*`` functions. Dtypes are compared exactly; the cache test's
tolerances are the JAX test's.
"""
import importlib

import jax
import jax.numpy as jnp
import jax.scipy.special  # noqa: F401  (resolved by name below)
import numpy as np
import optax  # noqa: F401
import pytest
import torch
import torch.nn.functional as F

from apex_tpu import amp as jamp
from apex_tpu.amp.lists import jax_overrides as jo
from apex_tpu_torch import amp
from apex_tpu_torch.amp.lists import torch_overrides as to

B, H = 4, 16
DTYPES = ["float32", "bfloat16", "float16"]


def _x(dtype, seed=0, shape=(B, H)):
    """Values in (0.1, 0.9): inside every listed op's domain but acosh's
    (a NaN there keeps its dtype)."""
    a = np.random.default_rng(seed).uniform(0.1, 0.9, shape).astype(
        np.float32)
    return a, dtype


def _t(arr_dtype):
    a, dtype = arr_dtype
    return torch.from_numpy(a).to(getattr(torch, dtype))


def _j(arr_dtype):
    a, dtype = arr_dtype
    return jnp.asarray(a).astype(getattr(jnp, dtype))


def _labels_t(x):
    return torch.arange(x.shape[0]) % x.shape[1]


def _labels_j(x):
    return jnp.arange(x.shape[0]) % x.shape[1]


def _w(x, *shape):
    n = int(np.prod(shape))
    return x.flatten()[:n].reshape(*shape)


# how each torch entry is called (default: fn(x))
TORCH_CALLS = {
    "torch.matmul": lambda f, x: f(x, x.T),
    "torch.mm": lambda f, x: f(x, x.T),
    "torch.bmm": lambda f, x: f(x[None], x.T[None]),
    "torch.addmm": lambda f, x: f(x[:, :4], x, x.T[:, :4]),
    "torch.addbmm": lambda f, x: f(x[:, :4], x[None], x.T[None, :, :4]),
    "torch.baddbmm": lambda f, x: f(x[None, :, :4], x[None], x.T[None, :, :4]),
    "torch.addmv": lambda f, x: f(x[:, 0], x, x[0]),
    "torch.addr": lambda f, x: f(x[:4, :4], x[0, :4], x[1, :4]),
    "torch.mv": lambda f, x: f(x, x[0]),
    "torch.dot": lambda f, x: f(x[0], x[1]),
    "torch.vdot": lambda f, x: f(x[0], x[1]),
    "torch.inner": lambda f, x: f(x, x),
    "torch.outer": lambda f, x: f(x[0], x[1]),
    "torch.ger": lambda f, x: f(x[0], x[1]),
    "torch.tensordot": lambda f, x: f(x, x, dims=([1], [1])),
    "torch.einsum": lambda f, x: f("bh,oh->bo", x, x),
    "torch.kron": lambda f, x: f(x[:2, :2], x[:2, :2]),
    "torch.cross": lambda f, x: f(x[:, :3], x[:, 3:6], dim=1),
    "torch.chain_matmul": lambda f, x: f(x, x.T, x),
    "torch.conv1d": lambda f, x: f(x[None], _w(x, 3, 4, 3)),
    "torch.conv2d": lambda f, x: f(_w(x, 1, 4, 4, 4), _w(x, 2, 4, 2, 2)),
    "torch.conv3d": lambda f, x: f(_w(x, 1, 2, 2, 4, 4), _w(x, 2, 2, 1, 2, 2)),
    "torch.conv_transpose1d": lambda f, x: f(x[None], _w(x, 4, 2, 3)),
    "torch.conv_transpose2d": lambda f, x: f(_w(x, 1, 4, 4, 4),
                                             _w(x, 4, 2, 2, 2)),
    "torch.conv_transpose3d": lambda f, x: f(_w(x, 1, 2, 2, 4, 4),
                                             _w(x, 2, 2, 1, 2, 2)),
    "torch.conv_tbc": lambda f, x: f(x.T[:, None, :4].contiguous(),
                                     _w(x, 3, 4, 2), x[0, :2]),
    "torch.prelu": lambda f, x: f(x, x[0, :1]),
    "torch.linalg.matmul": lambda f, x: f(x, x.T),
    "torch.linalg.multi_dot": lambda f, x: f([x, x.T, x]),
    "torch.linalg.vecdot": lambda f, x: f(x, x),
    "torch.linalg.cross": lambda f, x: f(x[:, :3], x[:, 3:6]),
    "F.linear": lambda f, x: f(x, x[:3]),
    "torch.atan2": lambda f, x: f(x, x),
    "torch.arctan2": lambda f, x: f(x, x),
    "torch.hypot": lambda f, x: f(x, x),
    "torch.pow": lambda f, x: f(x, 2.5),
    "torch.logaddexp": lambda f, x: f(x, x),
    "torch.logaddexp2": lambda f, x: f(x, x),
    "torch.polygamma": lambda f, x: f(1, x),
    "torch.mvlgamma": lambda f, x: f(x + 2, p=1),
    "torch.xlogy": lambda f, x: f(x, x),
    "torch.quantile": lambda f, x: f(x, 0.5),
    "torch.nanquantile": lambda f, x: f(x, 0.5),
    "torch.cumsum": lambda f, x: f(x, 1),
    "torch.cumprod": lambda f, x: f(x, 1),
    "torch.logcumsumexp": lambda f, x: f(x, 1),
    "torch.logsumexp": lambda f, x: f(x, 1),
    "torch.renorm": lambda f, x: f(x, 2, 0, 1.0),
    "torch.dist": lambda f, x: f(x, x),
    "torch.cdist": lambda f, x: f(x, x),
    "torch.softmax": lambda f, x: f(x, 1),
    "torch.log_softmax": lambda f, x: f(x, 1),
    "torch.linalg.cond": lambda f, x: f(x[:4, :4]),
    "torch.linalg.det": lambda f, x: f(x[:4, :4]),
    "torch.linalg.slogdet": lambda f, x: f(x[:4, :4]),
    "F.softmax": lambda f, x: f(x, -1),
    "F.log_softmax": lambda f, x: f(x, -1),
    "F.softmin": lambda f, x: f(x, -1),
    "F.layer_norm": lambda f, x: f(x, (H,)),
    "F.group_norm": lambda f, x: f(x, 2),
    "F.local_response_norm": lambda f, x: f(x[None], 2),
    "F.cosine_similarity": lambda f, x: f(x, x),
    "F.cross_entropy": lambda f, x: f(x, _labels_t(x)),
    "F.nll_loss": lambda f, x: f(x, _labels_t(x)),
    "F.poisson_nll_loss": lambda f, x: f(x, x),
    "F.gaussian_nll_loss": lambda f, x: f(x, x, x),
    "F.kl_div": lambda f, x: f(x, x),
    "F.l1_loss": lambda f, x: f(x, x),
    "F.mse_loss": lambda f, x: f(x, x),
    "F.smooth_l1_loss": lambda f, x: f(x, x),
    "F.huber_loss": lambda f, x: f(x, x),
    "F.soft_margin_loss": lambda f, x: f(x, x),
    "F.multilabel_soft_margin_loss": lambda f, x: f(x, x),
    "F.multilabel_margin_loss": lambda f, x: f(
        x, torch.zeros(x.shape, dtype=torch.long)),
    "F.multi_margin_loss": lambda f, x: f(x, _labels_t(x)),
    "F.margin_ranking_loss": lambda f, x: f(x[0], x[1], x[2]),
    "F.hinge_embedding_loss": lambda f, x: f(x, x),
    "F.cosine_embedding_loss": lambda f, x: f(x, x, torch.ones(x.shape[0])),
    "F.triplet_margin_loss": lambda f, x: f(x, x, x),
    "F.binary_cross_entropy_with_logits": lambda f, x: f(x, x),
    "F.ctc_loss": lambda f, x: f(
        x[:, None, :], torch.tensor([[1, 2]]), torch.tensor([B]),
        torch.tensor([2])),
    "torch.special.gammainc": lambda f, x: f(x, x),
    "torch.special.gammaincc": lambda f, x: f(x, x),
    "torch.special.polygamma": lambda f, x: f(1, x),
    "torch.special.multigammaln": lambda f, x: f(x + 2, 1),
    "torch.special.xlogy": lambda f, x: f(x, x),
    "torch.special.xlog1py": lambda f, x: f(x, x),
    "torch.special.logsumexp": lambda f, x: f(x, 1),
    "torch.special.zeta": lambda f, x: f(x + 1, x),
    "torch.special.softmax": lambda f, x: f(x, 1),
    "torch.special.log_softmax": lambda f, x: f(x, 1),
    "xentropy.softmax_cross_entropy_loss": lambda f, x: f(x, _labels_t(x)),
    "mlp.mlp": lambda f, x: f(x, [x[:3], x[:2, :3]], [x[0, :3], x[1, :2]]),
    "fused_dense.fused_dense": lambda f, x: f(x, x[:3], x[0, :3]),
    "fused_dense.fused_dense_gelu_dense": lambda f, x: f(
        x, x[:3], x[0, :3], x[:2, :3], x[1, :2]),
    "fused_dense.dense_no_bias": lambda f, x: f(x, x[:3]),
}
# F.conv* are the torch.conv* builtins under a second attribute
for _n in ("conv1d", "conv2d", "conv3d", "conv_transpose1d",
           "conv_transpose2d", "conv_transpose3d", "conv_tbc"):
    TORCH_CALLS["F." + _n] = TORCH_CALLS["torch." + _n]

# how each JAX counterpart is called (default: fn(x))
JAX_CALLS = {
    "jnp.matmul": lambda f, x: f(x, x.T),
    "lax.dot": lambda f, x: f(x, x.T),
    "lax.batch_matmul": lambda f, x: f(x[None], x.T[None]),
    "jnp.dot": lambda f, x: f(x, x.T),
    "jnp.vdot": lambda f, x: f(x, x),
    "jnp.inner": lambda f, x: f(x, x),
    "jnp.outer": lambda f, x: f(x[0], x[1]),
    "jnp.tensordot": lambda f, x: f(x, x, axes=((1,), (1,))),
    "jnp.einsum": lambda f, x: f("bh,oh->bo", x, x),
    "jnp.kron": lambda f, x: f(x[:2, :2], x[:2, :2]),
    "jnp.cross": lambda f, x: f(x[:, :3], x[:, 3:6]),
    "jnp.linalg.multi_dot": lambda f, x: f([x, x.T, x]),
    "jnp.linalg.matmul": lambda f, x: f(x, x.T),
    "jnp.linalg.vecdot": lambda f, x: f(x, x),
    "lax.conv_general_dilated": lambda f, x: f(
        _w(x, 1, 4, 4, 4), _w(x, 2, 4, 2, 2), (1, 1), "VALID"),
    "lax.conv_transpose": lambda f, x: f(
        _w(x, 1, 4, 4, 4), _w(x, 2, 4, 2, 2), (1, 1), "VALID",
        dimension_numbers=("NCHW", "OIHW", "NCHW")),
    "lax.dot_general": lambda f, x: f(x, x[:3], (((1,), (1,)), ((), ()))),
    "jnp.arctan2": lambda f, x: f(x, x),
    "jnp.hypot": lambda f, x: f(x, x),
    "jnp.power": lambda f, x: f(x, 2.5),
    "jnp.logaddexp": lambda f, x: f(x, x),
    "jnp.logaddexp2": lambda f, x: f(x, x),
    "jnp.quantile": lambda f, x: f(x, 0.5),
    "jnp.nanquantile": lambda f, x: f(x, 0.5),
    "jnp.linalg.cond": lambda f, x: f(x[:4, :4]),
    "jnp.linalg.det": lambda f, x: f(x[:4, :4]),
    "jnp.linalg.slogdet": lambda f, x: f(x[:4, :4]),
    "jax.scipy.special.xlogy": lambda f, x: f(x, x),
    "jax.scipy.special.xlog1py": lambda f, x: f(x, x),
    "jax.scipy.special.gammainc": lambda f, x: f(x, x),
    "jax.scipy.special.gammaincc": lambda f, x: f(x, x),
    "jax.scipy.special.zeta": lambda f, x: f(x + 1, x),
    "optax.cosine_similarity": lambda f, x: f(x, x),
    "optax.cosine_distance": lambda f, x: f(x, x),
    "optax.softmax_cross_entropy_with_integer_labels": lambda f, x: f(
        x, _labels_j(x)),
    "optax.kl_divergence": lambda f, x: f(x, x),
    "optax.squared_error": lambda f, x: f(x, x),
    "optax.huber_loss": lambda f, x: f(x, x),
    "optax.hinge_loss": lambda f, x: f(x, x),
    "optax.sigmoid_binary_cross_entropy": lambda f, x: f(x, x),
    "apex_tpu.contrib.xentropy.softmax_cross_entropy_loss": lambda f, x: f(
        x, _labels_j(x)),
    "apex_tpu.mlp.mlp": lambda f, x: f(
        x, [x[:3], x[:2, :3]], [x[0, :3], x[1, :2]]),
    "apex_tpu.fused_dense.fused_dense": lambda f, x: f(x, x[:3], x[0, :3]),
    "apex_tpu.fused_dense.fused_dense_gelu_dense": lambda f, x: f(
        x, x[:3], x[0, :3], x[:2, :3], x[1, :2]),
    "apex_tpu.fused_dense.dense_no_bias": lambda f, x: f(x, x[:3]),
}


def _resolve_jax(name):
    if name.startswith("apex_tpu."):
        module, attr = name.rsplit(".", 1)
        return getattr(importlib.import_module(module), attr)
    roots = {"jnp": jnp, "lax": jax.lax, "jax": jax, "optax": optax}
    head, *rest = name.split(".")
    obj = roots[head]
    for part in rest:
        obj = getattr(obj, part)
    return obj


def _entry_name(module, name):
    for label, mod in to._MODULES.items():
        if mod is module:
            return f"{label}.{name}"
    raise KeyError((module, name))


def _first(out):
    return out[0] if isinstance(out, (tuple, list)) else out


def _torch_dtype(entry, x):
    module, name = entry
    call = TORCH_CALLS.get(_entry_name(module, name), lambda f, x: f(x))
    with amp.autocast(dtype=torch.bfloat16):
        return str(_first(call(getattr(module, name), x)).dtype)[6:]


def _jax_dtype(jname, x):
    call = JAX_CALLS.get(jname, lambda f, x: f(x))
    with jamp.autocast(dtype=jnp.bfloat16):
        return str(_first(call(_resolve_jax(jname), x)).dtype)


def _ids(entries):
    return [_entry_name(m, n) for m, n in entries]


@pytest.mark.parametrize("in_dtype", DTYPES)
@pytest.mark.parametrize("entry", to.LOW_PRECISION_FUNCS,
                         ids=_ids(to.LOW_PRECISION_FUNCS))
def test_low_precision_entry_matches_jax(entry, in_dtype):
    """ALWAYS_HALF: fp32 and bf16 inputs compute in bf16; fp16 stays fp16
    (only fp32/fp64 are cast down), as in the JAX package."""
    x = _x(in_dtype)
    got = _torch_dtype(entry, _t(x))
    jname = to.JAX_COUNTERPART[_entry_name(*entry)]
    want = ("float16" if in_dtype == "float16" else "bfloat16") \
        if jname is None else _jax_dtype(jname, _j(x))
    assert got == want, (_entry_name(*entry), in_dtype, got, want)


@pytest.mark.parametrize("in_dtype", DTYPES)
@pytest.mark.parametrize("entry", to.FP32_FUNCS, ids=_ids(to.FP32_FUNCS))
def test_fp32_entry_matches_jax(entry, in_dtype):
    """ALWAYS_FLOAT: fp32 out of any float input, as in the JAX package."""
    x = _x(in_dtype)
    got = _torch_dtype(entry, _t(x))
    jname = to.JAX_COUNTERPART[_entry_name(*entry)]
    want = "float32" if jname is None else _jax_dtype(jname, _j(x))
    assert got == want, (_entry_name(*entry), in_dtype, got, want)


def test_every_jax_counterpart_is_on_the_same_jax_list():
    """The name map pairs entries of one category: a low-precision entry
    with a JAX low-precision entry, an fp32 one with a JAX fp32 one."""
    def names(entries):
        out = set()
        for module, name in entries:
            for label, mod in (("jnp", jnp), ("jnp.linalg", jnp.linalg),
                               ("lax", jax.lax), ("jax.nn", jax.nn),
                               ("jax.scipy.special", jax.scipy.special),
                               ("optax", optax)):
                if mod is module:
                    out.add(f"{label}.{name}")
        return out
    jlow, jfp32 = names(jo.LOW_PRECISION_FUNCS), names(jo.FP32_FUNCS)
    for entries, jset, jentries in (
            (to.LOW_PRECISION_FUNCS, jlow, jo.LOW_PRECISION_FUNCS),
            (to.FP32_FUNCS, jfp32, jo.FP32_FUNCS)):
        for module, name in entries:
            jname = to.JAX_COUNTERPART[_entry_name(module, name)]
            if jname is None:
                continue
            if jname.startswith("apex_tpu."):
                # the JAX lists hold apex_tpu's own surfaces by (module,
                # name)
                jmod, jattr = jname.rsplit(".", 1)
                assert any(m is importlib.import_module(jmod)
                           and n == jattr for m, n in jentries), jname
                continue
            assert jname in jset, (_entry_name(module, name), jname)


@pytest.mark.parametrize("in_dtype", DTYPES)
def test_unlisted_and_sqrt_square_keep_input_dtype(in_dtype):
    """MATCH_INPUT: ops on neither list (and sqrt/square, deliberately off
    the fp32 list) keep their input dtype, as JAX's do."""
    x = _x(in_dtype)
    with amp.autocast(dtype=torch.bfloat16):
        got = [torch.relu(_t(x)).dtype, torch.tanh(_t(x)).dtype,
               torch.sqrt(_t(x)).dtype, torch.square(_t(x)).dtype,
               F.relu(_t(x)).dtype]
    with jamp.autocast(dtype=jnp.bfloat16):
        want = [jax.nn.relu(_j(x)).dtype, jnp.tanh(_j(x)).dtype,
                jnp.sqrt(_j(x)).dtype, jnp.square(_j(x)).dtype]
    assert [str(d)[6:] for d in got] == [str(d) for d in want] + [in_dtype]
    assert all(str(d)[6:] == in_dtype for d in got)


def test_backward_matches_input_dtype():
    """The grad w.r.t. an input has the INPUT's dtype whatever the op's
    cast (reference run_layer_test(test_backward=True))."""
    for in_dtype in ("float32", "bfloat16"):
        x = _t(_x(in_dtype)).requires_grad_(True)
        with amp.autocast(dtype=torch.bfloat16):
            y = torch.matmul(x, x.T)
            z = F.log_softmax(x, -1)
        assert y.dtype == torch.bfloat16 and z.dtype == torch.float32
        g, = torch.autograd.grad(y.float().sum() + z.sum(), x)
        assert g.dtype == x.dtype


def test_cache_does_not_change_gradients():
    """The cast cache is a pure memoization (reference test_cache), to the
    JAX test's tolerances: on and off agree within 2e-2 of the fp32
    gradient's largest entry, each within 5e-2 of it; the fp32 gradients
    equal the JAX package's within 1e-5."""
    w1n, _ = _x("float32", 1, (H, H))
    w2n, _ = _x("float32", 2, (H, H))
    xn, _ = _x("float32", 3)
    x = torch.from_numpy(xn)

    def grads(cache):
        w1 = torch.from_numpy(w1n).requires_grad_(True)
        w2 = torch.from_numpy(w2n).requires_grad_(True)
        with amp.autocast(dtype=torch.bfloat16, cache_casts=cache):
            # w1 used twice: the second use hits the cache (when on)
            h = torch.matmul(torch.matmul(x, w1), w2)
            h = torch.matmul(h, w1)
        return torch.autograd.grad(h.float().sum(), (w1, w2))

    w1 = torch.from_numpy(w1n).requires_grad_(True)
    w2 = torch.from_numpy(w2n).requires_grad_(True)
    ref = torch.autograd.grad(
        torch.matmul(torch.matmul(torch.matmul(x, w1), w2), w1).sum(),
        (w1, w2))
    jref = jax.grad(lambda a, b: jnp.sum(jnp.matmul(jnp.matmul(
        jnp.matmul(jnp.asarray(xn), a), b), a)), argnums=(0, 1))(
        jnp.asarray(w1n), jnp.asarray(w2n))
    g_on, g_off = grads(True), grads(False)
    for a, b, r, j in zip(g_on, g_off, ref, jref):
        scale = float(r.abs().max())
        np.testing.assert_allclose(r.numpy(), np.asarray(j), rtol=1e-5,
                                   atol=1e-5 * scale)
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=0.02 * scale)
        np.testing.assert_allclose(a.numpy(), r.numpy(), atol=0.05 * scale)
        np.testing.assert_allclose(b.numpy(), r.numpy(), atol=0.05 * scale)


def test_cache_casts_each_tensor_once():
    x = _t(_x("float32"))
    seen = []
    orig = torch.Tensor.to

    def counting_to(self, *args, **kwargs):
        seen.append(id(self))
        return orig(self, *args, **kwargs)

    try:
        torch.Tensor.to = counting_to
        with amp.autocast(dtype=torch.bfloat16):
            torch.mm(x, x.T)
            torch.mm(x, x.T)
    finally:
        torch.Tensor.to = orig
    assert seen.count(id(x)) == 1


@pytest.mark.parametrize("grad", [False, True])
def test_cache_sees_in_place_changes(grad):
    """A tensor changed in place keeps its id: the second cast must see
    the new values (the residual pattern ``h += F.linear(h, w1)``), so the
    region gives what it gives with the cache off, values and gradients."""
    hn, _ = _x("float32", 4)
    w1n, _ = _x("float32", 5, (H, H))
    w2n, _ = _x("float32", 6, (H, H))

    def run(cache):
        w1 = torch.from_numpy(w1n).requires_grad_(grad)
        w2 = torch.from_numpy(w2n).requires_grad_(grad)
        h = torch.from_numpy(hn.copy())
        if grad:
            h = h * 1.0  # not a leaf, so it may change in place
        with amp.autocast(dtype=torch.bfloat16, cache_casts=cache):
            y = F.linear(h, w1)
            h += y
            z = F.linear(h, w2)
        out = [z.detach()]
        if grad:
            out += torch.autograd.grad(z.float().sum(), (w1, w2))
        return out

    for a, b in zip(run(True), run(False)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_cache_sees_in_place_parameter_updates():
    """An update under no_grad between two uses of a weight in one region
    is seen by the second cast."""
    x = _t(_x("float32"))
    w = torch.from_numpy(_x("float32", 7, (H, H))[0])
    with amp.autocast(dtype=torch.bfloat16):
        a = torch.mm(x, w)
        with torch.no_grad():
            w.mul_(2.0)
        b = torch.mm(x, w)
    torch.testing.assert_close(b, (x.to(torch.bfloat16)
                                   @ w.to(torch.bfloat16)), rtol=0, atol=0)
    assert not torch.equal(a, b)


def test_every_registered_entry_is_patchable():
    """Every (module, name) on the patched lists exists, wraps on entry
    and is restored on exit."""
    entries = (to.LOW_PRECISION_FUNCS + to.FP32_FUNCS
               + to.PROMOTE_CAST_FUNCS)
    originals = {(id(m), n): getattr(m, n) for m, n in entries}
    with amp.autocast(dtype=torch.bfloat16):
        for module, name in entries:
            assert hasattr(getattr(module, name),
                           "__apex_tpu_torch_wrapped__"), (module, name)
    for module, name in entries:
        assert getattr(module, name) is originals[(id(module), name)]


def test_list_sizes_cover_the_jax_surface():
    """The JAX test pins >= 100 patched entries and >= 120 with the
    promote list; the port covers at least as many as the JAX lists hold,
    and keeps sqrt/square off the fp32 list."""
    patched = len(to.LOW_PRECISION_FUNCS) + len(to.FP32_FUNCS)
    assert patched >= 100 and patched + len(to.PROMOTE_FUNCS) >= 120
    assert patched >= len(jo.LOW_PRECISION_FUNCS) + len(jo.FP32_FUNCS)
    fp32_names = {name for _, name in to.FP32_FUNCS}
    assert "sqrt" not in fp32_names and "square" not in fp32_names
    assert set(to.JAX_COUNTERPART) == {
        _entry_name(m, n) for m, n in to.LOW_PRECISION_FUNCS
        + to.FP32_FUNCS + to.PROMOTE_FUNCS + to.PROMOTE_CAST_FUNCS}


# ---------------------------------------------------------------------------
# promotion
# ---------------------------------------------------------------------------

PROMOTE_CALLS = {
    "torch.where": lambda f, a, b: f(a > 0.5, a, b),
    "torch.cat": lambda f, a, b: f([a, b]),
    "torch.concatenate": lambda f, a, b: f([a, b]),
    "torch.stack": lambda f, a, b: f([a, b]),
    "torch.hstack": lambda f, a, b: f([a, b]),
    "torch.vstack": lambda f, a, b: f([a, b]),
    "torch.dstack": lambda f, a, b: f([a, b]),
    "torch.column_stack": lambda f, a, b: f([a, b]),
    "torch.addcmul": lambda f, a, b: f(a, b, a),
    "torch.addcdiv": lambda f, a, b: f(a, b, a),
    "torch.lerp": lambda f, a, b: f(a, b, 0.5),
    "F.bilinear": lambda f, a, b: f(a, b, torch.ones(3, H, H,
                                                     dtype=b.dtype)),
}
JAX_PROMOTE_CALLS = {
    "jnp.where": lambda f, a, b: f(a > 0.5, a, b),
    **{k: (lambda f, a, b: f([a, b])) for k in (
        "jnp.concatenate", "jnp.stack", "jnp.hstack", "jnp.vstack",
        "jnp.dstack", "jnp.column_stack")},
}
COMPARE = {"torch.eq", "torch.ne", "torch.gt", "torch.ge", "torch.lt",
           "torch.le"}


@pytest.mark.parametrize("entry", to.PROMOTE_FUNCS,
                         ids=_ids(to.PROMOTE_FUNCS))
def test_promote_entry_is_native_and_matches_jax(entry):
    """Mixed bf16/fp32 arguments give the widest dtype without a patch,
    as the JAX counterpart does (comparisons: bool)."""
    module, name = entry
    label = _entry_name(module, name)
    call = PROMOTE_CALLS.get(label, lambda f, a, b: f(a, b))
    hi, lo = _x("float32"), _x("bfloat16", 1)
    want_t = "bool" if label in COMPARE else "float32"
    with amp.autocast(dtype=torch.bfloat16):
        assert not hasattr(getattr(module, name),
                           "__apex_tpu_torch_wrapped__")
        got = [call(getattr(module, name), _t(hi), _t(lo)).dtype,
               call(getattr(module, name), _t(lo), _t(hi)).dtype]
        same = call(getattr(module, name), _t(lo), _t(lo)).dtype
    assert [str(d)[6:] for d in got] == [want_t, want_t], label
    assert str(same)[6:] == ("bool" if label in COMPARE else "bfloat16")
    jname = to.JAX_COUNTERPART[label]
    if jname is not None:
        jcall = JAX_PROMOTE_CALLS.get(jname, lambda f, a, b: f(a, b))
        with jamp.autocast(dtype=jnp.bfloat16):
            jd = jcall(_resolve_jax(jname), _j(hi), _j(lo)).dtype
        assert str(jd) == want_t, (label, jname, jd)


@pytest.mark.parametrize("entry", to.PROMOTE_CAST_FUNCS,
                         ids=_ids(to.PROMOTE_CAST_FUNCS))
def test_promote_cast_entry(entry):
    """The ops torch refuses on mixed dtypes are cast to the widest one
    under autocast (the reference's promote wrapper), and refuse outside
    it."""
    module, name = entry
    label = _entry_name(module, name)
    call = PROMOTE_CALLS.get(label, lambda f, a, b: f(a, b))
    hi, lo = _t(_x("float32")), _t(_x("bfloat16", 1))
    with pytest.raises(RuntimeError):
        call(getattr(module, name), lo, hi)
    with amp.autocast(dtype=torch.bfloat16):
        assert call(getattr(module, name), lo, hi).dtype == torch.float32
        assert call(getattr(module, name), lo, lo).dtype == torch.bfloat16


# ---------------------------------------------------------------------------
# the escape hatch and the registry
# ---------------------------------------------------------------------------

def test_disable_casts_restores_originals():
    a = _t(_x("float32"))
    with amp.autocast(dtype=torch.bfloat16):
        with amp.disable_casts():
            assert torch.matmul(a, a.T).dtype == torch.float32
        assert torch.matmul(a, a.T).dtype == torch.bfloat16
    assert torch.matmul(a, a.T).dtype == torch.float32


def test_disabled_autocast_is_a_noop():
    a = _t(_x("float32"))
    orig = torch.matmul
    with amp.autocast(enabled=False):
        assert torch.matmul is orig
        assert torch.matmul(a, a.T).dtype == torch.float32


class _Ns:
    """A namespace of user functions to register."""

    @staticmethod
    def mix(a, b):
        return a @ b

    @staticmethod
    def exp(a):
        return torch.exp(a)

    @staticmethod
    def join(a, b):
        return torch.heaviside(a, b)


@pytest.mark.parametrize("register,fn,args,want", [
    (amp.register_half_function, "mix", ("float32", "float32"), "bfloat16"),
    (amp.register_bf16_function, "mix", ("float32", "bfloat16"), "bfloat16"),
    (amp.register_float_function, "exp", ("bfloat16",), "float32"),
    (amp.register_promote_function, "join", ("bfloat16", "float32"),
     "float32"),
], ids=["half", "bf16", "float", "promote"])
def test_register_functions(monkeypatch, register, fn, args, want):
    """A registered (module, name) is patched like a listed one while the
    context is open, and restored after."""
    from apex_tpu_torch.amp import amp as amp_mod

    for lst in ("_EXTRA_LOW_PRECISION", "_EXTRA_FP32", "_EXTRA_PROMOTE"):
        monkeypatch.setattr(amp_mod, lst, list(getattr(amp_mod, lst)))
    orig = getattr(_Ns, fn)
    register(_Ns, fn)
    inputs = [_t(_x(d, i, (H, H))) for i, d in enumerate(args)]
    with amp.autocast(dtype=torch.bfloat16):
        assert str(getattr(_Ns, fn)(*inputs).dtype)[6:] == want
    assert getattr(_Ns, fn) is orig


def test_ops_inside_a_wrapped_op_keep_their_dtypes(monkeypatch):
    """The depth guard: a listed op called from inside another wrapped op
    keeps its dtypes (an fp32 function's inner matmul is not cast down)."""
    from apex_tpu_torch.amp import amp as amp_mod

    monkeypatch.setattr(amp_mod, "_EXTRA_FP32", [])

    class Ns:
        @staticmethod
        def gram(a):
            return torch.matmul(a, a.T)

    amp.register_float_function(Ns, "gram")
    x = _t(_x("bfloat16"))
    with amp.autocast(dtype=torch.bfloat16):
        assert Ns.gram(x).dtype == torch.float32
        assert torch.matmul(x.float(), x.float().T).dtype == torch.bfloat16
