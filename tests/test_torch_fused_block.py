"""The port's fused block tails against the JAX package's, on the CPU.

The same numpy-seeded inputs go through ``apex_tpu.ops.fused_block`` with
``interpret=True`` (the Pallas kernel bodies on the CPU, as
``tests/test_fused_block.py`` runs them) and through
``apex_tpu_torch.ops.fused_block`` (its plain versions on CPU tensors):
each op's forward and backward, with and without hash dropout, at
widths up to 5120 and at 1000 (not a multiple of 8: the kernels take any
width), the keep mask bit for bit, the argument errors; then a 2-layer
GPT with
``fused_block=True`` against JAX's, and the four recompute settings of
the port against each other.

Tolerances: fp32 outputs atol 2e-6 + rtol 4e-6 (XLA's and PyTorch's
tanh, rsqrt and summation order differ in the last bits; the GeLU
derivative at large |x| is a difference of terms of order 1, so its
error is absolute), except the fp32 bias-GeLU, which holds each package
on its own against the float64 GeLU within the error of fp32 arithmetic
(derived at ``_within_fp32_gelu_error``); bf16 outputs
one bf16 rounding (2^-7 of the value, plus 1e-6); fp32 column sums
(bias and LayerNorm-parameter gradients) 1e-5 + 1e-5·|x|. The model:
fp32 loss rtol 1e-5 and every gradient leaf within 1e-5 of its largest
entry; bf16 O2 loss rtol 1e-3 and each leaf within 5e-2 of its largest
entry (the tolerances of ``tests/test_torch_training.py``). The four
recompute settings give bitwise equal losses and gradients.
"""
import collections
import dataclasses
import gc

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.multiprocessing.reductions import StorageWeakRef
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves as pytree_leaves

from apex_tpu.ops import fused_block as jfb
from apex_tpu.transformer.testing import GPTConfig as JaxGPTConfig
from apex_tpu.transformer.testing import gpt_loss as jax_gpt_loss
from apex_tpu.transformer.testing import init_gpt_params as jax_init
from apex_tpu_torch._tree import tree_leaves, value_and_grad
from apex_tpu_torch.convert import params_from_jax
from apex_tpu_torch.ops import fused_block as tfb
from apex_tpu_torch.transformer.testing import GPTConfig, gpt_loss
from apex_tpu_torch.transformer.testing.standalone_transformer_lm import (
    transformer_block,
)

TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
SEEDS = [7, -123456789]


def _close(got: torch.Tensor, want, dtype: str, what: str) -> None:
    got = got.detach().float().numpy()
    want = np.asarray(jnp.asarray(want).astype(jnp.float32))
    assert got.shape == want.shape, (what, got.shape, want.shape)
    atol, rtol = (2e-6, 4e-6) if dtype == "float32" else (1e-6, 2.0 ** -7)
    err = np.abs(got - want)
    bad = err > atol + rtol * np.abs(want)
    assert not bad.any(), (what, float(err.max()), int(bad.sum()))


def _close_sum(got: torch.Tensor, want, what: str) -> None:
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(jnp.asarray(want, jnp.float32)),
                               rtol=1e-5, atol=1e-5, err_msg=what)


def _data(rows, n, dtype, seed):
    """x, bias, residual, cotangents g (y) and gs (sum), as numpy fp32
    values that are exact in ``dtype``."""
    rng = np.random.default_rng(seed)

    def a(*shape, scale=1.0):
        v = (rng.normal(size=shape) * scale).astype(np.float32)
        return np.array(jnp.asarray(v, JDT[dtype]).astype(jnp.float32))
    return dict(x=a(rows, n), b=a(n, scale=0.1), r=a(rows, n),
                w=a(n, scale=0.2) + 1.0, lb=a(n, scale=0.1), g=a(rows, n),
                gs=a(rows, n))


def _j(v, dtype):
    return jnp.asarray(v, JDT[dtype])


def _t(v, dtype, grad=True):
    return torch.from_numpy(v).to(TDT[dtype]).requires_grad_(grad)


# ---------------------------------------------------------------------------
# the keep mask
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", SEEDS + [2 ** 31 - 1, 0])
@pytest.mark.parametrize("p", [0.1, 0.5])
def test_keep_mask_equals_jax_bit_for_bit(seed, p):
    want = np.asarray(jfb.dropout_mask_reference(seed, 130, 96, p))
    got = tfb.dropout_mask_reference(seed, 130, 96, p).numpy()
    np.testing.assert_array_equal(got, want)
    assert abs((1.0 - got.mean()) - p) < 0.03


# ---------------------------------------------------------------------------
# the three ops, forward and backward
# ---------------------------------------------------------------------------

#: tanh-approximate GeLU constants of both packages' kernels
_C, _A = 0.7978845608028654, 0.044715


def _gelu_f64(z):
    """GeLU and its derivative in float64 at the fp32 inputs ``z``."""
    z = z.astype(np.float64)
    t = np.tanh(_C * (z + _A * z ** 3))
    d_inner = _C * (1.0 + 3.0 * _A * z * z)
    return (0.5 * z * (1.0 + t),
            0.5 * (1.0 + t) + 0.5 * z * (1.0 - t * t) * d_inner, d_inner)


def _cpu_state() -> str:
    """What sets torch's CPU arithmetic in this process: the vector ISA
    ATen dispatches to, the intra-op thread count, and whether denormals
    survive a multiply on this thread (``torch.set_flush_denormal`` off)."""
    tiny = torch.tensor([1e-39], dtype=torch.float32)
    kept = bool((tiny * torch.tensor([1.0])).item() != 0.0)
    return (f"cpu capability {torch.backends.cpu.get_cpu_capability()}, "
            f"{torch.get_num_threads()} threads, denormals "
            f"{'kept' if kept else 'flushed'}")


def _within_fp32_gelu_error(got, z, g, what):
    """One package's fp32 ``y`` and ``dx`` against the float64 GeLU of
    the same fp32 ``z = x + b``, within the error of fp32 arithmetic:
    tanh(u) within dt = 4e-7 (4 ulps of the tanh, 2.4e-7, plus the five
    roundings of u = c (z + a z^3) carried through its slope 1 - t^2,
    at most 0.45 * 3e-7), each further operation one rounding (6e-8
    relative). So |dy| <= 0.5 |z| (dt + 1.2e-7) + 1.2e-7 |y| and
    |d(dgelu)| <= dt (0.5 + |z| D) + 5e-7 (1 + 0.5 |z| D), D = c (1 +
    3 a z^2), times |g| for dx, plus one rounding of dx."""
    y64, d64, d_inner = _gelu_f64(z)
    dt = 4e-7
    lim_y = 0.5 * np.abs(z) * (dt + 1.2e-7) + 1.2e-7 * np.abs(y64) + 1e-12
    zd = np.abs(z) * d_inner
    lim_d = np.abs(g) * (dt * (0.5 + zd) + 5e-7 * (1.0 + 0.5 * zd)) \
        + 6e-8 * np.abs(g * d64) + 1e-12
    for name, v, want, lim in (("y", got[0], y64, lim_y),
                               ("dx", got[1], g * d64, lim_d)):
        err = np.abs(np.asarray(v, np.float64) - want)
        bad = err > lim
        assert not bad.any(), (what, name, float(err.max()),
                               int(bad.sum()), float((err / lim).max()),
                               _cpu_state())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("rows,n", [(64, 128), (130, 256), (8, 1000),
                                    (4, 5120)])
def test_bias_gelu_matches_jax_kernel(dtype, rows, n):
    """fp32: each package held on its own against the float64 GeLU of the
    same inputs (``_within_fp32_gelu_error``), so a result off in one of
    them names that one; bf16: the two packages against each other within
    one bf16 rounding."""
    d = _data(rows, n, dtype, 1)
    jy, vjp = jax.vjp(lambda x, b: jfb.bias_gelu(x, b, interpret=True),
                      _j(d["x"], dtype), _j(d["b"], dtype))
    jdx, jdb = vjp(_j(d["g"], dtype))
    x, b = _t(d["x"], dtype), _t(d["b"], "float32")
    y = tfb.bias_gelu(x, b.to(TDT[dtype]))
    y.backward(_t(d["g"], dtype, False))
    assert y.dtype == x.grad.dtype == TDT[dtype]
    if dtype == "float32":
        z = d["x"] + d["b"]  # the fp32 sum both kernels take
        _within_fp32_gelu_error((np.asarray(jy), np.asarray(jdx)), z,
                                d["g"], "jax")
        _within_fp32_gelu_error((y.detach().numpy(), x.grad.numpy()), z,
                                d["g"], "torch")
        _close_sum(b.grad, jdb, "db")
    else:  # db rounded to the bf16 bias once
        _close(y, jy, dtype, "y")
        _close(x.grad, jdx, dtype, "dx")
        _close(b.grad, jdb, dtype, "db")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("p,seed", [(0.0, None)] + [(0.1, s) for s in SEEDS])
def test_bias_dropout_residual_matches_jax_kernel(dtype, p, seed):
    d = _data(96, 128, dtype, 2)
    kw = dict(dropout_p=p, seed=seed)
    jout, vjp = jax.vjp(
        lambda x, b, r: jfb.bias_dropout_residual(x, b, r, interpret=True,
                                                  **kw),
        _j(d["x"], dtype), jnp.asarray(d["b"]), _j(d["r"], dtype))
    jdx, jdb, jdr = vjp(_j(d["g"], dtype))
    x, b, r = _t(d["x"], dtype), _t(d["b"], "float32"), _t(d["r"], dtype)
    out = tfb.bias_dropout_residual(x, b, r, **kw)
    out.backward(_t(d["g"], dtype, False))
    _close(out, jout, dtype, "out")
    _close(x.grad, jdx, dtype, "dx")
    _close(r.grad, jdr, dtype, "dres")
    _close_sum(b.grad, jdb, "db")
    if p:
        keep = tfb.dropout_mask_reference(seed, 96, 128, p)
        np.testing.assert_array_equal(x.grad.float().numpy() == 0,
                                      keep.numpy() == 0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("p,seed", [(0.0, None)] + [(0.1, s) for s in SEEDS])
@pytest.mark.parametrize("rows,n", [(64, 64), (130, 256), (8, 1000),
                                    (4, 5120)])
def test_residual_add_layer_norm_matches_jax_kernel(dtype, p, seed, rows, n):
    d = _data(rows, n, dtype, 3)
    kw = dict(eps=1e-5, dropout_p=p, seed=seed)
    (js, jy), vjp = jax.vjp(
        lambda x, b, r, w, lb: jfb.residual_add_layer_norm(
            x, b, r, w, lb, interpret=True, **kw),
        _j(d["x"], dtype), jnp.asarray(d["b"]), _j(d["r"], dtype),
        jnp.asarray(d["w"]), jnp.asarray(d["lb"]))
    jdx, jdb, jdr, jdw, jdlb = vjp((_j(d["gs"], dtype), _j(d["g"], dtype)))
    x, r = _t(d["x"], dtype), _t(d["r"], dtype)
    b, w, lb = (_t(d[k], "float32") for k in ("b", "w", "lb"))
    s, y = tfb.residual_add_layer_norm(x, b, r, w, lb, **kw)
    torch.autograd.backward((s, y), (_t(d["gs"], dtype, False),
                                     _t(d["g"], dtype, False)))
    assert s.dtype == y.dtype == TDT[dtype]
    _close(s, js, dtype, "sum")
    _close(y, jy, dtype, "y")
    _close(x.grad, jdx, dtype, "dx")
    _close(r.grad, jdr, dtype, "dres")
    for got, want, what in ((b.grad, jdb, "db"), (w.grad, jdw, "dw"),
                            (lb.grad, jdlb, "dlb")):
        _close_sum(got, want, what)


def test_residual_ln_normalises_the_rounded_sum():
    """In bf16 the statistics are those of the bf16 sum, not of the fp32
    one: y equals LayerNorm(sum.float()) to fp32 precision."""
    d = _data(64, 128, "bfloat16", 4)
    x, r = _t(d["x"], "bfloat16", False), _t(d["r"], "bfloat16", False)
    b, w, lb = (torch.from_numpy(d[k]) for k in ("b", "w", "lb"))
    s, y = tfb.residual_add_layer_norm(x, b, r, w, lb)
    want = torch.nn.functional.layer_norm(s.float(), (128,), w, lb, 1e-5)
    assert torch.equal(s, (r.float() + x.float() + b).to(torch.bfloat16))
    torch.testing.assert_close(y.float(), want.to(torch.bfloat16).float(),
                               atol=1e-6, rtol=2.0 ** -7)


def test_bias_dropout_residual_keeps_no_activation():
    """The op's backward needs only the seed: autograd saves no tensor
    for it (x and the residual are not kept alive)."""
    d = _data(32, 64, "float32", 5)
    saved = []
    with torch.autograd.graph.saved_tensors_hooks(
            lambda t: saved.append(t) or t, lambda t: t):
        tfb.bias_dropout_residual(_t(d["x"], "float32"),
                                  _t(d["b"], "float32"),
                                  _t(d["r"], "float32"), dropout_p=0.1,
                                  seed=3)
    assert saved == []


def test_argument_errors_match_jax():
    x = torch.zeros(4, 8, 64)
    b = torch.zeros(64)
    for fn in (lambda: tfb.bias_gelu(x, b[:32]),
               lambda: tfb.bias_dropout_residual(x, b[:32], x),
               lambda: tfb.residual_add_layer_norm(x, b[:32], x, b, b)):
        with pytest.raises(ValueError, match="bias must be"):
            fn()
    with pytest.raises(ValueError, match="must match"):
        tfb.bias_dropout_residual(x, b, x[:2])
    with pytest.raises(ValueError, match="must match"):
        tfb.residual_add_layer_norm(x, b, x[:2], b, b)
    for p in (-0.1, 1.0):
        with pytest.raises(ValueError, match="dropout_p"):
            tfb.bias_dropout_residual(x, b, x, dropout_p=p, seed=1)
    with pytest.raises(ValueError, match="seed"):
        tfb.bias_dropout_residual(x, b, x, dropout_p=0.1)
    with pytest.raises(ValueError, match="seed"):
        tfb.residual_add_layer_norm(x, b, x, b, b, dropout_p=0.1)
    # the same errors in the JAX package
    jx, jb = jnp.zeros((4, 8, 64)), jnp.zeros(64)
    with pytest.raises(ValueError, match="bias must be"):
        jfb.bias_gelu(jx, jb[:32])
    with pytest.raises(ValueError, match="seed"):
        jfb.bias_dropout_residual(jx, jb, jx, dropout_p=0.1)


def test_fused_block_available_and_kernel_refusals():
    """What the kernels take; on CPU tensors every shape runs the plain
    version, so the refusals are checked on the kernel-argument check the
    wrappers run before any launch."""
    # any width, as the JAX package's tails: wider than one block span
    # (4096) and not a multiple of 8 included
    for n in (1, 1000, 1004, 1024, 4096, 5120, 8192, 16384):
        assert tfb.fused_block_available(n), n
    assert not tfb.fused_block_available(0)
    x = torch.zeros(4, 64)
    for n in (60, 1000, 8192):
        rows, _ = tfb._kernel_args("t", (torch.zeros(2, n),), ())
        assert rows[0].shape == (2, n)
    with pytest.raises(ValueError, match="at least 1"):
        tfb._kernel_args("t", (torch.zeros(2, 0),), ())
    with pytest.raises(ValueError, match="one dtype"):
        tfb._kernel_args("t", (x, x.to(torch.bfloat16)), ())
    # fp16 is taken, as fp32 and bf16; a dtype no kernel instantiates not
    rows, _ = tfb._kernel_args("t", (x.to(torch.float16),), ())
    assert rows[0].dtype == torch.float16
    with pytest.raises(ValueError, match="one dtype"):
        tfb._kernel_args("t", (x.to(torch.float64),), ())
    with pytest.raises(ValueError, match="aligned"):
        tfb._kernel_args("t", (torch.zeros(4 * 64 + 1)[1:].view(4, 64),), ())
    rows, params = tfb._kernel_args("t", (x,), (torch.ones(64,
                                                           dtype=torch.bfloat16),))
    assert params[0].dtype == torch.float32 and rows[0] is x


# ---------------------------------------------------------------------------
# the 2-layer GPT with fused_block=True against JAX's
# ---------------------------------------------------------------------------

SHAPE = dict(num_layers=2, hidden_size=64, num_attention_heads=4,
             vocab_size=128, max_position_embeddings=32, hidden_dropout=0.0,
             attention_dropout=0.0)


def _setup(seed, dtype="float32", **kw):
    jcfg = JaxGPTConfig(**SHAPE, use_flash_attention=True, fused_block=True,
                        fused_block_interpret=True,
                        compute_dtype=JDT[dtype], **kw)
    tcfg = GPTConfig(**SHAPE, fused_block=True, compute_dtype=TDT[dtype],
                     **kw)
    jp = jax_init(jcfg, jax.random.PRNGKey(seed))
    if dtype == "bfloat16":  # O2: bf16 params
        jp = jax.tree_util.tree_map(lambda a: a.astype(jnp.bfloat16), jp)
    tp = params_from_jax(jax.tree_util.tree_map(np.asarray, jp),
                         dtype=TDT[dtype])
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, 128, size=(2, 32)).astype(np.int32)
    return jcfg, tcfg, jp, tp, tokens, np.roll(tokens, -1, axis=1)


def _torch_vg(cfg, params, tokens, labels):
    return value_and_grad(lambda p: gpt_loss(
        cfg, p, torch.from_numpy(tokens), torch.from_numpy(labels)), params)


@pytest.mark.parametrize("dtype,loss_rtol,grad_tol",
                         [("float32", 1e-5, 1e-5), ("bfloat16", 1e-3, 5e-2)])
def test_fused_gpt_loss_and_every_grad_match_jax(dtype, loss_rtol, grad_tol):
    jcfg, tcfg, jp, tp, tokens, labels = _setup(0, dtype)
    jl, jg = jax.value_and_grad(lambda p: jax_gpt_loss(
        jcfg, p, jnp.asarray(tokens), jnp.asarray(labels)))(jp)
    tl, tg = _torch_vg(tcfg, tp, tokens, labels)
    np.testing.assert_allclose(float(tl), float(jl), rtol=loss_rtol)
    jleaves = jax.tree_util.tree_leaves(jg)
    assert len(jleaves) == len(tree_leaves(tg))
    for a, b in zip(jleaves, tree_leaves(tg)):
        assert b.dtype == TDT[dtype]
        a = np.asarray(jnp.asarray(a).astype(jnp.float32))
        b = b.float().numpy()
        assert np.abs(a - b).max() <= grad_tol * np.abs(a).max(), (
            np.abs(a - b).max(), np.abs(a).max())


# ---------------------------------------------------------------------------
# recompute
# ---------------------------------------------------------------------------

RECOMPUTE = [None, "full", "selective", "selective_elementwise"]


def test_recompute_settings_give_the_same_loss_and_grads():
    _, tcfg, _, tp, tokens, labels = _setup(1)
    results = {rg: _torch_vg(dataclasses.replace(
        tcfg, recompute_granularity=rg), tp, tokens, labels)
        for rg in RECOMPUTE}
    l0, g0 = results[None]
    for rg in RECOMPUTE[1:]:
        l1, g1 = results[rg]
        assert float(l1) == float(l0), rg
        for a, b in zip(tree_leaves(g0), tree_leaves(g1)):
            assert torch.equal(a, b), rg


class _Tracker(TorchDispatchMode):
    """Records every dispatcher op's output storage (a weak reference to
    the storage itself, not to a Python tensor) and counts the port's
    named forward ops as they execute."""

    def __init__(self):
        super().__init__()
        self.storages = {}
        self.ops = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func.name().startswith("apex_tpu_torch::"):
            self.ops[func.name().split("::")[1]] += 1
        for t in pytree_leaves(out):
            if isinstance(t, torch.Tensor):
                st = t.untyped_storage()
                self.storages[st.data_ptr()] = (StorageWeakRef(st),
                                                st.nbytes())
        return out


def _one_layer(rg, dtype="float32"):
    _, tcfg, _, tp, _, _ = _setup(2, dtype)
    cfg = dataclasses.replace(tcfg, num_layers=1, recompute_granularity=rg)
    lp = {k: v[:1].clone().requires_grad_(True)
          for k, v in tp["layers"].items()}
    rng = np.random.default_rng(2)
    h = torch.from_numpy(rng.normal(size=(32, 2, 64)).astype(
        np.float32)).to(TDT[dtype]).requires_grad_(True)
    return cfg, lp, h


def _layer_saved_bytes(rg, dtype) -> int:
    """Bytes the forward of one checkpointed layer leaves alive for its
    backward: storages created by the forward's ops that outlive it,
    less the layer's output (views of the inputs are not new storage)."""
    cfg, lp, h = _one_layer(rg, dtype)
    tr = _Tracker()
    with tr:
        out = transformer_block(cfg, lp, h, None)
    gc.collect()
    skip = {t.untyped_storage().data_ptr() for t in (out, h, *lp.values())}
    return sum(nbytes for ptr, (ref, nbytes) in tr.storages.items()
               if ptr not in skip and not ref.expired())


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_saved_bytes_full_lt_selective_elementwise_lt_none(dtype):
    """In bf16 O2, the configuration the policy is for: full <
    selective < selective_elementwise < none. The margin over no
    recompute is small in the port: the fused tails already save no
    input, so no recompute keeps little beyond what the policy keeps.

    In fp32 the policy keeps exactly one ``[s, b, h]`` activation more
    than no recompute: a weight GEMM's output that only a fused tail
    reads. JAX's dataflow remat saves a saveable value only when the
    backward reads it; torch's recompute replays the layer op by op up
    to the last op that saved a tensor, so a GEMM on that path is kept
    (the policy's rule) or replayed."""
    saved = {rg: _layer_saved_bytes(rg, dtype) for rg in RECOMPUTE}
    assert saved["full"] < saved["selective"] < \
        saved["selective_elementwise"], saved
    if dtype == "bfloat16":
        assert saved["selective_elementwise"] < saved[None], saved
    else:
        assert saved["selective_elementwise"] - saved[None] == 32 * 2 * 64 * 4



@pytest.mark.parametrize("rg,replayed", [
    ("selective_elementwise", {}),
    # the tails whose outputs the backward reads; bias_dropout_residual's
    # backward reads nothing, so its forward is never replayed
    ("selective", {"residual_ln_fwd": 1, "bias_gelu_fwd": 1}),
    ("full", {"layer_norm_fwd": 1, "flash_attn_fwd": 1,
              "residual_ln_fwd": 1, "bias_gelu_fwd": 1}),
    (None, {})])
def test_backward_replays_only_what_the_policy_drops(rg, replayed):
    """Counts of the named forward ops that run inside one layer's
    backward: an output the policy kept comes from its cache and runs
    (launches) nothing."""
    cfg, lp, h = _one_layer(rg, "bfloat16")
    out = transformer_block(cfg, lp, h, None)
    tr = _Tracker()
    with tr:
        out.float().pow(2).sum().backward()
    assert dict(tr.ops) == replayed
