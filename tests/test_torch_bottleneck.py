"""``contrib.bottleneck.Bottleneck`` of the port against the JAX
package's flax block, on the CPU.

Flax-initialised parameters and batch statistics carried across with
``convert.bottleneck_state_from_jax`` + ``load_state_dict``; numpy-seeded
NHWC inputs in fp32 and bf16 (which the flax convs promote to fp32: the
block computes and returns fp32); stride 1 without and with the
downsample (widths differ) and stride 2 at an even size, where flax's
``"SAME"`` pads the 3x3 conv 0 before and 1 after. In training: the
output, the updated batch statistics, the gradients of every parameter
and of the input; in evaluation (``use_running_stats``) the output from
the running statistics. The stride-2 padding is shown against torch's
symmetric one, which gives another output.

Tolerances: within 1e-5 of each result's largest entry (convolutions
summed in orders the libraries choose, through three BatchNorms whose
variance, E[x^2] - E[x]^2, is flax's); the statistics within 1e-5 of
their largest entry; the gradient of a bf16 input within one bf16
rounding (2^-8) of its largest entry.
"""
import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from apex_tpu.contrib.bottleneck import Bottleneck as JBottleneck
from apex_tpu_torch.contrib.bottleneck import Bottleneck as TBottleneck
from apex_tpu_torch.convert import bottleneck_state_from_jax

TOL = 1e-5
# (in, mid, out, stride, hw)
CASES = {"stride 1": (16, 4, 16, 1, 6), "stride 1 downsample": (8, 4, 16, 1, 6),
         "stride 2 even": (8, 4, 16, 2, 8)}


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, flax.core.unfreeze(tree))


def _close(got, want, tol=TOL):
    want = np.asarray(jnp.asarray(want).astype(jnp.float32))
    got = got.detach().float().numpy()
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= tol * np.abs(want).max(), (
        np.abs(got - want).max(), np.abs(want).max())


def _blocks(case, seed, running=False):
    cin, mid, cout, stride, hw = CASES[case]
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((3, hw, hw, cin)).astype(np.float32)
    jmod = JBottleneck(cin, mid, cout, stride, use_running_stats=running)
    variables = jmod.init(jax.random.PRNGKey(seed), jnp.asarray(x))
    params = _np_tree(variables["params"])
    # move the BatchNorms off their initial ones / zeros, and the running
    # statistics off theirs, so that every leaf is seen
    for name, leaf in params.items():
        if "scale" in leaf:
            leaf["scale"] = (1 + 0.2 * rng.standard_normal(
                leaf["scale"].shape)).astype(np.float32)
            leaf["bias"] = (0.1 * rng.standard_normal(
                leaf["bias"].shape)).astype(np.float32)
    stats = _np_tree(variables["batch_stats"])
    for leaf in stats.values():
        leaf["mean"] = (0.1 * rng.standard_normal(leaf["mean"].shape)).astype(
            np.float32)
        leaf["var"] = (1 + 0.2 * rng.random(leaf["var"].shape)).astype(
            np.float32)
    tmod = TBottleneck(cin, mid, cout, stride, use_running_stats=running,
                       device="cpu")
    tmod.load_state_dict(bottleneck_state_from_jax(params, stats))
    return x, jmod, params, stats, tmod


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", list(CASES))
def test_training_forward_stats_and_gradients(case, dtype):
    x, jmod, params, stats, tmod = _blocks(case, 0)
    jx = jnp.asarray(x).astype(getattr(jnp, dtype))
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    cin, mid, cout, stride, hw = CASES[case]
    dy = np.random.default_rng(9).standard_normal(
        (3, hw // stride, hw // stride, cout)).astype(np.float32)

    def loss(p, x):
        y, state = jmod.apply({"params": p, "batch_stats": stats}, x,
                              mutable=["batch_stats"])
        return jnp.sum(y * dy), (y, state)
    (_, (jy, jstate)), (jgp, jgx) = jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True)(params, jx)

    tx.requires_grad_()
    ty = tmod(tx)
    assert ty.dtype == torch.float32 and ty.shape == jy.shape
    assert jy.dtype == jnp.float32
    _close(ty, jy)
    for name, leaf in _np_tree(jstate["batch_stats"]).items():
        for key, want in leaf.items():
            _close(getattr(getattr(tmod, name), key), want)
    names = [n for n, _ in tmod.named_parameters()]
    grads = torch.autograd.grad((ty * torch.from_numpy(dy)).sum(),
                                [p for _, p in tmod.named_parameters()]
                                + [tx])
    for name, g in zip(names, grads):
        mod, key = name.split(".")
        want = jgp[mod][key]
        if key == "kernel":
            g = g.permute(2, 3, 1, 0)  # back to HWIO
        _close(g, want)
    _close(grads[-1], jgx, TOL if dtype == "float32" else 2.0 ** -8)


@pytest.mark.parametrize("case", list(CASES))
def test_evaluation_uses_the_running_statistics(case):
    x, jmod, params, stats, tmod = _blocks(case, 1, running=True)
    jy = jmod.apply({"params": params, "batch_stats": stats}, jnp.asarray(x))
    before = {k: v.clone() for k, v in tmod.state_dict().items()}
    _close(tmod(torch.from_numpy(x)), jy)
    for k, v in tmod.state_dict().items():
        assert torch.equal(v, before[k]), k


def test_stride_2_pads_as_flax_same():
    """flax's SAME pads a stride-2 3x3 conv over 8 rows by (0, 1): the
    port's conv2 equals JAX's and not torch's symmetric padding of 1."""
    x, jmod, params, stats, tmod = _blocks("stride 2 even", 2)
    y = jax.random.normal(jax.random.PRNGKey(3), (3, 8, 8, 4))
    want = jax.lax.conv_general_dilated(
        y, jnp.asarray(params["conv2"]["kernel"]), (2, 2), "SAME",
        dimension_numbers=("NHWC", "HWIO", "NHWC"))
    ty = torch.from_numpy(np.array(y)).permute(0, 3, 1, 2)
    got = tmod.conv2(ty).permute(0, 2, 3, 1)
    _close(got, want)
    sym = F.conv2d(ty, tmod.conv2.kernel, None, 2, 1).permute(0, 2, 3, 1)
    assert sym.shape == got.shape
    assert not torch.allclose(sym, got, atol=1e-3)
