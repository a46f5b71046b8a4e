"""The multi-tensor applier and the optimizers' base against the JAX
package's.

``multi_tensor_applier`` forwards its ``chunk_size`` to exactly the ops
marked ``accepts_chunk_size`` (unless the call names one), passes every
other op's arguments through untouched, and gives what the JAX applier
gives over the same numpy-seeded flat buffers and trees: the four flat
ops (the JAX side in Pallas interpret mode, which grids over the chunk)
and the tree scale. Tolerances as in ``test_torch_exports.py``: scale
exact, sums of squares rtol 1e-6, maxima and counts exact.
``FusedOptimizer`` is the base of the six optimizers, and its optax
adapter refuses with a message that says why.
"""
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.multi_tensor_apply import MultiTensorApply as JApply
from apex_tpu.ops import multi_tensor as jmt
from apex_tpu_torch import optimizers
from apex_tpu_torch.multi_tensor_apply import (
    ROW,
    MultiTensorApply,
    multi_tensor_applier,
)
from apex_tpu_torch.ops import multi_tensor_scale
from apex_tpu_torch.ops import packed_optimizer as T

J = importlib.import_module("apex_tpu.ops.packed_optimizer")


def _spy(accepts):
    calls = []

    def op(*args, **kwargs):
        calls.append((args, kwargs))
        return "out"

    if accepts is not None:
        op.accepts_chunk_size = accepts
    return op, calls


@pytest.mark.parametrize("accepts", [True, False, None])
def test_applier_forwards_chunk_size_exactly_when_accepted(accepts):
    op, calls = _spy(accepts)
    applier = MultiTensorApply(4096)
    assert applier(op, 1, 2, k=3) == "out"
    want = {"k": 3, "chunk_size": 4096} if accepts else {"k": 3}
    assert calls == [((1, 2), want)]
    if accepts:  # a chunk named by the call wins
        applier(op, 1, chunk_size=ROW)
        assert calls[-1] == ((1,), {"chunk_size": ROW})
    assert multi_tensor_applier.chunk_size == 2048 * 32
    assert JApply().chunk_size == multi_tensor_applier.chunk_size


N = 3 * 65536 + 5 * ROW + 11  # past three default chunks, not whole rows


def _buffers(seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=N).astype(np.float32)
    y = rng.normal(size=N).astype(np.float32)
    x[2 * ROW + 9] = np.nan
    return x, y


@pytest.mark.parametrize("chunk", [2048 * 32, 4096])
@pytest.mark.parametrize("name", ["packed_row_stats",
                                  "multi_tensor_l2norm_flat",
                                  "multi_tensor_scale_flat",
                                  "multi_tensor_axpby_flat"])
def test_applier_over_flat_ops_matches_jax(name, chunk):
    x, y = _buffers(chunk)

    def call(applier, mod, conv, **kw):
        op = getattr(mod, name)
        if name == "packed_row_stats":
            return applier(op, conv(x), inv_scale=2.0, **kw)
        if name == "multi_tensor_l2norm_flat":
            return applier(op, conv(y), **kw)
        if name == "multi_tensor_scale_flat":
            return applier(op, conv(x), 0.5, **kw)
        return applier(op, 0.5, 2.0, conv(y), conv(x), **kw)

    want = call(JApply(chunk), J, jnp.asarray, use_kernel=True,
                interpret=True)
    got = call(MultiTensorApply(chunk), T, torch.from_numpy)
    assert len(got) == len(want)
    exact = name in ("multi_tensor_scale_flat", "multi_tensor_axpby_flat")
    for i, (g, w) in enumerate(zip(got, want)):
        w = np.asarray(w)
        assert tuple(g.shape) == w.shape
        if exact or (name == "packed_row_stats" and i > 0) or \
                g.dtype == torch.bool:
            # axpby: 0.5 * y + 2 * x, both products exact in fp32 here
            np.testing.assert_array_equal(g.numpy(), w)
        else:
            np.testing.assert_allclose(g.numpy(), w, rtol=1e-6)


def test_applier_over_a_tree_op_matches_jax():
    rng = np.random.default_rng(7)
    tree = {"a": rng.normal(size=(5, 7)).astype(np.float32),
            "b": [rng.normal(size=(33,)).astype(np.float32)]}
    tree["b"][0][3] = np.inf
    jout, jfound = JApply()(jmt.multi_tensor_scale,
                            {"a": jnp.asarray(tree["a"]),
                             "b": [jnp.asarray(tree["b"][0])]}, 0.125)
    tout, tfound = multi_tensor_applier(
        multi_tensor_scale, {"a": torch.from_numpy(tree["a"]),
                             "b": [torch.from_numpy(tree["b"][0])]}, 0.125)
    np.testing.assert_array_equal(tout["a"].numpy(), np.asarray(jout["a"]))
    np.testing.assert_array_equal(tout["b"][0].numpy(),
                                  np.asarray(jout["b"][0]))
    assert bool(tfound) == bool(jfound) is True


SIX = ("FusedAdam", "FusedLAMB", "FusedMixedPrecisionLamb", "FusedSGD",
       "FusedNovoGrad", "FusedAdagrad")


@pytest.mark.parametrize("name", SIX)
def test_fused_optimizer_is_the_base(name):
    from apex_tpu import optimizers as jopt

    cls = getattr(optimizers, name)
    assert issubclass(cls, optimizers.FusedOptimizer)
    assert issubclass(getattr(jopt, name), jopt.FusedOptimizer)
    opt = cls(lr=0.01)
    assert isinstance(opt, optimizers.FusedOptimizer)
    with pytest.raises(NotImplementedError, match="optax has no PyTorch"):
        opt.as_gradient_transformation()


def test_fused_optimizer_protocol_is_abstract():
    base = optimizers.FusedOptimizer()
    with pytest.raises(NotImplementedError):
        base.init({})
    with pytest.raises(NotImplementedError):
        base.step({}, None, {})
    assert isinstance(optimizers.FusedAdamW(), optimizers.FusedOptimizer)
