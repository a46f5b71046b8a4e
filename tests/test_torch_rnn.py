"""``RNN`` of the port (cells and models) against the JAX package's, on
the CPU.

Each cell (ReLU, Tanh, LSTM, GRU, mLSTM) on numpy-seeded parameters and
states; the five factories stacked 2 layers deep, unidirectional and
bidirectional, with and without bias, with a projection, batch-first and
with given initial states, on the JAX-initialised parameter trees
carried across with ``params_from_jax`` (lists of dicts): the outputs,
the final states and the gradients of the input and every parameter;
the port's own ``init`` (the JAX tree's structure and shapes, the
bounds, on the named device) and dropout between layers (drawn from a
``torch.Generator``: one generator state gives one output, which differs
from the output without dropout, itself the JAX package's).

Tolerances: fp32 throughout, within 1e-5 of each result's largest entry
(matmuls and recurrences over up to 7 steps in orders the libraries
choose).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu import RNN as jrnn
from apex_tpu_torch import RNN as trnn
from apex_tpu_torch.convert import params_from_jax

TOL = 1e-5
FACTORIES = ["LSTM", "GRU", "ReLU", "Tanh", "mLSTM"]
LSTMS = ("LSTM", "mLSTM")


def _np(x):
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _close(got, want, tol=TOL):
    want = _np(want)
    got = got.detach().float().numpy()
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= tol * np.abs(want).max(), (
        np.abs(got - want).max(), np.abs(want).max())


def _to_np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.mark.parametrize("cell", ["RNNReLUCell", "RNNTanhCell", "LSTMCell",
                                  "GRUCell", "mLSTMCell"])
def test_cells_match(cell):
    rng = np.random.default_rng(0)
    gates = {"LSTMCell": 4, "mLSTMCell": 4, "GRUCell": 3}.get(cell, 1)
    h, i, b = 6, 5, 3
    p = {"w_ih": rng.standard_normal((gates * h, i)),
         "w_hh": rng.standard_normal((gates * h, h)),
         "b_ih": rng.standard_normal(gates * h),
         "b_hh": rng.standard_normal(gates * h)}
    if cell == "mLSTMCell":
        p.update(w_mih=rng.standard_normal((h, i)),
                 w_mhh=rng.standard_normal((h, h)))
    p = {k: (0.4 * v).astype(np.float32) for k, v in p.items()}
    x = rng.standard_normal((b, i)).astype(np.float32)
    hs = rng.standard_normal((b, h)).astype(np.float32)
    cs = rng.standard_normal((b, h)).astype(np.float32)
    lstm = cell in ("LSTMCell", "mLSTMCell")
    jstate = (jnp.asarray(hs), jnp.asarray(cs)) if lstm else jnp.asarray(hs)
    tstate = (torch.from_numpy(hs), torch.from_numpy(cs)) if lstm \
        else torch.from_numpy(hs)
    want = getattr(jrnn, cell)(jax.tree_util.tree_map(jnp.asarray, p),
                               jnp.asarray(x), jstate)
    got = getattr(trnn, cell)(params_from_jax(p), torch.from_numpy(x),
                              tstate)
    for g, w in zip(jax.tree_util.tree_leaves(list(got) if lstm else [got]),
                    jax.tree_util.tree_leaves(list(want) if lstm
                                              else [want])):
        _close(g, w)


@pytest.mark.parametrize("bidirectional", [False, True])
@pytest.mark.parametrize("name", FACTORIES)
def test_models_forward_and_gradients_match(name, bidirectional):
    kw = dict(num_layers=2, bidirectional=bidirectional)
    jm = getattr(jrnn, name)(5, 6, **kw)
    tm = getattr(trnn, name)(5, 6, **kw)
    jp = jm.init(jax.random.PRNGKey(1))
    tp = params_from_jax(_to_np(jp))
    x = np.random.default_rng(2).standard_normal((7, 3, 5)).astype(
        np.float32)
    dy = np.random.default_rng(3).standard_normal(
        (7, 3, 12 if bidirectional else 6)).astype(np.float32)
    def jloss(p, x):
        y, fin = jm(p, x)
        return jnp.sum(y * dy), (y, fin)
    (_, (jy, jfin)), (jgp, jgx) = jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True)(jp, jnp.asarray(x))
    leaves, treedef = jax.tree_util.tree_flatten(tp)
    live = [t.requires_grad_() for t in leaves]
    tx = torch.from_numpy(x).requires_grad_()
    ty, tfin = tm(jax.tree_util.tree_unflatten(treedef, live), tx)
    _close(ty, jy)
    for g, w in zip(jax.tree_util.tree_leaves(tfin),
                    jax.tree_util.tree_leaves(jfin)):
        _close(g, w)
    grads = torch.autograd.grad((ty * torch.from_numpy(dy)).sum(),
                                live + [tx])
    for g, w in zip(grads[:-1], jax.tree_util.tree_leaves(jgp)):
        _close(g, w)
    _close(grads[-1], jgx)


@pytest.mark.parametrize("name", ["LSTM", "GRU", "mLSTM"])
def test_projection_no_bias_batch_first_and_initial_state(name):
    kw = dict(num_layers=2, bias=False, batch_first=True, output_size=4,
              bidirectional=True)
    jm, tm = getattr(jrnn, name)(5, 6, **kw), getattr(trnn, name)(5, 6, **kw)
    jp = jm.init(jax.random.PRNGKey(4))
    tp = params_from_jax(_to_np(jp))
    rng = np.random.default_rng(5)
    x = rng.standard_normal((3, 7, 5)).astype(np.float32)

    def state():
        h = rng.standard_normal((3, 6)).astype(np.float32)
        return (h, h * 0.5) if name in LSTMS else h
    init = [(state(), state()) for _ in range(2)]
    jy, jfin = jm(jp, jnp.asarray(x), jax.tree_util.tree_map(
        jnp.asarray, init))
    ty, tfin = tm(tp, torch.from_numpy(x), jax.tree_util.tree_map(
        torch.from_numpy, init))
    assert ty.shape == (3, 7, 4)
    _close(ty, jy)
    for g, w in zip(jax.tree_util.tree_leaves(tfin),
                    jax.tree_util.tree_leaves(jfin)):
        _close(g, w)


def test_init_and_dropout():
    m = trnn.mLSTM(5, 8, num_layers=3, dropout=0.5, output_size=3)
    p = m.init(torch.Generator().manual_seed(0), device="cpu")
    jp = jrnn.mLSTM(5, 8, num_layers=3, output_size=3).init(
        jax.random.PRNGKey(0))
    assert jax.tree_util.tree_structure(
        jax.tree_util.tree_map(lambda t: 0, p)) == \
        jax.tree_util.tree_structure(jax.tree_util.tree_map(lambda a: 0, jp))
    for got, want in zip(jax.tree_util.tree_leaves(p),
                         jax.tree_util.tree_leaves(jp)):
        assert tuple(got.shape) == want.shape and got.device.type == "cpu"
    for leaf in jax.tree_util.tree_leaves(p["layers"]):
        assert float(leaf.abs().max()) <= 8 ** -0.5
    x = torch.randn(6, 2, 5, generator=torch.Generator().manual_seed(1))
    plain, _ = m(p, x)
    dropped, _ = m(p, x, dropout_key=torch.Generator().manual_seed(2))
    again, _ = m(p, x, dropout_key=torch.Generator().manual_seed(2))
    assert torch.equal(dropped, again) and not torch.equal(dropped, plain)
    # the model without dropout equals the JAX package's at dropout 0
    jm = jrnn.mLSTM(5, 8, num_layers=3, output_size=3)
    jy, _ = jm(jax.tree_util.tree_map(
        lambda t: jnp.asarray(t.numpy()), p), jnp.asarray(x.numpy()))
    _close(plain, jy)
