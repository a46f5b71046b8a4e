"""The port's loss scaler and pytree multi-tensor ops against the JAX
package's, on the CPU.

One sequence of overflow flags drives both ``LossScaler``s, dynamic and
static: growth after the window, an overflow absorbed by the hysteresis,
backoff, the max and min clamps, and the run of consecutive skips; every
field of every state is compared. Then ``unscale`` (trees, with an
``out_dtype``), ``unscale_flat`` (the JAX side with its Pallas kernel in
interpret mode and on its XLA route), ``found_inf_flat`` at scales above
and below 1, ``unscale_with_stashed``, the ``state_dict`` round trip, a
state carried from JAX (``convert.loss_scale_state_from_jax``), the
telemetry hooks (``numerics=``, ``metrics=``), and the ops of
``ops/multi_tensor.py``
(``has_inf_or_nan``, ``multi_tensor_scale`` per tensor,
``multi_tensor_axpby``, ``multi_tensor_unscale_l2norm``,
``update_scale_hysteresis``).

Tolerances: the scaler's state is exact (powers of two and integer
counters); an unscale is one fp32 multiply and one cast on both sides,
bit for bit; axpby's two products and a sum may be contracted by XLA,
rtol 1e-6; the norms are sums in another order, rtol 1e-6; every flag
exactly.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.amp import LossScaler as JaxLossScaler
from apex_tpu.ops import multi_tensor as jmt
from apex_tpu_torch.amp import LossScaler, LossScaleState
from apex_tpu_torch.convert import loss_scale_state_from_jax
from apex_tpu_torch.ops import multi_tensor as tmt

ROUTES = {"interpret": dict(use_kernel=True, interpret=True),
          "xla": dict(use_kernel=False)}
FIELDS = LossScaleState._fields

#: growth after the window (3 clean steps), an overflow absorbed by the
#: hysteresis (2), backoff, growth up to the max clamp, then a run of
#: overflows down to the min clamp and out again
FOUND = ([False] * 3 + [True] + [False] * 2 + [True, True] + [False] * 9
         + [True] * 14 + [False] * 4)
SCALERS = {
    "dynamic": dict(loss_scale="dynamic", init_scale=2.0 ** 10,
                    scale_window=3, hysteresis=2, min_loss_scale=1.0,
                    max_loss_scale=2.0 ** 12),
    "dynamic_no_min": dict(loss_scale="dynamic", init_scale=4.0,
                           scale_window=2),
    "static": dict(loss_scale=128.0),
}


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _fields_equal(jstate, tstate):
    for name in FIELDS:
        a = np.asarray(getattr(jstate, name))
        b = getattr(tstate, name)
        assert b.dim() == 0, name
        assert b.item() == a.item(), (name, b.item(), a.item())


@pytest.mark.parametrize("kind", list(SCALERS))
def test_scaler_state_machine_matches_jax(kind):
    js_, ts_ = JaxLossScaler(**SCALERS[kind]), LossScaler(**SCALERS[kind])
    jstate, tstate = js_.init_state(), ts_.init_state("cpu")
    _fields_equal(jstate, tstate)
    seen = set()
    for found in FOUND:
        jstate = jstate._replace(found_inf=jnp.asarray(found))
        tstate = tstate._replace(found_inf=torch.tensor(found))
        jstate, tstate = js_.update_scale(jstate), ts_.update_scale(tstate)
        _fields_equal(jstate, tstate)
        seen.add(float(tstate.loss_scale))
        assert ts_.state_dict(tstate) == js_.state_dict(jstate)
    if kind == "dynamic":
        # the clamps were reached and the skip run counted
        assert {1.0, 2.0 ** 12} <= seen
    assert int(tstate.consecutive_skips) == 0


def test_scaler_counts_consecutive_skips():
    scaler = LossScaler(init_scale=2.0 ** 8)
    state = scaler.init_state("cpu")
    for k in range(1, 4):
        state = scaler.update_scale(state._replace(
            found_inf=torch.tensor(True)))
        assert int(state.consecutive_skips) == k
        assert float(state.loss_scale) == 2.0 ** (8 - k)
        assert not bool(state.found_inf)
    state = scaler.update_scale(state)
    assert int(state.consecutive_skips) == 0


def _tree(seed, dtype=np.float32, bad=False):
    rng = np.random.default_rng(seed)
    t = {"w": (rng.normal(size=(33, 17)) * 100).astype(np.float32),
         "b": (rng.normal(size=9) * 100).astype(np.float32)}
    if bad:
        t["b"][4] = np.inf
    return t


def _both(tree, jdt=jnp.float32, tdt=torch.float32):
    return ({k: jnp.asarray(v).astype(jdt) for k, v in tree.items()},
            {k: torch.from_numpy(v.copy()).to(tdt) for k, v in tree.items()})


@pytest.mark.parametrize("bad", [False, True])
@pytest.mark.parametrize("dtype,out", [("float32", None),
                                       ("bfloat16", "float32"),
                                       ("float32", "bfloat16")])
def test_unscale_matches_jax(dtype, out, bad):
    kw = SCALERS["dynamic"]
    js_, ts_ = JaxLossScaler(**kw), LossScaler(**kw)
    jg, tg = _both(_tree(1, bad=bad), getattr(jnp, dtype),
                   getattr(torch, dtype))
    jout, jstate = js_.unscale(js_.init_state(), jg,
                               out_dtype=out and getattr(jnp, out))
    tout, tstate = ts_.unscale(ts_.init_state("cpu"), tg,
                               out_dtype=out and getattr(torch, out))
    for k in jout:
        np.testing.assert_array_equal(_np(tout[k]), _np(jout[k]))
        assert tout[k].dtype == getattr(torch, out or dtype)
    _fields_equal(jstate, tstate)
    assert bool(tstate.found_inf) == bad


@pytest.mark.parametrize("route", list(ROUTES))
@pytest.mark.parametrize("n", [4 * 1024, 70001])
@pytest.mark.parametrize("bad", [False, True])
def test_unscale_flat_matches_jax(bad, n, route):
    """bf16 flat gradients unscaled into fp32 (the lifecycle's upcast)."""
    a = (np.random.default_rng(n).normal(size=n) * 1e3).astype(np.float32)
    if bad:
        a[n // 2] = np.nan
    kw = SCALERS["dynamic"]
    js_, ts_ = JaxLossScaler(**kw), LossScaler(**kw)
    jout, jstate = js_.unscale_flat(
        js_.init_state(), jnp.asarray(a).astype(jnp.bfloat16),
        out_dtype=jnp.float32, **ROUTES[route])
    tout, tstate = ts_.unscale_flat(
        ts_.init_state("cpu"), torch.from_numpy(a).to(torch.bfloat16),
        out_dtype=torch.float32)
    assert tout.dtype == torch.float32 and tout.shape == (n,)
    np.testing.assert_array_equal(_np(tout), _np(jout))
    _fields_equal(jstate, tstate)
    assert bool(tstate.found_inf) == bad


@pytest.mark.parametrize("scale,value,flagged", [
    (1024.0, 3e38, False),   # finite, and 1/scale only shrinks it
    (0.5, 3e38, True),       # finite, but overflows under 1/0.5
    (0.5, 1e38, False),      # finite under 1/0.5
    (1024.0, np.inf, True), (0.5, np.nan, True)])
def test_found_inf_flat_matches_jax(scale, value, flagged):
    a = np.random.default_rng(3).normal(size=5000).astype(np.float32)
    a[1234] = value
    kw = dict(SCALERS["dynamic_no_min"], init_scale=scale)
    js_, ts_ = JaxLossScaler(**kw), LossScaler(**kw)
    jstate = js_.found_inf_flat(js_.init_state(), jnp.asarray(a))
    tstate = ts_.found_inf_flat(ts_.init_state("cpu"), torch.from_numpy(a))
    assert bool(tstate.found_inf) == bool(jstate.found_inf) == flagged

    class Buckets:  # the BucketBuffers handoff: a tuple of buffers
        buffers = (torch.from_numpy(a[:2000]), torch.from_numpy(a[2000:]))
    tstate = ts_.found_inf_flat(ts_.init_state("cpu"), Buckets())
    assert bool(tstate.found_inf) == flagged


@pytest.mark.parametrize("bad", [False, True])
def test_unscale_with_stashed_matches_jax(bad):
    kw = SCALERS["dynamic"]
    js_, ts_ = JaxLossScaler(**kw), LossScaler(**kw)
    jn, tn = _both(_tree(4, bad=bad))
    js, tss = _both(_tree(5))
    jout, jstate = js_.unscale_with_stashed(js_.init_state(), jn, js)
    tout, tstate = ts_.unscale_with_stashed(ts_.init_state("cpu"), tn, tss)
    for k in jout:
        np.testing.assert_allclose(_np(tout[k]), _np(jout[k]), rtol=1e-6)
    _fields_equal(jstate, tstate)


def test_scale_loss_and_state_dict_round_trip():
    scaler = LossScaler(**SCALERS["dynamic"])
    state = scaler.init_state("cpu")
    for found in FOUND[:8]:
        state = scaler.update_scale(state._replace(
            found_inf=torch.tensor(found)))
    sd = scaler.state_dict(state)
    back = scaler.load_state_dict(sd, "cpu")
    for name in FIELDS:
        assert torch.equal(getattr(back, name), getattr(state, name)), name
    loss = torch.tensor(1.5, dtype=torch.bfloat16)
    scaled = scaler.scale_loss(back, loss)
    assert scaled.dtype == torch.bfloat16
    assert float(scaled) == 1.5 * sd["loss_scale"]
    assert scaler.loss_scale(back) is back.loss_scale


def test_scaler_continues_from_a_jax_state():
    kw = SCALERS["dynamic"]
    js_, ts_ = JaxLossScaler(**kw), LossScaler(**kw)
    jstate = js_.init_state()
    for found in FOUND[:7]:
        jstate = js_.update_scale(jstate._replace(
            found_inf=jnp.asarray(found)))
    tstate = loss_scale_state_from_jax(
        {k: np.asarray(v) for k, v in jstate._asdict().items()})
    _fields_equal(jstate, tstate)
    for found in FOUND[7:]:
        jstate = js_.update_scale(jstate._replace(
            found_inf=jnp.asarray(found)))
        tstate = ts_.update_scale(tstate._replace(
            found_inf=torch.tensor(found)))
        _fields_equal(jstate, tstate)


def test_telemetry_hooks_are_refused():
    """The telemetry hooks once raised here; they are ported now. The name
    stays: it checks the hooks end to end against the JAX scaler's — the
    tuples ``update_scale`` returns for ``metrics=`` and ``numerics=``, and
    ``unscale`` / ``unscale_flat`` handing their non-finite flags to the
    monitor (field by field, exactly)."""
    from apex_tpu import telemetry as jtel
    from apex_tpu.multi_tensor_apply.packing import PackSpec as JaxPackSpec
    from apex_tpu.telemetry import numerics as jnum
    from apex_tpu_torch import telemetry as ttel
    from apex_tpu_torch.multi_tensor_apply.packing import PackSpec
    from apex_tpu_torch.telemetry import numerics as tnum

    g = {"a": np.ones((3, 4), np.float32), "b": np.ones((1030,), np.float32)}
    g["b"][1027] = np.inf
    jsc, tsc = JaxLossScaler("dynamic", init_scale=8.0), LossScaler(
        "dynamic", init_scale=8.0)
    jg = {k: jnp.asarray(v) for k, v in g.items()}
    tg = {k: torch.from_numpy(v) for k, v in g.items()}
    jmon, tmon = (jnum.NumericsMonitor(spec=JaxPackSpec(jg)),
                  tnum.NumericsMonitor(spec=PackSpec(tg)))
    jflat, tflat = JaxPackSpec(jg).pack(jg), PackSpec(tg).pack(tg)
    _, js, jn = jsc.unscale_flat(jsc.init_state(), jflat,
                                 numerics=(jmon, jmon.init()))
    _, ts, tn = tsc.unscale_flat(tsc.init_state("cpu"), tflat,
                                 numerics=(tmon, tmon.init("cpu")))
    np.testing.assert_array_equal(np.asarray(jn.grad_nonfinite),
                                  tn.grad_nonfinite.numpy())
    assert bool(ts.found_inf) and bool(js.found_inf)
    _, ts2, tn2 = tsc.unscale(tsc.init_state("cpu"), tg,
                              numerics=(tnum.NumericsMonitor(tg),
                                        tnum.NumericsMonitor(tg).init("cpu")))
    assert tn2.grad_nonfinite.tolist() == [0.0, 1.0] and bool(ts2.found_inf)
    jout = jsc.update_scale(js, metrics=jtel.init_metrics(), numerics=jn)
    tout = tsc.update_scale(ts, metrics=ttel.init_metrics("cpu"),
                            numerics=tn)
    assert len(jout) == len(tout) == 3
    _fields_equal(jout[0], tout[0])
    for jst, tst in zip(jout[1:], tout[1:]):
        for f in jst._fields:
            np.testing.assert_array_equal(np.asarray(getattr(jst, f)),
                                          np.asarray(getattr(tst, f)),
                                          err_msg=f)
    assert isinstance(tsc.update_scale(ts, numerics=tn), tuple)
    assert isinstance(tsc.update_scale(ts), LossScaleState)


# ---------------------------------------------------------------------------
# ops/multi_tensor.py over trees
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("bad", [False, True])
def test_has_inf_or_nan_and_scale_per_tensor_match_jax(bad):
    jg, tg = _both(_tree(6, bad=bad))
    assert bool(tmt.has_inf_or_nan(tg)) == bool(jmt.has_inf_or_nan(jg)) \
        == bad
    jout, jfound, jflags = jmt.multi_tensor_scale(jg, 0.125,
                                                  per_tensor=True)
    tout, tfound, tflags = tmt.multi_tensor_scale(tg, 0.125,
                                                  per_tensor=True)
    np.testing.assert_array_equal(tflags.numpy(), np.asarray(jflags))
    assert bool(tfound) == bool(jfound) == bad
    for k in jout:
        np.testing.assert_array_equal(_np(tout[k]), _np(jout[k]))
    assert not bool(tmt.has_inf_or_nan({}))


def test_axpby_and_unscale_l2norm_match_jax():
    (jx, tx), (jy, ty) = _both(_tree(7)), _both(_tree(8))
    jout, jfound = jmt.multi_tensor_axpby(0.5, -2.0, jx, jy,
                                          out_dtype=jnp.bfloat16)
    tout, tfound = tmt.multi_tensor_axpby(0.5, -2.0, tx, ty,
                                          out_dtype=torch.bfloat16)
    for k in jout:
        assert tout[k].dtype == torch.bfloat16
        np.testing.assert_allclose(_np(tout[k]), _np(jout[k]), rtol=8e-3)
    assert not bool(tfound) and not bool(jfound)
    with pytest.raises(ValueError, match="matching"):
        tmt.multi_tensor_axpby(1.0, 1.0, tx, {"w": tx["w"]})
    for per_tensor in (False, True):
        jn, jper, jf = jmt.multi_tensor_unscale_l2norm(jx, 0.25, per_tensor)
        tn, tper, tf = tmt.multi_tensor_unscale_l2norm(tx, 0.25, per_tensor)
        np.testing.assert_allclose(float(tn), float(jn), rtol=1e-6)
        assert bool(tf) == bool(jf) is False
        if per_tensor:
            np.testing.assert_allclose(tper.numpy(), np.asarray(jper),
                                       rtol=1e-6)
        else:
            assert tper is None and jper is None


@pytest.mark.parametrize("scale,growth,hyst,found", [
    (1024.0, 0, 1, False), (1024.0, 1999, 1, False), (1024.0, 5, 1, True),
    (1024.0, 5, 3, True), (1024.0, 5, 0, True), (3e38, 1999, 1, False),
    (2.0, 1999, 2, False)])
def test_update_scale_hysteresis_matches_jax(scale, growth, hyst, found):
    want = jmt.update_scale_hysteresis(
        jnp.float32(scale), jnp.int32(growth), jnp.int32(hyst),
        jnp.asarray(found), hysteresis=2)
    got = tmt.update_scale_hysteresis(
        torch.tensor(scale), torch.tensor(growth, dtype=torch.int32),
        torch.tensor(hyst, dtype=torch.int32), torch.tensor(found),
        hysteresis=2)
    assert [g.dtype for g in got] == [torch.float32, torch.int32,
                                      torch.int32]
    for g, w in zip(got, want):
        assert g.item() == np.asarray(w).item()

