"""The port's numerics health monitor against the JAX package's, on the
CPU (``apex_tpu_torch.telemetry.numerics`` against
``apex_tpu.telemetry.numerics``).

Each case of ``tests/test_numerics.py`` runs on both packages from the
same numpy inputs, and the records the sinks receive are compared whole:
the same events with the same keys in the same order and the same values,
``t_wall`` apart. The port's drain defers each step's values to the host
(``telemetry.flush()`` emits what is in flight, as
``jax.effects_barrier()`` does); on the CPU emission is immediate. The
row statistics sweep (#23, ``packed_row_stats``) is held against the JAX
kernel in interpret mode and on its XLA route, with nan and inf rows.

Tolerances: records compare exactly where both packages compute the same
fp32 operations (counts, flags, maxima, steps, scales); norms and sums of
squares, which XLA and PyTorch sum in other orders, rtol 1e-5; the
activation taps of a 2-layer GPT (different GEMM orders) rtol 1e-4.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu import telemetry as jtel
from apex_tpu.multi_tensor_apply.packing import PackSpec as JaxPackSpec
from apex_tpu.telemetry import numerics as jnum
from apex_tpu_torch import telemetry as ttel
from apex_tpu_torch.convert import numerics_state_from_jax, params_from_jax
from apex_tpu_torch.multi_tensor_apply.packing import ROW, PackSpec
from apex_tpu_torch.telemetry import numerics as tnum

CPU = "cpu"


def _np_params():
    return {"embed": np.ones((4, 8), np.float32),
            "w1": np.ones((2 * ROW,), np.float32),   # exactly 2 packed rows
            "blk": {"w2": np.ones((3, 3), np.float32)}}


def _np_grads(poison=None, value=np.nan, scale=1.0):
    g = jax.tree_util.tree_map(lambda v: v * np.float32(scale),
                               _np_params())
    if poison == "w1":
        g["w1"][ROW + 3] = value   # the leaf's second row
    elif poison == "embed":
        g["embed"][1, 2] = value
    elif poison == "w2":
        g["blk"]["w2"][0, 0] = value
    return g


def _j(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _t(tree):
    return jax.tree_util.tree_map(torch.from_numpy, tree)


def _strip(records):
    return [{k: v for k, v in r.items() if k != "t_wall"} for r in records]


def _same_records(jrecs, trecs, rtol=1e-5):
    """The same events, keys and order; numbers equal within ``rtol``
    (nan equal to nan), everything else exactly."""
    jrecs, trecs = _strip(jrecs), _strip(trecs)
    assert len(jrecs) == len(trecs), (jrecs, trecs)

    def same(a, b, where):
        if isinstance(a, dict):
            assert isinstance(b, dict) and list(a) == list(b), (where, a, b)
            for k in a:
                same(a[k], b[k], f"{where}.{k}")
        elif isinstance(a, list):
            assert isinstance(b, list) and len(a) == len(b), (where, a, b)
            for i, (x, y) in enumerate(zip(a, b)):
                same(x, y, f"{where}[{i}]")
        elif isinstance(a, float) and not isinstance(a, bool):
            assert type(b) is float, (where, a, b)
            np.testing.assert_allclose(b, a, rtol=rtol, err_msg=where)
        else:
            assert a == b and type(a) is type(b), (where, a, b)
    for i, (a, b) in enumerate(zip(jrecs, trecs)):
        same(a, b, f"record {i}")


# ---------------------------------------------------------------------------
# overflow provenance
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("leaf,name", [
    ("w1", "['w1']"), ("embed", "['embed']"), ("w2", "['blk']['w2']"),
])
def test_pytree_provenance_names_exactly_the_poisoned_leaf(leaf, name):
    jmon, tmon = (jnum.NumericsMonitor(_j(_np_params())),
                  tnum.NumericsMonitor(_t(_np_params())))
    assert jmon.names == tmon.names
    jring, tring = jtel.RingBufferRecorder(), ttel.RingBufferRecorder()

    @jax.jit
    def jstep(ns, grads):
        return jmon.drain(jmon.observe(ns, grads=grads), jring)

    def tstep(ns, grads):
        return tmon.drain(tmon.observe(ns, grads=grads), tring)

    js, ts = jmon.init(), tmon.init(CPU)
    for poison in (None, None, None, leaf, None):
        js = jstep(js, _j(_np_grads(poison)))
        ts = tstep(ts, _t(_np_grads(poison)))
    jax.effects_barrier()
    ttel.flush()
    (ev,) = tring.records
    assert ev["kind"] == "nonfinite_grads"
    assert [l["name"] for l in ev["leaves"]] == [name]
    assert ev["step"] == 4 and ev["first_bad_step"] == 4
    _same_records(list(jring.records), list(tring.records))


@pytest.mark.parametrize("value", [np.nan, np.inf, -np.inf])
def test_packed_provenance_names_exactly_the_poisoned_leaf(value):
    jspec = JaxPackSpec(_j(_np_params()), chunk_size=2 * ROW)
    tspec = PackSpec(_t(_np_params()), chunk_size=2 * ROW)
    jmon, tmon = (jnum.NumericsMonitor(spec=jspec),
                  tnum.NumericsMonitor(spec=tspec))
    jring, tring = jtel.RingBufferRecorder(), ttel.RingBufferRecorder()
    js, ts = jmon.init(), tmon.init(CPU)
    for poison in (None, "w1"):
        g = _np_grads(poison, value)
        js = jmon.drain(jmon.observe(
            js, flat_grads=jspec.pack(_j(g), jnp.float32)), jring)
        ts = tmon.drain(tmon.observe(
            ts, flat_grads=tspec.pack(_t(g), torch.float32)), tring)
    jax.effects_barrier()
    (ev,) = tring.records
    assert [l["name"] for l in ev["leaves"]] == ["['w1']"]
    assert ev["leaves"][0]["nonfinite"] == 1.0
    _same_records(list(jring.records), list(tring.records))


@pytest.mark.parametrize("poison", [None, "w1", "embed", "w2"])
def test_packed_vs_pytree_provenance_parity(poison):
    """One poisoned tree through both observation paths of each package:
    the same per-leaf verdicts and counts, and the same state as JAX's."""
    tspec = PackSpec(_t(_np_params()))
    tmon_tree = tnum.NumericsMonitor(_t(_np_params()))
    tmon_flat = tnum.NumericsMonitor(spec=tspec)
    jmon = jnum.NumericsMonitor(spec=JaxPackSpec(_j(_np_params())))
    g = _np_grads(poison)
    ns_t = tmon_tree.observe(tmon_tree.init(CPU), grads=_t(g))
    ns_f = tmon_flat.observe(tmon_flat.init(CPU),
                             flat_grads=tspec.pack(_t(g), torch.float32))
    js = jmon.observe(jmon.init(), flat_grads=JaxPackSpec(
        _j(_np_params())).pack(_j(g), jnp.float32))
    assert torch.equal(ns_t.grad_nonfinite, ns_f.grad_nonfinite)
    assert bool(ns_t.overflow) == bool(ns_f.overflow) == (poison is not None)
    torch.testing.assert_close(ns_t.grad_sq, ns_f.grad_sq, rtol=1e-5,
                               atol=0.0, equal_nan=True)
    for f in ("grad_nonfinite", "grad_maxabs", "overflow", "first_bad_step",
              "ewma_steps"):
        np.testing.assert_array_equal(getattr(ns_f, f).numpy(),
                                      np.asarray(getattr(js, f)), f)
    np.testing.assert_allclose(ns_f.grad_sq.numpy(), np.asarray(js.grad_sq),
                               rtol=1e-5)


def _scaler_pair(**kw):
    from apex_tpu.amp.scaler import LossScaler as JaxLossScaler
    from apex_tpu_torch.amp import LossScaler

    return JaxLossScaler("dynamic", **kw), LossScaler("dynamic", **kw)


def test_scaler_unscale_provenance_is_free_and_exact():
    """Per-leaf flags reused from the unscale sweep name the leaf; the
    scaler consumes the overflow (4 -> 2); both packages' records equal."""
    jmon, tmon = (jnum.NumericsMonitor(_j(_np_params())),
                  tnum.NumericsMonitor(_t(_np_params())))
    jring, tring = jtel.RingBufferRecorder(), ttel.RingBufferRecorder()
    jsc, tsc = _scaler_pair(init_scale=4.0)

    @jax.jit
    def jstep(ss, ns, grads):
        grads, ss, ns = jsc.unscale(ss, grads, numerics=(jmon, ns))
        ss, ns = jsc.update_scale(ss, numerics=ns)
        return ss, jmon.drain(ns, jring)

    def tstep(ss, ns, grads):
        grads, ss, ns = tsc.unscale(ss, grads, numerics=(tmon, ns))
        ss, ns = tsc.update_scale(ss, numerics=ns)
        return ss, tmon.drain(ns, tring)

    jss, jns = jsc.init_state(), jmon.init()
    tss, tns = tsc.init_state(CPU), tmon.init(CPU)
    for poison in (None, "w2"):
        jss, jns = jstep(jss, jns, _j(_np_grads(poison)))
        tss, tns = tstep(tss, tns, _t(_np_grads(poison)))
    jax.effects_barrier()
    (ev,) = tring.records
    assert [l["name"] for l in ev["leaves"]] == ["['blk']['w2']"]
    assert float(tss.loss_scale) == 2.0 and ev["loss_scale"] == 2.0
    _same_records(list(jring.records), list(tring.records))


def test_scaler_flat_unscale_provenance_names_the_leaf():
    """The packed path of the scaler: ``unscale_flat``'s per-row flags
    become per-leaf provenance through the spec's rows."""
    jspec, tspec = JaxPackSpec(_j(_np_params())), PackSpec(_t(_np_params()))
    jmon, tmon = (jnum.NumericsMonitor(spec=jspec),
                  tnum.NumericsMonitor(spec=tspec))
    jring, tring = jtel.RingBufferRecorder(), ttel.RingBufferRecorder()
    jsc, tsc = _scaler_pair(init_scale=8.0)
    g = _np_grads("w1", np.inf)
    _, jss, jns = jsc.unscale_flat(jsc.init_state(),
                                   jspec.pack(_j(g), jnp.float32),
                                   numerics=(jmon, jmon.init()))
    _, tss, tns = tsc.unscale_flat(tsc.init_state(CPU),
                                   tspec.pack(_t(g), torch.float32),
                                   numerics=(tmon, tmon.init(CPU)))
    jss, jns = jsc.update_scale(jss, numerics=jns)
    tss, tns = tsc.update_scale(tss, numerics=tns)
    jmon.drain(jns, jring)
    tmon.drain(tns, tring)
    jax.effects_barrier()
    (ev,) = tring.records
    assert [l["name"] for l in ev["leaves"]] == ["['w1']"]
    _same_records(list(jring.records), list(tring.records))


def test_scaler_update_scale_returns_all_requested_states():
    jsc, tsc = _scaler_pair(init_scale=4.0)
    jst = jsc.init_state()._replace(found_inf=jnp.asarray(True))
    tst = tsc.init_state(CPU)._replace(found_inf=torch.tensor(True))
    jout = jsc.update_scale(jst, metrics=jtel.init_metrics(),
                            numerics=jnum.NumericsMonitor(
                                _j(_np_params())).init())
    tout = tsc.update_scale(tst, metrics=ttel.init_metrics(CPU),
                            numerics=tnum.NumericsMonitor(
                                _t(_np_params())).init(CPU))
    st2, m2, ns2 = tout
    assert int(m2.overflow_skips) == 1 and bool(ns2.overflow)
    assert float(ns2.loss_scale) == 2.0 and float(ns2.prev_loss_scale) == 4.0
    for f in ns2._fields:
        np.testing.assert_array_equal(np.asarray(getattr(ns2, f)),
                                      np.asarray(getattr(jout[2], f)), f)
    st3, ns3 = tsc.update_scale(tst, numerics=tout[2])
    assert isinstance(st3, type(tst)) and bool(ns3.overflow)


# ---------------------------------------------------------------------------
# anomaly rules
# ---------------------------------------------------------------------------

def _run_both(steps, jmon, tmon, drain_kw=None):
    """``steps``: grads trees (numpy) observed in turn and drained; the
    two packages' record lists."""
    jring, tring = jtel.RingBufferRecorder(), ttel.RingBufferRecorder()
    js, ts = jmon.init(), tmon.init(CPU)
    for g in steps:
        js = jmon.drain(jmon.observe(js, grads=_j(g)), jring,
                        **(drain_kw or {}))
        ts = tmon.drain(tmon.observe(ts, grads=_t(g)), tring,
                        **(drain_kw or {}))
    jax.effects_barrier()
    ttel.flush()
    return list(jring.records), list(tring.records)


def test_grad_spike_vs_ewma_window():
    kw = dict(spike_warmup=3, spike_factor=5.0)
    jrecs, trecs = _run_both(
        [_np_grads()] * 5 + [_np_grads(scale=100.0)],
        jnum.NumericsMonitor(_j(_np_params()), **kw),
        tnum.NumericsMonitor(_t(_np_params()), **kw))
    (ev,) = trecs
    assert ev["kind"] == "grad_spike"
    assert ev["ratio"] == pytest.approx(100.0, rel=0.05)
    _same_records(jrecs, trecs)


def test_spike_needs_warmup():
    kw = dict(spike_warmup=10, spike_factor=5.0)
    jrecs, trecs = _run_both(
        [_np_grads(), _np_grads(scale=100.0)],
        jnum.NumericsMonitor(_j(_np_params()), **kw),
        tnum.NumericsMonitor(_t(_np_params()), **kw))
    assert jrecs == trecs == []


@pytest.mark.parametrize("rule", ["scale_collapse", "scaler_stall"])
def test_scale_rules_are_edge_triggered(rule):
    """Three overflowed updates 4 -> 2 -> 1 -> 0.5: ``scale_collapse``
    fires on the crossing below the floor only, ``scaler_stall`` on the
    skip run crossing its budget only, in both packages alike."""
    kw = (dict(scale_floor=2.0) if rule == "scale_collapse"
          else dict(max_consecutive_skips=2))
    jmon = jnum.NumericsMonitor(_j(_np_params()), **kw)
    tmon = tnum.NumericsMonitor(_t(_np_params()), **kw)
    jsc, tsc = _scaler_pair(init_scale=4.0)
    jring, tring = jtel.RingBufferRecorder(), ttel.RingBufferRecorder()
    jss, jns = jsc.init_state(), jmon.init()
    tss, tns = tsc.init_state(CPU), tmon.init(CPU)
    for _ in range(3):
        jss, jns = jsc.update_scale(
            jss._replace(found_inf=jnp.asarray(True)), numerics=jns)
        tss, tns = tsc.update_scale(
            tss._replace(found_inf=torch.tensor(True)), numerics=tns)
        jns = jmon.drain(jns, jring)
        tns = tmon.drain(tns, tring)
    jax.effects_barrier()
    hits = [r for r in tring.records if r["kind"] == rule]
    assert len(hits) == 1
    if rule == "scale_collapse":
        assert hits[0]["loss_scale"] == 1.0
        assert hits[0]["prev_loss_scale"] == 2.0 and hits[0]["floor"] == 2.0
    else:
        assert hits[0]["consecutive_skips"] == 2
    _same_records(list(jring.records), list(tring.records))


def test_health_every_periodic_table():
    jrecs, trecs = _run_both(
        [_np_grads()] * 5, jnum.NumericsMonitor(_j(_np_params())),
        tnum.NumericsMonitor(_t(_np_params())), dict(health_every=2))
    assert [r["step"] for r in trecs] == [2, 4]
    leaves = trecs[-1]["leaves"]
    assert leaves["['w1']"]["norm"] == pytest.approx(float(np.sqrt(2 * ROW)),
                                                     rel=1e-6)
    _same_records(jrecs, trecs)


def test_state_carried_from_jax_continues_alike():
    """A mid-run JAX state (a warm EWMA, a latched ``first_bad_step``)
    carried into the port (``convert.numerics_state_from_jax``): the next
    steps give the same records, a spike included."""
    kw = dict(spike_warmup=2, spike_factor=5.0)
    jmon = jnum.NumericsMonitor(_j(_np_params()), **kw)
    tmon = tnum.NumericsMonitor(_t(_np_params()), **kw)
    js = jmon.init()
    for poison in (None, "embed", None, None):
        js = jmon.observe(js, grads=_j(_np_grads(poison)))
    assert int(js.first_bad_step) == 2 and int(js.ewma_steps) == 3
    ts = numerics_state_from_jax(
        {f: np.asarray(getattr(js, f)) for f in js._fields})
    assert ts.step == 4
    jring, tring = jtel.RingBufferRecorder(), ttel.RingBufferRecorder()
    for g in (_np_grads(), _np_grads(scale=50.0), _np_grads("w1")):
        js = jmon.drain(jmon.observe(js, grads=_j(g)), jring)
        ts = tmon.drain(tmon.observe(ts, grads=_t(g)), tring)
    jax.effects_barrier()
    assert [r["kind"] for r in tring.records] == ["grad_spike",
                                                  "nonfinite_grads"]
    assert tring.records[-1]["first_bad_step"] == 2
    _same_records(list(jring.records), list(tring.records))


def test_observe_validates_sources():
    mon = tnum.NumericsMonitor(_t(_np_params()))
    ns = mon.init(CPU)
    with pytest.raises(ValueError, match="exactly one"):
        mon.observe(ns)
    with pytest.raises(ValueError, match="exactly one"):
        mon.observe(ns, grads=_t(_np_grads()), flat_grads=torch.zeros(ROW))
    with pytest.raises(ValueError, match="leaves"):
        mon.observe(ns, grads={"just_one": torch.ones(3)})
    with pytest.raises(ValueError, match="PackSpec"):
        mon.observe(ns, flat_grads=torch.zeros(ROW))
    with pytest.raises(ValueError, match="exactly one of"):
        tnum.NumericsMonitor(None)
    with pytest.raises(TypeError, match="sink"):
        mon.drain(ns, 3)
    if not torch.cuda.is_available():  # the state lives on the card
        with pytest.raises(RuntimeError, match="no CUDA device"):
            mon.init()


# ---------------------------------------------------------------------------
# activation watch
# ---------------------------------------------------------------------------

def test_tap_identity_and_watch_emission():
    x = np.arange(8.0, dtype=np.float32)
    tx = torch.from_numpy(x)
    assert tnum.tap("t", tx) is tx  # no watch: the same tensor
    jring, tring = jtel.RingBufferRecorder(), ttel.RingBufferRecorder()
    with jnum.activation_watch(jring, tag="unit"):
        jax.jit(lambda v: jnum.tap("t/x", v, layer=3) * 2.0)(jnp.asarray(x))
        jax.effects_barrier()
    with tnum.activation_watch(tring, tag="unit"):
        assert tnum.watching()
        assert tnum.tap("t/x", tx, layer=3) is tx
    assert not tnum.watching()
    (r,) = tring.records
    assert r["event"] == "activation" and r["layer"] == 3
    assert r["maxabs"] == 7.0
    _same_records(list(jring.records), list(tring.records))


def test_tap_only_nonfinite_gates_healthy_activations():
    jring, tring = jtel.RingBufferRecorder(), ttel.RingBufferRecorder()
    vals = [np.ones(4, np.float32), np.array([1, np.nan, 1, 1], np.float32)]
    with jnum.activation_watch(jring, only_nonfinite=True):
        f = jax.jit(lambda v: jnum.tap("t", v))
        for v in vals:
            f(jnp.asarray(v))
        jax.effects_barrier()
    with tnum.activation_watch(tring, only_nonfinite=True):
        for v in vals:
            tnum.tap("t", torch.from_numpy(v))
    (r,) = tring.records
    assert r["nonfinite"] == 1.0
    _same_records(list(jring.records), list(tring.records))


def test_transformer_layer_taps_report_per_layer():
    """The per-layer ``attn`` and ``mlp`` taps of a 2-layer GPT from the
    same weights (JAX's ``gpt_forward`` and the port's trunk, the same
    layer stack): the same records (names, layers, counts; maxima and
    norms rtol 1e-4), and the watched forward equals the bare one."""
    from apex_tpu.transformer.testing import GPTConfig as JaxGPTConfig
    from apex_tpu.transformer.testing import init_gpt_params as jax_init
    from apex_tpu.transformer.testing.standalone_transformer_lm import (
        gpt_forward as jax_gpt_forward,
    )
    from apex_tpu_torch.transformer.testing import GPTConfig
    from apex_tpu_torch.transformer.testing.standalone_transformer_lm import (
        gpt_hidden,
    )

    kw = dict(num_layers=2, hidden_size=64, num_attention_heads=4,
              vocab_size=128, max_position_embeddings=32,
              hidden_dropout=0.0, attention_dropout=0.0)
    jparams = jax_init(JaxGPTConfig(**kw), jax.random.PRNGKey(0))
    tparams = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams))
    tokens = np.random.default_rng(1).integers(0, 128, (2, 32))
    jring, tring = jtel.RingBufferRecorder(), ttel.RingBufferRecorder()
    with jnum.activation_watch(jring):
        jax.jit(lambda p: jax_gpt_forward(JaxGPTConfig(**kw), p,
                                          jnp.asarray(tokens))[0])(jparams)
        jax.effects_barrier()
    cfg = GPTConfig(**kw)
    bare = gpt_hidden(cfg, tparams, torch.from_numpy(tokens))
    with tnum.activation_watch(tring):
        watched = gpt_hidden(cfg, tparams, torch.from_numpy(tokens))
    torch.testing.assert_close(watched, bare, rtol=0, atol=0)
    assert sorted((r["name"].rsplit("/", 1)[1], r["layer"])
                  for r in tring.records) == [
        ("attn", 1), ("attn", 2), ("mlp", 1), ("mlp", 2)]
    _same_records(list(jring.records), list(tring.records), rtol=1e-4)


def test_packed_adam_grad_tap_names_guilty_leaves():
    """Packed FusedAdam's ``tap_flat`` on its flat gradient buffer names
    the non-finite leaf through the spec's rows, in both packages."""
    from apex_tpu.optimizers import FusedAdam as JaxFusedAdam
    from apex_tpu_torch.optimizers import FusedAdam

    params = {"a": np.ones(ROW, np.float32), "b": np.ones(ROW, np.float32)}
    grads = {"a": np.ones(ROW, np.float32), "b": np.ones(ROW, np.float32)}
    grads["b"][5] = np.nan
    jopt, topt = (JaxFusedAdam(lr=1e-3, packed=True),
                  FusedAdam(lr=1e-3, packed=True))
    jring, tring = jtel.RingBufferRecorder(), ttel.RingBufferRecorder()
    with jnum.activation_watch(jring):
        jax.jit(lambda g, s, p: jopt.step(g, s, p))(
            _j(grads), jopt.init(_j(params)), _j(params))
        jax.effects_barrier()
    tparams = _t(params)
    with tnum.activation_watch(tring):
        topt.step(_t(grads), topt.init(tparams), tparams)
    (r,) = [r for r in tring.records
            if r["name"] == "apex_tpu.packed_adam/grads"]
    assert r["nonfinite"] == 1.0
    assert [l["name"] for l in r["leaves"]] == ["['b']"]
    _same_records(list(jring.records), list(tring.records))


# ---------------------------------------------------------------------------
# the row statistics sweep (#23)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("route", ["interpret", "xla"])
@pytest.mark.parametrize("n,dtype", [(4 * ROW, "float32"),
                                     (4 * ROW, "bfloat16"),
                                     (5 * ROW - 37, "float32")])
def test_packed_row_stats_matches_jax(n, dtype, route):
    """``packed_row_stats`` against the JAX kernel (interpret mode) and its
    XLA route, a nan and an inf planted in known rows: the counts exact
    (1 there, 0 elsewhere), nan and inf in those rows' sums and maxima,
    the maxima equal, the sums rtol 1e-6."""
    from apex_tpu.ops.packed_optimizer import packed_row_stats as jstats
    from apex_tpu_torch.ops.packed_optimizer import packed_row_stats

    x = np.random.default_rng(n).normal(size=(n,)).astype(np.float32)
    x[ROW + 1] = np.nan
    x[3 * ROW + 7] = np.inf
    jx = jnp.asarray(x, jnp.bfloat16 if dtype == "bfloat16" else jnp.float32)
    kw = (dict(interpret=True) if route == "interpret"
          else dict(use_kernel=False))
    want = jstats(jx, inv_scale=0.5, **kw)
    got = packed_row_stats(torch.from_numpy(np.array(
        jx.astype(jnp.float32))).to(getattr(torch, dtype)),
        inv_scale=torch.tensor(0.5))
    rows = -(-n // ROW)
    nf = np.zeros(rows, np.float32)
    nf[1] = nf[3] = 1.0
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and g.shape == (rows,)
    np.testing.assert_array_equal(got[2].numpy(), nf)
    np.testing.assert_array_equal(np.asarray(want[2]), nf)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                               rtol=1e-6)
    assert bool(got[0][1].isnan()) and bool(got[1][1].isnan())
    assert bool(got[0][3].isinf()) and bool(got[1][3].isinf())
