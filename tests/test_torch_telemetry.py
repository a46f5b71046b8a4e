"""The port's telemetry core against the JAX package's, on the CPU: the
metrics accumulate/drain (``apex_tpu_torch.telemetry.metrics``), the
recorder sinks and their JSONL format, ``percentiles`` and ``read_jsonl``
(``apex_tpu_torch.telemetry.recorder``), and the deferred emission that
replaces the JAX drains' ``lax.cond`` over an async callback.

Records are compared whole with the JAX package's on the same inputs,
host-clock fields apart (``t_wall``, and the rates derived from the wall
time between drains). The JSONL lines of the two recorders are equal byte
for byte for the same record and time stamp. A JSONL stream written by the
port parses with ``tools/health_report.py``'s aggregation, which imports
no JAX.

Tolerances: none beyond fp32 equality: the window sums add the same fp32
values in the same order on both sides.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu import telemetry as jtel
from apex_tpu_torch import telemetry as ttel
from apex_tpu_torch.convert import metrics_state_from_jax
from apex_tpu_torch.telemetry import numerics as tnum
from apex_tpu_torch.telemetry import recorder as trec

CPU = "cpu"
_CLOCK = ("t_wall", "wall_dt_s", "steps_per_sec", "tokens_per_sec",
          "achieved_gbps")


def _strip(records):
    return [{k: v for k, v in r.items() if k not in _CLOCK}
            for r in records]


def _drive_metrics(every_n, steps, **drain_kw):
    """``steps`` losses through both packages' accumulate/drain; the two
    rings' records and the final states."""
    jring, tring = jtel.RingBufferRecorder(), ttel.RingBufferRecorder()
    jm, tm = jtel.init_metrics(), ttel.init_metrics(CPU)

    @jax.jit
    def jstep(m, loss):
        m = jtel.accumulate(m, loss=loss, tokens=64)
        return jtel.drain(m, jring, every_n=every_n, **drain_kw)

    for i in range(steps):
        loss = 1.0 + i
        jm = jstep(jm, jnp.float32(loss))
        tm = ttel.accumulate(tm, loss=torch.tensor(loss), tokens=64)
        tm = ttel.drain(tm, tring, every_n=every_n, **drain_kw)
    jax.effects_barrier()
    ttel.flush()
    return list(jring.records), list(tring.records), jm, tm


def test_metrics_accumulate_and_drain_every_n():
    jrecs, trecs, jm, tm = _drive_metrics(3, 7, tag="unit")
    assert [r["step"] for r in trecs] == [3, 6]
    assert trecs[0]["loss"] == 2.0 and trecs[1]["loss"] == 5.0
    assert trecs[0]["tokens"] == 192.0 and trecs[1]["total_tokens"] == 384.0
    assert "wall_dt_s" not in trecs[0] and trecs[1]["steps_per_sec"] > 0
    assert [list(r) for r in trecs] == [list(r) for r in jrecs]
    assert _strip(trecs) == _strip(jrecs)
    # the undrained 7th step stays in the window, on the host counters
    assert tm.window_steps == int(jm.window_steps) == 1
    assert tm.total_steps == int(jm.total_steps) == 7


def test_metrics_drain_bytes_per_step_reports_gbps():
    jrecs, trecs, _, _ = _drive_metrics(1, 3, bytes_per_step=1e9)
    assert "achieved_gbps" not in trecs[0]
    assert trecs[-1]["achieved_gbps"] > 0
    assert [list(r) for r in trecs] == [list(r) for r in jrecs]


def test_metrics_grad_and_param_norms():
    grads = {"a": np.full((3,), 2.0, np.float32),
             "b": np.full((4,), -2.0, np.float32)}
    params = {"w": np.full((9,), 1.0, np.float32)}
    jm = jtel.accumulate(jtel.init_metrics(),
                         grads=jax.tree_util.tree_map(jnp.asarray, grads),
                         params=jax.tree_util.tree_map(jnp.asarray, params))
    tm = ttel.accumulate(ttel.init_metrics(CPU),
                         grads=jax.tree_util.tree_map(torch.from_numpy,
                                                      grads),
                         params=jax.tree_util.tree_map(torch.from_numpy,
                                                       params))
    assert float(tm.grad_norm_sum) == float(jm.grad_norm_sum)
    assert float(tm.param_norm_sum) == float(jm.param_norm_sum) == 3.0
    with pytest.raises(ValueError):
        ttel.accumulate(tm, grads={"a": torch.ones(1)}, grad_norm=1.0)
    summary = ttel.summarize(tm)
    assert summary["step"] == 1 and float(summary["grad_norm"]) == float(
        tm.grad_norm_sum)


def test_scaler_update_scale_feeds_metrics_counters():
    """Skips and growths counted alike in both packages: an overflow
    backs off 4 -> 2, two clean steps grow it back at the window."""
    from apex_tpu.amp.scaler import LossScaler as JaxLossScaler
    from apex_tpu_torch.amp import LossScaler

    kw = dict(init_scale=4.0, scale_window=2, hysteresis=1)
    jsc, tsc = JaxLossScaler("dynamic", **kw), LossScaler("dynamic", **kw)
    jst, tst = jsc.init_state(), tsc.init_state(CPU)
    jm, tm = jtel.init_metrics(), ttel.init_metrics(CPU)
    for found in (True, False, False):
        jst, jm = jsc.update_scale(jst._replace(found_inf=jnp.asarray(found)),
                                   jm)
        tst, tm = tsc.update_scale(tst._replace(found_inf=torch.tensor(
            found)), tm)
    assert int(tm.overflow_skips) == 1 and int(tm.scale_growths) == 1
    for f in ("loss_scale", "overflow_skips", "scale_growths"):
        assert np.asarray(getattr(tm, f)) == np.asarray(getattr(jm, f)), f


def test_metrics_state_carried_from_jax():
    """A mid-run JAX ``MetricsState`` carried into the port
    (``convert.metrics_state_from_jax``) drains the same record."""
    jm = jtel.init_metrics()
    for loss in (3.0, 5.0):
        jm = jtel.accumulate(jm, loss=jnp.float32(loss), tokens=32)
    tm = metrics_state_from_jax({f: np.asarray(getattr(jm, f))
                                 for f in jm._fields})
    assert tm.total_steps == 2 and tm.window_steps == 2
    jring, tring = jtel.RingBufferRecorder(), ttel.RingBufferRecorder()
    jtel.drain(jtel.accumulate(jm, loss=jnp.float32(7.0)), jring)
    ttel.drain(ttel.accumulate(tm, loss=7.0), tring)
    jax.effects_barrier()
    assert _strip(tring.records) == _strip(jring.records)
    assert tring.records[0]["loss"] == 5.0


# ---------------------------------------------------------------------------
# recorders
# ---------------------------------------------------------------------------

def test_jsonl_lines_equal_the_jax_recorders_byte_for_byte(tmp_path):
    """The same record (tensors, numpy values, non-finite floats, nested
    lists and dicts) with the same ``t_wall`` gives the same line."""
    rec = {"event": "anomaly", "step": 4, "t_wall": 1234.5,
           "kind": "nonfinite_grads",
           "leaves": [{"name": "['w1']", "nonfinite": 1.0,
                       "maxabs": float("nan"), "norm": float("inf")}],
           "loss_scale": np.float32(0.5), "first_bad_step": np.int32(4)}
    trec_ = {**rec, "loss_scale": torch.tensor(0.5),
             "vec": torch.tensor([1.0, float("-inf")])}
    jrec_ = {**rec, "vec": np.array([1.0, -np.inf], np.float32)}
    paths = tmp_path / "j.jsonl", tmp_path / "t.jsonl"
    with jtel.JsonlRecorder(paths[0]) as j:
        j.record(jrec_)
        j.add_scalar("lr", np.float32(1e-3), 7)
    with ttel.JsonlRecorder(paths[1]) as t:
        t.record(trec_)
        t.add_scalar("lr", torch.tensor(1e-3), 7)
    jlines = paths[0].read_bytes().splitlines()
    tlines = paths[1].read_bytes().splitlines()
    assert jlines[0] == tlines[0]
    assert [json.loads(x)["name"] for x in (jlines[1], tlines[1])] == [
        "lr", "lr"]
    (r, s) = ttel.read_jsonl(paths[1])
    assert r["leaves"][0]["maxabs"] == "nan" and r["vec"] == [1.0, "-inf"]
    assert s["event"] == "scalar" and s["step"] == 7


def test_jsonl_recorder_rank_gating(tmp_path):
    path = tmp_path / "other_rank.jsonl"
    rec = ttel.JsonlRecorder(path, log_rank=3)
    rec.record({"x": 1})
    rec.close()
    assert not path.exists()
    assert ttel.is_logging_process() is True
    assert ttel.is_logging_process(3) is False


def test_ring_multi_and_tagged_recorders():
    ring = ttel.RingBufferRecorder(capacity=2)
    multi = ttel.MultiRecorder(ring, ttel.NullRecorder())
    for i in range(4):
        multi.record({"i": i})
    assert [r["i"] for r in ring.records] == [2, 3]
    assert all("t_wall" in r for r in ring.records)
    ring2 = ttel.RingBufferRecorder()
    tagged = ttel.TaggedRecorder(ring2, replica_id=1, labels={"tenant": "a"})
    tagged.record({"event": "x", "replica_id": 5, "labels": {"k": 1}})
    tagged.add_scalar("loss", torch.tensor(2.0), 3)
    (a, b) = ring2.records
    assert a["replica_id"] == 5 and a["labels"] == {"tenant": "a", "k": 1}
    assert b["value"] == 2.0 and b["replica_id"] == 1
    assert ring2.counts_by_event() == {"x": 1, "scalar": 1}
    assert ring2.events("x") == [a]


@pytest.mark.parametrize("values,field", [
    ([3.0, 1.0, "nan", 2.0, None, True, "inf", 7], None),
    ([{"ms": 1.0}, {"ms": 9.0}, {"ms": "nan"}, {"other": 3}, 5], "ms"),
    ([], None)])
def test_percentiles_match_jax(values, field):
    assert ttel.percentiles(values, field=field) == jtel.percentiles(
        values, field=field)


def test_read_jsonl_skips_a_torn_tail_only(tmp_path):
    path = tmp_path / "torn.jsonl"
    path.write_text('{"a": 1}\n{"b": 2}\n{"c": ')
    stats = {}
    assert ttel.read_jsonl(path, stats=stats) == [{"a": 1}, {"b": 2}]
    assert stats == {"torn_lines": 1}
    path.write_text('{"a": 1}\n{"b\n{"c": 3}\n')
    with pytest.raises(json.JSONDecodeError):
        ttel.read_jsonl(path)


def test_defer_emits_in_order_and_flush_drains():
    """On the CPU a deferred emission runs at once with host copies of its
    values in their own dtypes; ``flush`` leaves nothing pending."""
    got = []
    trec.defer({"a": torch.tensor(1.5), "b": torch.tensor([1, 2],
                                                          dtype=torch.int32),
                "c": torch.tensor(True)}, got.append)
    trec.defer({"a": torch.tensor(float("nan"))}, got.append)
    ttel.flush()
    assert not trec._PENDING
    assert got[0]["a"].dtype == np.float32 and got[0]["a"] == 1.5
    assert got[0]["b"].dtype == np.int32 and got[0]["b"].tolist() == [1, 2]
    assert got[0]["c"].dtype == np.bool_ and bool(got[0]["c"])
    assert np.isnan(got[1]["a"])


def test_health_report_parses_the_ports_jsonl(tmp_path):
    """A monitored run written by the port's ``JsonlRecorder``: metrics,
    a numerics health table, an activation tap and a poisoned step, read
    back and folded by ``tools/health_report.py`` (which imports no JAX)."""
    from tools.health_report import health_from_records, render_report

    params = {"w1": torch.ones(1024), "embed": torch.ones(4, 8)}
    mon = tnum.NumericsMonitor(params)
    path = tmp_path / "run.jsonl"
    with ttel.JsonlRecorder(path) as rec:
        ns, m = mon.init(CPU), ttel.init_metrics(CPU)
        for step in range(4):
            grads = {k: v.clone() for k, v in params.items()}
            if step == 2:
                grads["w1"][5] = float("inf")
            ns = mon.drain(mon.observe(ns, grads=grads), rec, health_every=2)
            m = ttel.drain(ttel.accumulate(m, loss=1.0, tokens=8), rec,
                           every_n=2)
        with tnum.activation_watch(rec):
            tnum.tap("apex_tpu.transformer_layer/mlp",
                     torch.tensor([1.0, float("nan")]), layer=2)
        ttel.flush()
    h = health_from_records(ttel.read_jsonl(path))
    assert h["first_bad_step"] == 3
    assert h["anomaly_counts"] == {"nonfinite_grads": 1}
    assert h["leaves"]["['w1']"]["first_bad_step"] == 3
    assert h["leaves"]["['embed']"]["first_bad_step"] is None
    assert h["taps"]["apex_tpu.transformer_layer/mlp@layer2"][
        "nonfinite_events"] == 1
    assert "first bad step: 3" in render_report(h)
