"""The port's training-side resilience against the JAX package's
(counterparts of ``tests/test_resilience.py``'s ``TestRetry``,
``TestCheckpointHardening``, ``TestCheckpointManager``,
``TestResumableIteration``, ``TestScalerStall`` and ``TestRewind``).

Each scenario runs once through each package on the same states (the
same values, numpy-made; bf16 and fp32 leaves, a packed FusedAdam state)
and the two must give the same retained steps, the same fallback walk,
the same event records (wall stamps, pids, durations and paths left out;
an ``error`` text is held to be present, its wording is each package's
own) and the same rewind decisions and steps. State round-trips bit for
bit. Where a reference test fails on the reference itself, the port's
counterpart says in its docstring which promise it holds instead.
"""
import json
import os
import random
import signal
import threading
import time
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import apex_tpu.resilience as jres
from apex_tpu import checkpoint as jckpt
from apex_tpu import telemetry as jtel
from apex_tpu.amp.scaler import LossScaler as JLossScaler
from apex_tpu.optimizers import FusedAdam as JFusedAdam
from apex_tpu.telemetry import numerics as jnum

import apex_tpu_torch.resilience as tres
from apex_tpu_torch import checkpoint as tckpt
from apex_tpu_torch import telemetry as ttel
from apex_tpu_torch.amp.scaler import LossScaler as TLossScaler
from apex_tpu_torch.optimizers import FusedAdam as TFusedAdam
from apex_tpu_torch.resilience.state import tree_leaves as t_leaves
from apex_tpu_torch.telemetry import numerics as tnum

# ---------------------------------------------------------------------------
# the two packages behind one face
# ---------------------------------------------------------------------------


def _j_mini(step, fill):
    params = {"w": jnp.full((8,), float(fill), jnp.bfloat16),
              "b": jnp.full((4,), float(fill), jnp.float32)}
    return jres.capture(step, params, None, data={"position": step})


def _t_mini(step, fill):
    params = {"w": torch.full((8,), float(fill), dtype=torch.bfloat16),
              "b": torch.full((4,), float(fill), dtype=torch.float32)}
    return tres.capture(step, params, None, data={"position": step})


J = SimpleNamespace(res=jres, tel=jtel, ckpt=jckpt, mini=_j_mini, on={},
                    arr=lambda a: np.asarray(a),
                    b=lambda v: float(np.asarray(v)))
T = SimpleNamespace(res=tres, tel=ttel, ckpt=tckpt, mini=_t_mini,
                    on={"device": "cpu"},
                    arr=lambda a: a.float().numpy()
                    if a.dtype == torch.bfloat16 else a.numpy(),
                    b=lambda v: float(v))

#: keys that name this run, not the behaviour: dropped before comparing
_RUN_KEYS = ("t_wall", "pid", "duration_s")


def _norm(rec, root):
    out = {}
    for k, v in rec.items():
        if k in _RUN_KEYS:
            continue
        if k in ("path", "tmp") and isinstance(v, str):
            v = os.path.relpath(v, root)
            v = v.split(".tmp-")[0] + (".tmp" if ".tmp-" in v else "")
        if k == "error":
            assert isinstance(v, str) and v, rec
            v = "<error>"
        out[k] = v
    return out


def _events(recs, root):
    return [_norm(r, root) for r in recs]


def _both(tmp_path, fn):
    """``fn(ns, root)`` through each package, in a root of its own."""
    want = fn(J, str(tmp_path / "jax"))
    got = fn(T, str(tmp_path / "port"))
    return want, got


# ---------------------------------------------------------------------------
# retry.py: the policies this package adds
# ---------------------------------------------------------------------------


class TestRetry:
    @pytest.mark.parametrize("name", ["ELASTIC_BARRIER_POLICY",
                                      "TRANSPORT_POLICY"])
    def test_policies_equal_the_jax_ones(self, name):
        j, t = getattr(jres, name), getattr(tres, name)
        for f in ("attempts", "base_delay", "max_delay", "deadline",
                  "emit_every"):
            assert getattr(t, f) == getattr(j, f), (name, f)
        assert [c.__name__ for c in t.retry_on] == \
            [c.__name__ for c in j.retry_on]

    def test_barrier_retry_under_deadline_matches_jax(self):
        """A barrier that never fills, under ``ELASTIC_BARRIER_POLICY``
        with a deadline, a fake clock and seeded jitter: the same
        attempts, the same retry and deadline records in both
        packages."""
        def run(ns):
            import dataclasses
            events, t = [], {"now": 0.0}

            def poll():
                t["now"] += 0.1
                raise ns.res.BarrierNotReady("peers missing")

            pol = dataclasses.replace(ns.res.ELASTIC_BARRIER_POLICY,
                                      deadline=3.0, rng=random.Random(3))
            with pytest.raises(ns.res.BarrierNotReady):
                ns.res.retry_call(
                    poll, policy=pol, tag="barrier", sink=events.append,
                    sleep=lambda d: t.__setitem__("now", t["now"] + d),
                    clock=lambda: t["now"])
            return [{k: v for k, v in e.items() if k != "error"}
                    for e in events]

        want, got = run(J), run(T)
        assert got == want
        assert got[-1]["event"] == "retry_deadline"


# ---------------------------------------------------------------------------
# checkpoint.py hardening
# ---------------------------------------------------------------------------


class TestCheckpointHardening:
    def test_atomic_save_failure_keeps_previous(self, tmp_path):
        """A save that fails (an unsupported leaf) neither clobbers the
        previous tree nor leaves a staging tree. The reference's own test
        fails on the reference: the failed save leaves orbax's
        ``<path>.tmp-<pid>.orbax-checkpoint-tmp`` directory behind. The
        port holds the JAX module's documented promise (a failed write
        removes its partial tree and whatever was at ``path`` stays), and
        the test's own: no ``.tmp-`` tree survives."""
        p = str(tmp_path / "ck")
        tckpt.save_checkpoint(p, {"w": torch.arange(4.0)})

        class Unserializable:
            pass

        with pytest.raises(Exception):
            tckpt.save_checkpoint(p, {"w": Unserializable()})
        back = tckpt.load_checkpoint(p)
        np.testing.assert_array_equal(back["w"].numpy(), np.arange(4.0))
        assert not [d for d in os.listdir(tmp_path) if ".tmp-" in d]

    def test_truncated_checkpoint_raises_typed_error(self, tmp_path):
        for ns, state in ((J, {"w": jnp.arange(64.0)}),
                          (T, {"w": torch.arange(64.0)})):
            p = str(tmp_path / f"ck{id(ns)}")
            ns.ckpt.save_checkpoint(p, state)
            ns.res.corrupt_checkpoint(p)
            with pytest.raises(ns.ckpt.CheckpointCorruptError) as ei:
                ns.ckpt.load_checkpoint(p, target=state)
            assert ei.value.path == os.path.abspath(p)
            assert ei.value.__cause__ is not None

    def test_corrupt_only_largest_clips_one_file(self, tmp_path):
        p = str(tmp_path / "ck")
        tckpt.save_checkpoint(p, {"w": torch.arange(4096.0)})
        hit = tres.corrupt_checkpoint(p, only_largest=True)
        assert [os.path.basename(h) for h in hit] == ["arrays.bin"]
        assert os.path.getsize(hit[0]) == 4
        with pytest.raises(FileNotFoundError):
            tres.corrupt_checkpoint(str(tmp_path / "empty"))

    def test_dead_writer_tmp_swept_on_next_save(self, tmp_path):
        p = str(tmp_path / "ck")
        dead = f"{p}.tmp-999999999"  # no such pid
        os.makedirs(dead)
        tckpt.save_checkpoint(p, {"w": torch.zeros(2)})
        assert not os.path.exists(dead)
        assert os.path.exists(p)


# ---------------------------------------------------------------------------
# CheckpointManager
# ---------------------------------------------------------------------------


def _packed_states():
    """The same trained packed-Adam state in both packages: bf16 and
    fp32 params, one step from ones, a scaler with counters, a
    numerics and a metrics state."""
    pw = np.arange(8.0, dtype=np.float32)
    jp = {"w": jnp.asarray(pw, jnp.bfloat16), "b": jnp.ones((4,))}
    tp = {"w": torch.from_numpy(pw).to(torch.bfloat16),
          "b": torch.ones(4)}
    jo = JFusedAdam(lr=1e-2, packed=True, packed_interpret=True,
                    packed_chunk_size=256, master_weights=True)
    to = TFusedAdam(lr=1e-2, packed=True, packed_chunk_size=256,
                    master_weights=True)
    jp2, jo2 = jo.step(jax.tree_util.tree_map(jnp.ones_like, jp),
                       jo.init(jp), jp)
    tp2, to2 = to.step({k: torch.ones_like(v) for k, v in tp.items()},
                       to.init(tp), tp)
    jsc, tsc = JLossScaler("dynamic"), TLossScaler("dynamic")
    jss = jsc.init_state()._replace(loss_scale=jnp.float32(512.0),
                                    consecutive_skips=jnp.int32(2))
    tss = tsc.init_state("cpu")._replace(
        loss_scale=torch.tensor(512.0),
        consecutive_skips=torch.tensor(2, dtype=torch.int32))
    return (jp, jo, jsc, jp2, jo2, jss), (tp, to, tsc, tp2, to2, tss)


class TestCheckpointManager:
    def test_save_restore_roundtrip_with_packed_state(self, tmp_path):
        """Every leaf of a packed FusedAdam state, the scaler, the
        generator state, the metrics and the numerics state round-trips
        bit for bit, and the moments equal the JAX package's after the
        same step."""
        (_, jo, _, _, jo2, _), (tp, to, tsc, tp2, to2, tss) = \
            _packed_states()
        mon = tnum.NumericsMonitor(tp)
        metrics = ttel.accumulate(ttel.init_metrics("cpu"),
                                  loss=torch.tensor(1.5), tokens=8)
        gen = torch.Generator().manual_seed(7)
        torch.rand(3, generator=gen)
        st = tres.capture(5, tp2, to2, scaler=tss, rng=gen.get_state(),
                          data={"position": 5}, metrics=metrics,
                          numerics=mon.init("cpu"))
        mgr = tres.CheckpointManager(str(tmp_path), keep_n=3)
        mgr.save(st, blocking=True)

        def init_fn():
            return tres.capture(0, tp, to.init(tp),
                                scaler=tsc.init_state("cpu"),
                                rng=torch.Generator().manual_seed(0)
                                .get_state(),
                                data={"position": 0},
                                metrics=ttel.init_metrics("cpu"),
                                numerics=mon.init("cpu"))

        back, resumed = tres.resume_or_init(mgr, init_fn)
        assert resumed and back.step == 5
        assert back.data == {"position": 5}
        a = t_leaves((st.params, st.opt_state, st.scaler, st.rng,
                      st.metrics, st.numerics))
        b = t_leaves((back.params, back.opt_state, back.scaler, back.rng,
                      back.metrics, back.numerics))
        assert len(a) == len(b)
        for x, y in zip(a, b):
            if isinstance(x, torch.Tensor):
                assert x.dtype == y.dtype and x.shape == y.shape
                assert torch.equal(x.reshape(-1).view(torch.uint8),
                                   y.reshape(-1).view(torch.uint8))
            else:
                assert x == y
        assert back.opt_state.spec == to2.spec
        g2 = torch.Generator()
        g2.set_state(back.rng)
        assert torch.equal(torch.rand(3, generator=g2),
                           torch.rand(3, generator=gen))
        # the moments equal the JAX step's; the masters within one fp32
        # rounding (the two packages order Adam's division and square
        # root differently)
        for name in ("exp_avg", "exp_avg_sq"):
            np.testing.assert_array_equal(
                getattr(back.opt_state, name).numpy(),
                np.asarray(getattr(jo2, name)))
        np.testing.assert_allclose(back.opt_state.master_params.numpy(),
                                   np.asarray(jo2.master_params),
                                   rtol=2.0 ** -23, atol=0)

    def test_retention_gc_keeps_newest(self, tmp_path):
        def run(ns, root):
            rec = ns.tel.RingBufferRecorder()
            mgr = ns.res.CheckpointManager(root, keep_n=2, sink=rec)
            for s in (1, 2, 3, 4, 5):
                mgr.save(ns.mini(s, s))
            mgr.wait_until_finished()
            return mgr.all_steps(), _events(rec.records, root)

        want, got = _both(tmp_path, run)
        assert got == want
        assert got[0] == [4, 5]

    def test_emergency_checkpoints_survive_gc(self, tmp_path):
        def run(ns, root):
            rec = ns.tel.RingBufferRecorder()
            mgr = ns.res.CheckpointManager(root, keep_n=1, sink=rec)
            mgr.save(ns.mini(1, 1), blocking=True, emergency=True)
            for s in (2, 3, 4):
                mgr.save(ns.mini(s, s), blocking=True)
            return mgr.all_steps(), _events(rec.records, root)

        want, got = _both(tmp_path, run)
        assert got == want
        assert got[0] == [1, 4]

    def test_emergency_save_is_always_blocking(self, tmp_path):
        def run(ns, root):
            mgr = ns.res.CheckpointManager(root, async_save=True)
            with pytest.raises(ValueError, match="always blocking"):
                mgr.save(ns.mini(1, 1), blocking=False, emergency=True)
            mgr.save(ns.mini(1, 1), emergency=True)
            return mgr.all_steps()

        want, got = _both(tmp_path, run)
        assert got == want == [1]

    def test_restore_explicit_missing_step_raises(self, tmp_path):
        def run(ns, root):
            mgr = ns.res.CheckpointManager(root, keep_n=2)
            for s in (3, 6):
                mgr.save(ns.mini(s, s), blocking=True)
            with pytest.raises(FileNotFoundError, match=r"step 9.*\[3, 6\]"):
                mgr.restore(ns.mini(0, 0), step=9)
            back = mgr.restore(ns.mini(0, 0), step=3)
            return back.step, ns.arr(back.params["b"]).tolist()

        want, got = _both(tmp_path, run)
        assert got == want == (3, [3.0] * 4)

    def test_maybe_save_cadence(self, tmp_path):
        def run(ns, root):
            mgr = ns.res.CheckpointManager(os.path.join(root, "a"),
                                           save_every=3)
            saved = [s for s in range(10)
                     if mgr.maybe_save(ns.mini(s, s))]
            mgr.wait_until_finished()
            mgr1 = ns.res.CheckpointManager(os.path.join(root, "b"),
                                            save_every=1)
            saved1 = [s for s in range(4)
                      if mgr1.maybe_save(ns.mini(s, s))]
            mgr1.wait_until_finished()
            mgr0 = ns.res.CheckpointManager(os.path.join(root, "c"),
                                            save_every=0)
            zero = mgr0.maybe_save(ns.mini(0, 0))
            mgr0.wait_until_finished()
            return saved, mgr.all_steps(), saved1, zero

        want, got = _both(tmp_path, run)
        assert got == want
        assert got[0] == [3, 6, 9] and got[2] == [1, 2, 3] and got[3]

    def test_async_failed_write_surfaces_at_barrier(self, tmp_path):
        def run(ns, root):
            chaos = ns.res.ChaosMonkey().fail_write_at(2)
            rec = ns.tel.RingBufferRecorder()
            mgr = ns.res.CheckpointManager(root, chaos=chaos, sink=rec)
            mgr.save(ns.mini(2, 2))  # async; fails in the background
            with pytest.raises(ns.res.ChaosError):
                mgr.wait_until_finished()
            return (_events(rec.records, root), chaos.faults_fired,
                    mgr.all_steps(),
                    sorted(d for d in os.listdir(root) if ".tmp-" in d))

        want, got = _both(tmp_path, run)
        assert got == want
        assert got[0][0]["event"] == "checkpoint_failed"

    def test_failed_commit_leaves_previous_loadable(self, tmp_path):
        def run(ns, root):
            chaos = ns.res.ChaosMonkey().fail_commit_at(4)
            rec = ns.tel.RingBufferRecorder()
            mgr = ns.res.CheckpointManager(root, chaos=chaos, sink=rec)
            mgr.save(ns.mini(2, 2), blocking=True)
            with pytest.raises(ns.res.ChaosError):
                mgr.save(ns.mini(4, 4), blocking=True)
            back = mgr.restore(ns.mini(0, 0))
            return (mgr.all_steps(), back.step,
                    ns.arr(back.params["b"]).tolist(),
                    _events(rec.records, root))

        want, got = _both(tmp_path, run)
        assert got == want
        assert got[:2] == ([2], 2)

    def test_corrupt_newest_falls_back_to_good(self, tmp_path):
        def run(ns, root):
            rec = ns.tel.RingBufferRecorder()
            mgr = ns.res.CheckpointManager(root, sink=rec)
            for s in (2, 4, 6):
                mgr.save(ns.mini(s, s), blocking=True)
            ns.res.corrupt_checkpoint(os.path.join(root, "step_00000006"))
            ns.res.corrupt_checkpoint(os.path.join(root, "step_00000004"))
            back = mgr.restore(ns.mini(0, 0))
            return back.step, _events(rec.records, root)

        want, got = _both(tmp_path, run)
        assert got == want
        falls = [e for e in got[1] if e["event"] == "checkpoint_fallback"]
        assert got[0] == 2 and [f["step"] for f in falls] == [6, 4]

    def test_restore_none_when_empty(self, tmp_path):
        for ns in (J, T):
            mgr = ns.res.CheckpointManager(str(tmp_path / str(id(ns))))
            assert mgr.restore(ns.mini(0, 0)) is None
            st, resumed = ns.res.resume_or_init(mgr,
                                                lambda: ns.mini(0, 0))
            assert not resumed and st.step == 0

    def test_all_checkpoints_failing_raises_not_reinit(self, tmp_path):
        mgr = tres.CheckpointManager(str(tmp_path))
        mgr.save(_t_mini(2, 2), blocking=True)
        bigger = tres.capture(0, {"w": torch.zeros(8, dtype=torch.bfloat16),
                                  "b": torch.zeros(4),
                                  "extra": torch.zeros(2)},
                              None, data={"position": 0})
        rec = []
        mgr._record = rec.append
        with pytest.raises(tckpt.CheckpointCorruptError):
            mgr.restore(bigger)
        assert rec and rec[0]["event"] == "checkpoint_fallback"

    def test_preemption_handler_flushes_emergency(self, tmp_path):
        def run(ns, root):
            rec = ns.tel.RingBufferRecorder()
            mgr = ns.res.CheckpointManager(root, keep_n=2, sink=rec)
            holder = {"state": ns.mini(7, 7)}
            mgr.install_preemption_handler(lambda: holder["state"])
            try:
                assert not mgr.preempted
                ns.res.send_preemption(signal.SIGTERM)
                assert mgr.preempted
                with open(os.path.join(root, "step_00000007",
                                       "meta.json")) as f:
                    meta = json.load(f)
            finally:
                mgr.uninstall_preemption_handler()
            return (mgr.all_steps(), sorted(meta),
                    {k: v for k, v in meta.items() if k != "format"},
                    _events(rec.records, root))

        want, got = _both(tmp_path, run)
        assert got == want
        assert got[2]["emergency"] is True
        assert signal.getsignal(signal.SIGTERM) is not None

    def test_wait_bounded_by_watchdog(self, tmp_path):
        wd = tres.HangWatchdog(timeout_s=0.3, poll_s=0.02)
        mgr = tres.CheckpointManager(str(tmp_path), watchdog=wd)
        mgr._done.clear()  # a wedged background write
        try:
            with pytest.raises(tres.HangError) as ei:
                mgr.wait_until_finished()
            assert "wait_until_finished" in str(ei.value)
            assert "MainThread" in ei.value.stacks
        finally:
            mgr._done.set()
            wd.close()

    def test_snapshot_is_a_copy_taken_at_save(self, tmp_path):
        """The async save writes the state as it was at ``save()``: an
        in-place update right after (what the packed step does) does not
        reach the checkpoint."""
        mgr = tres.CheckpointManager(str(tmp_path), async_save=True)
        st = _t_mini(3, 3)
        mgr.save(st)
        st.params["b"].add_(100.0)
        mgr.wait_until_finished()
        back = mgr.restore(_t_mini(0, 0))
        assert back.params["b"].tolist() == [3.0] * 4


# ---------------------------------------------------------------------------
# resumable iteration
# ---------------------------------------------------------------------------


class TestResumableIteration:
    def test_indexed_batches_roundtrip(self):
        def run(ns):
            it = ns.res.IndexedBatches(lambda i: i * 10)
            out = [next(it) for _ in range(3)]
            st = it.state()
            it2 = ns.res.IndexedBatches(lambda i: i * 10,
                                        position=st["position"])
            out.append(next(it2))
            it2.skip(2)
            out.append(next(it2))
            return out, st

        assert run(T) == run(J) == ([0, 10, 20, 30, 60], {"position": 3})

    def test_iterator_drain_restore(self):
        def run(ns):
            it = ns.res.ResumableIterator(lambda: iter(range(100)))
            out = [next(it) for _ in range(4)]
            st = it.state()
            it.restore(st)
            out.append(next(it))
            it.skip(5)
            out.append(next(it))
            return out

        assert run(T) == run(J) == [0, 1, 2, 3, 4, 10]


# ---------------------------------------------------------------------------
# the scaler's consecutive-skip counter and the scaler_stall rule
# ---------------------------------------------------------------------------


def _overflowed(st, lib):
    if lib is J:
        return st._replace(found_inf=jnp.asarray(True))
    return st._replace(found_inf=torch.tensor(True))


class TestScalerStall:
    def test_consecutive_skips_counter(self):
        def run(lib, sc, st):
            out = []
            for _ in range(3):
                st = sc.update_scale(_overflowed(st, lib))
                out.append(int(st.consecutive_skips))
            st = sc.update_scale(st)
            return out + [int(st.consecutive_skips),
                          float(st.loss_scale)]

        j = JLossScaler("dynamic", hysteresis=1)
        t = TLossScaler("dynamic", hysteresis=1)
        assert run(T, t, t.init_state("cpu")) == \
            run(J, j, j.init_state()) == [1, 2, 3, 0, 8192.0]

    def test_static_scaler_also_counts(self):
        sc = TLossScaler(128.0)
        st = sc.update_scale(_overflowed(sc.init_state("cpu"), T))
        assert int(st.consecutive_skips) == 1

    def test_state_dict_roundtrip_includes_counter(self):
        sc = TLossScaler("dynamic")
        st = sc.init_state("cpu")._replace(
            consecutive_skips=torch.tensor(5, dtype=torch.int32))
        sd = sc.state_dict(st)
        assert sd["consecutive_skips"] == 5
        assert int(sc.load_state_dict(sd, "cpu").consecutive_skips) == 5
        del sd["consecutive_skips"]
        assert int(sc.load_state_dict(sd, "cpu").consecutive_skips) == 0

    @pytest.mark.parametrize("budget", [3, 0])
    def test_scaler_stall_events_match_jax(self, budget):
        """Six overflowed updates, a clean one, four more: past
        ``max_consecutive_skips`` the anomaly engine emits ONE
        ``scaler_stall`` a run (edge-triggered), none at budget 0 — the
        same records as the JAX monitor's, ``t_wall`` apart."""
        def run(lib):
            if lib is J:
                sc = JLossScaler("dynamic", hysteresis=1)
                mon = jnum.NumericsMonitor({"w": jnp.ones((4,))},
                                           max_consecutive_skips=budget)
                rec, st, ns = jtel.RingBufferRecorder(), sc.init_state(), \
                    mon.init()
            else:
                sc = TLossScaler("dynamic", hysteresis=1)
                mon = tnum.NumericsMonitor({"w": torch.ones(4)},
                                           max_consecutive_skips=budget)
                rec, st, ns = ttel.RingBufferRecorder(), \
                    sc.init_state("cpu"), mon.init("cpu")
            for bad in [True] * 6 + [False] + [True] * 4:
                st, ns = sc.update_scale(
                    _overflowed(st, lib) if bad else st, numerics=ns)
                ns = mon.drain(ns, rec)
            if lib is J:
                jax.effects_barrier()
            else:
                ttel.flush()
            return [{k: v for k, v in r.items() if k != "t_wall"}
                    for r in rec.records
                    if r.get("kind") in ("scaler_stall", "scale_collapse")]

        want, got = run(J), run(T)
        assert got == want
        stalls = [r for r in got if r["kind"] == "scaler_stall"]
        assert len(stalls) == (2 if budget else 0)


# ---------------------------------------------------------------------------
# rewind
# ---------------------------------------------------------------------------


class TestRewind:
    def test_ring_and_budget_trigger(self):
        def run(ns, skips):
            ctl = ns.res.RewindController(keep=2, skip_budget=3,
                                          snapshot_every=2)
            for s in (1, 2, 3, 4, 5, 6):
                ctl.offer(ns.mini(s, s), healthy=True)
            ring = [sn.step for sn in ctl._ring]
            ctl.offer(ns.mini(7, 7), consecutive_skips=skips)
            return ring, ctl.rewind_pending, ctl._pending

        assert run(T, torch.tensor(3, dtype=torch.int32)) == \
            run(J, jnp.int32(3)) == ([3, 5], True,
                                     "consecutive_skips 3 >= budget 3")

    def test_anomaly_event_sink_triggers(self):
        for ns in (J, T):
            ctl = ns.res.RewindController()
            ctl.record({"event": "anomaly", "kind": "grad_spike"})
            assert not ctl.rewind_pending
            ctl.record({"event": "anomaly", "kind": "scale_collapse"})
            assert ctl.rewind_pending

    def test_rewind_decisions_match_jax(self):
        """A run of offers (healthy, skipped, a stall event), two rewinds
        and the exhaustion: the same ring, decisions, restored steps,
        data positions and ``rewind`` records in both packages."""
        def run(ns, skip):
            rec = ns.tel.RingBufferRecorder()
            ctl = ns.res.RewindController(keep=2, skip_budget=2,
                                          snapshot_every=2, recorder=rec,
                                          max_rewinds=3, tag="t")
            it = ns.res.IndexedBatches(lambda i: i)
            out = []
            for s in range(1, 12):
                next(it)
                st = ns.mini(s, s)._replace(data=it.state())
                bad = s in (5, 9)
                ctl.offer(st, consecutive_skips=skip(2 if bad else 0))
                if s == 7:
                    ctl.record({"event": "anomaly", "kind": "scaler_stall"})
                if ctl.rewind_pending:
                    back = ctl.rewind(data_iter=it, skip_batches=1,
                                      current_step=s, **ns.on)
                    out.append((s, back.step, back.data,
                                ns.arr(back.params["b"]).tolist()))
                out.append([sn.step for sn in ctl._ring])
            with pytest.raises(ns.res.RewindExhaustedError):
                ctl.rewind(**ns.on)
            return out, [{k: v for k, v in r.items() if k != "t_wall"}
                         for r in rec.records]

        want = run(J, lambda n: jnp.int32(n))
        got = run(T, lambda n: torch.tensor(n, dtype=torch.int32))
        assert got == want
        assert [e["trigger"] for e in got[1]] == [
            "consecutive_skips 2 >= budget 2", "scaler_stall",
            "consecutive_skips 2 >= budget 2"]

    def test_rewind_restores_and_advances_data(self):
        rec = ttel.RingBufferRecorder()
        ctl = tres.RewindController(keep=2, recorder=rec)
        st = tres.capture(4, {"w": torch.full((4,), 4.0)}, None,
                          data={"position": 4})
        ctl.offer(st, healthy=True)
        it = tres.IndexedBatches(lambda i: i, position=9)
        ctl.request_rewind("test trigger")
        back = ctl.rewind(data_iter=it, skip_batches=2, current_step=9,
                          device="cpu")
        assert int(back.step) == 4
        assert back.params["w"].tolist() == [4.0] * 4
        assert back.data == {"position": 11}
        assert not ctl.rewind_pending
        (ev,) = rec.events("rewind")
        assert ev["to_step"] == 4 and ev["step"] == 9
        assert ev["trigger"] == "test trigger"

    def test_snapshot_and_rewind_are_copies(self):
        """The ring holds its own host copy, and a rewind hands out a
        copy of it: an in-place update of the live state, or of a
        restored one (the packed step updates its buffers in place),
        never reaches the ring."""
        ctl = tres.RewindController()
        w = torch.arange(4.0)
        ctl.offer(tres.capture(1, {"w": w}, None), healthy=True)
        w[0] = 99.0
        snap_w = ctl._ring[0].state.params["w"]
        assert snap_w[0].item() == 0.0 and snap_w.data_ptr() != w.data_ptr()
        back = ctl.rewind(device="cpu")
        back.params["w"].add_(1.0)
        assert ctl._ring[0].state.params["w"].tolist() == [0.0, 1, 2, 3]

    def test_max_rewinds_exhausts(self):
        ctl = tres.RewindController(max_rewinds=1)
        ctl.offer(_t_mini(1, 1), healthy=True)
        ctl.rewind(device="cpu")
        with pytest.raises(tres.RewindExhaustedError):
            ctl.rewind(device="cpu")

    def test_rewind_defaults_to_the_card(self, monkeypatch):
        """Like every entry point of the port, ``rewind`` restores onto
        the card unless ``device='cpu'`` is given: without one it
        raises, before it spends a rewind or clears the trigger."""
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        ctl = tres.RewindController()
        ctl.offer(_t_mini(1, 1), healthy=True)
        ctl.request_rewind("t")
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ctl.rewind()
        assert ctl.rewinds == 0 and ctl.rewind_pending

    def test_rewind_without_snapshot_raises(self):
        with pytest.raises(RuntimeError):
            tres.RewindController().rewind()

    @pytest.mark.parametrize("flag", [False, True,
                                      torch.tensor(False),
                                      torch.tensor(True)])
    def test_poison_grads_matches_jax(self, flag):
        g = np.linspace(-1, 1, 4).astype(np.float32)
        got = tres.poison_grads({"w": torch.from_numpy(g).to(torch.bfloat16)},
                                flag)["w"]
        want = jres.poison_grads({"w": jnp.asarray(g, jnp.bfloat16)},
                                 bool(flag))["w"]
        np.testing.assert_array_equal(got.float().numpy(),
                                      np.asarray(want, np.float32))
        assert got.dtype == torch.bfloat16


# ---------------------------------------------------------------------------
# the training chaos
# ---------------------------------------------------------------------------


class TestChaos:
    def test_monkey_fires_once_like_jax(self):
        def run(ns):
            m = ns.res.ChaosMonkey().fail_write_at(2, 3).fail_commit_at(3)
            m.poison_batches(range(4, 6))
            out = []
            for step in (1, 2, 2, 3):
                for hook in (m.before_write, m.before_commit):
                    try:
                        hook(step)
                        out.append("ok")
                    except ns.res.ChaosError:
                        out.append("fault")
            out.append([m.should_poison(b) for b in range(7)])
            return out, m.faults_fired

        assert run(T) == run(J)

    def test_stalling_sink_blocks_until_released(self):
        fwd = ttel.RingBufferRecorder()
        sink = tres.StallingSink(stall_s=30.0, forward=fwd)
        t = threading.Thread(target=sink.record, args=({"event": "x"},))
        t0 = time.monotonic()
        t.start()
        assert sink.stalled.wait(5.0)
        sink.release()
        t.join(5.0)
        assert time.monotonic() - t0 < 10.0
        assert sink.records == [{"event": "x"}]
        assert [r["event"] for r in fwd.records] == ["x"]
