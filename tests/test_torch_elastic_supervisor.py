"""The elastic service's supervision in the port, against the JAX package
(counterparts of ``tests/test_elastic.py``'s ``TestChaosHost``,
``TestHeartbeat``, ``TestSupervisor``, ``TestSupervisorCLI`` and its
chaos trace), on the CPU.

- ``ChaosHost``: the spec round-trips, and the JAX class and the port's
  parse each other's specs; faults fire once, at or past their step.
- ``Heartbeat`` and the liveness helpers: the beat file's bytes are the
  JAX format, read across packages; corpse beats and dead writers'
  staging files are swept, a live writer's spared.
- ``Supervisor`` over scripted hosts (plain ``python -c`` bodies): the
  same incidents, restarts, world history and event sequence as the JAX
  supervisor's for a death, a hang, the restart budget and a reshape.
- The real fake hosts (``_elastic_host.py --device cpu``) under the
  supervisor: a SIGKILL mid-``.part`` write, a reshape 2 -> 3, a
  heartbeat wedge and a SIGKILL mid-barrier; the loss records after
  that whole history equal the uninterrupted run's byte for byte. The
  CLI (``tools/torch_elastic_supervisor.py``) does the same with a kill
  at a step boundary and a reshape.
"""
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import pytest

from apex_tpu.resilience import chaos as jchaos
from apex_tpu.resilience import elastic as jel
from apex_tpu.resilience import liveness as jlive
from apex_tpu.telemetry import RingBufferRecorder as JRing

from apex_tpu_torch.resilience import (
    ChaosHost,
    Heartbeat,
    Supervisor,
    WorldFailedError,
    live_beat,
    read_json_tolerant,
    sweep_stale,
    writer_alive,
)
from apex_tpu_torch.telemetry import RingBufferRecorder

REPO = Path(__file__).resolve().parent.parent
HOST_PROGRAM = str(REPO / "apex_tpu_torch" / "resilience" / "_elastic_host.py")
CLI = str(REPO / "tools" / "torch_elastic_supervisor.py")
STEPS = 12


# ---------------------------------------------------------------------------
# ChaosHost + Heartbeat
# ---------------------------------------------------------------------------


class TestChaosHost:
    @pytest.mark.parametrize("spec", [
        "", "kill@7", "kill_write@6,kill_barrier@5",
        "kill@7,kill_write@6,kill_barrier@5,wedge@9:2.5"])
    def test_spec_round_trips_across_packages(self, spec):
        t = ChaosHost.parse(spec)
        j = jchaos.ChaosHost.parse(spec)
        assert t.to_spec() == j.to_spec()
        assert jchaos.ChaosHost.parse(t.to_spec()).to_spec() == t.to_spec()

    def test_unknown_fault_refused(self):
        with pytest.raises(ValueError, match="unknown chaos fault"):
            ChaosHost.parse("explode@3")

    def test_take_fires_once_at_or_past_step(self, monkeypatch):
        died = []
        monkeypatch.setattr(ChaosHost, "_die",
                            staticmethod(lambda: died.append(True)))
        c = (ChaosHost().kill_at_step(5).kill_in_shard_write_at(3)
             .kill_in_barrier_at(4))
        c.at_step_boundary(4)
        c.mid_part_write(2)
        assert not died
        c.at_step_boundary(6)  # past the armed step still fires
        c.at_step_boundary(7)  # once only
        c.mid_part_write(3)
        c.in_barrier(9)
        c.before_commit(9)  # the barrier fault already fired
        assert len(died) == 3
        assert c.faults_fired == [("kill", 6), ("kill_write", 3),
                                  ("kill_barrier", 9)]

    def test_wedge_take(self):
        c = ChaosHost().wedge_heartbeat_at(3, 1.5)
        assert c.take_wedge(2) is None
        assert c.take_wedge(3) == 1.5
        assert c.take_wedge(4) is None
        assert c.faults_fired == [("wedge", 3)]


def _dead_pid():
    proc = subprocess.Popen([sys.executable, "-c", "pass"])
    proc.wait(timeout=30)
    return proc.pid


class TestHeartbeat:
    def test_beat_read_age_and_jax_bytes(self, tmp_path):
        path = str(tmp_path / "hb" / "hb-1")
        assert Heartbeat.age_s(path) is None
        Heartbeat(path, host=1).beat(7)
        rec = Heartbeat.read(path)
        assert sorted(rec) == ["host", "pid", "step", "t_wall"]
        assert rec["host"] == 1 and rec["step"] == 7
        assert Heartbeat.age_s(path) < 5.0
        # each package reads the other's beats
        assert jel.Heartbeat.read(path) == rec
        jpath = str(tmp_path / "hb" / "hb-2")
        jel.Heartbeat(jpath, host=2).beat(3)
        assert Heartbeat.read(jpath) == jel.Heartbeat.read(jpath)

    def test_corpse_beats_and_dead_staging_swept(self, tmp_path):
        d = tmp_path / "hb"
        d.mkdir()
        dead = _dead_pid()
        (d / "hb-0").write_text(json.dumps(
            {"host": 0, "step": 4, "pid": dead, "t_wall": time.time()}))
        Heartbeat(str(d / "hb-1"), host=1).beat(5)
        (d / f"hb-2.tmp-{dead}").write_text("{")
        (d / "notes.txt").write_text("not a beat")
        assert live_beat(str(d / "hb-0")) is None
        assert live_beat(str(d / "hb-1"))["step"] == 5
        assert jlive.live_beat(str(d / "hb-1"))["step"] == 5
        assert writer_alive(os.getpid()) and not writer_alive(dead)
        assert read_json_tolerant(str(d / "notes.txt")) is None
        removed = sweep_stale(str(d), prefix="hb-")
        assert sorted(os.path.basename(p) for p in removed) == [
            "hb-0", f"hb-2.tmp-{dead}"]
        assert sorted(os.listdir(d)) == ["hb-1", "notes.txt"]


# ---------------------------------------------------------------------------
# the supervisor over scripted hosts, against the JAX supervisor
# ---------------------------------------------------------------------------


def _script_host(hb_dir, bodies):
    def build_cmd(host, world, incarnation):
        body = bodies[min(incarnation, len(bodies) - 1)]
        hb = os.path.join(hb_dir, f"hb-{host}")
        return [sys.executable, "-c", body.format(hb=hb, host=host)]

    return build_cmd


BEAT_AND_EXIT0 = "open(r'{hb}', 'w').close()"
BEAT_AND_DIE = ("import sys; open(r'{hb}', 'w').close(); "
                "sys.exit(3 if {host} == 1 else 0)")
BEAT_AND_HANG = ("import time; open(r'{hb}', 'w').close(); "
                 "time.sleep(60 if {host} == 1 else 0)")

SCRIPTS = {
    "death": ([BEAT_AND_DIE, BEAT_AND_EXIT0], 2,
              dict(heartbeat_timeout_s=30.0, max_restarts=2), None),
    "hang": ([BEAT_AND_HANG, BEAT_AND_EXIT0], 2,
             dict(heartbeat_timeout_s=0.4, poll_s=0.02, max_restarts=2),
             None),
    "budget": ([BEAT_AND_DIE], 2, dict(max_restarts=1), None),
    "reshape": ([BEAT_AND_DIE, BEAT_AND_EXIT0], 2,
                dict(max_restarts=2), lambda incarnation, world: 3),
}


def _supervise(cls, ring, failed, tmp, name):
    bodies, world, kw, on_restart = SCRIPTS[name]
    hb = str(tmp / "hb")
    rec = ring()
    sup = cls(_script_host(hb, bodies), world, heartbeat_dir=hb, sink=rec,
              on_restart=on_restart, **kw)
    try:
        summary = sup.run()
    except failed as e:
        summary = {"failed": str(e),
                   "restarts": sup.restarts,
                   "incidents": [{"kind": i.kind, "host": i.host,
                                  "incarnation": i.incarnation,
                                  "detail": i.detail,
                                  "recovery_s": i.recovery_s}
                                 for i in sup.incidents]}
    summary.pop("wall_s", None)
    for inc in summary["incidents"]:
        # detection to first heartbeat: a time, present or not
        inc["recovery_s"] = inc["recovery_s"] is not None
        if inc["kind"] == "host_hang":
            inc["detail"] = "heartbeat stale"
    events = [(r["event"], r.get("host"), r.get("incarnation"),
               r.get("world"))
              for r in rec.records
              if r["event"] not in ("span", "blackbox", "host_exit",
                                    "host_launched")]
    launched = sorted((r["incarnation"], r["host"]) for r in rec.records
                      if r["event"] == "host_launched")
    return summary, events, launched


@pytest.mark.parametrize("name", sorted(SCRIPTS))
def test_supervisor_matches_jax(tmp_path, name):
    want = _supervise(jel.Supervisor, JRing, jel.WorldFailedError,
                      tmp_path / "jax", name)
    got = _supervise(Supervisor, RingBufferRecorder, WorldFailedError,
                     tmp_path / "port", name)
    assert got == want
    summary = got[0]
    if name == "budget":
        assert summary["restarts"] == 2 and "host 1" in summary["failed"]
    else:
        assert summary["ok"] and summary["restarts"] == 1
        assert summary["incidents"][0]["host"] == 1
    if name == "reshape":
        assert summary["world_history"] == [2, 3]


# ---------------------------------------------------------------------------
# the real fake hosts under supervision
# ---------------------------------------------------------------------------


def _records(path):
    """{step: hex} of a losses file; a replayed step must repeat its
    record exactly."""
    out = {}
    with open(path) as f:
        for line in f:
            if line.startswith("S "):
                _, s, hexval = line.split()
                step = int(s)
                if step in out:
                    assert out[step] == hexval, f"replay diverged at {step}"
                out[step] = hexval
    return out


def _env():
    return {**os.environ, "PYTHONPATH": str(REPO) + os.pathsep
            + os.environ.get("PYTHONPATH", "")}


@pytest.fixture(scope="module")
def uninterrupted(tmp_path_factory):
    """The uninterrupted run: one fake host, no fault, the same steps."""
    d = tmp_path_factory.mktemp("elastic_ref")
    out = subprocess.run(
        [str(a) for a in (sys.executable, HOST_PROGRAM, "--host", 0,
                          "--world", 1, "--steps", STEPS, "--root",
                          d / "ckpt", "--losses", d / "l.txt",
                          "--heartbeat-dir", d / "hb", "--device", "cpu")],
        env=_env(), capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    recs = _records(d / "l.txt")
    assert sorted(recs) == list(range(STEPS))
    return recs


def test_chaos_trace_kills_reshapes_wedges_byte_exact(tmp_path,
                                                      uninterrupted):
    """A supervised world of 2 fake hosts suffers a SIGKILL mid-``.part``
    write, restarts RESHAPED to 3 hosts, suffers a heartbeat wedge (a
    hang) and a SIGKILL mid-barrier, and still lands loss records
    byte-identical to the uninterrupted run — no markerless step is ever
    restored (a torn restore would diverge the records)."""
    run = tmp_path
    ckpt, losses = str(run / "ckpt"), str(run / "losses.txt")
    chaos_by = {(0, 1): "kill_write@4",    # SIGKILL mid-.part write
                (1, 2): "wedge@7",         # heartbeat wedge -> host_hang
                (2, 0): "kill_barrier@10"}  # SIGKILL mid commit barrier

    def build_cmd(host, world, incarnation):
        return [sys.executable, HOST_PROGRAM, "--host", host,
                "--world", world, "--steps", STEPS, "--root", ckpt,
                "--losses", losses, "--heartbeat-dir", str(run / "hb"),
                "--save-every", 2, "--barrier-timeout", 30,
                "--step-sleep", 0.05, "--device", "cpu"]

    def host_env(host, world, incarnation):
        spec = chaos_by.get((incarnation, host))
        return {"APEX_TPU_ELASTIC_CHAOS": spec} if spec else None

    rec = RingBufferRecorder()
    sup = Supervisor(
        build_cmd, 2, heartbeat_dir=str(run / "hb"),
        heartbeat_timeout_s=3.0, startup_timeout_s=60.0, poll_s=0.05,
        max_restarts=4, sink=rec, env=_env(), host_env=host_env,
        on_restart=lambda incarnation, world: 3 if incarnation == 0
        else world)
    summary = sup.run()
    assert summary["ok"], summary
    assert summary["restarts"] == 3
    assert summary["world_history"] == [2, 3, 3, 3]
    assert [i["kind"] for i in summary["incidents"]] == [
        "host_death", "host_hang", "host_death"]
    assert all(i["recovery_s"] is not None for i in summary["incidents"])
    assert _records(losses) == uninterrupted
    # the markerless garbage the kills left was never restored: the
    # reshaped incarnations re-flattened committed steps only
    assert [r["event"] for r in rec.records if r["event"] ==
            "world_restart"] == ["world_restart"] * 3


class TestSupervisorCLI:
    def test_parse_chaos_and_reshape_match_jax(self):
        sys.path.insert(0, str(REPO))
        from tools import elastic_supervisor as jes
        from tools import torch_elastic_supervisor as es

        for specs in (["0:2:kill@7", "1:0:wedge@3:9"], []):
            assert es.parse_chaos(specs) == jes.parse_chaos(specs)
        assert es.parse_reshape(["1:2", "3:1"]) == {1: 2, 3: 1}
        with pytest.raises(SystemExit):
            es.parse_chaos(["bogus"])
        with pytest.raises(SystemExit):
            es.parse_reshape(["bogus"])
        assert os.path.exists(es.HOST_PROGRAM)
        assert es.HOST_PROGRAM == HOST_PROGRAM

    def test_cli_kill_and_reshape_byte_exact(self, tmp_path, uninterrupted):
        """Host 1 killed at step 8, past its step-6 save, which waited on
        the step-3 commit: the restarted world of 3 re-flattens a
        committed step."""
        out = subprocess.run(
            [sys.executable, CLI, "--world", "2", "--steps", str(STEPS),
             "--run-dir", str(tmp_path), "--device", "cpu",
             "--chaos", "0:1:kill@8", "--reshape", "1:3",
             "--heartbeat-timeout", "30", "--json"],
            env=_env(), capture_output=True, text=True, timeout=180)
        assert out.returncode == 0, out.stderr
        summary = json.loads(out.stdout)
        assert summary["world_history"] == [2, 3]
        assert [i["kind"] for i in summary["incidents"]] == ["host_death"]
        assert _records(tmp_path / "losses.txt") == uninterrupted
        events = [json.loads(line)["event"] for line in
                  open(tmp_path / "events.jsonl")]
        assert "host_death" in events and "world_done" in events
        assert "checkpoint_reshard" in events

    def test_cli_world_failed_exits_one(self, tmp_path):
        out = subprocess.run(
            [sys.executable, CLI, "--world", "1", "--steps", "0",
             "--run-dir", str(tmp_path), "--max-restarts", "0",
             "--cmd", f"{sys.executable} -c 'import sys; sys.exit(3)'"],
            env=_env(), capture_output=True, text=True, timeout=60)
        assert out.returncode == 1, out.stderr
        assert "world failed" in out.stderr
