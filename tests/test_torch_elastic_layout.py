"""The elastic service's layouts and its two-phase commit in the port,
against the JAX package (counterparts of ``tests/test_elastic.py``'s
``TestWorldLayout``, ``TestReflatten``, ``TestTwoPhaseCommit``,
``TestElasticReshard``, ``TestFsyncDurability`` and
``TestMultiWriterSweep``).

Layouts: ``world_chunk_size``, ``pack_spec_for_world``,
``grad_buckets_for_world``, ``sharded_leaf_indices`` and
``reflatten_flat`` through both packages on the same templates (the fake
host's MLP and a mixed-dtype GPT-like tree): the same chunk sizes,
totals, offsets, shard bounds and leaf indices; reflattened buffers equal
bit for bit; ``layout_findings`` empty for worlds 1-8 (the JAX auditor's
``check_pack_spec`` rules). Commit: ``shard-<h>.part`` + ``COMMIT`` with
the JAX fields, markerless steps as garbage, fsync durability, the
multi-writer sweep and restores onto other worlds, bit for bit.
"""
import functools
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu import analysis
from apex_tpu.multi_tensor_apply.packing import PackSpec as JPackSpec
from apex_tpu.resilience import elastic as jel
from apex_tpu.resilience import state as jstate

from apex_tpu_torch.multi_tensor_apply.packing import (
    ROW,
    PackSpec,
    layout_findings,
)
from apex_tpu_torch.resilience import (
    COMMIT_MARKER,
    BarrierNotReady,
    ChaosError,
    CheckpointManager,
    ElasticCheckpointManager,
    capture,
    grad_buckets_for_world,
    pack_spec_for_world,
    reflatten_flat,
    sharded_leaf_indices,
    world_chunk_size,
)
from apex_tpu_torch.resilience import elastic as tel_mod
from apex_tpu_torch.resilience import _elastic_host as eh
from apex_tpu_torch.resilience.state import (
    device_part,
    flat_leaves,
    tree_leaves,
)
from apex_tpu_torch.telemetry import RingBufferRecorder

# the fake host's helpers build on the card by default; these tests hold
# their CPU path
build_world = functools.partial(eh.build_world, device="cpu")
fresh_state = functools.partial(eh.fresh_state, device="cpu")
reference_records = functools.partial(eh.reference_records, device="cpu")

#: template shapes and dtypes: the fake host's MLP and a mixed-dtype
#: GPT-like tree (bf16 matrices, fp32 norms, a leaf of 1 element)
TEMPLATES = {
    "host_mlp": {"b1": ((16,), "float32"), "w1": ((8, 16), "float32"),
                 "w2": ((16, 1), "float32")},
    "gpt_like": {"emb": ((500, 64), "bfloat16"),
                 "layers": {"qkv_w": ((2, 64, 192), "bfloat16"),
                            "ln_w": ((2, 64), "float32"),
                            "fc1_b": ((2, 256), "bfloat16")},
                 "scale": ((1,), "float32")},
}


def _jtree(t):
    return {k: _jtree(v) if isinstance(v, dict)
            else jnp.zeros(v[0], getattr(jnp, v[1])) for k, v in t.items()}


def _ttree(t):
    return {k: _ttree(v) if isinstance(v, dict)
            else torch.zeros(v[0], dtype=getattr(torch, v[1]))
            for k, v in t.items()}


def _layout(spec):
    return (spec.total, spec.chunk_size, spec.offsets, spec.sizes,
            spec.bucket_bounds, spec.bucket_leaf_ranges)


# ---------------------------------------------------------------------------
# world-aware layouts + re-flattening
# ---------------------------------------------------------------------------


class TestWorldLayout:
    @pytest.mark.parametrize("chunk", [1, 256, ROW, 4 * ROW + 1, 65536])
    @pytest.mark.parametrize("world", [1, 2, 3, 4, 5, 8])
    def test_world_chunk_size_matches_jax(self, chunk, world):
        assert world_chunk_size(chunk, world) == \
            jel.world_chunk_size(chunk, world)

    def test_host_helpers_default_to_the_card(self, monkeypatch):
        """The fake host's helpers build on the card unless
        ``device='cpu'`` is given, as every entry point of the port."""
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        for call in (lambda: eh.batch_fn(0), lambda: eh.init_params(),
                     lambda: eh.fresh_state(2),
                     lambda: eh.reference_records(2, 1)):
            with pytest.raises(RuntimeError, match="no CUDA device"):
                call()

    def test_world_chunk_size_refuses_no_world(self):
        with pytest.raises(ValueError):
            world_chunk_size(256, 0)

    @pytest.mark.parametrize("name", sorted(TEMPLATES))
    @pytest.mark.parametrize("world", range(1, 9))
    def test_pack_spec_for_world_matches_jax(self, name, world):
        t = pack_spec_for_world(_ttree(TEMPLATES[name]), world,
                                chunk_size=256)
        j = jel.pack_spec_for_world(_jtree(TEMPLATES[name]), world,
                                    chunk_size=256)
        assert _layout(t) == _layout(j)
        assert t.shard_bounds(world) == j.shard_bounds(world)
        assert layout_findings(t, shard_count=world) == []
        assert not analysis.check_pack_spec(j, shard_count=world)

    @pytest.mark.parametrize("name", sorted(TEMPLATES))
    @pytest.mark.parametrize("world", range(1, 9))
    def test_grad_buckets_for_world_match_jax(self, name, world):
        t = grad_buckets_for_world(_ttree(TEMPLATES[name]), world,
                                   bucket_cap_mb=0.01, chunk_size=256)
        j = jel.grad_buckets_for_world(_jtree(TEMPLATES[name]), world,
                                       bucket_cap_mb=0.01, chunk_size=256)
        assert _layout(t.spec) == _layout(j.spec)
        assert layout_findings(t.spec, shard_count=world) == []

    def test_host_worlds_lay_out_differently(self):
        _, b2, _, _ = build_world(2)
        _, b4, _, _ = build_world(4)
        assert b2.spec.total != b4.spec.total
        assert b2.spec.offsets != b4.spec.offsets

    def test_shard_bounds_red_indivisible(self):
        spec = PackSpec({"w": torch.zeros(8)}, chunk_size=ROW)
        with pytest.raises(ValueError, match="not divisible"):
            spec.shard_bounds(3)


def _filled(spec, seed=0):
    buf = np.zeros((spec.total,), np.float32)
    mask = spec.valid_mask()
    buf[mask] = np.random.default_rng(seed).standard_normal(
        int(mask.sum())).astype(np.float32)
    return buf


class TestReflatten:
    @pytest.mark.parametrize("name", sorted(TEMPLATES))
    @pytest.mark.parametrize("old,new", [(4, 2), (2, 4), (8, 1), (3, 5)])
    def test_reflatten_matches_jax_bitwise(self, name, old, new):
        tt, jt = _ttree(TEMPLATES[name]), _jtree(TEMPLATES[name])
        so, sn = (pack_spec_for_world(tt, w, chunk_size=256)
                  for w in (old, new))
        jo, jn = (jel.pack_spec_for_world(jt, w, chunk_size=256)
                  for w in (old, new))
        buf = _filled(so)
        got = reflatten_flat(so, sn, torch.from_numpy(buf))
        want = jel.reflatten_flat(jo, jn, buf)
        assert isinstance(got, torch.Tensor)
        np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                      np.asarray(want).view(np.uint32))
        # a NumPy buffer comes back as one, and the round trip is exact
        back = reflatten_flat(sn, so, got.numpy())
        assert isinstance(back, np.ndarray)
        np.testing.assert_array_equal(back.view(np.uint32),
                                      buf.view(np.uint32))
        for la, lb in zip(tree_leaves(so.unpack(torch.from_numpy(buf),
                                                cast=False)),
                          tree_leaves(sn.unpack(got, cast=False))):
            assert torch.equal(la, lb)

    def test_mismatched_templates_raise(self):
        _, b2, _, _ = build_world(2)
        other = PackSpec({"x": torch.zeros(64, 64)}, chunk_size=1024)
        with pytest.raises(ValueError, match="different leaf"):
            reflatten_flat(other, b2.spec, torch.zeros(other.total))

    def test_wrong_length_buffer_raises(self):
        _, b2, _, _ = build_world(2)
        with pytest.raises(ValueError, match="shape"):
            reflatten_flat(b2.spec, b2.spec, torch.zeros(b2.spec.total + 1))

    def test_reshard_findings_red_and_green(self):
        _, b2, _, _ = build_world(2)
        _, b4, _, _ = build_world(4)
        assert tel_mod.reshard_findings(b4.spec, b2.spec, old_count=4,
                                        new_count=2) == []
        other = PackSpec({"x": torch.zeros(64, 64)}, chunk_size=1024)
        codes = [c for c, _ in tel_mod.reshard_findings(other, b2.spec)]
        assert "reshard_leaf_mismatch" in codes
        # the JAX auditor names the same findings on the same layouts
        from apex_tpu.resilience._elastic_host import (
            build_world as jbuild,
        )

        _, jb2, _, _ = jbuild(2)
        _, jb4, _, _ = jbuild(4)
        jother = JPackSpec({"x": jnp.zeros((64, 64))}, chunk_size=1024)
        assert [f.code for f in analysis.check_reshard(jother, jb2.spec)] \
            == codes
        for old_count in (5, 7):
            got = [c for c, _ in tel_mod.reshard_findings(
                b4.spec, b2.spec, old_count=old_count, new_count=2)]
            want = [f.code for f in analysis.check_reshard(
                jb4.spec, jb2.spec, old_count=old_count, new_count=2)
                if f.severity == "error"]
            assert got == want and got

    def test_sharded_leaf_indices_match_jax(self):
        """The same flat-leaf keys are row-sharded: the opt state's three
        flat buffers, never a leaf that only coincides in length."""
        from apex_tpu.resilience._elastic_host import (
            build_world as jbuild,
        )

        for world in (1, 2, 4):
            p, _, o, s = jbuild(world)
            jst = jstate.capture(0, p, o.init(p), scaler=s.init_state(),
                                 rng=jax.random.PRNGKey(42))
            jflat = jstate.flat_leaves(jstate.device_part(jst))
            tst = fresh_state(world)
            tflat = flat_leaves(device_part(tst))
            total = tst.opt_state.spec.total
            assert total == o.init(p).spec.total
            n_p = len(tree_leaves(tst.params))
            cand = {f"{i:05d}" for i in range(
                n_p, n_p + len(tree_leaves(tst.opt_state)))}
            got = sharded_leaf_indices(tflat, total, candidates=cand)
            want = jel.sharded_leaf_indices(jflat, total, candidates=cand)
            assert got == want and len(got) == 3
            assert sorted(tflat) == sorted(jflat)


# ---------------------------------------------------------------------------
# the two-phase commit
# ---------------------------------------------------------------------------


def _save_world(root, state, world, rec=None, barrier_timeout_s=30.0):
    """All-hosts save through W in-process manager instances (hosts > 0
    async — they wait for host 0's COMMIT in the background)."""
    mgrs = [ElasticCheckpointManager(root, host=h, world=world, sink=rec,
                                     barrier_timeout_s=barrier_timeout_s)
            for h in range(world)]
    for m in mgrs[1:]:
        m.save(state, blocking=False)
    mgrs[0].save(state, blocking=True)
    for m in mgrs[1:]:
        m.wait_until_finished()
    return mgrs


def _bits_equal(a, b):
    assert a.dtype == b.dtype and a.shape == b.shape
    assert torch.equal(a.reshape(-1).view(torch.uint8),
                       b.reshape(-1).view(torch.uint8))


class TestTwoPhaseCommit:
    def test_commit_layout_and_marker(self, tmp_path):
        root = str(tmp_path / "ckpt")
        mgrs = _save_world(root, fresh_state(2, step=3, position=3), 2)
        d = tmp_path / "ckpt" / "step_00000003"
        assert sorted(os.listdir(d)) == ["COMMIT", "shard-0.part",
                                         "shard-1.part"]
        commit = json.loads((d / "COMMIT").read_text())
        # the JAX marker's fields, format named for this package
        assert sorted(commit) == sorted(
            ["step", "world", "hosts", "spec", "emergency", "pid",
             "format", "t_wall"])
        assert commit["world"] == 2 and commit["step"] == 3
        assert commit["hosts"] == [0, 1] and commit["emergency"] is False
        assert commit["spec"]["total"] == fresh_state(2).opt_state.spec.total
        assert mgrs[0].all_steps() == [3]
        meta1 = json.loads((d / "shard-1.part" / "meta.json").read_text())
        assert meta1["host"] == 1 and meta1["pid"] == os.getpid()
        assert "data" not in meta1  # replicated host state rides shard 0
        meta0 = json.loads((d / "shard-0.part" / "meta.json").read_text())
        assert meta0["data"] == {"position": 3}
        assert meta0["sharded"] == meta1["sharded"] and meta0["sharded"]

    def test_markerless_step_is_garbage_fallback(self, tmp_path):
        """Restore over a partially committed step (a shard present, no
        COMMIT) skips back to the prior good step, emits one
        ``checkpoint_fallback`` and raises nothing. The reference's test
        passes and fails from run to run on the reference (it failed in
        a full run of the suite and passed alone); the port holds the
        promise the JAX module documents: a markerless step is garbage by
        protocol, never loaded."""
        root = str(tmp_path / "ckpt")
        rec = RingBufferRecorder()
        _save_world(root, fresh_state(2, step=4, position=4), 2, rec=rec)
        torn = tmp_path / "ckpt" / "step_00000006" / "shard-0.part"
        torn.mkdir(parents=True)
        (torn / "meta.json").write_text(json.dumps(
            {"step": 6, "host": 0, "world": 2, "pid": os.getpid()}))
        m = ElasticCheckpointManager(root, host=0, world=2, sink=rec)
        restored = m.restore(fresh_state(2))
        assert restored is not None and restored.step == 4
        falls = rec.events("checkpoint_fallback")
        assert [r["step"] for r in falls] == [6]
        assert "uncommitted" in falls[0]["error"]

    def test_no_commit_without_all_shards(self, tmp_path):
        root = str(tmp_path / "ckpt")
        rec = RingBufferRecorder()
        m0 = ElasticCheckpointManager(root, host=0, world=2, sink=rec,
                                      barrier_timeout_s=0.5)
        with pytest.raises(BarrierNotReady):
            m0.save(fresh_state(2, step=3), blocking=True)
        d = tmp_path / "ckpt" / "step_00000003"
        assert not (d / COMMIT_MARKER).exists()
        assert m0.all_steps() == []
        assert rec.events("checkpoint_failed")
        assert rec.events("retry_deadline")
        assert m0.restore(fresh_state(2)) is None

    def test_emergency_flush_commits_alone_and_restores(self, tmp_path):
        root = str(tmp_path / "ckpt")
        rec = RingBufferRecorder()
        _, state = reference_records(2, 3)  # non-trivial moments
        m1 = ElasticCheckpointManager(root, host=1, world=2, sink=rec,
                                      barrier_timeout_s=5.0)
        m1.save(state, emergency=True)  # NO peers ever show up
        assert m1.all_steps() == [3]
        commit = json.loads(
            (tmp_path / "ckpt" / "step_00000003" / "COMMIT").read_text())
        assert commit["world"] == 1 and commit["emergency"] is True
        m0 = ElasticCheckpointManager(root, host=0, world=2, sink=rec)
        restored = m0.restore(fresh_state(2))
        assert restored.step == 3 and restored.data == {"position": 3}
        for a, b in zip(tree_leaves(restored.opt_state),
                        tree_leaves(state.opt_state)):
            _bits_equal(a, b)
        assert m0._is_emergency(str(tmp_path / "ckpt" / "step_00000003"))

    def test_barrier_rejects_stale_shard_from_other_world(self, tmp_path):
        root = str(tmp_path / "ckpt")
        stale = tmp_path / "ckpt" / "step_00000003" / "shard-1.part"
        stale.mkdir(parents=True)
        (stale / "meta.json").write_text(json.dumps(
            {"step": 3, "host": 1, "world": 4, "pid": 1}))
        m0 = ElasticCheckpointManager(root, host=0, world=2,
                                      barrier_timeout_s=0.5)
        with pytest.raises(BarrierNotReady):
            m0.save(fresh_state(2, step=3), blocking=True)
        assert not (tmp_path / "ckpt" / "step_00000003" /
                    COMMIT_MARKER).exists()


class TestElasticReshard:
    def test_restore_onto_other_worlds_bitwise(self, tmp_path):
        root = str(tmp_path / "ckpt")
        rec = RingBufferRecorder()
        _, head = reference_records(2, 3)
        _save_world(root, head, 2, rec=rec)
        s2 = head.opt_state.spec
        for new_world in (1, 3, 4):
            m = ElasticCheckpointManager(root, host=0, world=new_world,
                                         sink=rec)
            restored = m.restore(fresh_state(new_world))
            assert restored.step == 3
            assert restored.data == {"position": 3}
            sN = restored.opt_state.spec
            assert layout_findings(sN, shard_count=new_world) == []
            for name in ("exp_avg", "exp_avg_sq", "master_params"):
                a = s2.unpack(getattr(head.opt_state, name), cast=False)
                b = sN.unpack(getattr(restored.opt_state, name),
                              cast=False)
                for la, lb in zip(tree_leaves(a), tree_leaves(b)):
                    _bits_equal(la, lb)
            _bits_equal(restored.opt_state.step, head.opt_state.step)
            _bits_equal(restored.rng, head.rng)
            for la, lb in zip(tree_leaves(restored.params),
                              tree_leaves(head.params)):
                _bits_equal(la, lb)
        reshards = rec.events("checkpoint_reshard")
        assert [(r["saved_world"], r["world"]) for r in reshards] == [
            (2, 1), (2, 3), (2, 4)]

    def test_resumed_records_bit_identical_to_uninterrupted(self, tmp_path):
        """W=4 head + W'=2 tail == uninterrupted W'=2 run, byte for byte
        (f32 hex records). The reference's test fails on the reference
        (``File exists`` on a shard's orbax staging directory when the
        four managers of one process save at once); the port holds the
        promise the JAX module documents: the resumed run is
        bit-identical to an uninterrupted W' run from the same step."""
        root = str(tmp_path / "ckpt")
        head_records, head = reference_records(4, 3)
        _save_world(root, head, 4)
        m = ElasticCheckpointManager(root, host=0, world=2)
        restored = m.restore(fresh_state(2))
        tail_records, _ = reference_records(2, 6, start_state=restored)
        ref_records, _ = reference_records(2, 6)
        assert {**head_records, **tail_records} == ref_records


# ---------------------------------------------------------------------------
# fsync durability of the rename commit
# ---------------------------------------------------------------------------


class TestFsyncDurability:
    def test_commit_fsyncs_staged_tree_and_parent(self, tmp_path,
                                                  monkeypatch):
        from apex_tpu_torch.resilience import manager as mgr_mod

        trees, dirs = [], []
        real_tree, real_dir = mgr_mod.fsync_tree, mgr_mod.fsync_dir
        monkeypatch.setattr(mgr_mod, "fsync_tree",
                            lambda p: (trees.append(p), real_tree(p))[1])
        monkeypatch.setattr(mgr_mod, "fsync_dir",
                            lambda p: (dirs.append(p), real_dir(p))[1])
        fsyncs = []
        real_fsync = os.fsync
        monkeypatch.setattr(os, "fsync",
                            lambda fd: (fsyncs.append(fd),
                                        real_fsync(fd))[1])
        m = CheckpointManager(str(tmp_path / "ckpt"), async_save=False)
        m.save(capture(2, {"w": torch.arange(4.0)}, None), blocking=True)
        assert any(".tmp-" in p for p in trees)
        assert m.root in dirs
        assert fsyncs

    def test_elastic_commit_fsyncs_marker_and_dirs(self, tmp_path,
                                                   monkeypatch):
        dirs = []
        real_dir = tel_mod.fsync_dir
        monkeypatch.setattr(tel_mod, "fsync_dir",
                            lambda p: (dirs.append(p), real_dir(p))[1])
        root = str(tmp_path / "ckpt")
        m = ElasticCheckpointManager(root, host=0, world=1)
        m.save(fresh_state(1, step=2, position=2), blocking=True)
        step_dir = os.path.join(m.root, "step_00000002")
        assert dirs.count(step_dir) >= 2 and m.root in dirs

    def test_injected_fsync_fault_fails_clean(self, tmp_path, monkeypatch):
        from apex_tpu_torch.resilience import manager as mgr_mod

        m = CheckpointManager(str(tmp_path / "ckpt"), async_save=False)
        template = capture(0, {"w": torch.arange(4.0)}, None)
        m.save(capture(2, {"w": torch.full((4,), 2.0)}, None),
               blocking=True)

        def flaky(p):
            raise ChaosError("injected fsync fault")

        monkeypatch.setattr(mgr_mod, "fsync_tree", flaky)
        with pytest.raises(ChaosError):
            m.save(capture(4, {"w": torch.full((4,), 4.0)}, None),
                   blocking=True)
        monkeypatch.undo()
        assert [n for n in os.listdir(m.root) if ".tmp-" in n] == []
        restored = m.restore(template)
        assert restored.step == 2
        assert float(restored.params["w"][0]) == 2.0


# ---------------------------------------------------------------------------
# the multi-writer-safe stale-tmp sweep
# ---------------------------------------------------------------------------


@pytest.fixture
def live_foreign_pid():
    """A real live process that is NOT us — the concurrent fake host
    whose in-flight save a sweep must never delete."""
    proc = subprocess.Popen([sys.executable, "-c",
                             "import time; time.sleep(60)"])
    yield proc.pid
    proc.kill()
    proc.wait(timeout=10)


def _dead_pid():
    proc = subprocess.Popen([sys.executable, "-c", "pass"])
    proc.wait(timeout=30)
    return proc.pid


class TestMultiWriterSweep:
    def test_base_sweep_spares_live_writer(self, tmp_path,
                                           live_foreign_pid):
        root = tmp_path / "ckpt"
        live = root / f"step_00000006.tmp-{live_foreign_pid}"
        dead = root / f"step_00000008.tmp-{_dead_pid()}"
        for d in (live, dead):
            d.mkdir(parents=True)
            (d / "sentinel").write_text("x")
        CheckpointManager(str(root))
        assert live.exists(), \
            "sweep deleted a LIVE concurrent writer's in-flight save"
        assert not dead.exists()

    def test_elastic_sweep_spares_live_shard_writer(self, tmp_path,
                                                    live_foreign_pid):
        root = tmp_path / "ckpt"
        step = root / "step_00000004"
        live_tmp = step / f"shard-1.tmp-{live_foreign_pid}"
        dead_tmp = step / f"shard-2.tmp-{_dead_pid()}"
        for d in (live_tmp, dead_tmp):
            d.mkdir(parents=True)
        ElasticCheckpointManager(str(root), host=0, world=2)
        assert live_tmp.exists()
        assert not dead_tmp.exists()

    def test_elastic_sweep_markerless_garbage_rules(self, tmp_path,
                                                    live_foreign_pid):
        root = str(tmp_path / "ckpt")
        _save_world(root, fresh_state(2, step=6, position=6), 2)

        def seed_partial(step, pid):
            d = tmp_path / "ckpt" / f"step_{step:08d}" / "shard-0.part"
            d.mkdir(parents=True)
            (d / "meta.json").write_text(json.dumps(
                {"step": step, "host": 0, "world": 2, "pid": pid}))
            return d.parent

        older_dead = seed_partial(2, _dead_pid())
        older_live = seed_partial(4, live_foreign_pid)
        newer_dead = seed_partial(8, _dead_pid())
        older_live_tmp = (tmp_path / "ckpt" / "step_00000003"
                          / f"shard-1.tmp-{live_foreign_pid}")
        older_live_tmp.mkdir(parents=True)
        ElasticCheckpointManager(root, host=1, world=2)
        assert not older_dead.exists()
        assert older_live.exists()
        assert older_live_tmp.exists()
        assert newer_dead.exists()
