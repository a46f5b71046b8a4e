"""``parallel_state`` over ``torch.distributed``, the fp8 amax reduction
and the model-parallel ``GradScaler`` against the JAX package's mesh.

One gloo world of 8 CPU processes is spawned once for the whole file
(rendezvous over a ``FileStore`` in a temporary directory, no TCP port;
a join timeout of 120 s, so a hang fails these tests instead of the
suite's clock). In it every rank lays out six (tp, pp) layouts, with
split ranks and virtual pipelines, and records what it sees. The JAX
package's ``initialize_model_parallel`` over the 8 CPU devices of
``tests/conftest.py`` gives the expected values: the coordinates of
each device id in ``mesh.devices``, every group's members, and the JAX
getters evaluated per device inside ``shard_map``.

- Every getter and the members of the group of every set of axes equal
  the JAX mesh's on every rank.
- ``reduce_amax`` equals the JAX ``pmax`` over the same axes (the max
  over the group's ranks and only those); at (tp, pp) = (2, 2) it gives
  the JAX test's ``[3.0, 4.0]`` (``tests/test_fp8.py``).
- ``GradScaler``: an inf planted on rank 5 skips the step, and halves
  the scale, on exactly the ranks of its model-parallel group, as the
  JAX ``GradScaler`` does under ``shard_map`` on the same layout.
- fp8 ``fp8_fused_dense`` and ``record_grad_amax`` with the amax group
  of two tensor ranks: both ranks derive one scale, the JAX
  ``shard_map`` result on 2 devices.
- ``RankInfoFormatter`` prints ``[r/8]``.

All comparisons are exact: ranks, members and maxima are integers or
fp32 values that no arithmetic separates.
"""
import itertools
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import PartitionSpec as P

from apex_tpu.fused_dense import fp8 as jfp8
from apex_tpu.transformer import parallel_state as jps
from apex_tpu.transformer.amp import GradScaler as JGradScaler

REPO = Path(__file__).resolve().parents[1]
WORLD = 8
JOIN_TIMEOUT_S = 120
#: (tp, pp, virtual pp, split rank)
LAYOUTS = ((1, 1, None, None), (2, 1, None, None), (2, 2, None, 1),
           (2, 4, 2, 2), (8, 1, None, None), (1, 8, 4, 4))
AXES = ("pipeline", "data", "tensor")
AXIS_SETS = [s for n in (1, 2, 3) for s in itertools.combinations(AXES, n)]
REDUCE_SETS = [("data", "tensor"), ("tensor",), ("pipeline",),
               ("pipeline", "data", "tensor")]
POISONED = 5
FP8_LAYOUT = (2, 4)

_WORKER = r"""
import itertools, json, logging, sys
import numpy as np
import torch
import torch.distributed as dist

torch.set_num_threads(1)
rank, world, store, out = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
layouts = json.loads(sys.argv[5])
dist.init_process_group("gloo", init_method="file://" + store,
                        world_size=world, rank=rank)
import apex_tpu_torch
from apex_tpu_torch.fused_dense import fp8
from apex_tpu_torch.transformer import parallel_state as ps
from apex_tpu_torch.transformer.amp import GradScaler

AXES = ("pipeline", "data", "tensor")
sets = [s for n in (1, 2, 3) for s in itertools.combinations(AXES, n)]
reduce_sets = [("data", "tensor"), ("tensor",), ("pipeline",), AXES]
res = {"layouts": []}
for tp, pp, vpp, split in layouts:
    mesh = ps.initialize_model_parallel(tp, pp, vpp, split, use_fp8_=True)
    r = {"devices": mesh.devices.tolist()}
    r["ranks"] = [ps.get_pipeline_model_parallel_rank(),
                  ps.get_data_parallel_rank(),
                  ps.get_tensor_model_parallel_rank()]
    r["sizes"] = [ps.get_pipeline_model_parallel_world_size(),
                  ps.get_data_parallel_world_size(),
                  ps.get_tensor_model_parallel_world_size()]
    r["groups"] = {",".join(s): list(ps.get_group_ranks(s)) for s in sets}
    r["src"] = ps.get_tensor_model_parallel_src_rank()
    r["getters"] = [int(v) for v in (
        ps.get_tensor_model_parallel_rank(),
        ps.get_pipeline_model_parallel_rank(),
        ps.get_data_parallel_rank(),
        ps.is_pipeline_first_stage(), ps.is_pipeline_first_stage(True),
        ps.is_pipeline_last_stage(), ps.is_pipeline_last_stage(True),
        ps.is_pipeline_stage_before_split(),
        ps.is_pipeline_stage_after_split(),
        ps.get_pipeline_model_parallel_next_rank(),
        ps.get_pipeline_model_parallel_prev_rank(),
        ps.is_rank_in_embedding_group(),
        ps.is_rank_in_position_embedding_group())]
    r["at_split"] = bool(ps.is_pipeline_stage_at_split())
    r["host"] = [ps.get_virtual_pipeline_model_parallel_rank(),
                 ps.get_virtual_pipeline_model_parallel_world_size(),
                 ps.get_pipeline_model_parallel_split_rank(),
                 [ps.get_num_layers(24, rank=p) for p in range(pp)],
                 ([ps.get_num_layers(24, True, rank=p) for p in range(pp)]
                  if split is not None else None)]
    r["amax"] = {}
    for s in reduce_sets:
        a = torch.tensor([float((rank * 5) % 8) + 0.5, -float(rank)])
        got = ps.reduce_amax(a, s)
        assert got is a  # in place
        r["amax"][",".join(s)] = a.tolist()
    a = torch.tensor(abs(float(rank) - 3.0))
    r["amax_group"] = float(ps.reduce_amax(a))
    scaler = GradScaler("dynamic", init_scale=4.0)
    st = scaler.init_state("cpu")
    g = {"w": torch.ones(4) * (float("inf") if rank == POISONED else 1.0)}
    _, st = scaler.unscale(st, g)
    new = scaler.update_scale(st)
    r["scaler"] = [float(st.found_inf), float(new.loss_scale)]
    if (tp, pp) == FP8_LAYOUT:
        t = ps.get_tensor_model_parallel_rank()
        x = torch.from_numpy(np.random.default_rng(100 + t).normal(
            size=(8, 16)).astype(np.float32) * (t + 1))
        w = torch.from_numpy(np.random.default_rng(200 + t).normal(
            size=(16, 16)).astype(np.float32) * (0.5 + t))
        s0 = fp8.init_fp8_dense_state(with_grad_meta=True, device="cpu")
        _, s1 = fp8.fp8_fused_dense(x, w, None, s0,
                                    amax_reduction_axes=("data", "tensor"))
        s2 = fp8.record_grad_amax(s1, torch.tensor(3.0 * t + 1.0),
                                  amax_reduction_axes=("data", "tensor"))
        r["fp8"] = [float(s1.x.scale), float(s1.w.scale),
                    float(s1.x.amax_history[0]), float(s1.w.amax_history[0]),
                    float(s2.g.scale), float(s2.g.amax_history[0])]
    ps.destroy_model_parallel()
    res["layouts"].append(r)
rec = logging.LogRecord("apex_tpu_torch", logging.INFO, "worker", 1, "m",
                        None, None)
res["formatter"] = apex_tpu_torch.RankInfoFormatter(
    "%(rank_info)s").format(rec)
dist.destroy_process_group()
with open(f"{out}/rank{rank}.json", "w") as f:
    json.dump(res, f)
""".replace("POISONED", str(POISONED)).replace(
    "FP8_LAYOUT", str(FP8_LAYOUT))


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """Each rank's record, from one spawned gloo world of 8."""
    tmp = tmp_path_factory.mktemp("gloo")
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    env.pop("XLA_FLAGS", None)
    layouts = json.dumps([list(l) for l in LAYOUTS])
    procs = [subprocess.Popen(
        [sys.executable, "-c", _WORKER, str(r), str(WORLD),
         str(tmp / "store"), str(tmp), layouts],
        env=env, cwd=str(tmp), stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for r in range(WORLD)]
    deadline = time.monotonic() + JOIN_TIMEOUT_S
    errors = []
    try:
        for r, p in enumerate(procs):
            try:
                _, err = p.communicate(
                    timeout=max(1.0, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                errors.append(f"rank {r}: no exit within {JOIN_TIMEOUT_S} s")
                continue
            if p.returncode:
                errors.append(f"rank {r} exited {p.returncode}:\n"
                              f"{err[-3000:]}")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert not errors, "\n".join(errors)
    return [json.loads((tmp / f"rank{r}.json").read_text())
            for r in range(WORLD)]


def _jax_mesh(tp, pp, vpp, split):
    return jps.initialize_model_parallel(tp, pp, vpp, split, use_fp8_=True)


def _per_device(mesh, fn):
    """``fn(rank)`` (a traced int32 scalar, the device id) evaluated on
    every device inside ``shard_map``; returns ``{rank: np.ndarray}``."""
    ids = np.vectorize(lambda d: d.id)(mesh.devices).astype(np.int32)
    spec = P(*AXES)
    out = jax.jit(jax.shard_map(
        lambda r: fn(r.reshape(()))[None, None, None],
        mesh=mesh, in_specs=(spec,), out_specs=spec, check_vma=False))(
        jnp.asarray(ids))
    out = np.asarray(out)
    return {int(ids[c]): out[c] for c in np.ndindex(ids.shape)}


@pytest.mark.parametrize("li", range(len(LAYOUTS)),
                         ids=[f"tp{l[0]}-pp{l[1]}" for l in LAYOUTS])
def test_layout_groups_and_getters_equal_the_jax_mesh(world, li):
    tp, pp, vpp, split = LAYOUTS[li]
    mesh = _jax_mesh(tp, pp, vpp, split)
    try:
        ids = np.vectorize(lambda d: d.id)(mesh.devices)

        def getters(r):
            vals = [jps.get_tensor_model_parallel_rank(),
                    jps.get_pipeline_model_parallel_rank(),
                    jps.get_data_parallel_rank(),
                    jps.is_pipeline_first_stage(),
                    jps.is_pipeline_first_stage(True),
                    jps.is_pipeline_last_stage(),
                    jps.is_pipeline_last_stage(True),
                    jps.is_pipeline_stage_before_split(),
                    jps.is_pipeline_stage_after_split(),
                    jps.get_pipeline_model_parallel_next_rank(),
                    jps.get_pipeline_model_parallel_prev_rank(),
                    jps.is_rank_in_embedding_group(),
                    jps.is_rank_in_position_embedding_group()]
            return jnp.stack([jnp.asarray(v).astype(jnp.int32)
                              for v in vals])

        want_getters = _per_device(mesh, getters)
        host = [jps.get_virtual_pipeline_model_parallel_rank(),
                jps.get_virtual_pipeline_model_parallel_world_size(),
                jps.get_pipeline_model_parallel_split_rank(),
                [jps.get_num_layers(24, rank=p) for p in range(pp)],
                ([jps.get_num_layers(24, True, rank=p) for p in range(pp)]
                 if split is not None else None)]
        sizes = [jps.get_pipeline_model_parallel_world_size(),
                 jps.get_data_parallel_world_size(),
                 jps.get_tensor_model_parallel_world_size()]
        for rank in range(WORLD):
            rec = world[rank]["layouts"][li]
            assert rec["devices"] == ids.tolist()
            coords = [int(c) for c in np.argwhere(ids == rank)[0]]
            assert rec["ranks"] == coords
            assert rec["sizes"] == sizes
            for s in AXIS_SETS:
                index = tuple(slice(None) if a in s else coords[i]
                              for i, a in enumerate(AXES))
                assert rec["groups"][",".join(s)] == sorted(
                    int(x) for x in ids[index].reshape(-1)), s
            assert rec["src"] == min(rec["groups"]["tensor"])
            assert rec["getters"] == want_getters[rank].tolist(), rank
            p = coords[0]
            assert rec["at_split"] == bool(
                jps.is_pipeline_stage_before_split(p)
                and jps.is_pipeline_stage_after_split(p + 1))
            assert rec["host"] == host
    finally:
        jps.destroy_model_parallel()


@pytest.mark.parametrize("li", range(len(LAYOUTS)),
                         ids=[f"tp{l[0]}-pp{l[1]}" for l in LAYOUTS])
def test_reduce_amax_equals_the_jax_pmax(world, li):
    mesh = _jax_mesh(*LAYOUTS[li])
    try:
        for axes in REDUCE_SETS:
            def red(r, axes=axes):
                a = jnp.stack([((r * 5) % 8).astype(jnp.float32) + 0.5,
                               -r.astype(jnp.float32)])
                return jps.reduce_amax(a, axes)

            want = _per_device(mesh, red)
            for rank in range(WORLD):
                got = world[rank]["layouts"][li]["amax"][",".join(axes)]
                assert got == want[rank].tolist(), (axes, rank)

        want = _per_device(mesh, lambda r: jps.reduce_amax(
            jnp.abs(r.astype(jnp.float32) - 3.0)))
        for rank in range(WORLD):
            assert world[rank]["layouts"][li]["amax_group"] == float(
                want[rank])
    finally:
        jps.destroy_model_parallel()


def test_reduce_amax_gives_the_jax_tests_answer(world):
    """(tp, pp) = (2, 2): each pipeline stage keeps its own max of
    ``|rank - 3|`` (stage 0 holds ranks 0-3 -> 3, stage 1 -> 4)."""
    li = LAYOUTS.index((2, 2, None, 1))
    got = [world[r]["layouts"][li]["amax_group"] for r in range(WORLD)]
    assert got == [3.0] * 4 + [4.0] * 4


@pytest.mark.parametrize("li", range(len(LAYOUTS)),
                         ids=[f"tp{l[0]}-pp{l[1]}" for l in LAYOUTS])
def test_grad_scaler_skips_on_the_model_parallel_group(world, li):
    mesh = _jax_mesh(*LAYOUTS[li])
    try:
        scaler = JGradScaler("dynamic", init_scale=4.0)
        state = scaler.init_state()

        def step(r):
            g = {"w": jnp.where(r == POISONED, jnp.inf, 1.0) * jnp.ones(4)}
            _, st = scaler.unscale(state, g)
            new = scaler.update_scale(st)
            return jnp.stack([st.found_inf.astype(jnp.float32),
                              new.loss_scale])

        want = _per_device(mesh, step)
        group = set(world[POISONED]["layouts"][li]["groups"][
            "pipeline,tensor"])
        for rank in range(WORLD):
            got = world[rank]["layouts"][li]["scaler"]
            assert got == want[rank].tolist(), rank
            assert got == ([1.0, 2.0] if rank in group else [0.0, 4.0])
    finally:
        jps.destroy_model_parallel()


def test_fp8_scales_agree_across_the_amax_group(world):
    """The amax group of (tp, pp) = (2, 4) is two tensor ranks in each
    stage: both derive the scales the JAX ``shard_map`` derives on 2
    devices."""
    mesh = jps.initialize_model_parallel(2, 1, devices=jax.devices()[:2],
                                         use_fp8_=True)
    try:
        xs = np.stack([np.random.default_rng(100 + t).normal(
            size=(8, 16)).astype(np.float32) * (t + 1) for t in range(2)])
        ws = np.stack([np.random.default_rng(200 + t).normal(
            size=(16, 16)).astype(np.float32) * (0.5 + t) for t in range(2)])

        def f(x, w):
            t = jax.lax.axis_index("tensor")
            s0 = jfp8.init_fp8_dense_state(with_grad_meta=True)
            _, s1 = jfp8.fp8_fused_dense(
                x[0], w[0], None, s0, amax_reduction_axes=("data", "tensor"))
            s2 = jfp8.record_grad_amax(
                s1, 3.0 * t.astype(jnp.float32) + 1.0,
                amax_reduction_axes=("data", "tensor"))
            return jnp.stack([s1.x.scale, s1.w.scale, s1.x.amax_history[0],
                              s1.w.amax_history[0], s2.g.scale,
                              s2.g.amax_history[0]])[None]

        spec = P("tensor")
        want = np.asarray(jax.jit(jax.shard_map(
            f, mesh=mesh, in_specs=(spec, spec), out_specs=spec,
            check_vma=False))(jnp.asarray(xs), jnp.asarray(ws)))
    finally:
        jps.destroy_model_parallel()
    assert (want[0] == want[1]).all()
    li = LAYOUTS.index(next(l for l in LAYOUTS if l[:2] == FP8_LAYOUT))
    for rank in range(WORLD):
        assert world[rank]["layouts"][li]["fp8"] == want[0].tolist(), rank


def test_rank_info_formatter(world):
    assert [w["formatter"] for w in world] == [
        f"[{r}/{WORLD}]" for r in range(WORLD)]
