"""Data-parallel gradient synchronisation across ranks: the port's
``parallel.distributed`` in a gloo world of 4 against the JAX package's
under ``jax.shard_map`` over 4 of the 8 CPU devices of
``tests/conftest.py``.

One gloo world of 4 CPU processes is spawned once for the file
(rendezvous over a ``FileStore`` in a temporary directory, a join
timeout of 180 s). Every rank reads the same numpy-seeded inputs, takes
its own rank's slice, runs every case and writes its results; the JAX
side runs the same cases on the same slices, one per device, under
``shard_map`` with ``check_vma=False`` (a replicated operand's gradient
is then per device, as a rank's is; the JAX package's own
``tests/test_grad_lifecycle.py`` runs the same way).

Cases: ``sync_gradients`` (mean, sum, fp32 reduction, pre-division by 2
and 4, ``keep_fp32``), ``sync_gradients_bucketed`` (one all-reduce a
bucket, counted on every rank; ``match_leaf_dtype``; ``concat=False``),
``DistributedDataParallel.wrap_grad_fn`` (``has_value``, ``flat``),
``broadcast_params`` from rank 2, ``Reducer`` and the fused flat
lifecycle through ``step_flat`` (3 steps, raw bucket sums, the average
and the unscale deferred into the kernel's ``grad_scale``).

Tolerances: gradients drawn on a dyadic grid (multiples of 1/8 up to
7/8, whose sums and halvings are exact in any order, bf16 included)
match bit for bit; random-normal gradients within ``4 * world * eps *
max|sum|`` of the leaf's dtype (gloo and XLA sum in other orders); the
flat lifecycle's fp32 master buffer within rtol 1e-6 atol 1e-7 after 3
steps (one packed Adam sweep a step on both sides).
"""
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
from jax.sharding import Mesh, PartitionSpec as P

from apex_tpu.amp import LossScaler as JLossScaler
from apex_tpu.optimizers import FusedAdam as JFusedAdam
from apex_tpu.parallel import (
    DistributedDataParallel as JDDP,
    GradBuckets as JGradBuckets,
    Reducer as JReducer,
    sync_gradients as jsync,
    sync_gradients_bucketed as jsync_bucketed,
)

REPO = Path(__file__).resolve().parents[1]
WORLD = 4
JOIN_TIMEOUT_S = 180
CHUNK = 2048
#: leaf name -> (shape, dtype) of the gradient tree
LEAVES = {"b": ((40,), "float32"), "h": ((7, 33), "bfloat16"),
          "w": ((96, 40), "float32"), "z": ((2100,), "float32")}
BUCKET_MB = 0.01
#: (name, sync_gradients keywords)
SYNC_CASES = (
    ("mean", {}),
    ("sum", {"gradient_average": False}),
    ("fp32", {"allreduce_always_fp32": True}),
    ("fp32_keep", {"allreduce_always_fp32": True, "keep_fp32": True}),
    ("predivide2", {"gradient_predivide_factor": 2.0}),
    ("predivide4_sum", {"gradient_predivide_factor": 4.0,
                        "gradient_average": False}),
)
BUCKET_CASES = (
    ("bucketed", {}),
    ("bucketed_fp32", {"allreduce_always_fp32": True}),
    ("bucketed_fp32_match", {"allreduce_always_fp32": True,
                             "match_leaf_dtype": True}),
    ("bucketed_predivide2", {"gradient_predivide_factor": 2.0}),
)
KINDS = ("dyadic", "normal")
LIFECYCLE_STEPS = 3


def _inputs():
    """Per-rank inputs, stacked ``[WORLD, ...]``: two gradient trees (a
    dyadic grid and random normals), per-rank params for the broadcast,
    and the lifecycle's data."""
    rng = np.random.default_rng(2024)
    out = {}
    for name, (shape, _) in LEAVES.items():
        out[f"dyadic/{name}"] = (rng.integers(-7, 8, size=(WORLD, *shape))
                                 / 8.0).astype(np.float32)
        out[f"normal/{name}"] = rng.normal(size=(WORLD, *shape)).astype(
            np.float32)
        out[f"params/{name}"] = rng.normal(size=(WORLD, *shape)).astype(
            np.float32)
    out["x"] = rng.normal(size=(WORLD, 8, 96)).astype(np.float32)
    out["life_w"] = (rng.normal(size=(96, 40)) * 0.1).astype(np.float32)
    out["life_b"] = np.zeros(40, np.float32)
    out["life_x"] = rng.normal(size=(LIFECYCLE_STEPS, WORLD, 8, 96)).astype(
        np.float32)
    return out


_WORKER = r"""
import json, sys
import numpy as np
import torch
import torch.distributed as dist

torch.set_num_threads(1)
rank, world, store, out, inputs = (int(sys.argv[1]), int(sys.argv[2]),
                                   sys.argv[3], sys.argv[4], sys.argv[5])
spec = json.loads(sys.argv[6])
dist.init_process_group("gloo", init_method="file://" + store,
                        world_size=world, rank=rank)
from apex_tpu_torch._tree import value_and_grad
from apex_tpu_torch.amp import LossScaler
from apex_tpu_torch.optimizers import FusedAdam
from apex_tpu_torch.parallel import (DistributedDataParallel, GradBuckets,
                                     Reducer, sync_gradients,
                                     sync_gradients_bucketed)

arr = dict(np.load(inputs))
leaves, chunk, cap = spec["leaves"], spec["chunk"], spec["bucket_mb"]
calls = []
real = dist.all_reduce
def counted(*a, **k):
    calls.append(1)
    return real(*a, **k)
dist.all_reduce = counted

def tree(kind):
    return {n: torch.from_numpy(arr[kind + "/" + n][rank]).to(
        getattr(torch, dt)) for n, (_, dt) in leaves.items()}

def np32(t):
    return t.detach().float().numpy()

res = {}
for kind in ("dyadic", "normal"):
    g = tree(kind)
    before = {k: v.clone() for k, v in g.items()}
    for name, kw in spec["sync"]:
        out_t = sync_gradients(g, "data", **kw)
        for n, v in out_t.items():
            res[f"{kind}/{name}/{n}"] = np32(v)
            res[f"{kind}/{name}/{n}/dtype"] = np.array(str(v.dtype))
    assert all(torch.equal(before[k], g[k]) for k in g)  # inputs kept
    buckets = GradBuckets(g, bucket_cap_mb=cap, chunk_size=chunk)
    res["n_buckets"] = np.array(buckets.n_buckets)
    for name, kw in spec["bucketed"]:
        b = buckets
        if kw.get("allreduce_always_fp32"):
            b = GradBuckets(g, bucket_cap_mb=cap, chunk_size=chunk,
                            reduce_dtype=torch.float32)
        n0 = len(calls)
        flat, _ = sync_gradients_bucketed(g, "data", buckets=b, **kw)
        res[f"{kind}/{name}/allreduces"] = np.array(len(calls) - n0)
        res[f"{kind}/{name}/flat"] = np32(flat)
        res[f"{kind}/{name}/dtype"] = np.array(str(flat.dtype))
        bufs, _ = sync_gradients_bucketed(g, "data", buckets=b,
                                          concat=False, **kw)
        assert torch.equal(torch.cat(bufs.buffers), flat)
        res[f"{kind}/{name}/n_bufs"] = np.array(len(bufs.buffers))
    red = Reducer("data").reduce(g)
    for n, v in red.items():
        res[f"{kind}/reducer/{n}"] = np32(v)

# wrap_grad_fn over a regression loss on this rank's batch
x = torch.from_numpy(arr["x"][rank])
params = {"w": torch.from_numpy(arr["life_w"]),
          "b": torch.from_numpy(arr["life_b"])}
def loss_fn(p):
    return ((x @ p["w"] + p["b"]) ** 2).mean()
ddp = DistributedDataParallel("data")
v, gr = ddp.wrap_grad_fn(lambda p: value_and_grad(loss_fn, p),
                         has_value=True)(params)
res["wrap/value"] = np.array(float(v))
for n, t in gr.items():
    res["wrap/" + n] = np32(t)
wb = GradBuckets(params, bucket_cap_mb=cap, chunk_size=chunk)
bddp = DistributedDataParallel("data", bucket_cap_mb=cap)
n0 = len(calls)
flat = bddp.wrap_grad_fn(lambda p: value_and_grad(loss_fn, p)[1],
                         flat=True, buckets=wb)(params)
res["wrap_flat/allreduces"] = np.array(len(calls) - n0)
res["wrap_flat/flat"] = np32(flat)
bc = ddp.broadcast_params(tree("params"), src_index=2)
for n, t in bc.items():
    res["bcast/" + n] = np32(t)

# the fused flat lifecycle: raw bucket sums, found_inf_flat, step_flat
lbuckets = GradBuckets(params, bucket_cap_mb=cap, chunk_size=chunk,
                       reduce_dtype=torch.float32)
opt = FusedAdam(lr=1e-2, master_weights=True, packed=True,
                packed_spec=lbuckets.spec)
fddp = DistributedDataParallel("data", allreduce_always_fp32=True,
                               gradient_average=False, bucket_cap_mb=cap)
scaler = LossScaler("dynamic", init_scale=2.0 ** 4)
ss, ostate = scaler.init_state("cpu"), opt.init(params)
losses = []
for s in range(spec["steps"]):
    xs = torch.from_numpy(arr["life_x"][s, rank])
    p = lbuckets.unpack(ostate.master_params)
    loss, grads = value_and_grad(
        lambda q: scaler.scale_loss(ss, ((xs @ q["w"] + q["b"]) ** 2
                                         ).mean()), p)
    bufs, _ = fddp.reduce_flat(grads, buckets=lbuckets, concat=False)
    ss = scaler.found_inf_flat(ss, bufs)
    ostate = opt.step_flat(bufs, ostate, found_inf=ss.found_inf,
                           grad_scale=ss.loss_scale * world)
    ss = scaler.update_scale(ss)
    losses.append(float(loss))
res["life/master"] = np32(ostate.master_params)
res["life/losses"] = np.array(losses)
dist.destroy_process_group()
np.savez(f"{out}/rank{rank}.npz", **res)
"""


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """Each rank's results, from one spawned gloo world of 4."""
    tmp = tmp_path_factory.mktemp("gloo_ddp")
    inputs = tmp / "inputs.npz"
    np.savez(inputs, **_inputs())
    spec = json.dumps({"leaves": LEAVES, "chunk": CHUNK,
                       "bucket_mb": BUCKET_MB,
                       "sync": [list(c) for c in SYNC_CASES],
                       "bucketed": [list(c) for c in BUCKET_CASES],
                       "steps": LIFECYCLE_STEPS})
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    env.pop("XLA_FLAGS", None)
    procs = [subprocess.Popen(
        [sys.executable, "-c", _WORKER, str(r), str(WORLD),
         str(tmp / "store"), str(tmp), str(inputs), spec],
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
    return [dict(np.load(tmp / f"rank{r}.npz")) for r in range(WORLD)]


def _mesh():
    return Mesh(np.array(jax.devices()[:WORLD]), ("data",))


def _per_device(fn, *stacked):
    """``fn(*per-device slices)`` under ``shard_map`` over 4 devices (each
    input ``[WORLD, ...]`` sharded on its first axis); returns the outputs
    stacked ``[WORLD, ...]`` (numpy, a tree as ``fn`` returns it)."""
    def body(*xs):
        out = fn(*(x[0] for x in xs))
        return jax.tree_util.tree_map(lambda o: o[None], out)
    spec = P("data")
    out = jax.jit(jax.shard_map(body, mesh=_mesh(), in_specs=spec,
                                out_specs=spec, check_vma=False))(
        *(jnp.asarray(x) for x in stacked))
    return jax.tree_util.tree_map(np.asarray, out)


def _jtree(arr, kind):
    return {n: jnp.asarray(arr[f"{kind}/{n}"]).astype(dt)
            for n, (_, dt) in LEAVES.items()}


def _stacked_tree(arr, kind):
    return {n: arr[f"{kind}/{n}"] for n in LEAVES}


def _check(got, want, dtype, kind):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    if kind == "dyadic":
        np.testing.assert_array_equal(got, want)
    else:
        eps = float(jnp.finfo(dtype).eps)
        tol = 4 * WORLD * eps * max(float(np.abs(want).max()), 1e-30)
        np.testing.assert_allclose(got, want, rtol=0, atol=tol)


ARR = _inputs()


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("case", [c[0] for c in SYNC_CASES])
def test_sync_gradients_equals_the_jax_psum(world, case, kind):
    kw = dict(SYNC_CASES)[case]

    def fn(*leaves):
        t = dict(zip(LEAVES, (l.astype(dt) for l, (_, dt) in
                              zip(leaves, LEAVES.values()))))
        out = jsync(t, "data", **kw)
        return [out[n].astype(jnp.float32) for n in LEAVES], \
            [jnp.zeros((), out[n].dtype) for n in LEAVES]

    stacked = [ARR[f"{kind}/{n}"] for n in LEAVES]
    want, dtypes = _per_device(fn, *stacked)
    for i, (n, (_, dt)) in enumerate(LEAVES.items()):
        for r in range(WORLD):
            got = world[r][f"{kind}/{case}/{n}"]
            out_dt = jnp.asarray(dtypes[i]).dtype
            assert str(world[r][f"{kind}/{case}/{n}/dtype"]) == \
                "torch." + str(out_dt), (n, out_dt)
            _check(got, want[i][r], out_dt, kind)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("case", [c[0] for c in BUCKET_CASES])
def test_sync_gradients_bucketed_equals_jax(world, case, kind):
    kw = dict(BUCKET_CASES)[case]
    template = _jtree(ARR, kind)
    template = jax.tree_util.tree_map(lambda a: a[0], template)
    jb = JGradBuckets(template, bucket_cap_mb=BUCKET_MB, chunk_size=CHUNK,
                      reduce_dtype=jnp.float32
                      if kw.get("allreduce_always_fp32") else None)

    def fn(*leaves):
        t = dict(zip(LEAVES, (l.astype(dt) for l, (_, dt) in
                              zip(leaves, LEAVES.values()))))
        flat, _ = jsync_bucketed(t, "data", buckets=jb, **kw)
        return flat.astype(jnp.float32), jnp.zeros((), flat.dtype)

    want, dt = _per_device(fn, *[ARR[f"{kind}/{n}"] for n in LEAVES])
    out_dt = jnp.asarray(dt).dtype
    for r in range(WORLD):
        res = world[r]
        assert int(res[f"{kind}/{case}/allreduces"]) == jb.n_buckets
        assert int(res[f"{kind}/{case}/n_bufs"]) == jb.n_buckets
        assert str(res[f"{kind}/{case}/dtype"]) == "torch." + str(out_dt)
        _check(res[f"{kind}/{case}/flat"], want[r], out_dt, kind)
    assert jb.n_buckets >= 2


@pytest.mark.parametrize("kind", KINDS)
def test_reducer_equals_the_jax_pmean(world, kind):
    def fn(*leaves):
        t = dict(zip(LEAVES, (l.astype(dt) for l, (_, dt) in
                              zip(leaves, LEAVES.values()))))
        out = JReducer("data").reduce(t)
        return [out[n].astype(jnp.float32) for n in LEAVES]

    want = _per_device(fn, *[ARR[f"{kind}/{n}"] for n in LEAVES])
    for i, (n, (_, dt)) in enumerate(LEAVES.items()):
        for r in range(WORLD):
            _check(world[r][f"{kind}/reducer/{n}"], want[i][r],
                   jnp.dtype(dt), kind)


def _loss(p, x):
    return jnp.mean((x @ p["w"] + p["b"]) ** 2)


def test_wrap_grad_fn_equals_jax(world):
    params = {"w": jnp.asarray(ARR["life_w"]), "b": jnp.asarray(
        ARR["life_b"])}
    ddp = JDDP("data")

    def fn(x):
        v, g = ddp.wrap_grad_fn(jax.value_and_grad(_loss),
                                has_value=True)(params, x)
        return v, g["w"], g["b"]

    v, gw, gb = _per_device(fn, ARR["x"])
    jb = JGradBuckets(params, bucket_cap_mb=BUCKET_MB, chunk_size=CHUNK)
    bddp = JDDP("data", bucket_cap_mb=BUCKET_MB)
    flat = _per_device(lambda x: bddp.wrap_grad_fn(
        jax.grad(_loss), flat=True, buckets=jb)(params, x), ARR["x"])
    for r in range(WORLD):
        res = world[r]
        np.testing.assert_allclose(float(res["wrap/value"]), float(v[r]),
                                   rtol=1e-6)
        for got, want in ((res["wrap/w"], gw[r]), (res["wrap/b"], gb[r])):
            _check(got, want, jnp.float32, "normal")
        assert int(res["wrap_flat/allreduces"]) == jb.n_buckets
        _check(res["wrap_flat/flat"], flat[r], jnp.float32, "normal")


def test_broadcast_params_from_rank_2(world):
    def fn(*leaves):
        t = dict(zip(LEAVES, (l.astype(dt) for l, (_, dt) in
                              zip(leaves, LEAVES.values()))))
        out = JDDP("data").broadcast_params(t, src_index=2)
        return [out[n].astype(jnp.float32) for n in LEAVES]

    want = _per_device(fn, *[ARR[f"params/{n}"] for n in LEAVES])
    for i, (n, (_, dt)) in enumerate(LEAVES.items()):
        src = ARR[f"params/{n}"][2].astype(jnp.dtype(dt)).astype(np.float32)
        for r in range(WORLD):
            np.testing.assert_array_equal(world[r][f"bcast/{n}"], want[i][r])
            np.testing.assert_array_equal(world[r][f"bcast/{n}"], src)


def test_flat_lifecycle_through_step_flat_equals_jax(world):
    params = {"w": jnp.asarray(ARR["life_w"]), "b": jnp.asarray(
        ARR["life_b"])}
    jb = JGradBuckets(params, bucket_cap_mb=BUCKET_MB, chunk_size=CHUNK,
                      reduce_dtype=jnp.float32)
    opt = JFusedAdam(lr=1e-2, master_weights=True, packed=True,
                     packed_spec=jb.spec)
    ddp = JDDP("data", allreduce_always_fp32=True, gradient_average=False,
               bucket_cap_mb=BUCKET_MB)
    scaler = JLossScaler("dynamic", init_scale=2.0 ** 4)

    def run(xs):
        ss, ostate = scaler.init_state(), opt.init(params)
        losses = []
        for s in range(LIFECYCLE_STEPS):
            p = jb.unpack(ostate.master_params)
            loss, grads = jax.value_and_grad(
                lambda q: scaler.scale_loss(ss, _loss(q, xs[s])))(p)
            bufs, _ = ddp.reduce_flat(grads, buckets=jb, concat=False)
            ss = scaler.found_inf_flat(ss, bufs)
            ostate = opt.step_flat(bufs, ostate, found_inf=ss.found_inf,
                                   grad_scale=ss.loss_scale * WORLD)
            ss = scaler.update_scale(ss)
            losses.append(loss)
        return ostate.master_params, jnp.stack(losses)

    master, losses = _per_device(
        run, np.moveaxis(ARR["life_x"], 1, 0))
    for r in range(WORLD):
        np.testing.assert_allclose(world[r]["life/master"], master[r],
                                   rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(world[r]["life/losses"], losses[r],
                                   rtol=1e-6)
    # every rank holds the same master buffer
    for r in range(1, WORLD):
        np.testing.assert_array_equal(world[r]["life/master"],
                                      world[0]["life/master"])
