"""ZeRO-2 ``DistributedFusedAdam`` / ``DistributedFusedLAMB`` of the port
in a gloo world of 4 against the JAX package's under ``jax.shard_map``
over 4 of the 8 CPU devices of ``tests/conftest.py`` (the mirror of
``tests/test_distributed_optimizers.py``).

One gloo world of 4 CPU processes is spawned once for the file
(``test_torch_tensor_parallel.spawn_world``). Every rank reads the same
numpy-seeded params and batches, takes its quarter of each batch,
computes its local gradients of the toy MLP loss with autograd and steps
its optimizer; the JAX side runs the same steps with one device a rank.
The cases: Adam and AdamW 5 steps; bf16 params over fp32 masters; the
overflow skip; ``grad_scale`` with the clip; LAMB with and without
``use_nvlamb``; a v1 and a v2 checkpoint round trip; a JAX ``init`` +
2 steps carried across with ``convert.distributed_fused_adam_state_from_jax``
and stepped 2 more; ``redundant_axis`` at distributed 2 x redundant 2
(``parallel_state`` with tensor groups of 2: the state sharded over
``tensor``, the gradients summed over ``data`` too); and the layout's
leaf that spans shards.

Tolerances: params and each rank's state shards within ``rtol=1e-5,
atol=1e-6`` of JAX's after the fp32 runs (the same fp32 operations; the
gradients' and reductions' summation orders differ between torch and
XLA and between gloo and the mesh); the bf16 params within one bf16
rounding of their value (``rtol=2**-7``) and the fp32 masters within
``atol=1e-5``; the overflow skip bit for bit; a checkpoint's arrays
equal to JAX's within the fp32 tolerance and a restored state's next
step equal to the unrestored one's bit for bit.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh, PartitionSpec as P

from apex_tpu.contrib.optimizers import (
    DistributedFusedAdam as JAdam,
    DistributedFusedLAMB as JLAMB,
)
from test_torch_tensor_parallel import spawn_world

WORLD = 4
N_BATCH = 4 * WORLD
RTOL, ATOL = 1e-5, 1e-6


def _params(seed):
    rng = np.random.default_rng(seed)
    return {"w1": rng.normal(size=(7, 5)).astype(np.float32),
            "b1": rng.normal(size=(5,)).astype(np.float32),
            "w2": rng.normal(size=(5, 3)).astype(np.float32)}


def _batch(seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(N_BATCH, 7)).astype(np.float32),
            rng.normal(size=(N_BATCH, 3)).astype(np.float32))


#: label -> (optimizer class name, constructor kwargs, param seed, batch
#: seeds, bf16 params); every case steps from its own init
CASES = {
    "adamw": ("adam", dict(lr=1e-2, adam_w_mode=True, weight_decay=0.01),
              0, range(100, 105), False),
    "adam": ("adam", dict(lr=1e-2, adam_w_mode=False, weight_decay=0.0),
             0, range(100, 105), False),
    "bf16": ("adam", dict(lr=1e-2), 10, range(200, 203), True),
    "clip": ("adam", dict(lr=1e-2, max_grad_norm=0.05), 5, [6], False),
    "lamb": ("lamb", dict(lr=1e-2, weight_decay=0.01, use_nvlamb=False,
                          max_grad_norm=1.0), 11, range(300, 304), False),
    "nvlamb": ("lamb", dict(lr=1e-2, weight_decay=0.0, use_nvlamb=True,
                            max_grad_norm=1.0), 11, range(300, 304), False),
}
CLIP_SCALE = 128.0


def _inputs():
    out = {}
    for seed in {c[2] for c in CASES.values()} | {3, 7, 12, 20}:
        for k, v in _params(seed).items():
            out[f"p{seed}/{k}"] = v
    for seed in set().union(*[set(c[3]) for c in CASES.values()],
                            {4, 8, 9, 13, 14, 21, 22, 23, 24, 30}):
        out[f"x{seed}"], out[f"y{seed}"] = _batch(seed)
    return out


ARR = _inputs()


def _carried_state():
    """JAX init + 2 steps of AdamW: the params and the global state the
    carried case starts from (numpy)."""
    opt = JAdam(lr=1e-2, weight_decay=0.01, distributed_size=WORLD)
    params = {k: jnp.asarray(v) for k, v in _params(20).items()}
    state = opt.init(params)
    step = _dist_step(opt, _mesh())
    for s in (21, 22):
        params, state = step(params, state, *_xy(s))
    return (jax.tree_util.tree_map(np.asarray, params),
            jax.tree_util.tree_map(np.asarray, state))


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
from apex_tpu_torch.contrib.optimizers import (DistributedFusedAdam,
                                               DistributedFusedLAMB)
from apex_tpu_torch.convert import distributed_fused_adam_state_from_jax
from apex_tpu_torch.transformer import parallel_state as ps

arr = dict(np.load(inputs))
res = {}
CLS = {"adam": DistributedFusedAdam, "lamb": DistributedFusedLAMB}

def params(seed, dtype=torch.float32):
    return {k: torch.from_numpy(arr[f"p{seed}/{k}"]).to(dtype)
            for k in ("w1", "b1", "w2")}

def local(seed, r=rank, n=world):
    x, y = torch.from_numpy(arr[f"x{seed}"]), torch.from_numpy(arr[f"y{seed}"])
    b = x.shape[0] // n
    return x[r * b:(r + 1) * b], y[r * b:(r + 1) * b]

def loss(p, x, y, scale=1.0):
    h = torch.tanh(x @ p["w1"].float() + p["b1"].float())
    return ((h @ p["w2"].float() - y) ** 2).mean() * scale

def grads(p, seed, scale=1.0, r=rank, n=world):
    x, y = local(seed, r, n)
    return value_and_grad(lambda q: loss(q, x, y, scale), p)[1]

def save(label, p, state):
    for k, v in p.items():
        res[f"{label}/p/{k}"] = v.detach().float().numpy()
    for k in ("exp_avg", "exp_avg_sq", "param_shard"):
        res[f"{label}/s/{k}"] = getattr(state, k).numpy()
    res[f"{label}/step"] = np.array(int(state.step))

for label, (kind, kw, pseed, bseeds, bf16) in spec["cases"].items():
    opt = CLS[kind](distributed_size=world, **kw)
    p = params(pseed, torch.bfloat16 if bf16 else torch.float32)
    state = opt.init(p)
    scale = spec["clip_scale"] if label == "clip" else 1.0
    for s in bseeds:
        p, state = opt.step(grads(p, s, scale), state, p,
                            grad_scale=scale if label == "clip" else None)
    save(label, p, state)
    res[f"{label}/dtype"] = np.array(str(p["w1"].dtype))
    if kind == "lamb":
        res[f"{label}/s/segment_ids"] = state.segment_ids.numpy()

# the ZeRO property: every state buffer is this rank's 1/world shard
opt = DistributedFusedAdam(lr=1e-2, distributed_size=world)
state = opt.init(params(3))
layout = opt.layout_for(params(3))
res["zero/shapes"] = np.array([tuple(getattr(state, k).shape)[0] for k in
                               ("exp_avg", "exp_avg_sq", "param_shard")])
res["zero/shard_size"] = np.array(layout.shard_size)
res["zero/padded"] = np.array(layout.padded)

# the overflow skip: params and state unchanged bit for bit
p0 = params(3)
p1, s1 = opt.step(grads(p0, 4), state, p0, found_inf=torch.tensor(True))
res["skip/same"] = np.array(all(torch.equal(p1[k], p0[k]) for k in p0)
                            and int(s1.step) == 0
                            and torch.equal(s1.exp_avg, state.exp_avg))

# checkpoint round trips: v1 and v2, then one more step from each
for fmt in ("v1", "v2"):
    opt = DistributedFusedAdam(lr=1e-2, distributed_size=world)
    p = params(7)
    state = opt.init(p)
    p, state = opt.step(grads(p, 8), state, p)
    sd = opt.state_dict(state, format=fmt)
    for k in ("exp_avg", "exp_avg_sq", "param_shard"):
        res[f"ckpt_{fmt}/sd/{k}"] = sd[k]
    restored = opt.load_state_dict(sd)
    pa, sa = opt.step(grads(p, 9), state, p)
    pb, sb = opt.step(grads(p, 9), restored, p)
    res[f"ckpt_{fmt}/same"] = np.array(
        all(torch.equal(pa[k], pb[k]) for k in pa) and int(sb.step) == 2)
    for k, v in pa.items():
        res[f"ckpt_{fmt}/p/{k}"] = v.numpy()
opt = DistributedFusedLAMB(lr=1e-2, distributed_size=world)
p = params(12)
state = opt.init(p)
p, state = opt.step(grads(p, 13), state, p)
restored = opt.load_state_dict(opt.state_dict(state))
pa, _ = opt.step(grads(p, 14), state, p)
pb, _ = opt.step(grads(p, 14), restored, p)
res["ckpt_lamb/same"] = np.array(all(torch.equal(pa[k], pb[k]) for k in pa)
                                 and torch.equal(restored.segment_ids,
                                                 state.segment_ids))

# a JAX state carried across mid-run, then 2 more steps
carried = spec["carried"]
class _S:
    pass
js = _S()
for k in ("exp_avg", "exp_avg_sq", "param_shard"):
    setattr(js, k, arr[f"carried/{k}"])
js.step = arr["carried/step"]
state = distributed_fused_adam_state_from_jax(js, rank, world)
opt = DistributedFusedAdam(lr=1e-2, weight_decay=0.01,
                           distributed_size=world)
p = {k: torch.from_numpy(arr[f"carried/p/{k}"]) for k in ("w1", "b1", "w2")}
opt.layout_for(p)
for s in (23, 24):
    p, state = opt.step(grads(p, s), state, p)
save("carried", p, state)

# redundant_axis: distributed over tensor groups of 2, redundant over data
ps.initialize_model_parallel(2)
opt = DistributedFusedAdam(lr=1e-2, weight_decay=0.01, distributed_size=2,
                           distributed_axis="tensor", redundant_axis="data")
p = params(3)
state = opt.init(p)
for s in (30, 4):
    p, state = opt.step(grads(p, s), state, p)
save("redundant", p, state)
ps.destroy_model_parallel()

dist.destroy_process_group()
np.savez(f"{out}/rank{rank}.npz", **res)
"""


def _mesh(n=WORLD, axes=("data",)):
    devs = np.array(jax.devices()[:n])
    if len(axes) == 2:
        devs = devs.reshape(2, 2)
    return Mesh(devs, axes)


def _loss(params, x, y, scale=1.0):
    h = jnp.tanh(x @ params["w1"].astype(jnp.float32)
                 + params["b1"].astype(jnp.float32))
    return jnp.mean((h @ params["w2"].astype(jnp.float32) - y) ** 2) * scale


def _xy(seed):
    return jnp.asarray(ARR[f"x{seed}"]), jnp.asarray(ARR[f"y{seed}"])


def _dist_step(opt, mesh, batch_axes="data", scale=None):
    specs = opt.state_specs()

    def shard_fn(params, state, x, y):
        g = jax.grad(_loss)(params, x, y, 1.0 if scale is None else scale)
        return opt.step(g, state, params, grad_scale=scale)

    return jax.jit(jax.shard_map(
        shard_fn, mesh=mesh,
        in_specs=(P(), specs, P(batch_axes), P(batch_axes)),
        out_specs=(P(), specs), check_vma=False))


@functools.lru_cache(maxsize=None)
def _jax_case(label):
    kind, kw, pseed, bseeds, bf16 = CASES[label]
    cls = JAdam if kind == "adam" else JLAMB
    opt = cls(distributed_size=WORLD, **kw)
    params = {k: jnp.asarray(v, jnp.bfloat16 if bf16 else jnp.float32)
              for k, v in _params(pseed).items()}
    state = opt.init(params)
    step = _dist_step(opt, _mesh(),
                      scale=CLIP_SCALE if label == "clip" else None)
    for s in bseeds:
        params, state = step(params, state, *_xy(s))
    return params, state, opt.layout_for(params)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    params, state = _carried_state()
    inputs = dict(ARR)
    for k in ("exp_avg", "exp_avg_sq", "param_shard"):
        inputs[f"carried/{k}"] = getattr(state, k)
    inputs["carried/step"] = np.asarray(state.step)
    for k, v in params.items():
        inputs[f"carried/p/{k}"] = v
    spec = {"cases": {k: [c[0], c[1], c[2], list(c[3]), c[4]]
                      for k, c in CASES.items()},
            "clip_scale": CLIP_SCALE, "carried": True}
    return spawn_world(tmp_path_factory.mktemp("gloo_zero"), _WORKER,
                       inputs, spec, world=WORLD)


def _shard(a, r, n=WORLD):
    a = np.asarray(a, np.float32).reshape(-1)
    k = a.shape[0] // n
    return a[r * k:(r + 1) * k]


def _hold(world, label, params, state, rtol=RTOL, atol=ATOL, n=WORLD):
    for r in range(n):
        rec = world[r]
        for k in params:
            np.testing.assert_allclose(
                rec[f"{label}/p/{k}"], np.asarray(params[k], np.float32),
                rtol=rtol, atol=atol, err_msg=f"rank {r} {k}")
        for k in ("exp_avg", "exp_avg_sq", "param_shard"):
            np.testing.assert_allclose(
                rec[f"{label}/s/{k}"], _shard(getattr(state, k), r, n),
                rtol=rtol, atol=atol, err_msg=f"rank {r} state {k}")
        assert int(rec[f"{label}/step"]) == int(state.step)


@pytest.mark.parametrize("label", ["adamw", "adam", "clip", "lamb",
                                   "nvlamb"])
def test_matches_jax_sharded_step(world, label):
    params, state, _ = _jax_case(label)
    _hold(world, label, params, state)
    if CASES[label][0] == "lamb":
        for r in range(WORLD):
            np.testing.assert_array_equal(world[r][f"{label}/s/segment_ids"],
                                          _shard(state.segment_ids, r))


def test_bf16_params_over_fp32_masters(world):
    params, state, _ = _jax_case("bf16")
    for r in range(WORLD):
        assert str(world[r]["bf16/dtype"]) == "torch.bfloat16"
        for k in params:
            np.testing.assert_allclose(
                world[r][f"bf16/p/{k}"], np.asarray(params[k], np.float32),
                rtol=2 ** -7, atol=1e-6)
        np.testing.assert_allclose(world[r]["bf16/s/param_shard"],
                                   _shard(state.param_shard, r), atol=1e-5)


def test_state_is_sharded_a_quarter_a_rank(world):
    for r in range(WORLD):
        size = int(world[r]["zero/shard_size"])
        assert size * WORLD == int(world[r]["zero/padded"])
        assert list(world[r]["zero/shapes"]) == [size] * 3


def test_overflow_skips_the_step(world):
    assert all(bool(world[r]["skip/same"]) for r in range(WORLD))


@pytest.mark.parametrize("fmt", ["v1", "v2"])
def test_checkpoint_round_trip(world, fmt):
    opt = JAdam(lr=1e-2, distributed_size=WORLD)
    params = {k: jnp.asarray(v) for k, v in _params(7).items()}
    state = opt.init(params)
    step = _dist_step(opt, _mesh())
    params, state = step(params, state, *_xy(8))
    sd = opt.state_dict(state, format=fmt)
    p2, _ = step(params, state, *_xy(9))
    for r in range(WORLD):
        rec = world[r]
        assert bool(rec[f"ckpt_{fmt}/same"])
        for k in ("exp_avg", "exp_avg_sq", "param_shard"):
            assert rec[f"ckpt_{fmt}/sd/{k}"].shape == sd[k].shape
            np.testing.assert_allclose(rec[f"ckpt_{fmt}/sd/{k}"], sd[k],
                                       rtol=RTOL, atol=ATOL)
        for k in p2:
            np.testing.assert_allclose(rec[f"ckpt_{fmt}/p/{k}"],
                                       np.asarray(p2[k]), rtol=RTOL,
                                       atol=ATOL)
    assert all(bool(world[r]["ckpt_lamb/same"]) for r in range(WORLD))


def test_jax_state_carried_across(world):
    params, state = _carried_state()
    opt = JAdam(lr=1e-2, weight_decay=0.01, distributed_size=WORLD)
    params = jax.tree_util.tree_map(jnp.asarray, params)
    state = jax.tree_util.tree_map(jnp.asarray, state)
    opt.layout_for(params)
    step = _dist_step(opt, _mesh())
    for s in (23, 24):
        params, state = step(params, state, *_xy(s))
    _hold(world, "carried", params, state)


def test_redundant_axis_distributed_2_by_redundant_2(world):
    opt = JAdam(lr=1e-2, weight_decay=0.01, distributed_size=2,
                distributed_axis="tensor", redundant_axis="data")
    params = {k: jnp.asarray(v) for k, v in _params(3).items()}
    state = opt.init(params)
    step = _dist_step(opt, _mesh(axes=("data", "tensor")),
                      batch_axes=("data", "tensor"))
    for s in (30, 4):
        params, state = step(params, state, *_xy(s))
    for r in range(WORLD):
        t = r % 2  # rank = data * 2 + tensor: the shard is the tensor index
        rec = world[r]
        for k in params:
            np.testing.assert_allclose(rec[f"redundant/p/{k}"],
                                       np.asarray(params[k]), rtol=RTOL,
                                       atol=ATOL)
        for k in ("exp_avg", "exp_avg_sq", "param_shard"):
            np.testing.assert_allclose(rec[f"redundant/s/{k}"],
                                       _shard(getattr(state, k), t, 2),
                                       rtol=RTOL, atol=ATOL)


def test_a_leaf_spans_shards_and_its_trust_ratio_is_whole(world):
    """``w1`` (35 elements after ``b1``'s 5) covers shards 0-2 of 14: its
    LAMB trust ratio needs every rank's partial sums, and the params
    match JAX's whole-tensor ratio."""
    _, _, layout = _jax_case("lamb")
    lo, hi = layout.offsets[1], layout.offsets[2]  # sorted keys: b1, w1, w2
    assert hi - lo == 35
    assert lo // layout.shard_size != (hi - 1) // layout.shard_size
    params, _, _ = _jax_case("lamb")
    for r in range(WORLD):
        np.testing.assert_allclose(world[r]["lamb/p/w1"],
                                   np.asarray(params["w1"]), rtol=RTOL,
                                   atol=ATOL)


def test_trust_ratio_norms_over_a_large_leaf():
    """LAMB's per-tensor norms over a leaf of 4M small entries: summed
    one float at a time (an ``index_add_`` into the leaf's segment) the
    squares stop adding once the sum dwarfs them, and the trust ratio
    drifts; summed by reduction over the leaf's range, one
    ``DistributedFusedLAMB`` step at world 1 is pytree ``FusedLAMB``'s
    within fp32 rounding."""
    import torch

    from apex_tpu_torch.contrib.optimizers import DistributedFusedLAMB
    from apex_tpu_torch.optimizers import FusedLAMB

    g = torch.Generator().manual_seed(0)
    params = {"w": 0.02 * torch.randn(2048, 2048, generator=g),
              "b": 0.02 * torch.randn(2048, generator=g)}
    grads = {k: 1e-3 * torch.randn(v.shape, generator=g)
             for k, v in params.items()}
    outs = []
    for opt in (DistributedFusedLAMB(lr=1e-2, distributed_size=1),
                FusedLAMB(lr=1e-2)):
        new, _ = opt.step(grads, opt.init(params), params)
        outs.append(new)
    for k in params:
        np.testing.assert_allclose(outs[0][k].numpy(), outs[1][k].numpy(),
                                   rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("kind", ["adam", "lamb"])
def test_state_from_jax_cuts_every_rank(kind):
    """``convert.distributed_fused_adam_state_from_jax`` on a JAX state
    (LAMB's with its segment ids): the ranks' slices put back together are
    the JAX global buffers, and the port's own ``init`` gives each rank
    the same slices."""
    import torch

    from apex_tpu_torch.contrib.optimizers import (
        DistributedFusedAdam,
        DistributedFusedLAMB,
        DistributedFusedLAMBState,
    )
    from apex_tpu_torch.convert import distributed_fused_adam_state_from_jax

    jcls, tcls = ((JAdam, DistributedFusedAdam) if kind == "adam"
                  else (JLAMB, DistributedFusedLAMB))
    params = _params(3)
    jstate = jax.tree_util.tree_map(np.asarray, jcls(
        lr=1e-2, distributed_size=WORLD).init(
            {k: jnp.asarray(v) for k, v in params.items()}))
    cuts = [distributed_fused_adam_state_from_jax(jstate, r, WORLD)
            for r in range(WORLD)]
    fields = ["exp_avg", "exp_avg_sq", "param_shard"]
    if kind == "lamb":
        assert all(isinstance(c, DistributedFusedLAMBState) for c in cuts)
        fields.append("segment_ids")
    for f in fields:
        np.testing.assert_array_equal(
            np.concatenate([getattr(c, f).numpy() for c in cuts]),
            np.asarray(getattr(jstate, f)).reshape(-1))
    # rank 0's init at world 1 holds the whole buffers: the same values
    mine = tcls(lr=1e-2, distributed_size=1).init(
        {k: torch.from_numpy(v) for k, v in params.items()})
    for f in fields:
        np.testing.assert_array_equal(
            getattr(mine, f).numpy()[:len(getattr(cuts[0], f))],
            getattr(cuts[0], f).numpy()[:len(getattr(mine, f))])
