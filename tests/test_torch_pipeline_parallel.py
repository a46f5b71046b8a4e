"""Pipeline parallelism across ranks: the port's ``pipeline_parallel`` (the
p2p rotations, the four schedules, the differentiable ``pipeline_rounds``,
the utilities) in a gloo world of 4 against the JAX package's under
``jax.shard_map(check_vma=True)`` over 4 of the 8 CPU devices of
``tests/conftest.py`` (the mirror of ``tests/test_pipeline_parallel.py``
and ``tests/test_pipeline_1f1b.py``).

One gloo world of 4 CPU processes is spawned once for the file
(``test_torch_tensor_parallel.spawn_world``): a pipeline of 4 stages,
every rank running every case on the same numpy-seeded inputs and
writing its results; the JAX side runs the same cases, one stage a
device. The toy stage is the JAX tests' ``tanh(x @ w + b)`` with a mean
squared error on the last stage; with virtual chunks, chunk ``c`` of
stage ``s`` holds global block ``c * pp + s`` (the reference layout).

Tolerances: the rotations move values exactly; the schedules' losses
and outputs on the toy stages 1e-6 relative (1e-6 absolute near zero),
their sums in another order than XLA's; the gradients, through up to
eight ``tanh`` blocks and a recompute, 1e-5 absolute, the JAX tests' own
tolerance for their schedules against the dense model.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from apex_tpu.transformer.pipeline_parallel import p2p_communication as jp2p
from apex_tpu.transformer.pipeline_parallel import (
    forward_backward_no_pipelining as jnopipe,
    run_pipeline as jrun_pipeline,
    run_pipeline_interleaved as jrun_interleaved,
)
from apex_tpu.transformer.pipeline_parallel.schedules import (
    pipeline_forward_backward_1f1b as j1f1b,
)
from apex_tpu.transformer.pipeline_parallel.schedules.fwd_bwd_pipelining_without_interleaving import (  # noqa: E501
    pipeline_rounds as jrounds,
)
from apex_tpu.transformer.pipeline_parallel import utils as jutils
from test_torch_tensor_parallel import spawn_world

PP, H, MBS = 4, 8, 2
RTOL = ATOL = 1e-6
GRAD_ATOL = 1e-5

_PRELUDE = r"""
import json, sys
import numpy as np
import torch
import torch.distributed as dist

torch.set_num_threads(1)
rank, world, store, out, inputs = (int(sys.argv[1]), int(sys.argv[2]),
                                   sys.argv[3], sys.argv[4], sys.argv[5])
dist.init_process_group("gloo", init_method="file://" + store,
                        world_size=world, rank=rank)
from apex_tpu_torch.transformer import parallel_state as ps
arr = dict(np.load(inputs))
res = {}

def T(name):
    return torch.from_numpy(arr[name])

def np32(t):
    return t.detach().float().numpy()
"""

_WORKER = _PRELUDE + r"""
from apex_tpu_torch.transformer.pipeline_parallel import (
    get_forward_backward_func, p2p_communication as p2p)
from apex_tpu_torch.transformer.pipeline_parallel import schedules as S
from apex_tpu_torch.transformer.pipeline_parallel import utils as U
from apex_tpu_torch.transformer.pipeline_parallel.schedules.fwd_bwd_pipelining_without_interleaving import pipeline_rounds

ps.initialize_model_parallel(1, 4)
r = ps.get_pipeline_model_parallel_rank()
PP = 4

def stage_fn(p, x):
    return torch.tanh(x @ p["w"] + p["b"])

def loss_fn(y, t):
    return ((y - t) ** 2).mean()

def own(prefix, vpp):
    w, b = T(prefix + "_w"), T(prefix + "_b")
    if vpp == 1:
        return {"w": w[r], "b": b[r]}
    return {"w": torch.stack([w[c * PP + r] for c in range(vpp)]),
            "b": torch.stack([b[c * PP + r] for c in range(vpp)])}

def save(label, loss, grads, dinp):
    res[label + "/loss"] = np32(loss)
    if grads is not None:
        res[label + "/w"], res[label + "/b"] = np32(grads["w"]), np32(grads["b"])
    if dinp is not None:
        res[label + "/dinp"] = np32(dinp)

# --- the rotations ---------------------------------------------------------
x = T("rot")[r]
res["p2p/fwd"] = np32(p2p.send_forward(x))
res["p2p/bwd"] = np32(p2p.send_backward(x))
a, b = p2p.send_forward_recv_backward(x, 2 * x)
res["p2p/pair_f"], res["p2p/pair_b"] = np32(a), np32(b)
tree = p2p.send_forward({"a": x, "b": [x + 1]})
res["p2p/tree"] = np32(tree["b"][0])

# --- the schedules -----------------------------------------------------------
for label, n, fn in (("gpipe", 6, "pfb"), ("1f1b", 6, "1f1b"),
                     ("1f1b_odd", 5, "1f1b"), ("1f1b_small", 2, "1f1b")):
    inp, tgt = T(f"in{n}"), T(f"tg{n}")
    if fn == "pfb":
        out_ = S.pipeline_forward_backward(stage_fn, loss_fn, own("p", 1),
                                           inp, tgt)
    else:
        out_ = S.pipeline_forward_backward_1f1b(stage_fn, loss_fn,
                                                own("p", 1), inp, tgt)
    save(label, *out_)
loss, _, _ = S.pipeline_forward_backward(stage_fn, loss_fn, own("p", 1),
                                         T("in6"), T("tg6"), forward_only=True)
res["fwd_only/loss"] = np32(loss)
save("rounds_fwd_only", S.run_pipeline(None, stage_fn, loss_fn,
     {"w": T("p_w"), "b": T("p_b")}, T("in6"), T("tg6"), forward_only=True),
     None, None)
loss, g, dinp = S.run_pipeline(None, stage_fn, loss_fn,
                               {"w": T("p_w"), "b": T("p_b")}, T("in6"),
                               T("tg6"))
res["run/w"], res["run/b"] = np32(g["w"]), np32(g["b"])

ps.set_virtual_pipeline_model_parallel_world_size(2)
save("interleaved", *S.pipeline_forward_backward_interleaved(
    stage_fn, loss_fn, own("v", 2), T("in8"), T("tg8")))
ps.set_virtual_pipeline_model_parallel_world_size(None)
save("1f1b_vpp2", *S.pipeline_forward_backward_1f1b(
    stage_fn, loss_fn, own("v", 2), T("in8"), T("tg8"), num_chunks=2))
try:
    S.pipeline_forward_backward_interleaved(stage_fn, loss_fn, own("v", 2),
                                            T("in6"), T("tg6"))
    res["divisible_error"] = np.array(0)
except ValueError as e:
    res["divisible_error"] = np.array(int("divisible" in str(e)))
try:
    S.pipeline_forward_backward_1f1b(stage_fn, loss_fn, own("v", 2),
                                     T("in6"), T("tg6"), num_chunks=2)
    res["divisible_error_1f1b"] = np.array(0)
except ValueError as e:
    res["divisible_error_1f1b"] = np.array(int("divisible" in str(e)))

# the differentiable stream: outputs on the last stage, the backward of a
# loss read on every stage
leaves = {k: v.clone().requires_grad_(True) for k, v in own("v", 2).items()}
inp = T("in8").clone().requires_grad_(True)
outs = pipeline_rounds(stage_fn, leaves, inp, "pipeline", True, num_chunks=2)
(outs * T("cot8")).sum().backward()
res["rounds/outs"] = np32(outs)
res["rounds/w"], res["rounds/b"] = np32(leaves["w"].grad), np32(leaves["b"].grad)
res["rounds/dinp"] = np32(inp.grad)

# no pipelining: the whole stacked model on every rank
def whole(p, x):
    for L in range(PP):
        x = stage_fn({"w": p["w"][L], "b": p["b"][L]}, x)
    return x
loss, g = S.forward_backward_no_pipelining(
    whole, loss_fn, {"w": T("p_w"), "b": T("p_b")}, T("in6"), T("tg6"))
save("nopipe", loss, g, None)
loss, g = S.forward_backward_no_pipelining(
    whole, loss_fn, {"w": T("p_w"), "b": T("p_b")}, T("in6"), T("tg6"),
    forward_only=True)
res["nopipe_fo/loss"], res["nopipe_fo/none"] = np32(loss), np.array(g is None)

res["dispatch"] = np.array([
    get_forward_backward_func(None, 1) is S.forward_backward_no_pipelining,
    get_forward_backward_func(None, 4) is S.pipeline_forward_backward,
    get_forward_backward_func(2, 4) is S.pipeline_forward_backward_interleaved])

# the 1F1B in-flight bound: live saved activations at their peak
class Box:
    live = peak = 0

    def __init__(self, t):
        Box.live += 1
        Box.peak = max(Box.peak, Box.live)
        self.t = t

    def __del__(self):
        Box.live -= 1

def peak_of(fn):
    Box.live = Box.peak = 0
    with torch.autograd.graph.saved_tensors_hooks(Box, lambda b: b.t):
        fn()
    return Box.peak

for n in (4, 8):
    res[f"peak_1f1b_{n}"] = np.array(peak_of(lambda: S.pipeline_forward_backward_1f1b(
        stage_fn, loss_fn, own("p", 1), T(f"in{n}"), T(f"tg{n}"))))
    res[f"peak_gpipe_{n}"] = np.array(peak_of(lambda: S.pipeline_forward_backward(
        stage_fn, loss_fn, own("p", 1), T(f"in{n}"), T(f"tg{n}"),
        checkpoint_stages=False)))
def one_item():
    x = T("in4")[0].clone().requires_grad_(True)
    p = {k: v.clone().requires_grad_(True) for k, v in own("p", 1).items()}
    loss_fn(stage_fn(p, x), T("tg4")[0]).backward()
res["peak_item"] = np.array(peak_of(one_item))

# ticks: the hook sees every tick, forward and backward sub-ticks
ticks = []
S.pipeline_forward_backward_1f1b(stage_fn, loss_fn, own("p", 1), T("in4"),
                                 T("tg4"), tick_hook=lambda *a: ticks.append(a))
res["ticks"] = np.array([[t, rk, int(f), int(b_)] for t, rk, f, b_ in ticks])

# build_model: one chunk a virtual rank, the virtual rank set while built
built = []
chunks = S.build_model(lambda: built.append(
    ps.get_virtual_pipeline_model_parallel_rank()) or len(built),
    virtual_pipeline_model_parallel_size=3)
res["build"] = np.array(built + chunks)

# the utilities over the pipeline group
res["l2"] = np32(U.calc_params_l2_norm(own("p", 1), axis_name="pipeline"))
emb = {"word": T("rot")[r] * 1.0}
res["embsync"] = np32(U.sync_embedding_grads(emb)["word"])
res["possync"] = np32(U.sync_position_embedding_grads(emb)["word"])
res["spec_sync"] = np32(U.sync_grads_by_spec(
    {"a": T("rot")[r], "b": T("rot")[r]}, {"a": (None,), "b": ("pipeline",)},
    ("pipeline",))["a"])
res["avg"] = np32(U.average_losses_across_data_parallel_group(
    [T("rot")[r][0], T("rot")[r][1]], axis_name="pipeline"))
res["root"] = np32(U.mask_to_axis_root(T("rot")[r], "pipeline"))
ps.destroy_model_parallel()
dist.destroy_process_group()
np.savez(f"{out}/rank{rank}.npz", **res)
"""


def _inputs():
    rng = np.random.default_rng(19)

    def n(*shape, s=1.0):
        return (s * rng.normal(size=shape)).astype(np.float32)

    out = {"rot": n(PP, 3), "p_w": n(PP, H, H, s=0.5),
           "p_b": n(PP, H, s=0.1), "v_w": n(2 * PP, H, H, s=0.5),
           "v_b": n(2 * PP, H, s=0.1), "cot8": n(8, MBS, H)}
    for m in (2, 4, 5, 6, 8):
        out[f"in{m}"], out[f"tg{m}"] = n(m, MBS, H), n(m, MBS, H)
    return out


ARR = _inputs()


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    return spawn_world(tmp_path_factory.mktemp("gloo_pp"), _WORKER, ARR, {})


def _mesh():
    return Mesh(np.array(jax.devices()[:PP]), ("pipeline",))


def _stage(p, x):
    return jnp.tanh(x @ p["w"] + p["b"])


def _loss(y, t):
    return jnp.mean((y - t) ** 2)


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=RTOL,
                               atol=atol)


def _jp(prefix):
    return {"w": jnp.asarray(ARR[prefix + "_w"]),
            "b": jnp.asarray(ARR[prefix + "_b"])}


def _chunked(vpp):
    """``[pp, vpp, ...]``: chunk c of stage s = global block c * pp + s."""
    f = _jp("v")
    return {k: jnp.stack([jnp.stack([f[k][c * PP + s] for c in range(vpp)])
                          for s in range(PP)]) for k in f}


def _jax_1f1b(params, n, vpp):
    def local(p, x, t):
        # the JAX tests' harness: every operand marked pipeline-varying
        p, x, t = jutils.pvary_full(
            (jax.tree_util.tree_map(lambda a: a[0], p), x, t), ("pipeline",))
        loss, g, d = j1f1b(_stage, _loss, p, x, t, axis_name="pipeline",
                           num_chunks=vpp)
        return loss, jax.tree_util.tree_map(lambda a: a[None], g), d

    spec = jax.tree_util.tree_map(lambda _: P("pipeline"), params)
    return jax.jit(jax.shard_map(local, mesh=_mesh(),
                                 in_specs=(spec, P(), P()),
                                 out_specs=(P(), spec, P()),
                                 check_vma=True))(
        params, jnp.asarray(ARR[f"in{n}"]), jnp.asarray(ARR[f"tg{n}"]))


def _check(world, label, loss, grads, dinp, vpp=1):
    for r in range(PP):
        _close(world[r][label + "/loss"], loss)
        for k in ("w", "b"):
            _close(world[r][f"{label}/{k}"], np.asarray(grads[k])[r],
                   GRAD_ATOL)
        if dinp is not None:
            _close(world[r][label + "/dinp"], dinp, GRAD_ATOL)


def test_p2p_rotations_match_jax(world):
    x = jnp.asarray(ARR["rot"])

    def sm(fn):
        return jax.shard_map(fn, mesh=_mesh(), in_specs=P("pipeline"),
                             out_specs=P("pipeline"), check_vma=False)(x)

    fwd = sm(lambda t: jp2p.send_forward(t, "pipeline"))
    bwd = sm(lambda t: jp2p.send_backward(t, "pipeline"))
    np.testing.assert_array_equal(np.asarray(fwd), np.roll(ARR["rot"], 1, 0))
    for r in range(PP):
        np.testing.assert_array_equal(world[r]["p2p/fwd"], np.asarray(fwd)[r])
        np.testing.assert_array_equal(world[r]["p2p/bwd"], np.asarray(bwd)[r])
        np.testing.assert_array_equal(world[r]["p2p/pair_f"],
                                      np.asarray(fwd)[r])
        np.testing.assert_array_equal(world[r]["p2p/pair_b"],
                                      2 * np.asarray(bwd)[r])
        np.testing.assert_array_equal(world[r]["p2p/tree"],
                                      np.asarray(fwd)[r] + 1)


@pytest.mark.parametrize("label,n", [("gpipe", 6), ("1f1b", 6),
                                     ("1f1b_odd", 5), ("1f1b_small", 2)])
def test_schedules_match_jax(world, label, n):
    params = _jp("p")
    if label == "gpipe":
        loss, grads, dinp = jax.jit(lambda p, x, t: jrun_pipeline(
            _mesh(), _stage, _loss, p, x, t))(
            params, jnp.asarray(ARR[f"in{n}"]), jnp.asarray(ARR[f"tg{n}"]))
    else:
        loss, grads, dinp = _jax_1f1b(params, n, 1)
    _check(world, label, loss, grads, dinp)


def test_forward_only_and_stacked_form_match_jax(world):
    args = (_jp("p"), jnp.asarray(ARR["in6"]), jnp.asarray(ARR["tg6"]))
    loss = jax.jit(lambda p, x, t: jrun_pipeline(
        _mesh(), _stage, _loss, p, x, t, forward_only=True))(*args)
    _, grads, _ = jax.jit(lambda p, x, t: jrun_pipeline(
        _mesh(), _stage, _loss, p, x, t))(*args)
    for r in range(PP):
        _close(world[r]["fwd_only/loss"], loss)
        _close(world[r]["rounds_fwd_only/loss"], loss)
        # run_pipeline's gradients stacked [pp, ...] on every stage
        _close(world[r]["run/w"], grads["w"], GRAD_ATOL)
        _close(world[r]["run/b"], grads["b"], GRAD_ATOL)


@pytest.mark.parametrize("label", ["interleaved", "1f1b_vpp2"])
def test_interleaved_schedules_match_jax(world, label):
    params = _chunked(2)
    if label == "interleaved":
        loss, grads, dinp = jax.jit(lambda p, x, t: jrun_interleaved(
            _mesh(), _stage, _loss, p, x, t))(
            params, jnp.asarray(ARR["in8"]), jnp.asarray(ARR["tg8"]))
    else:
        loss, grads, dinp = _jax_1f1b(params, 8, 2)
    _check(world, label, loss, grads, dinp)


def test_interleaved_requires_divisible_microbatches(world):
    for r in range(PP):
        assert int(world[r]["divisible_error"]) == 1
        assert int(world[r]["divisible_error_1f1b"]) == 1


def test_pipeline_rounds_matches_jax(world):
    params, inp, cot = _chunked(2), jnp.asarray(ARR["in8"]), \
        jnp.asarray(ARR["cot8"])

    def local(p, x):
        p = jax.tree_util.tree_map(lambda a: a[0], p)
        return jrounds(_stage, p, x, "pipeline", True, num_chunks=2)[None]

    spec = jax.tree_util.tree_map(lambda _: P("pipeline"), params)
    f = jax.shard_map(local, mesh=_mesh(), in_specs=(spec, P()),
                      out_specs=P("pipeline"), check_vma=False)
    outs = jax.jit(f)(params, inp)
    gp, gx = jax.jit(jax.grad(lambda p, x: jnp.sum(f(p, x)[-1] * cot),
                              argnums=(0, 1)))(params, inp)
    for r in range(PP):
        want = np.asarray(outs[-1]) if r == PP - 1 else np.zeros_like(
            ARR["in8"])
        _close(world[r]["rounds/outs"], want)
        _close(world[r]["rounds/w"], np.asarray(gp["w"])[r], GRAD_ATOL)
        _close(world[r]["rounds/b"], np.asarray(gp["b"])[r], GRAD_ATOL)
        _close(world[r]["rounds/dinp"], gx, GRAD_ATOL)


def test_no_pipelining_matches_jax(world):
    def whole(p, x):
        for L in range(PP):
            x = _stage({"w": p["w"][L], "b": p["b"][L]}, x)
        return x

    loss, grads = jax.jit(lambda p, x, t: jnopipe(whole, _loss, p, x, t))(
        _jp("p"), jnp.asarray(ARR["in6"]), jnp.asarray(ARR["tg6"]))
    for r in range(PP):
        _close(world[r]["nopipe/loss"], loss)
        _close(world[r]["nopipe/w"], grads["w"], GRAD_ATOL)
        _close(world[r]["nopipe/b"], grads["b"], GRAD_ATOL)
        _close(world[r]["nopipe_fo/loss"], loss)
        assert bool(world[r]["nopipe_fo/none"])


def test_get_forward_backward_func_dispatch(world):
    for r in range(PP):
        assert world[r]["dispatch"].all()


def test_1f1b_in_flight_bound(world):
    """Stage r keeps at most ``pp - r`` microbatches' saved activations,
    the same at 4 and 8 microbatches; the all-forwards-first schedule
    without recompute keeps them all."""
    item = int(world[0]["peak_item"])
    for r in range(PP):
        p4, p8 = int(world[r]["peak_1f1b_4"]), int(world[r]["peak_1f1b_8"])
        assert p4 == p8 <= (PP - r) * item, (r, p4, p8, item)
        g4, g8 = int(world[r]["peak_gpipe_4"]), int(world[r]["peak_gpipe_8"])
        assert g8 > g4 and g8 > p8, (r, g4, g8, p8)


def test_1f1b_tick_timeline(world):
    """Every stage's ticks: one forward and one backward a microbatch, the
    warm-up forwards first (``pp - r - 1`` of them) and the backwards
    last."""
    for r in range(PP):
        ticks = world[r]["ticks"]
        assert (ticks[:, 1] == r).all()
        assert ticks[:, 2].sum() == 4 and ticks[:, 3].sum() == 4
        acts = [("F" if f else "B") for _, _, f, b in ticks if f or b]
        warm = min(PP - r - 1, 4)
        assert acts[:warm] == ["F"] * warm and acts[warm] == "F"
        assert acts[-1] == "B"


def test_build_model_virtual_chunks(world):
    np.testing.assert_array_equal(world[0]["build"], [0, 1, 2, 1, 2, 3])


def test_pipeline_utilities_over_the_group(world):
    rot = ARR["rot"]
    want_l2 = np.sqrt(sum(np.sum(ARR["p_w"][s] ** 2) + np.sum(
        ARR["p_b"][s] ** 2) for s in range(PP)))
    for r in range(PP):
        np.testing.assert_allclose(world[r]["l2"], want_l2, rtol=1e-6)
        # the embedding group: the first and last stages
        _close(world[r]["embsync"], rot[0] + rot[PP - 1])
        _close(world[r]["possync"], rot[0])
        _close(world[r]["spec_sync"], rot.sum(0))
        np.testing.assert_array_equal(world[r]["root"],
                                      rot[0] if r == 0 else 0 * rot[0])
        _close(world[r]["avg"], rot[:, :2].mean(0))


def test_calc_params_l2_norm_matches_jax():
    from apex_tpu_torch.transformer.pipeline_parallel import utils as U

    tree = {"w": ARR["p_w"], "b": ARR["p_b"]}
    want = jutils.calc_params_l2_norm(
        jax.tree_util.tree_map(jnp.asarray, tree))
    got = U.calc_params_l2_norm({k: torch.from_numpy(v)
                                 for k, v in tree.items()})
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


@pytest.mark.parametrize("reset_pos", [False, True])
@pytest.mark.parametrize("reset_attn", [False, True])
@pytest.mark.parametrize("eod_mask", [False, True])
def test_ltor_masks_and_position_ids_bit_exact(reset_pos, reset_attn,
                                               eod_mask):
    from apex_tpu_torch.transformer.pipeline_parallel.utils import (
        get_ltor_masks_and_position_ids,
    )

    data = np.random.default_rng(5).integers(0, 4, size=(3, 17))
    want = jutils.get_ltor_masks_and_position_ids(
        jnp.asarray(data), 0, reset_pos, reset_attn, eod_mask)
    got = get_ltor_masks_and_position_ids(
        torch.from_numpy(data), 0, reset_pos, reset_attn, eod_mask)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        assert g.shape == tuple(w.shape)


def test_microbatch_helpers_match_jax():
    from apex_tpu_torch.transformer.pipeline_parallel import utils as U

    batch = {"x": np.arange(24, dtype=np.float32).reshape(12, 2)}
    tb = {"x": torch.from_numpy(batch["x"])}
    np.testing.assert_array_equal(
        U.split_into_microbatches(tb, 3)["x"].numpy(),
        np.asarray(jutils.split_into_microbatches(
            {"x": jnp.asarray(batch["x"])}, 3)["x"]))
    for mod in (U, jutils):
        mod._reconfigure_microbatch_calculator(0, None, 12, 4, 1)
    try:
        assert U.get_num_microbatches() == jutils.get_num_microbatches() == 3
        np.testing.assert_array_equal(
            U.get_kth_microbatch(tb, 1)["x"].numpy(),
            np.asarray(jutils.get_kth_microbatch(
                {"x": jnp.asarray(batch["x"])}, 1)["x"]))
        assert U.get_micro_batch_size() == 4
        assert U.get_current_global_batch_size() == 12
    finally:
        U.destroy_num_microbatches_calculator()
        jutils.destroy_num_microbatches_calculator()


def test_timers_and_schedule_warnings():
    import warnings

    from apex_tpu_torch.transformer.pipeline_parallel import Timers
    from apex_tpu_torch.transformer.pipeline_parallel.schedules import common

    timers = Timers()
    timers("fwd").start(barrier_on=torch.ones(1))
    timers("fwd").stop(barrier_on=[torch.ones(1)])
    assert timers("fwd").elapsed(reset=False) >= 0.0
    assert timers.log(["fwd"]).startswith("time (ms) | fwd: ")
    with pytest.raises(RuntimeError, match="not started"):
        timers("bwd").stop()
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        common.warn_ignored_parity_kwargs("f", {"custom_sync_context_handler":
                                                object(), "dtype": 1})
        common.warn_ignored_parity_kwargs("f", {"custom_sync_context_handler":
                                                object()})
    assert len(seen) == 1 and "custom_sync_context_handler" in str(
        seen[0].message)


def test_1f1b_orders_match_the_reference_counts():
    """The order of each stage: ``pp - r - 1`` warm-up forwards (``2 (pp -
    r - 1) + (vpp - 1) pp`` interleaved), every item once forward and
    once backward, chunks walked backward in reverse; the plan lays every
    order out without a stall at several sizes."""
    from apex_tpu_torch.transformer.pipeline_parallel.schedules.common import (
        gpipe_order, one_f_one_b_order, plan)

    for pp, vpp, n in ((4, 1, 6), (4, 1, 2), (2, 1, 5), (4, 2, 8),
                       (2, 3, 4), (3, 2, 6)):
        orders = [one_f_one_b_order(r, pp, vpp, n) for r in range(pp)]
        for r, o in enumerate(orders):
            warm = min(pp - r - 1 if vpp == 1
                       else 2 * (pp - r - 1) + (vpp - 1) * pp, n * vpp)
            assert [k for k, _, _ in o[:warm]] == ["F"] * warm
            assert sorted((m, c) for k, m, c in o if k == "F") == sorted(
                (m, c) for k, m, c in o if k == "B")
            assert len(o) == 2 * n * vpp
        ticks = plan(orders, pp, vpp)
        assert sum(len(a) for a, _ in ticks) == 2 * n * vpp * pp
        gp = plan([gpipe_order(r, pp, vpp, n) for r in range(pp)], pp, vpp)
        assert len(gp) == 2 * (n * vpp + pp - 1)
