"""Tensor parallelism across ranks: the port's ``tensor_parallel`` and the
GPT's tensor-parallel path in a gloo world of 4 against the JAX
package's under ``jax.shard_map(check_vma=True)`` over 2 or 4 of the 8
CPU devices of ``tests/conftest.py`` (the mirror of
``tests/test_tensor_parallel.py`` and
``tests/test_standalone_models.py::test_gpt_tp_matches_dense``).

One gloo world of 4 CPU processes is spawned once for the file
(rendezvous over a ``FileStore`` in a temporary directory). Every rank
reads the same numpy-seeded inputs and weights, runs every case and
writes its results; the JAX side runs the same cases on the same inputs,
one rank a device. The world first takes one tensor group of 4 (the
collectives, the layers, the cross entropy, ``broadcast_data``, the GPT
at TP 4), then two tensor groups of 2 (the GPT at TP 2, ranks 2 and 3 a
second replica of ranks 0 and 1).

Backward conventions. A collective whose dual is its exact transpose
(copy, the scatters, the sequence gather with ``to_model_parallel``, the
reduce-scatter, and the split backward of ``to_model_parallel=False``)
is held with a different cotangent on every rank: the gradient of the
sum of the ranks' losses, which is what JAX's autodiff gives. The
reduce's identity backward and the last-dim gather's split backward are
the reference's duals for a consumer that every rank computes alike, the
loss counted once: they are held with the same cotangent on every rank
against the JAX gradient of the ranks' mean loss (``pmean``), where the
JAX transpose would otherwise count the copies (``tests/
test_sequence_parallel.py`` pins the same over-count for the sequence
gather).

Tolerances: the collectives move values and sum them in gloo's or XLA's
order, 1e-6 relative; the layers and the cross entropy 1e-5 absolute,
as the JAX tests hold them against dense; the GPT's loss within
``rtol=2e-4`` and its gradients within ``atol=5e-4``, shard for shard
and the replicated ones on every rank, the JAX tests' tolerances against
the dense model.
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
import torch
from jax.sharding import Mesh, PartitionSpec as P

from apex_tpu.transformer import tensor_parallel as jtp
from apex_tpu.transformer.testing import (
    GPTConfig as JGPTConfig,
    gpt_loss as jgpt_loss,
    gpt_partition_specs as jspecs,
)
from apex_tpu.transformer.testing.standalone_transformer_lm import (
    parallel_attention as jattention,
)
from apex_tpu_torch.transformer.testing import (
    GPTConfig,
    gpt_partition_specs,
    shard_gpt_params,
)

REPO = Path(__file__).resolve().parents[1]
WORLD = 4
JOIN_TIMEOUT_S = 180
#: the small GPT of the JAX tests: 8 heads, so TP 4 gives each rank 2
GPT = dict(num_layers=2, hidden_size=32, num_attention_heads=8,
           vocab_size=128, max_position_embeddings=32, hidden_dropout=0.0,
           attention_dropout=0.0)
BATCH, SEQ = 2, 16
LOSS_RTOL, GRAD_ATOL = 2e-4, 5e-4


def gpt_params(seed: int):
    """A full GPT parameter tree in numpy, every leaf drawn (biases and
    norm parameters too, so each path carries a gradient)."""
    rng = np.random.default_rng(seed)
    h, L, v, f = (GPT["hidden_size"], GPT["num_layers"], GPT["vocab_size"],
                  4 * GPT["hidden_size"])

    def n(*shape, s=0.02, mean=0.0):
        return (mean + s * rng.normal(size=shape)).astype(np.float32)

    return {
        "embedding": {"word": n(v, h), "position": n(32, h)},
        "layers": {
            "input_ln_w": n(L, h, s=0.1, mean=1.0), "input_ln_b": n(L, h),
            "qkv_w": n(L, 3 * h, h), "qkv_b": n(L, 3 * h),
            "proj_w": n(L, h, h), "proj_b": n(L, h),
            "post_ln_w": n(L, h, s=0.1, mean=1.0), "post_ln_b": n(L, h),
            "fc1_w": n(L, f, h), "fc1_b": n(L, f),
            "fc2_w": n(L, h, f), "fc2_b": n(L, h),
        },
        "final_ln_w": n(h, s=0.1, mean=1.0), "final_ln_b": n(h),
    }


def flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


def unflat(d):
    out = {}
    for k, v in d.items():
        node = out
        *path, leaf = k.split("/")
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = v
    return out


def spawn_world(tmp: Path, worker: str, inputs: dict, spec: dict,
                world: int = WORLD):
    """Run ``worker`` (a Python source reading ``rank world store out
    inputs spec`` from argv) in a gloo world of ``world`` processes;
    returns each rank's saved arrays."""
    np.savez(tmp / "inputs.npz", **inputs)
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    env.pop("XLA_FLAGS", None)
    procs = [subprocess.Popen(
        [sys.executable, "-W", "ignore", "-c", worker, str(r), str(world),
         str(tmp / "store"), str(tmp), str(tmp / "inputs.npz"),
         json.dumps(spec)],
        env=env, cwd=str(tmp), stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for r in range(world)]
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
    return [dict(np.load(tmp / f"rank{r}.npz")) for r in range(world)]


#: shared by both files' workers: the world, the inputs, the GPT cases
WORKER_PRELUDE = r"""
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
from apex_tpu_torch.transformer import parallel_state as ps
from apex_tpu_torch.transformer import tensor_parallel as tp
from apex_tpu_torch.transformer.testing import (GPTConfig, gpt_loss,
                                                shard_gpt_params)

arr = dict(np.load(inputs))
res = {}

def T(name):
    return torch.from_numpy(arr[name])

def np32(t):
    return t.detach().float().numpy()

def tree(prefix):
    out = {}
    for k, v in arr.items():
        if k.startswith(prefix + "/"):
            node = out
            *path, leaf = k[len(prefix) + 1:].split("/")
            for p in path:
                node = node.setdefault(p, {})
            node[leaf] = torch.from_numpy(v)
    return out

def save_tree(prefix, t):
    for k, v in t.items():
        if isinstance(v, dict):
            save_tree(prefix + "/" + k, v)
        else:
            res[prefix + "/" + k] = np32(v)

def gpt_case(label, tpn, cfg_kw):
    cfg = GPTConfig(**spec["gpt"], tensor_model_parallel_size=tpn, **cfg_kw)
    shard = shard_gpt_params(tree("params"), cfg,
                             ps.get_tensor_model_parallel_rank(), tpn)
    tokens, labels = T("tokens").long(), T("labels").long()
    loss, grads = value_and_grad(
        lambda p: gpt_loss(cfg, p, tokens, labels, axis_name="tensor"),
        shard)
    res[label + "/loss"] = np.array(float(loss))
    save_tree(label + "/grad", grads)
"""

_WORKER = WORKER_PRELUDE + r"""
ps.initialize_model_parallel(4)
r = ps.get_tensor_model_parallel_rank()

def grad_of(fn, x, cot):
    x = x.clone().requires_grad_(True)
    y = fn(x)
    (y * cot).sum().backward()
    return np32(y), np32(x.grad)

# the collectives: (name, function, input, cotangent)
cases = (
    ("copy", tp.copy_to_tensor_model_parallel_region, T("rep6"), T("c6")[r]),
    ("reduce", tp.reduce_from_tensor_model_parallel_region, T("x34")[r],
     T("c34")[0]),
    ("scatter", tp.scatter_to_tensor_model_parallel_region, T("rep420"),
     T("c45")[r]),
    ("gather", tp.gather_from_tensor_model_parallel_region, T("x45")[r],
     T("c420")[0]),
    ("scatter_seq", tp.scatter_to_sequence_parallel_region, T("rep1224"),
     T("c324")[r]),
    ("gather_seq", lambda x: tp.gather_from_sequence_parallel_region(
        x, "tensor", True), T("x324")[r], T("c1224")[r]),
    ("gather_seq_split", lambda x: tp.gather_from_sequence_parallel_region(
        x, "tensor", False), T("x324")[r], T("c1224")[r]),
    ("reduce_scatter_seq", tp.reduce_scatter_to_sequence_parallel_region,
     T("x1224")[r], T("c324")[r]),
)
for name, fn, x, cot in cases:
    res[name + "/out"], res[name + "/grad"] = grad_of(fn, x, cot)

# the linears and the embedding: x [6, 12] replicated, cotangents alike
x, w, b = T("lin_x"), T("col_w").chunk(4)[r], T("col_b").chunk(4)[r]
leaves = [t.clone().requires_grad_(True) for t in (x, w, b)]
y, _, _ = tp.column_parallel_linear(*leaves, axis_name="tensor",
                                    gather_output=True)
(y * T("col_c")).sum().backward()
res["column/out"] = np32(y)
for n, t in zip("xwb", leaves):
    res["column/d" + n] = np32(t.grad)
x, w, b = T("row_x"), T("row_w").chunk(4, dim=1)[r], T("row_b")
leaves = [t.clone().requires_grad_(True) for t in (x, w, b)]
y, _, _ = tp.row_parallel_linear(*leaves, axis_name="tensor",
                                 input_is_parallel=False)
(y * T("row_c")).sum().backward()
res["row/out"] = np32(y)
for n, t in zip("xwb", leaves):
    res["row/d" + n] = np32(t.grad)
x, w1, w2 = T("mlp_x"), T("mlp_w1").chunk(4)[r], T("mlp_w2").chunk(4, 1)[r]
leaves = [t.clone().requires_grad_(True) for t in (x, w1, w2)]
h, _, _ = tp.column_parallel_linear(leaves[0], leaves[1], None,
                                    axis_name="tensor", gather_output=False)
y, _, _ = tp.row_parallel_linear(torch.nn.functional.gelu(h), leaves[2],
                                 None, axis_name="tensor",
                                 input_is_parallel=True)
(y ** 2).sum().backward()
for n, t in zip(("x", "w1", "w2"), leaves):
    res["pair/d" + n] = np32(t.grad)
table = T("emb_table").chunk(4)[r].clone().requires_grad_(True)
e = tp.vocab_parallel_embedding(T("emb_ids").long(), table,
                                axis_name="tensor")
(e * T("emb_c")).sum().backward()
res["embedding/out"], res["embedding/dtable"] = np32(e), np32(table.grad)

# the cross entropy, its gradient with and without smoothing
for ls in (0.0, 0.1):
    lg = T("ce_logits").chunk(4, dim=-1)[r].clone().requires_grad_(True)
    loss = tp.vocab_parallel_cross_entropy(lg, T("ce_target").long(), ls,
                                           "tensor")
    loss.sum().backward()
    res[f"ce{ls}/loss"], res[f"ce{ls}/grad"] = np32(loss), np32(lg.grad)

# broadcast_data: every rank's values differ; rank 0's arrive everywhere
data = {"v": T("bcast") + r, "keep": T("bcast")}
got = tp.broadcast_data(["v"], data, torch.float64)
assert set(got) == {"v"} and got["v"].dtype == torch.float64
assert torch.equal(data["v"], T("bcast") + r)  # the caller's kept
res["bcast"] = got["v"].numpy()

# the qkv cut: attention of this rank's heads, the row projection summed
from apex_tpu_torch.transformer.testing import parallel_attention
for tpn in (4,):
    cfg = GPTConfig(**spec["gpt"], tensor_model_parallel_size=tpn)
    lp = {k: torch.from_numpy(v) for k, v in arr.items()
          if k.startswith("attn/")}
    lp = {k[5:]: v for k, v in lp.items()}
    lp["qkv_w"], lp["qkv_b"] = lp["qkv_w"].chunk(tpn)[r], \
        lp["qkv_b"].chunk(tpn)[r]
    lp["proj_w"] = lp["proj_w"].chunk(tpn, dim=1)[r]
    res[f"attn{tpn}"] = np32(parallel_attention(
        cfg, lp, T("attn_h"), None, None, True, axis_name="tensor"))

gpt_case("gpt4", 4, {})
gpt_case("gpt4_fused", 4, {"fused_block": True})

ps.destroy_model_parallel()
ps.initialize_model_parallel(2)
r = ps.get_tensor_model_parallel_rank()
cfg = GPTConfig(**spec["gpt"], tensor_model_parallel_size=2)
lp = {k[5:]: torch.from_numpy(v) for k, v in arr.items()
      if k.startswith("attn/")}
lp["qkv_w"], lp["qkv_b"] = lp["qkv_w"].chunk(2)[r], lp["qkv_b"].chunk(2)[r]
lp["proj_w"] = lp["proj_w"].chunk(2, dim=1)[r]
res["attn2"] = np32(parallel_attention(cfg, lp, T("attn_h"), None, None, True,
                                       axis_name="tensor"))
gpt_case("gpt2", 2, {})
gpt_case("gpt2_fused", 2, {"fused_block": True})
ps.destroy_model_parallel()
dist.destroy_process_group()
np.savez(f"{out}/rank{rank}.npz", **res)
"""


def _inputs():
    rng = np.random.default_rng(18)

    def n(*shape, s=1.0):
        return (s * rng.normal(size=shape)).astype(np.float32)

    out = {
        "rep6": n(6), "c6": n(WORLD, 6),
        "x34": n(WORLD, 3, 4), "c34": n(WORLD, 3, 4),
        "rep420": n(4, 20), "c45": n(WORLD, 4, 5),
        "x45": n(WORLD, 4, 5), "c420": n(WORLD, 4, 20),
        "rep1224": n(12, 2, 4), "c324": n(WORLD, 3, 2, 4),
        "x324": n(WORLD, 3, 2, 4), "c1224": n(WORLD, 12, 2, 4),
        "x1224": n(WORLD, 12, 2, 4),
        "lin_x": n(6, 12), "col_w": n(16, 12, s=0.1), "col_b": n(16, s=0.1),
        "col_c": n(6, 16),
        "row_x": n(5, 16), "row_w": n(6, 16, s=0.1), "row_b": n(6, s=0.1),
        "row_c": n(5, 6),
        "mlp_x": n(3, 8), "mlp_w1": n(16, 8, s=0.2), "mlp_w2": n(8, 16, s=0.2),
        "emb_table": n(24, 5), "emb_c": n(2, 4, 5),
        "emb_ids": np.array([[0, 3, 17, 23], [5, 22, 11, 6]], np.int64),
        "ce_logits": n(4, 7, 32, s=2.0),
        "ce_target": rng.integers(0, 32, size=(4, 7)).astype(np.int64),
        "bcast": np.arange(6, dtype=np.float32).reshape(2, 3),
        "attn_h": n(SEQ, BATCH, GPT["hidden_size"]),
        "tokens": rng.integers(0, 128, size=(BATCH, SEQ)).astype(np.int64),
        "labels": rng.integers(0, 128, size=(BATCH, SEQ)).astype(np.int64),
    }
    params = gpt_params(7)
    for k, v in flat(params).items():
        out["params/" + k] = v
    for k in ("qkv_w", "qkv_b", "proj_w", "proj_b"):
        out["attn/" + k] = params["layers"][k][0]
    return out


ARR = _inputs()


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    return spawn_world(tmp_path_factory.mktemp("gloo_tp"), _WORKER, ARR,
                       {"gpt": GPT})


def _mesh(n):
    return Mesh(np.array(jax.devices()[:n]), ("tensor",))


def smap(fn, in_specs, out_specs, n=WORLD, check_vma=True):
    return jax.jit(jax.shard_map(fn, mesh=_mesh(n), in_specs=in_specs,
                                 out_specs=out_specs, check_vma=check_vma))


def _stack(world, key, n=WORLD):
    return np.stack([world[r][key] for r in range(n)])


def _close(got, want, rtol=1e-6, atol=1e-6):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol,
                               atol=atol)


# --- the collectives, forward and backward -------------------------------

#: (name, JAX function, the input is replicated, the cotangent is the
#: same on every rank, the JAX loss is the ranks' mean)
MAPPINGS = {
    "copy": (lambda x: jtp.copy_to_tensor_model_parallel_region(x, "tensor"),
             "rep6", "c6", True, False),
    "reduce": (lambda x: jtp.reduce_from_tensor_model_parallel_region(
        x, "tensor"), "x34", "c34", False, True),
    "scatter": (lambda x: jtp.scatter_to_tensor_model_parallel_region(
        x, "tensor"), "rep420", "c45", True, False),
    "gather": (lambda x: jtp.gather_from_tensor_model_parallel_region(
        x, "tensor"), "x45", "c420", False, True),
    "scatter_seq": (lambda x: jtp.scatter_to_sequence_parallel_region(
        x, "tensor"), "rep1224", "c324", True, False),
    "gather_seq": (lambda x: jtp.gather_from_sequence_parallel_region(
        x, "tensor", True), "x324", "c1224", False, False),
    "gather_seq_split": (lambda x: jtp.gather_from_sequence_parallel_region(
        x, "tensor", False), "x324", "c1224", False, False),
    "reduce_scatter_seq": (
        lambda x: jtp.reduce_scatter_to_sequence_parallel_region(
            x, "tensor"), "x1224", "c324", False, False),
}


def _jax_mapping(name):
    fn, xk, ck, replicated, mean = MAPPINGS[name]
    x, c = jnp.asarray(ARR[xk]), jnp.asarray(ARR[ck])
    if mean:  # the same cotangent on every rank: rank 0's
        c = jnp.broadcast_to(c[0], c.shape)
    xs = P() if replicated else P("tensor")

    def fwd(xi):
        return fn(xi if replicated else xi[0])[None]

    out = smap(fwd, xs, P("tensor"), check_vma=False)(x)

    def grad(xi, ci):
        def loss(a):
            v = jnp.sum(fn(a if replicated else a[0]) * ci[0])
            return jax.lax.pmean(v, "tensor") if mean else v
        return jax.grad(loss)(xi)

    g = smap(grad, (xs, P("tensor")), xs)(x, c)
    return np.asarray(out), np.asarray(g)


@pytest.mark.parametrize("name", sorted(MAPPINGS))
def test_mapping_forward_and_backward(world, name):
    want_out, want_grad = _jax_mapping(name)
    _close(_stack(world, name + "/out"), want_out)
    got = _stack(world, name + "/grad")
    if MAPPINGS[name][3]:  # a replicated input: its gradient on every rank
        for r in range(WORLD):
            _close(got[r], want_grad, rtol=1e-5, atol=1e-6)
    else:
        _close(got, want_grad, rtol=1e-5, atol=1e-6)


# --- the layers ------------------------------------------------------------

def test_column_parallel_linear_matches_jax(world):
    x, w, b, c = (jnp.asarray(ARR[k]) for k in ("lin_x", "col_w", "col_b",
                                                "col_c"))

    def loss(xi, wi, bi):
        y, _, _ = jtp.column_parallel_linear(xi, wi, bi, axis_name="tensor",
                                             gather_output=True)
        return jax.lax.pmean(jnp.sum(y * c), "tensor")

    specs = (P(), P("tensor", None), P("tensor"))
    gx, gw, gb = smap(jax.grad(loss, argnums=(0, 1, 2)), specs, specs)(x, w, b)
    for r in range(WORLD):
        _close(world[r]["column/out"], x @ w.T + b, atol=1e-5)
        _close(world[r]["column/dx"], gx, atol=1e-5)
    _close(np.concatenate([world[r]["column/dw"] for r in range(WORLD)]), gw,
           atol=1e-5)
    _close(np.concatenate([world[r]["column/db"] for r in range(WORLD)]), gb,
           atol=1e-5)


def test_row_parallel_linear_matches_jax(world):
    x, w, b, c = (jnp.asarray(ARR[k]) for k in ("row_x", "row_w", "row_b",
                                                "row_c"))

    def loss(xi, wi, bi):
        y, _, _ = jtp.row_parallel_linear(xi, wi, bi, axis_name="tensor",
                                          input_is_parallel=False)
        return jnp.sum(y * c)

    specs = (P(), P(None, "tensor"), P())
    gx, gw, gb = smap(jax.grad(loss, argnums=(0, 1, 2)), specs, specs)(x, w, b)
    for r in range(WORLD):
        _close(world[r]["row/out"], x @ w.T + b, atol=1e-5)
        _close(world[r]["row/dx"], gx, atol=1e-5)
        _close(world[r]["row/db"], gb, atol=1e-5)
    _close(np.concatenate([world[r]["row/dw"] for r in range(WORLD)], 1), gw,
           atol=1e-5)


def test_column_row_pair_backward_matches_jax(world):
    x, w1, w2 = (jnp.asarray(ARR[k]) for k in ("mlp_x", "mlp_w1", "mlp_w2"))

    def loss(xi, a, b):
        h, _, _ = jtp.column_parallel_linear(xi, a, None, axis_name="tensor",
                                             gather_output=False)
        y, _, _ = jtp.row_parallel_linear(jax.nn.gelu(h, approximate=False),
                                          b, None, axis_name="tensor",
                                          input_is_parallel=True)
        return jnp.sum(y ** 2)

    specs = (P(), P("tensor", None), P(None, "tensor"))
    gx, g1, g2 = smap(jax.grad(loss, argnums=(0, 1, 2)), specs, specs)(
        x, w1, w2)
    for r in range(WORLD):
        _close(world[r]["pair/dx"], gx, atol=2e-5)
    _close(np.concatenate([world[r]["pair/dw1"] for r in range(WORLD)]), g1,
           atol=2e-5)
    _close(np.concatenate([world[r]["pair/dw2"] for r in range(WORLD)], 1), g2,
           atol=2e-5)


def test_vocab_parallel_embedding_matches_jax(world):
    ids, table, c = (jnp.asarray(ARR[k]) for k in ("emb_ids", "emb_table",
                                                   "emb_c"))

    def loss(t):
        e = jtp.vocab_parallel_embedding(ids, t, axis_name="tensor")
        return jax.lax.pmean(jnp.sum(e * c), "tensor")

    g = smap(jax.grad(loss), P("tensor", None), P("tensor", None))(table)
    for r in range(WORLD):
        _close(world[r]["embedding/out"], ARR["emb_table"][ARR["emb_ids"]])
    _close(np.concatenate([world[r]["embedding/dtable"]
                           for r in range(WORLD)]), g)


@pytest.mark.parametrize("label_smoothing", [0.0, 0.1])
def test_vocab_parallel_cross_entropy_matches_jax(world, label_smoothing):
    logits, target = jnp.asarray(ARR["ce_logits"]), jnp.asarray(
        ARR["ce_target"])

    def loss(lg):
        return jtp.vocab_parallel_cross_entropy(lg, target, label_smoothing,
                                                "tensor")

    spec = P(None, None, "tensor")
    want = smap(loss, spec, P())(logits)
    g = smap(jax.grad(lambda lg: jnp.sum(loss(lg))), spec, spec)(logits)
    for r in range(WORLD):
        _close(world[r][f"ce{label_smoothing}/loss"], want, atol=1e-5)
    _close(np.concatenate([world[r][f"ce{label_smoothing}/grad"]
                           for r in range(WORLD)], -1), g, atol=1e-5)


def test_broadcast_data_from_the_first_rank(world):
    for r in range(WORLD):
        np.testing.assert_array_equal(world[r]["bcast"], ARR["bcast"])


# --- the GPT ---------------------------------------------------------------

def _jax_gpt(tpn, **cfg_kw):
    """The JAX TP GPT's loss and gradients (full arrays, assembled from
    the shards by the specs) under ``shard_map(check_vma=True)``."""
    cfg = JGPTConfig(**GPT, tensor_model_parallel_size=tpn, **cfg_kw)
    params = jax.tree_util.tree_map(jnp.asarray, gpt_params(7))
    specs = jspecs(cfg)

    def local(p, t, lab):
        return jgpt_loss(cfg, p, t, lab, axis_name="tensor")

    loss, grads = smap(jax.value_and_grad(local), (specs, P(), P()),
                       (P(), specs), n=tpn)(
        params, jnp.asarray(ARR["tokens"]), jnp.asarray(ARR["labels"]))
    return float(loss), flat(jax.tree_util.tree_map(np.asarray, grads))


def check_gpt(world, label, tpn, loss, grads, cfg):
    """Every rank's loss; each gradient shard for shard (the replicated
    ones on every rank, ranks ``tpn`` on the second replica)."""
    dims = flat(gpt_partition_specs(cfg))
    for r in range(WORLD):
        np.testing.assert_allclose(float(world[r][label + "/loss"]), loss,
                                   rtol=LOSS_RTOL)
    for key, want in grads.items():
        dim = dims[key]
        for base in range(0, WORLD, tpn):
            got = [world[base + t][f"{label}/grad/{key}"] for t in range(tpn)]
            if dim is None:
                for g in got:
                    np.testing.assert_allclose(g, want, atol=GRAD_ATOL,
                                               err_msg=key)
            else:
                np.testing.assert_allclose(np.concatenate(got, dim), want,
                                           atol=GRAD_ATOL, err_msg=key)


@pytest.mark.parametrize("tpn,fused", [(2, False), (2, True), (4, False),
                                       (4, True)])
def test_gpt_tp_matches_jax(world, tpn, fused):
    loss, grads = _jax_gpt(tpn, fused_block=fused)
    label = f"gpt{tpn}" + ("_fused" if fused else "")
    check_gpt(world, label, tpn, loss, grads,
              GPTConfig(**GPT, tensor_model_parallel_size=tpn))


@pytest.mark.parametrize("tpn", [2, 4])
def test_qkv_cut_gives_whole_heads(world, tpn):
    """The contiguous ``3h / tp`` rows of the fused qkv weight are whole
    heads, each with its own q, k and v: every rank's attention over its
    heads, summed by the row projection, is the dense attention (and the
    JAX package's), with every head's weights distinct."""
    lp = {k[5:]: ARR[k] for k in ARR if k.startswith("attn/")}
    qkv = lp["qkv_w"].reshape(GPT["num_attention_heads"], -1)
    assert len({row.tobytes() for row in qkv}) == GPT["num_attention_heads"]
    from apex_tpu_torch.transformer.testing import parallel_attention

    dense = parallel_attention(GPTConfig(**GPT),
                               {k: torch.from_numpy(v) for k, v in lp.items()},
                               torch.from_numpy(ARR["attn_h"]), None, None,
                               True).numpy()
    cfg = JGPTConfig(**GPT, tensor_model_parallel_size=tpn)
    specs = {"qkv_w": P("tensor", None), "qkv_b": P("tensor"),
             "proj_w": P(None, "tensor"), "proj_b": P()}
    want = smap(lambda p, h: jattention(cfg, p, h, None, "tensor", None, True),
                (specs, P()), P(), n=tpn)(
        {k: jnp.asarray(v) for k, v in lp.items()}, jnp.asarray(ARR["attn_h"]))
    for r in range(WORLD):
        _close(world[r][f"attn{tpn}"], dense, atol=1e-5)
        _close(world[r][f"attn{tpn}"], want, atol=1e-5)


@pytest.mark.parametrize("tpn", [2, 4, 8])
def test_shard_gpt_params_matches_jax_specs(tpn):
    """``shard_gpt_params`` cuts every leaf as slicing by the JAX
    ``PartitionSpec`` tree does, and the spec tree names the same dims."""
    params = gpt_params(3)
    cfg = GPTConfig(**GPT, tensor_model_parallel_size=tpn)
    jspec = flat(jspecs(JGPTConfig(**GPT)))
    dims = flat(gpt_partition_specs(cfg))
    assert set(jspec) == set(dims)
    tparams = unflat({k: torch.from_numpy(v)
                      for k, v in flat(params).items()})
    for r in range(tpn):
        got = flat(shard_gpt_params(tparams, cfg, r, tpn))
        for key, spec in jspec.items():
            full = flat(params)[key]
            axes = [i for i, a in enumerate(tuple(spec)) if a == "tensor"]
            assert (axes[0] if axes else None) == dims[key], key
            want = full if not axes else np.split(full, tpn, axes[0])[r]
            np.testing.assert_array_equal(got[key].numpy(), want, key)
