"""Context parallelism across ranks: the port's ring and Ulysses attention
and the GPT's context-parallel path in a gloo world of 4 against the JAX
package's under ``jax.shard_map(check_vma=True)`` over 4 of the 8 CPU
devices of ``tests/conftest.py`` (the mirror of
``tests/test_context_parallel.py``).

One gloo world of 4 CPU processes is spawned once for the file
(``test_torch_tensor_parallel.spawn_world``); the axis is the default
group (no model-parallel layout), and the cp 2 cases take a
``ProcessGroup`` of ranks ``{0, 1}`` (``{2, 3}`` the second) as their
axis. Every rank holds its sequence shard (contiguous, or the zigzag
layout of ``zigzag_indices``) of the same numpy-seeded q, k, v and
cotangent; the JAX side runs the same shards, one a device. The flash
chunks run the plain versions on the CPU (the JAX package its dense
interpret path).

Tolerances: attention outputs and gradients 2e-5 absolute (the JAX
tests' against its dense reference; the ring merges partial softmaxes in
another order); the GPT's loss ``rtol=2e-4`` and its gradients
``atol=5e-4`` on every rank, the tensor-parallel GPT's tolerances.
"""
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from apex_tpu.transformer import context_parallel as jcp
from apex_tpu.transformer.testing import GPTConfig as JGPTConfig
from apex_tpu.transformer.testing import gpt_loss as jgpt_loss
from test_torch_tensor_parallel import flat, spawn_world

CP = 4
B, N, S, D = 2, 4, 64, 16
ATT_ATOL = 2e-5
LOSS_RTOL, GRAD_ATOL = 2e-4, 5e-4
GPT = dict(num_layers=2, hidden_size=32, num_attention_heads=4,
           vocab_size=64, max_position_embeddings=S, hidden_dropout=0.0,
           attention_dropout=0.0, apply_query_key_layer_scaling=False)

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
from apex_tpu_torch.transformer import context_parallel as C
from apex_tpu_torch.transformer.testing import GPTConfig, gpt_loss

arr = dict(np.load(inputs))
res = {}
pairs = [dist.new_group([0, 1]), dist.new_group([2, 3])]

def T(name):
    return torch.from_numpy(arr[name])

def np32(t):
    return t.detach().float().numpy()

def shard(t, cp, r, zig):
    s = t.shape[2]
    if zig:
        t = t[:, :, torch.from_numpy(C.zigzag_indices(s, cp)[0])]
    n = s // cp
    return t[:, :, r * n:(r + 1) * n].contiguous()

def attn(label, fn, cp, r, zig, **kw):
    q, k, v = (shard(T(x), cp, r, zig).requires_grad_(True)
               for x in ("q", "k", "v"))
    o = fn(q, k, v, **kw)
    (o * shard(T("do"), cp, r, zig)).sum().backward()
    res[label + "/o"] = np32(o)
    for name, t in zip("qkv", (q, k, v)):
        res[f"{label}/d{name}"] = np32(t.grad)

for causal in (False, True):
    for zig in (False, True):
        attn(f"ring_c{int(causal)}_z{int(zig)}", C.ring_attention, 4, rank,
             zig and causal, axis_name="cp", causal=causal, zigzag=zig)
    attn(f"ulysses_c{int(causal)}", C.ulysses_attention, 4, rank, False,
         axis_name="cp", causal=causal)
attn("ring_cp2_zig", C.ring_attention, 2, rank % 2, True,
     axis_name=pairs[rank // 2], causal=True, zigzag=True)
q, k, v = (shard(T(x), 4, rank, False) for x in ("q", "k", "v"))
res["ulysses_dropout"] = np32(C.ulysses_attention(
    q, k, v, axis_name="cp", causal=True, dropout_p=0.25, dropout_seed=7))

params = {}
for key, val in arr.items():
    if key.startswith("params/"):
        node = params
        *path, leaf = key[7:].split("/")
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = torch.from_numpy(val)

def save_tree(prefix, t):
    for k, v in t.items():
        if isinstance(v, dict):
            save_tree(prefix + "/" + k, v)
        else:
            res[prefix + "/" + k] = np32(v)

for zig in (False, True):
    cfg = GPTConfig(**spec["gpt"], context_parallel_axis="cp",
                    context_parallel_zigzag=zig)
    tok = shard(T("tokens")[:, None], 4, rank, zig)[:, 0].long()
    lab = shard(T("labels")[:, None], 4, rank, zig)[:, 0].long()
    loss, grads = value_and_grad(lambda p: gpt_loss(cfg, p, tok, lab), params)
    res[f"gpt_z{int(zig)}/loss"] = np.array(float(loss))
    save_tree(f"gpt_z{int(zig)}/grad", grads)
dist.destroy_process_group()
np.savez(f"{out}/rank{rank}.npz", **res)
"""


def _gpt_params(seed: int):
    rng = np.random.default_rng(seed)
    h, L, v, f = 32, 2, 64, 128

    def n(*shape, s=0.02, mean=0.0):
        return (mean + s * rng.normal(size=shape)).astype(np.float32)

    return {
        "embedding": {"word": n(v, h), "position": n(S, h)},
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


def _inputs():
    rng = np.random.default_rng(20)
    out = {k: rng.normal(size=(B, N, S, D)).astype(np.float32)
           for k in ("q", "k", "v", "do")}
    tokens = rng.integers(0, 64, size=(2, S)).astype(np.int64)
    out["tokens"], out["labels"] = tokens, np.roll(tokens, -1, axis=1)
    for k, v in flat(_gpt_params(9)).items():
        out["params/" + k] = v
    return out


ARR = _inputs()


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    return spawn_world(tmp_path_factory.mktemp("gloo_cp"), _WORKER, ARR,
                       {"gpt": GPT})


def _mesh(cp=CP):
    return Mesh(np.array(jax.devices()[:cp]), ("cp",))


def _zig(x, cp, zig):
    if not zig:
        return x
    return x[:, :, jcp.zigzag_indices(x.shape[2], cp)[0]]


def _jax_attention(fn, cp, zig, **kw):
    """The JAX function's output and gradients on the same shards, each
    array in the sharded layout ``[b, n, s, d]`` (shard r = rank r's)."""
    spec = P(None, None, "cp", None)
    f = jax.jit(jax.shard_map(functools.partial(fn, axis_name="cp", **kw),
                              mesh=_mesh(cp), in_specs=(spec, spec, spec),
                              out_specs=spec))
    q, k, v, do = (jnp.asarray(_zig(ARR[x], cp, zig))
                   for x in ("q", "k", "v", "do"))
    o, vjp = jax.vjp(f, q, k, v)
    return [np.asarray(t) for t in (o, *vjp(do))]


def _check_sharded(world, label, want, cp=CP, ranks=range(CP)):
    for r in ranks:
        n = S // cp
        sl = slice((r % cp) * n, (r % cp + 1) * n)
        for name, w in zip(("o", "dq", "dk", "dv"), want):
            np.testing.assert_allclose(world[r][f"{label}/{name}"],
                                       w[:, :, sl], atol=ATT_ATOL,
                                       err_msg=f"{label} {name} rank {r}")


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("zig", [False, True])
def test_ring_attention_matches_jax(world, causal, zig):
    want = _jax_attention(jcp.ring_attention, CP, zig and causal,
                          causal=causal, zigzag=zig, block_q=8, block_k=8)
    _check_sharded(world, f"ring_c{int(causal)}_z{int(zig)}", want)


def test_zigzag_ring_on_process_group_pairs_matches_jax(world):
    want = _jax_attention(jcp.ring_attention, 2, True, causal=True,
                          zigzag=True, block_q=8, block_k=8)
    _check_sharded(world, "ring_cp2_zig", want, cp=2)


@pytest.mark.parametrize("causal", [False, True])
def test_ulysses_attention_matches_jax(world, causal):
    want = _jax_attention(jcp.ulysses_attention, CP, False, causal=causal)
    _check_sharded(world, f"ulysses_c{int(causal)}", want)


def test_ulysses_dropout_matches_jax(world):
    spec = P(None, None, "cp", None)
    f = jax.jit(jax.shard_map(functools.partial(
        jcp.ulysses_attention, axis_name="cp", causal=True, dropout_p=0.25,
        dropout_seed=7), mesh=_mesh(), in_specs=(spec, spec, spec),
        out_specs=spec))
    want = np.asarray(f(*(jnp.asarray(ARR[x]) for x in ("q", "k", "v"))))
    n = S // CP
    for r in range(CP):
        np.testing.assert_allclose(world[r]["ulysses_dropout"],
                                   want[:, :, r * n:(r + 1) * n],
                                   atol=ATT_ATOL)


@pytest.mark.parametrize("zig", [False, True])
def test_gpt_context_parallel_matches_jax(world, zig):
    cfg = JGPTConfig(**GPT, context_parallel_axis="cp",
                     context_parallel_zigzag=zig)
    params = jax.tree_util.tree_map(jnp.asarray, _gpt_params(9))
    tokens, labels = (jnp.asarray(_zig(ARR[k][:, None], CP, zig)[:, 0])
                      for k in ("tokens", "labels"))
    pspec = jax.tree_util.tree_map(lambda _: P(), params)
    fn = jax.shard_map(lambda p, t, l: jgpt_loss(cfg, p, t, l), mesh=_mesh(),
                       in_specs=(pspec, P(None, "cp"), P(None, "cp")),
                       out_specs=P())
    loss, grads = jax.jit(jax.value_and_grad(fn))(params, tokens, labels)
    grads = flat(jax.tree_util.tree_map(np.asarray, grads))
    label = f"gpt_z{int(zig)}"
    for r in range(CP):
        np.testing.assert_allclose(float(world[r][label + "/loss"]),
                                   float(loss), rtol=LOSS_RTOL)
        for key, want in grads.items():
            np.testing.assert_allclose(world[r][f"{label}/grad/{key}"], want,
                                       atol=GRAD_ATOL, err_msg=key)


@pytest.mark.parametrize("s,cp", [(64, 4), (64, 2), (48, 3), (16, 8)])
def test_zigzag_indices_bit_exact(s, cp):
    from apex_tpu_torch.transformer.context_parallel import zigzag_indices

    got, want = zigzag_indices(s, cp), jcp.zigzag_indices(s, cp)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
        assert g.dtype == w.dtype
    with pytest.raises(ValueError, match="2\\*cp"):
        zigzag_indices(s + 1, cp)


def test_merge_matches_jax():
    from apex_tpu_torch.transformer.context_parallel import _merge

    rng = np.random.default_rng(3)
    o1, o2 = rng.normal(size=(2, 2, 5, 4)).astype(np.float32)
    l1, l2 = rng.normal(size=(2, 2, 5)).astype(np.float32)
    l2[0, 0] = -1e30  # a row masked in one partial
    got = _merge(*(torch.from_numpy(x) for x in (o1, l1, o2, l2)))
    want = jcp._merge(*(jnp.asarray(x) for x in (o1, l1, o2, l2)))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6,
                                   atol=1e-7)


def test_ring_and_ulysses_on_one_rank_are_flash_attention():
    """Without a process group the ring has one rank: the result is the
    dense reference's, as the JAX functions' on one device."""
    from apex_tpu_torch.ops.flash_attention import mha_reference
    from apex_tpu_torch.transformer import context_parallel as C

    q, k, v = (torch.from_numpy(ARR[x]) for x in ("q", "k", "v"))
    for causal in (False, True):
        want = mha_reference(q, k, v, causal=causal)
        for fn in (C.ring_attention, C.ulysses_attention):
            got = fn(q, k, v, axis_name="cp", causal=causal)
            np.testing.assert_allclose(got.numpy(), want.numpy(),
                                       atol=ATT_ATOL)
        np.testing.assert_allclose(
            C.ring_attention_reference(q, k, v, causal=causal).numpy(),
            want.numpy(), atol=0)
    with pytest.raises(ValueError, match="dropout_seed"):
        C.ulysses_attention(q, k, v, axis_name="cp", dropout_p=0.1)


def _port_gpt(**kw):
    from apex_tpu_torch.transformer.testing import GPTConfig

    base = dict(GPT, context_parallel_axis="cp")
    base.update(kw)
    return GPTConfig(**base)


@pytest.mark.parametrize("bad_kw,match", [
    (dict(sequence_parallel=True), "mutually exclusive"),
    (dict(apply_query_key_layer_scaling=True,
          compute_dtype=torch.float16), "static softmax scale"),
    (dict(use_flash_attention=False), "cannot be honored"),
    (dict(max_position_embeddings=S // 2), "max_position_embeddings"),
    (dict(num_layers=1, hidden_size=576, num_attention_heads=2),
     "tileable"),
    (dict(context_parallel_zigzag=True), "% 16"),
])
def test_gpt_context_parallel_validations(bad_kw, match):
    """The JAX package's refusals, on one rank (a ring of one)."""
    from apex_tpu_torch.transformer.testing import gpt_loss, init_gpt_params

    cfg = _port_gpt(**bad_kw)
    params = init_gpt_params(cfg, torch.Generator().manual_seed(0))
    s = 40 if bad_kw.get("context_parallel_zigzag") else S
    tokens = torch.randint(0, 64, (2, s),
                           generator=torch.Generator().manual_seed(1))
    with pytest.raises(ValueError, match=match):
        gpt_loss(cfg, params, tokens, tokens)


def test_gpt_context_parallel_attention_dropout_raises():
    from apex_tpu_torch.transformer.testing import gpt_loss, init_gpt_params

    cfg = _port_gpt(attention_dropout=0.2)
    params = init_gpt_params(cfg, torch.Generator().manual_seed(0))
    tokens = torch.randint(0, 64, (2, S),
                           generator=torch.Generator().manual_seed(1))
    with pytest.raises(ValueError, match="attention dropout"):
        gpt_loss(cfg, params, tokens, tokens,
                 generator=torch.Generator().manual_seed(3),
                 deterministic=False)
