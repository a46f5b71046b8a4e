"""The pipelined GPT across ranks: the port's GPT composed around the
pipeline schedules (``pipeline_stage_layers``, the tensor-parallel
trunk, the tied word embedding in both of its pipelined forms) in a gloo
world of 4, against the JAX package's GPT (the mirror of
``tests/test_composed_parallelism.py`` and
``tests/test_tied_embedding_pipeline.py``).

The JAX package's own tests hold its pipelined GPT forms to its dense
model (``test_tied_embedding_pipeline``, ``test_composed_parallelism``):
the reference here is the JAX dense ``gpt_loss`` and its gradients on the
whole batch (the schedules' loss is the mean over equal microbatches of
each one's mean, the dense mean), every gradient cut as the rank holds
it. One gloo world of 4 CPU processes (``test_torch_tensor_parallel.
spawn_world``) runs the layouts in turn:

- PP 2 x TP 2 (4 layers): the reference tied form under the 1F1B
  schedule (the first and last stages own the word table, the last
  stage's head and loss inside the schedule, ``sync_embedding_grads``
  over the embedding group), and the vocab-sharded form (the table's
  rows split over ``(pipeline, tensor)``, the embedding on every rank,
  ``pipeline_rounds`` for the trunk, the last stage's hidden summed over
  the pipeline to every rank, the final LayerNorm, the head and the cross
  entropy vocab-parallel over ``(pipeline, tensor)``, the LayerNorm's
  gradients summed over ``(pipeline, tensor)``);
- PP 4 with ``vpp = 2`` (8 layers, one a chunk: four layers do not cut
  into eight chunks): the reference form under the interleaved schedule
  that ``get_forward_backward_func`` picks, and under the interleaved
  1F1B, and the vocab-sharded form over the interleaved stream.

Tolerances: the loss ``rtol=2e-4`` on every rank, the gradients
``atol=5e-4``, the tensor-parallel GPT's tolerances.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from apex_tpu.transformer.testing import GPTConfig as JGPTConfig
from apex_tpu.transformer.testing import gpt_loss as jgpt_loss
from test_torch_tensor_parallel import flat, spawn_world

H, HEADS, V, S, MBS, N_MICRO = 64, 4, 128, 16, 2, 4
LOSS_RTOL, GRAD_ATOL = 2e-4, 5e-4
CASES = {  # label: (layers, tp, pp, vpp)
    "ref_1f1b": (4, 2, 2, 1), "vocab_rounds": (4, 2, 2, 1),
    "ref_interleaved": (8, 1, 4, 2), "ref_1f1b_vpp2": (8, 1, 4, 2),
    "vocab_interleaved": (8, 1, 4, 2),
}

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
from apex_tpu_torch.transformer import parallel_state as ps
from apex_tpu_torch.transformer import tensor_parallel as tpl
from apex_tpu_torch.transformer.pipeline_parallel import (
    get_forward_backward_func)
from apex_tpu_torch.transformer.pipeline_parallel.schedules import (
    pipeline_forward_backward_1f1b)
from apex_tpu_torch.transformer.pipeline_parallel.schedules.fwd_bwd_pipelining_without_interleaving import pipeline_rounds
from apex_tpu_torch.transformer.pipeline_parallel.utils import (
    sync_embedding_grads, sync_grads_by_spec)
from apex_tpu_torch.transformer.testing import (
    GPTConfig, gpt_embed, pipeline_stage_layers, shard_gpt_params,
    transformer_block)
from apex_tpu_torch.transformer.testing.standalone_transformer_lm import (
    _lm_head, lm_head, ln_fp32)

arr = dict(np.load(inputs))
res = {}
PL_T = ("pipeline", "tensor")

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

def save(label, loss, grads):
    res[label + "/loss"] = np.array(float(loss))
    for k, v in grads.items():
        if isinstance(v, dict):
            for kk, vv in v.items():
                res[f"{label}/{k}/{kk}"] = np32(vv)
        elif v is not None:
            res[f"{label}/{k}"] = np32(v)

def setup(label):
    layers, tp, pp, vpp = spec["cases"][label]
    cfg = GPTConfig(**spec["gpt"], num_layers=layers,
                    tensor_model_parallel_size=tp)
    full = tree(f"params{layers}")
    rp = ps.get_pipeline_model_parallel_rank()
    rt = ps.get_tensor_model_parallel_rank()
    shard = shard_gpt_params(full, cfg, rt, tp)
    layers_ = pipeline_stage_layers(shard["layers"], cfg, rp, pp, vpp)
    tok = torch.from_numpy(arr["tokens"]).long()
    lab = torch.from_numpy(arr["labels"]).long()
    return cfg, full, shard, layers_, tok, lab, rp, rt, pp, vpp

def stage_fn_of(cfg):
    def stage_fn(lp, x):
        return transformer_block(cfg, lp, x, None, axis_name="tensor")
    return stage_fn

def reference_form(label, schedule):
    # the first and last stages own the word table; the head and the loss
    # on the last stage inside the schedule; the embedding outside it
    cfg, full, shard, layers, tok, lab, rp, rt, pp, vpp = setup(label)
    first, last = rp == 0, rp == pp - 1
    word_in = shard["embedding"]["word"].clone().requires_grad_(first)
    pos = full["embedding"]["position"].clone().requires_grad_(first)
    n, b, s = tok.shape
    if first:
        emb = torch.stack([gpt_embed(cfg, {"embedding": {
            "word": word_in, "position": pos}}, tok[m], axis_name="tensor")
            for m in range(n)])
    else:
        emb = torch.zeros(n, s, b, cfg.hidden_size)
    word_out = shard["embedding"]["word"].clone().requires_grad_(last)
    fw = full["final_ln_w"].clone().requires_grad_(last)
    fb = full["final_ln_b"].clone().requires_grad_(last)

    def loss_fn(y, labels):
        h = ln_fp32(y, fw, fb, cfg.layernorm_epsilon).to(cfg.compute_dtype)
        logits = _lm_head(cfg, {"embedding": {"word": word_out}}, h,
                          "tensor").transpose(0, 1)
        return tpl.vocab_parallel_cross_entropy(logits, labels, 0.0,
                                                "tensor").mean()

    loss, glayers, dinputs = schedule(stage_fn_of(cfg), loss_fn, layers,
                                      emb.detach(), lab)
    if first:
        emb.backward(dinputs)
    word = word_in.grad if first else (
        word_out.grad if last else torch.zeros_like(word_in))
    word = sync_embedding_grads({"w": word})["w"]
    save(label, loss, {"layers": glayers, "word": word,
                       "position": pos.grad if first else None,
                       "final_ln_w": fw.grad if last else None,
                       "final_ln_b": fb.grad if last else None})

def vocab_form(label):
    # the table's rows split over (pipeline, tensor); the trunk through the
    # differentiable stream; the last stage's hidden summed to every rank
    cfg, full, shard, layers, tok, lab, rp, rt, pp, vpp = setup(label)
    layers = {k: v.clone().requires_grad_() for k, v in layers.items()}
    idx = rp * cfg.tensor_model_parallel_size + rt
    nsh = pp * cfg.tensor_model_parallel_size
    word = full["embedding"]["word"].chunk(nsh)[idx].clone().requires_grad_()
    pos = full["embedding"]["position"].clone().requires_grad_()
    fw = full["final_ln_w"].clone().requires_grad_()
    fb = full["final_ln_b"].clone().requires_grad_()
    n, b, s = tok.shape
    emb = torch.stack([(tpl.vocab_parallel_embedding(tok[m], word,
                                                     axis_name=PL_T)
                        + pos[:s][None]).to(cfg.compute_dtype).transpose(0, 1)
                       for m in range(n)])
    outs = pipeline_rounds(stage_fn_of(cfg), layers, emb, "pipeline", True,
                           num_chunks=vpp)
    # the last stage's hidden (every tensor rank holds it) summed over the
    # pipeline to every stage; the copy sums the ranks' partial cotangents
    # over (pipeline, tensor) in the backward, so every rank of the last
    # stage backpropagates the whole cotangent of its replicated output
    y = outs if rp == pp - 1 else outs * 0.0
    y = tpl.copy_to_tensor_model_parallel_region(
        tpl.reduce_from_tensor_model_parallel_region(y, "pipeline"), PL_T)
    h = ln_fp32(y, fw, fb, cfg.layernorm_epsilon).to(cfg.compute_dtype)
    logits = lm_head(h, word).permute(0, 2, 1, 3)  # [n, b, s, v / (pp tp)]
    loss = tpl.vocab_parallel_cross_entropy(logits, lab, 0.0, PL_T).mean()
    loss.backward()
    syn = sync_grads_by_spec({"w": fw.grad, "b": fb.grad},
                             {"w": (), "b": ()}, PL_T)
    save(label, loss, {"layers": {k: v.grad for k, v in layers.items()},
                       "word": word.grad, "position": pos.grad,
                       "final_ln_w": syn["w"], "final_ln_b": syn["b"]})

ps.initialize_model_parallel(2, 2)
reference_form("ref_1f1b", pipeline_forward_backward_1f1b)
vocab_form("vocab_rounds")
ps.destroy_model_parallel()

ps.initialize_model_parallel(1, 4, 2)
fb_fn = get_forward_backward_func()
res["dispatch_interleaved"] = np.array(
    fb_fn.__name__ == "pipeline_forward_backward_interleaved")
reference_form("ref_interleaved", fb_fn)
reference_form("ref_1f1b_vpp2", lambda *a: pipeline_forward_backward_1f1b(
    *a, num_chunks=2))
vocab_form("vocab_interleaved")
ps.destroy_model_parallel()
dist.destroy_process_group()
np.savez(f"{out}/rank{rank}.npz", **res)
"""


def _gpt_params(seed: int, layers: int):
    rng = np.random.default_rng(seed)
    L, f = layers, 4 * H

    def n(*shape, s=0.02, mean=0.0):
        return (mean + s * rng.normal(size=shape)).astype(np.float32)

    return {
        "embedding": {"word": n(V, H), "position": n(S, H)},
        "layers": {
            "input_ln_w": n(L, H, s=0.1, mean=1.0), "input_ln_b": n(L, H),
            "qkv_w": n(L, 3 * H, H), "qkv_b": n(L, 3 * H),
            "proj_w": n(L, H, H), "proj_b": n(L, H),
            "post_ln_w": n(L, H, s=0.1, mean=1.0), "post_ln_b": n(L, H),
            "fc1_w": n(L, f, H), "fc1_b": n(L, f),
            "fc2_w": n(L, H, f), "fc2_b": n(L, H),
        },
        "final_ln_w": n(H, s=0.1, mean=1.0), "final_ln_b": n(H),
    }


GPT = dict(hidden_size=H, num_attention_heads=HEADS, vocab_size=V,
           max_position_embeddings=S, hidden_dropout=0.0,
           attention_dropout=0.0)


def _inputs():
    rng = np.random.default_rng(21)
    tokens = rng.integers(0, V, size=(N_MICRO, MBS, S)).astype(np.int64)
    out = {"tokens": tokens, "labels": np.roll(tokens, -1, axis=2)}
    for layers in (4, 8):
        for k, v in flat(_gpt_params(layers, layers)).items():
            out[f"params{layers}/{k}"] = v
    return out


ARR = _inputs()


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    return spawn_world(tmp_path_factory.mktemp("gloo_pp_gpt"), _WORKER, ARR,
                       {"gpt": GPT, "cases": CASES})


_DENSE = {}


def _dense(layers):
    """The JAX dense loss and gradients on the whole batch."""
    if layers not in _DENSE:
        cfg = JGPTConfig(**GPT, num_layers=layers)
        params = jax.tree_util.tree_map(jnp.asarray,
                                        _gpt_params(layers, layers))
        tok = jnp.asarray(ARR["tokens"].reshape(-1, S))
        lab = jnp.asarray(ARR["labels"].reshape(-1, S))
        loss, grads = jax.jit(jax.value_and_grad(
            lambda p: jgpt_loss(cfg, p, tok, lab)))(params)
        _DENSE[layers] = (float(loss), jax.tree_util.tree_map(np.asarray,
                                                              grads))
    return _DENSE[layers]


def _coords(r, tp):
    return r // tp, r % tp  # (pipeline stage, tensor rank)


def _tp_cut(g, dim, tp, rt):
    return g if dim is None or tp == 1 else np.split(g, tp, dim)[rt]


_TP_DIMS = {"input_ln_w": None, "input_ln_b": None, "qkv_w": 1, "qkv_b": 1,
            "proj_w": 2, "proj_b": None, "post_ln_w": None,
            "post_ln_b": None, "fc1_w": 1, "fc1_b": 1, "fc2_w": 2,
            "fc2_b": None}


def _stage_cut(g, layers, pp, vpp, rp):
    block = layers // (pp * vpp)
    chunks = [g[(c * pp + rp) * block:(c * pp + rp + 1) * block]
              for c in range(vpp)]
    return chunks[0] if vpp == 1 else np.stack(chunks)


@pytest.mark.parametrize("label", ["ref_1f1b", "ref_interleaved",
                                   "ref_1f1b_vpp2"])
def test_reference_tied_form_matches_jax(world, label):
    layers, tp, pp, vpp = CASES[label]
    loss, grads = _dense(layers)
    for r in range(4):
        rp, rt = _coords(r, tp)
        got = world[r]
        np.testing.assert_allclose(float(got[label + "/loss"]), loss,
                                   rtol=LOSS_RTOL)
        for k, dim in _TP_DIMS.items():
            want = _stage_cut(_tp_cut(grads["layers"][k], dim, tp, rt),
                              layers, pp, vpp, rp)
            np.testing.assert_allclose(got[f"{label}/layers/{k}"], want,
                                       atol=GRAD_ATOL, err_msg=f"{k} {r}")
        word = _tp_cut(grads["embedding"]["word"], 0, tp, rt)
        np.testing.assert_allclose(got[label + "/word"], word,
                                   atol=GRAD_ATOL)
        if rp == 0:
            np.testing.assert_allclose(got[label + "/position"],
                                       grads["embedding"]["position"],
                                       atol=GRAD_ATOL)
        if rp == pp - 1:
            for k in ("final_ln_w", "final_ln_b"):
                np.testing.assert_allclose(got[f"{label}/{k}"], grads[k],
                                           atol=GRAD_ATOL)


@pytest.mark.parametrize("label", ["vocab_rounds", "vocab_interleaved"])
def test_vocab_sharded_tied_form_matches_jax(world, label):
    layers, tp, pp, vpp = CASES[label]
    loss, grads = _dense(layers)
    word = np.split(grads["embedding"]["word"], pp * tp, 0)
    for r in range(4):
        rp, rt = _coords(r, tp)
        got = world[r]
        np.testing.assert_allclose(float(got[label + "/loss"]), loss,
                                   rtol=LOSS_RTOL)
        np.testing.assert_allclose(got[label + "/word"], word[rp * tp + rt],
                                   atol=GRAD_ATOL)
        for k, dim in _TP_DIMS.items():
            want = _stage_cut(_tp_cut(grads["layers"][k], dim, tp, rt),
                              layers, pp, vpp, rp)
            np.testing.assert_allclose(got[f"{label}/layers/{k}"], want,
                                       atol=GRAD_ATOL, err_msg=f"{k} {r}")
        np.testing.assert_allclose(got[label + "/position"],
                                   grads["embedding"]["position"],
                                   atol=GRAD_ATOL)
        for k in ("final_ln_w", "final_ln_b"):
            np.testing.assert_allclose(got[f"{label}/{k}"], grads[k],
                                       atol=GRAD_ATOL)


def test_get_forward_backward_func_picks_interleaved(world):
    for r in range(4):
        assert bool(world[r]["dispatch_interleaved"])


@pytest.mark.parametrize("pp,vpp", [(2, 1), (4, 1), (4, 2), (2, 2)])
def test_pipeline_stage_layers_reference_layout(pp, vpp):
    """Chunk ``c`` of stage ``s`` holds global layer block ``c * pp + s``;
    the stages' chunks together are every layer once."""
    import torch

    from apex_tpu_torch.transformer.testing import (
        GPTConfig,
        pipeline_stage_layers,
    )

    cfg = GPTConfig(num_layers=8)
    layers = {"w": torch.arange(8).float()[:, None].expand(8, 3)}
    seen = []
    block = 8 // (pp * vpp)
    for s in range(pp):
        got = pipeline_stage_layers(layers, cfg, s, pp, vpp)["w"]
        chunks = [got] if vpp == 1 else list(got)
        for c, ch in enumerate(chunks):
            want = [(c * pp + s) * block + i for i in range(block)]
            assert ch[:, 0].tolist() == want
            seen += want
    assert sorted(seen) == list(range(8))
    with pytest.raises(ValueError, match="divisible"):
        pipeline_stage_layers(layers, GPTConfig(num_layers=6), 0, 4, 1)
