"""The single-process parts of the tensor-parallel slice against the JAX
package: the batch samplers (``tests/test_data_samplers.py``), the
microbatch calculators, ``arguments`` / ``global_vars`` and
``DistributedTestBase`` (``tests/test_standalone_models.py``), the RNG
tracker, checkpointing, ``MemoryBuffer`` and the utilities
(``tests/test_tensor_parallel.py``), and the tensor-parallel functions at
world 1 (no process group: every collective is the identity, as the JAX
functions are over an axis of one device): the layers, the fp8 route of
the parallel linears and its amax-group check, the GPT's and BERT's
``axis_name`` path against their dense forms.

The samplers and calculators are pure Python on both sides and are held
index for index and number for number; the parser's namespaces key for
key.
"""
import dataclasses
import unittest

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.transformer import microbatches as jmb
from apex_tpu.transformer._data import (
    MegatronPretrainingRandomSampler as JRandom,
    MegatronPretrainingSampler as JSeq,
)
from apex_tpu.transformer.testing.arguments import parse_args as jparse
from apex_tpu_torch._tree import tree_leaves
from apex_tpu_torch.transformer import microbatches as tmb
from apex_tpu_torch.transformer import parallel_state
from apex_tpu_torch.transformer import tensor_parallel as tp
from apex_tpu_torch.transformer._data import (
    MegatronPretrainingRandomSampler as TRandom,
    MegatronPretrainingSampler as TSeq,
)
from apex_tpu_torch.transformer.testing import (
    TEST_SUCCESS_MESSAGE,
    DistributedTestBase,
    NcclDistributedTestBase,
    UccDistributedTestBase,
    print_separator,
    set_random_seed,
)
from apex_tpu_torch.transformer.testing.arguments import parse_args

# --- the samplers -----------------------------------------------------------

#: (total, consumed, local, rank, dp, drop_last)
SEQ_CASES = [(32, 0, 4, 0, 2, True), (32, 0, 4, 1, 2, True),
             (64, 24, 4, 0, 2, True), (10, 0, 4, 0, 1, True),
             (10, 0, 4, 0, 1, False), (10, 0, 4, 1, 2, False),
             (10, 0, 4, 0, 2, False), (100, 7, 3, 2, 3, False),
             (33, 5, 2, 1, 4, True)]
#: (total, consumed, local, rank, dp)
RANDOM_CASES = [(64, 0, 4, 0, 2), (64, 0, 4, 1, 2), (64, 16, 4, 0, 2),
                (64, 64, 4, 0, 2), (100, 30, 3, 2, 3), (61, 200, 5, 1, 2)]


@pytest.mark.parametrize("case", SEQ_CASES)
def test_sequential_sampler_indices_equal_jax(case):
    total, consumed, local, rank, dp, drop = case
    j = JSeq(total, consumed, local, rank, dp, drop_last=drop)
    t = TSeq(total, consumed, local, rank, dp, drop_last=drop)
    assert list(t) == list(j) and len(t) == len(j)


@pytest.mark.parametrize("case", RANDOM_CASES)
def test_random_sampler_indices_equal_jax(case):
    j, t = JRandom(*case), TRandom(*case)
    assert list(t) == list(j)
    assert t.consumed_samples == j.consumed_samples
    assert t.epoch == j.epoch


def test_sequential_sampler_semantics():
    per_rank = [list(TSeq(32, 0, 4, r, 2)) for r in range(2)]
    assert per_rank[0][0] == [0, 1, 2, 3] and per_rank[1][0] == [4, 5, 6, 7]
    assert sorted(i for b in per_rank for x in b for i in x) == \
        list(range(32))
    full = list(TSeq(64, 0, 4, 0, 2))
    assert list(TSeq(64, 24, 4, 0, 2)) == full[3:]
    assert list(TSeq(10, 0, 4, 0, 1, drop_last=False))[-1] == [8, 9]
    assert [list(TSeq(10, 0, 4, r, 2, drop_last=False))[-1]
            for r in range(2)] == [[8], [9]]
    s = TSeq(32, 0, 2, 0, 2)
    s.local_minibatch_size = 4
    assert s.local_minibatch_times_data_parallel_size == 8
    assert list(s)[0] == [0, 1, 2, 3]
    for bad in ((0, 0, 4, 0, 1), (8, 8, 4, 0, 1), (8, 0, 4, 2, 2)):
        with pytest.raises(RuntimeError):
            TSeq(*bad)


def test_random_sampler_semantics():
    r0 = {i for b in TRandom(64, 0, 4, 0, 2) for i in b}
    r1 = {i for b in TRandom(64, 0, 4, 1, 2) for i in b}
    assert not (r0 & r1) and r0 | r1 == set(range(64))
    full = list(TRandom(64, 0, 4, 0, 2))
    assert list(TRandom(64, 16, 4, 0, 2)) == full[2:]
    assert list(TRandom(64, 64, 4, 0, 2)) != full
    s = TRandom(64, 0, 4, 0, 2)
    assert s.consumed_samples == 0 and len(list(s)) * 8 == s.consumed_samples
    s.local_minibatch_size = 3
    assert s.last_batch_size == 64 % 6
    s2 = TRandom(64, 60, 4, 0, 2)
    s2.local_minibatch_size = 3
    assert len(list(s2)) > 0
    for bad in ((0, 0, 4, 0, 1), (8, 0, 0, 0, 1), (8, 0, 4, 2, 2),
                (6, 0, 4, 0, 2)):
        with pytest.raises(ValueError):
            TRandom(*bad)


# --- the microbatch calculators ---------------------------------------------

@pytest.mark.parametrize("rampup", [None, [4, 4, 100], [8, 8, 64],
                                    [16, 16, 0]])
def test_microbatch_calculators_equal_jax(rampup, capsys):
    j = jmb.build_num_microbatches_calculator(0, rampup, 32, 2, 2)
    t = tmb.build_num_microbatches_calculator(0, rampup, 32, 2, 2)
    assert type(t).__name__ == type(j).__name__
    for consumed in (0, 1, 17, 33, 50, 63, 64, 65, 100, 1000):
        for calc in (j, t):
            calc.update(consumed, consistency_check=False)
        assert (t.get(), t.get_current_global_batch_size()) == \
            (j.get(), j.get_current_global_batch_size()), consumed
    out = capsys.readouterr().out.splitlines()
    assert out[0] == out[1]


def test_microbatch_calculator_checks():
    for mod in (jmb, tmb):
        with pytest.raises(ValueError):
            mod.ConstantNumMicroBatches(10, 4, 2)
        with pytest.raises(ValueError):
            mod.build_num_microbatches_calculator(1, [4, 4], 32, 2, 2)
        with pytest.raises(ValueError):
            mod.RampupBatchsizeNumMicroBatches(4, 3, 10, 32, 2, 2)
        calc = mod.RampupBatchsizeNumMicroBatches(4, 4, 100, 32, 2, 2)
        calc.update(10, consistency_check=True)
        assert calc.get() == 1


# --- arguments, global_vars, the test base ----------------------------------

ARG_LINES = [
    ["--num-layers", "4", "--hidden-size", "64", "--num-attention-heads",
     "4", "--seq-length", "32", "--max-position-embeddings", "32",
     "--micro-batch-size", "2", "--global-batch-size", "16",
     "--tensor-model-parallel-size", "2", "--bf16", "--world-size", "8"],
    ["--hidden-size", "96", "--num-attention-heads", "6", "--fp16",
     "--world-size", "4", "--checkpoint-activations", "--local_rank", "3",
     "--rampup-batch-size", "2", "2", "100", "--sequence-parallel"],
    ["--hidden-size", "64", "--num-attention-heads", "4", "--world-size",
     "12", "--pipeline-model-parallel-size", "4",
     "--num-layers-per-virtual-pipeline-stage", "1", "--num-layers", "8",
     "--recompute-activations", "--sequence-parallel",
     "--tensor-model-parallel-size", "3"],
]


@pytest.mark.parametrize("line", range(len(ARG_LINES)))
def test_arguments_equal_jax(line):
    j, t = vars(jparse(args=ARG_LINES[line])), vars(parse_args(
        args=ARG_LINES[line]))
    assert j.pop("distributed_backend") == "xla"
    assert t.pop("distributed_backend") == "nccl"
    assert t == j


def test_arguments_parse_and_validate():
    args = parse_args(args=ARG_LINES[0])
    assert (args.data_parallel_size, args.params_dtype, args.ffn_hidden_size,
            args.kv_channels) == (4, "bfloat16", 256, 16)
    for bad in (["--hidden-size", "64", "--num-attention-heads", "4",
                 "--fp16", "--bf16", "--world-size", "8"],
                ["--hidden-size", "64", "--num-attention-heads", "4",
                 "--tensor-model-parallel-size", "3", "--world-size", "8"],
                ["--batch-size", "4"]):
        with pytest.raises(ValueError):
            parse_args(args=bad)
    # the world defaults to the process group's: one process here
    assert parse_args(args=["--hidden-size", "8", "--num-attention-heads",
                            "2"]).world_size == 1


def test_global_vars_lifecycle():
    from apex_tpu_torch.transformer.testing import global_vars as gv

    gv.destroy_global_vars()
    args = gv.set_global_variables(override_args=[
        "--hidden-size", "64", "--num-attention-heads", "4",
        "--micro-batch-size", "2", "--global-batch-size", "8",
        "--world-size", "2"])
    assert gv.get_args() is args
    assert gv.get_num_microbatches() == 2
    assert gv.get_current_global_batch_size() == 8
    timers = gv.get_timers()
    timers("step").start()
    timers("step").stop(barrier_on=torch.zeros(1))
    assert timers("step").elapsed() >= 0
    assert timers.log(["step"]).startswith("time (ms) | step:")
    with pytest.raises(RuntimeError):
        gv.set_global_variables(override_args=[])
    gv.destroy_global_vars()
    with pytest.raises(RuntimeError):
        gv.get_args()


def test_distributed_test_base():
    class MyTest(DistributedTestBase):
        MAX_WORLD_SIZE = 4

        def test_world(self):
            assert self.world_size == 1
            self.initialize_model_parallel(tp=1, pp=1)
            assert parallel_state.get_tensor_model_parallel_world_size() == 1
            assert parallel_state.model_parallel_is_initialized()

    suite = unittest.TestLoader().loadTestsFromTestCase(MyTest)
    result = unittest.TextTestRunner(verbosity=0).run(suite)
    assert result.wasSuccessful()
    assert not parallel_state.model_parallel_is_initialized()
    assert NcclDistributedTestBase is UccDistributedTestBase is \
        DistributedTestBase
    assert TEST_SUCCESS_MESSAGE == ">> passed the test :-)"


def test_commons(capsys):
    g = set_random_seed(5)
    assert isinstance(g, torch.Generator) and g.initial_seed() == 5
    a = np.random.rand()
    set_random_seed(5)
    assert np.random.rand() == a
    assert "model-parallel-rng" in tp.get_rng_state_tracker().states_
    print_separator("hello")
    assert " hello " in capsys.readouterr().out


# --- the RNG tracker and checkpointing --------------------------------------

def test_rng_tracker_fork_and_seed():
    tp.model_parallel_manual_seed(123)
    tracker = tp.get_rng_state_tracker()
    assert tracker is tp.get_cuda_rng_tracker()
    with tracker.fork() as g1:
        a = torch.rand(4, generator=g1)
    with tracker.fork() as g2:
        b = torch.rand(4, generator=g2)
    assert not torch.equal(a, b)
    with pytest.raises(Exception):
        tracker.add("model-parallel-rng", 99)
    with pytest.raises(Exception):
        tracker.add("other", 123)  # the default stream's seed
    with pytest.raises(Exception):
        tracker.fork("missing").__enter__()
    states = tracker.get_states()
    with tracker.fork() as g3:
        c = torch.rand(4, generator=g3)
    tracker.set_states(states)
    with tracker.fork() as g4:
        assert torch.equal(torch.rand(4, generator=g4), c)
    tracker.reset()
    assert tracker.get_states() == {}


def test_model_parallel_seed_offset():
    """``model-parallel-rng`` is seeded ``seed + 2718 + tp_rank`` (rank 0
    at world 1), ``default`` with ``seed``."""
    tp.model_parallel_manual_seed(7)
    st = tp.get_rng_state_tracker().states_
    assert st["model-parallel-rng"].initial_seed() == 7 + 2718
    assert st["default"].initial_seed() == 7


def test_model_parallel_rng_key_forms():
    """A seed gives a seed, a generator a generator; the rank folds in
    (rank 0 here), and equal inputs give equal streams."""
    assert tp.model_parallel_rng_key(5) == tp.model_parallel_rng_key(5)
    assert tp.model_parallel_rng_key(5) != tp.model_parallel_rng_key(6)
    from apex_tpu_torch.transformer.tensor_parallel.random import fold_in

    assert len({fold_in(9, r) for r in range(8)}) == 8
    g = tp.model_parallel_rng_key(torch.Generator().manual_seed(3))
    h = tp.model_parallel_rng_key(torch.Generator().manual_seed(3))
    assert torch.equal(torch.rand(3, generator=g), torch.rand(3, generator=h))


def test_checkpoint_matches_plain_and_replays_the_tracker():
    """The JAX test's function, and a dropout drawn from the tracker's
    fork inside the checkpointed function: the replay draws the same
    mask, so the gradient equals the plain one."""
    def f(x):
        return torch.sum(torch.tanh(x) ** 2)

    x = torch.from_numpy(np.array(jax.random.normal(
        jax.random.PRNGKey(16), (8,)))).requires_grad_(True)
    jx = jnp.asarray(x.detach().numpy())
    jf = lambda v: jnp.sum(jnp.tanh(v) ** 2)  # noqa: E731
    out = tp.checkpoint(f, False, x)
    out.backward()
    np.testing.assert_allclose(float(out.detach()), float(jf(jx)), rtol=1e-6)
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(jax.grad(jf)(jx)),
                               atol=1e-6)

    def drop(v):
        with tp.get_rng_state_tracker().fork() as g:
            keep = torch.rand(v.shape, generator=g) > 0.5
        return torch.sum(torch.where(keep, v, 0.0) ** 2)

    tp.model_parallel_manual_seed(3)
    v = torch.randn(64, requires_grad=True)
    loss = tp.CheckpointFunction.apply(drop, False, v)
    loss.backward()
    tp.model_parallel_manual_seed(3)
    v2 = v.detach().clone().requires_grad_(True)
    drop(v2).backward()
    torch.testing.assert_close(v.grad, v2.grad, rtol=0, atol=0)


# --- buffers and utilities --------------------------------------------------

def test_memory_buffer():
    buf = tp.MemoryBuffer("test", 32, torch.float32, track_usage=True,
                          device="cpu")
    t = buf.get((4, 4), 0)
    assert t.shape == (4, 4)
    t.fill_(2.0)  # a view: the buffer sees it
    assert float(buf.data[:16].sum()) == 32.0 and buf.get_in_use() == 16.0
    buf.zero()
    assert float(buf.data.abs().sum()) == 0.0
    with pytest.raises(ValueError):
        buf.get((33,), 0)
    ring = tp.RingMemBuffer("ring", 2, 16, torch.float32, device="cpu")
    b1, b2, b3 = (ring.get_next_buffer() for _ in range(3))
    assert b1 is b3 and b1 is not b2


def test_utils():
    with pytest.raises(ValueError):
        tp.ensure_divisibility(7, 2)
    assert tp.divide(12, 4) == 3
    parts = tp.split_tensor_along_last_dim(torch.ones(2, 8), 4, True)
    assert len(parts) == 4 and parts[0].shape == (2, 2) and \
        parts[0].is_contiguous()
    assert tp.VocabUtility.vocab_range_from_global_vocab_size(64, 3, 8) == \
        (24, 32)


def test_world_one_without_a_process_group():
    """No process group: the collectives are the identity and the layers
    the dense math (the JAX functions on one device)."""
    x = torch.randn(4, 6)
    for fn in (tp.copy_to_tensor_model_parallel_region,
               tp.reduce_from_tensor_model_parallel_region,
               tp.scatter_to_tensor_model_parallel_region,
               tp.gather_from_tensor_model_parallel_region,
               tp.scatter_to_sequence_parallel_region,
               tp.gather_from_sequence_parallel_region,
               tp.reduce_scatter_to_sequence_parallel_region):
        assert fn(x) is x
    w, b = torch.randn(5, 6), torch.randn(5)
    y, out_b, st = tp.column_parallel_linear(x, w, b, skip_bias_add=True)
    torch.testing.assert_close(y, x @ w.t())
    assert out_b is b and st is None
    y, _, _ = tp.row_parallel_linear(x, w, b)
    torch.testing.assert_close(y, x @ w.t() + b)
    mod = tp.ColumnParallelLinear(6, 5, device="cpu",
                                  generator=torch.Generator().manual_seed(0))
    assert mod.weight.shape == (5, 6) and mod(x)[0].shape == (4, 5)
    row = tp.RowParallelLinear(6, 5, device="cpu")
    assert row(x)[0].shape == (4, 5)
    emb = tp.VocabParallelEmbedding(10, 3, device="cpu")
    ids = torch.tensor([[1, 9]])
    torch.testing.assert_close(emb(ids), emb.weight[ids])
    assert tp.broadcast_data(["a"], {"a": x, "b": w})["a"] is x


def test_gpt_and_bert_axis_name_at_world_one():
    """Without a process group the tensor-parallel GPT is the dense one:
    the loss through the vocab-parallel cross entropy against the
    chunk-fused one and its gradients, the vocab-sharded logits (the whole
    vocab at one rank) against the dense forward's, BERT's MLM logits; a
    tensor size the world cannot hold raises."""
    from apex_tpu_torch._tree import value_and_grad
    from apex_tpu_torch.transformer.testing import (
        GPTConfig,
        bert_forward,
        gpt_forward,
        gpt_loss,
        init_gpt_params,
    )

    cfg = GPTConfig(num_layers=2, hidden_size=32, num_attention_heads=4,
                    vocab_size=64, max_position_embeddings=16,
                    hidden_dropout=0.0, attention_dropout=0.0)
    params = init_gpt_params(cfg, torch.Generator().manual_seed(2))
    g = torch.Generator().manual_seed(3)
    tokens = torch.randint(0, 64, (2, 16), generator=g)
    labels = torch.randint(0, 64, (2, 16), generator=g)
    dense, gd = value_and_grad(
        lambda p: gpt_loss(cfg, p, tokens, labels), params)
    tp1, gt = value_and_grad(
        lambda p: gpt_loss(cfg, p, tokens, labels, axis_name="tensor"),
        params)
    torch.testing.assert_close(tp1, dense, rtol=1e-6, atol=0)
    for a, b in zip(tree_leaves(gt), tree_leaves(gd)):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-6)
    torch.testing.assert_close(
        gpt_forward(cfg, params, tokens, axis_name="tensor"),
        gpt_forward(cfg, params, tokens), rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(
        bert_forward(cfg, params, tokens, axis_name="tensor")[0],
        bert_forward(cfg, params, tokens)[0], rtol=0, atol=0)
    with pytest.raises(ValueError, match="tensor_model_parallel_size"):
        gpt_loss(dataclasses.replace(cfg, tensor_model_parallel_size=2),
                 params, tokens, labels, axis_name="tensor")


def test_parallel_linears_fp8_route():
    """The fp8 route of the parallel linears is the fp8 recipe's dense
    projection on the shard (world 1: the whole weight), the rolled state
    included; under an initialised layout without the amax group it
    raises, as the reference asserts."""
    from apex_tpu_torch.fused_dense.fp8 import (
        fp8_fused_dense_qgrad,
        init_fp8_dense_state,
    )

    g = torch.Generator().manual_seed(4)
    x = torch.randn(8, 32, generator=g).to(torch.bfloat16)
    w = (torch.randn(48, 32, generator=g) * 0.1).to(torch.bfloat16)
    state = init_fp8_dense_state(4, with_grad_meta=True, device="cpu")
    carrier = torch.zeros(())
    want, want_state = fp8_fused_dense_qgrad(x, w, None, state, carrier)
    for fn, kw in ((tp.column_parallel_linear, {"gather_output": False}),
                   (tp.row_parallel_linear, {"input_is_parallel": True})):
        out, _, new = fn(x, w, None, fp8_state=state,
                         fp8_grad_carrier=carrier, **kw)
        torch.testing.assert_close(out, want.to(x.dtype), rtol=0, atol=0)
        for a, b in zip(tree_leaves(new), tree_leaves(want_state)):
            torch.testing.assert_close(a, b, rtol=0, atol=0)
    parallel_state.initialize_model_parallel(1)
    try:
        with pytest.raises(RuntimeError, match="amax reduction group"):
            tp.column_parallel_linear(x, w, None, fp8_state=state,
                                      fp8_grad_carrier=carrier)
    finally:
        parallel_state.destroy_model_parallel()
    parallel_state.initialize_model_parallel(1, use_fp8_=True)
    try:
        out, _, _ = tp.column_parallel_linear(
            x, w, None, fp8_state=state, fp8_grad_carrier=carrier,
            gather_output=False)
        torch.testing.assert_close(out, want.to(x.dtype), rtol=0, atol=0)
    finally:
        parallel_state.destroy_model_parallel()
