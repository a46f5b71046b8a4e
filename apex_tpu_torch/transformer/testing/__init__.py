"""Test and benchmark harness (counterpart of
``apex_tpu/transformer/testing``): the standalone GPT and BERT, the
argument parser, the global variables, the shared fixtures and the
distributed test base."""
from .commons import (  # noqa: F401
    TEST_SUCCESS_MESSAGE,
    initialize_distributed,
    print_separator,
    set_random_seed,
)
from .distributed_test_base import (  # noqa: F401
    DistributedTestBase,
    NcclDistributedTestBase,
    UccDistributedTestBase,
)
from .standalone_bert import bert_model_provider  # noqa: F401
from .standalone_gpt import gpt_model_provider  # noqa: F401
from .standalone_transformer_lm import (  # noqa: F401
    FP8_GEMM_NAMES,
    GPTConfig,
    bert_forward,
    gpt_embed,
    gpt_forward,
    gpt_hidden,
    gpt_loss,
    gpt_partition_specs,
    init_gpt_fp8_carriers,
    init_gpt_fp8_states,
    init_gpt_params,
    parallel_attention,
    parallel_mlp,
    pipeline_stage_layers,
    record_gpt_grad_amaxes,
    shard_gpt_params,
    transformer_block,
    transformer_layer,
)
