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
    init_gpt_fp8_carriers,
    init_gpt_fp8_states,
    init_gpt_params,
    parallel_attention,
    parallel_mlp,
    record_gpt_grad_amaxes,
    transformer_block,
    transformer_layer,
)
