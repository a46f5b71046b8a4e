from .standalone_bert import bert_model_provider  # noqa: F401
from .standalone_transformer_lm import (  # noqa: F401
    GPTConfig,
    bert_forward,
    gpt_embed,
    gpt_forward,
    gpt_hidden,
    gpt_loss,
    init_gpt_params,
    parallel_attention,
    parallel_mlp,
    transformer_block,
    transformer_layer,
)
