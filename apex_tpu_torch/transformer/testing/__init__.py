from .standalone_transformer_lm import (  # noqa: F401
    GPTConfig,
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
