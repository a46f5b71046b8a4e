"""The tensor-parallel layer library (counterpart of
``apex_tpu/transformer/tensor_parallel``): the collectives with their
backward duals, the parallel linears and embedding, the vocab-parallel
cross entropy, the model-parallel random streams and checkpointing, the
batch broadcast, the activation buffers and the fp32 ``main_grad``
accumulation, over ``torch.distributed`` process groups (a rank is a
process)."""
from .cross_entropy import vocab_parallel_cross_entropy  # noqa: F401
from .data import broadcast_data  # noqa: F401
from .mappings import (  # noqa: F401
    copy_to_tensor_model_parallel_region,
    gather_from_sequence_parallel_region,
    gather_from_tensor_model_parallel_region,
    reduce_from_tensor_model_parallel_region,
    reduce_scatter_to_sequence_parallel_region,
    scatter_to_sequence_parallel_region,
    scatter_to_tensor_model_parallel_region,
)
from .memory import MemoryBuffer, RingMemBuffer  # noqa: F401
from .random import (  # noqa: F401
    CheckpointFunction,
    RngStateTracker,
    checkpoint,
    get_cuda_rng_tracker,
    get_rng_state_tracker,
    model_parallel_cuda_manual_seed,
    model_parallel_manual_seed,
    model_parallel_rng_key,
)
from .layers import (  # noqa: F401
    ColumnParallelLinear,
    RowParallelLinear,
    VocabParallelEmbedding,
    column_parallel_linear,
    init_affine_weight_shard,
    row_parallel_linear,
    vocab_parallel_embedding,
)
from .grad_accumulation import (  # noqa: F401
    accumulate_main_grads,
    init_main_grads,
    wgrad_gemm_accum_fp16,
    wgrad_gemm_accum_fp32,
)
from .utils import (  # noqa: F401
    VocabUtility,
    divide,
    ensure_divisibility,
    split_tensor_along_last_dim,
)
