"""apex_tpu_torch.serving: paged-KV decode engine + continuous batching
(counterpart of ``apex_tpu.serving``, single device): the engine and its
scheduler, the paged KV cache, carried sampling, speculative decoding,
and the robustness layer (typed lifecycle, admission control,
degradation, recovery). The replica fleets and their transport are not
ported yet."""
from .decode_model import (  # noqa: F401
    chunk_hidden,
    decode_tokens,
    lm_logits,
    prefill_chunk_tokens,
    reference_decode,
    reference_sample_decode,
)
from .engine import (  # noqa: F401
    NO_TOKEN,
    POISONED,
    ServingEngine,
    SlotState,
    default_page_size,
)
from .kv_cache import (  # noqa: F401
    KVCacheState,
    PageAllocator,
    PagedKVSpec,
    PrefixCache,
    page_table_row,
    write_chunk_kv,
    write_token_kv,
)
from .robustness import (  # noqa: F401
    TERMINAL_STATES,
    AdmissionConfig,
    AdmissionController,
    DegradationPolicy,
    RejectionCode,
    RejectionError,
    RejectionReason,
    RequestStatus,
    SchedulerError,
    TransientRequestFailure,
    VirtualClock,
    is_terminal,
    recover_requests,
)
from .sampling import (  # noqa: F401
    GREEDY,
    SamplingParams,
    sample_tokens,
)
from .scheduler import Request, RunningSlot, Scheduler  # noqa: F401
from .spec_decode import ngram_propose, run_spec_step  # noqa: F401

__all__ = [
    "AdmissionConfig", "AdmissionController", "DegradationPolicy",
    "GREEDY", "KVCacheState", "NO_TOKEN", "POISONED", "PageAllocator",
    "PagedKVSpec", "PrefixCache", "RejectionCode", "RejectionError",
    "RejectionReason", "Request", "RequestStatus", "RunningSlot",
    "SamplingParams", "Scheduler", "SchedulerError", "ServingEngine",
    "SlotState", "TERMINAL_STATES", "TransientRequestFailure",
    "VirtualClock", "chunk_hidden", "decode_tokens", "default_page_size",
    "is_terminal", "lm_logits", "ngram_propose", "page_table_row",
    "prefill_chunk_tokens", "recover_requests", "reference_decode",
    "reference_sample_decode", "run_spec_step", "sample_tokens",
    "write_chunk_kv", "write_token_kv",
]
