"""`tpu_dist_torch.serve` — the continuous-batching decode server.

The counterpart of `tpu_dist.serve`: a paged KV cache (`paged_kv`: blocks
of a preallocated pool, per-request block tables, the same tokens as the
dense `TransformerLM.apply_cached` decode), the continuous-batching engine
(`engine`: admission and eviction every step, chunked prefill beside
decode), sampling at runtime parameters (`sampling`: per call and per slot,
the noise an input), and a request front end (`server`).
"""

from tpu_dist_torch.serve.engine import (
    Request,
    RequestResult,
    SamplingParams,
    ServeConfig,
    ServeEngine,
)
from tpu_dist_torch.serve.paged_kv import BlockAllocator, init_paged_cache, paged_apply_cached
from tpu_dist_torch.serve.sampling import (
    generate_runtime,
    gumbel,
    sample_logits,
    sample_slots,
    slot_noise,
)
from tpu_dist_torch.serve.server import LMServer

__all__ = [
    "BlockAllocator",
    "LMServer",
    "Request",
    "RequestResult",
    "SamplingParams",
    "ServeConfig",
    "ServeEngine",
    "generate_runtime",
    "gumbel",
    "init_paged_cache",
    "paged_apply_cached",
    "sample_logits",
    "sample_slots",
    "slot_noise",
]
