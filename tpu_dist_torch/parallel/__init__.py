"""`tpu_dist_torch.parallel` — data parallelism, the ring collectives,
expert parallelism and sequence parallelism (the K/V ring and Ulysses)."""

from tpu_dist_torch.parallel.data_parallel import (
    accumulate_gradients,
    average_gradients,
    broadcast_parameters,
)
from tpu_dist_torch.parallel.moe import (
    capacity_for,
    moe_mlp,
    moe_mlp_expert_choice,
    moe_mlp_top2,
    stack_expert_params,
)
from tpu_dist_torch.parallel.ring import (
    pad_to_multiple,
    ring_all_gather,
    ring_all_reduce,
    ring_all_reduce_chunked,
    ring_reduce_scatter,
)
from tpu_dist_torch.parallel.ring_attention import ring_attention, ring_attention_flash
from tpu_dist_torch.parallel.ulysses import ulysses_attention

__all__ = [
    "accumulate_gradients",
    "average_gradients",
    "broadcast_parameters",
    "capacity_for",
    "moe_mlp",
    "moe_mlp_expert_choice",
    "moe_mlp_top2",
    "pad_to_multiple",
    "ring_all_gather",
    "ring_all_reduce",
    "ring_all_reduce_chunked",
    "ring_attention",
    "ring_attention_flash",
    "ring_reduce_scatter",
    "stack_expert_params",
    "ulysses_attention",
]
