"""`tpu_dist_torch.parallel` — data parallelism and the ring collectives."""

from tpu_dist_torch.parallel.data_parallel import (
    accumulate_gradients,
    average_gradients,
    broadcast_parameters,
)
from tpu_dist_torch.parallel.ring import (
    pad_to_multiple,
    ring_all_gather,
    ring_all_reduce,
    ring_all_reduce_chunked,
    ring_reduce_scatter,
)

__all__ = [
    "accumulate_gradients",
    "average_gradients",
    "broadcast_parameters",
    "pad_to_multiple",
    "ring_all_gather",
    "ring_all_reduce",
    "ring_all_reduce_chunked",
    "ring_reduce_scatter",
]
