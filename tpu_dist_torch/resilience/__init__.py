"""`tpu_dist_torch.resilience` — bounded retry for the bootstrap and the
launcher's typed failures (the port of `tpu_dist.resilience.retry`).

Chaos injection, the NaN guard and preemption come with the resilience and
observability slice.
"""

from tpu_dist_torch.resilience import retry
from tpu_dist_torch.resilience.retry import (
    RendezvousTimeout,
    RetryPolicy,
    WorkerFailed,
    retry_call,
)

__all__ = ["RendezvousTimeout", "RetryPolicy", "WorkerFailed", "retry", "retry_call"]
