"""`tpu_dist_torch.resilience` — bounded retry for the bootstrap and the
launcher's typed failures, the NaN guard with the dynamic loss scale, and
preemption (the ports of `tpu_dist.resilience.retry`, ``guards`` and
``preempt``).

Chaos injection comes with resilience and observability (ROADMAP queue 1,
item 11).
"""

from tpu_dist_torch.resilience import guards, retry
from tpu_dist_torch.resilience.guards import bad_steps, loss_scale, nan_guard
from tpu_dist_torch.resilience.preempt import PreemptionGuard
from tpu_dist_torch.resilience.retry import (
    RendezvousTimeout,
    RetryPolicy,
    WorkerFailed,
    retry_call,
)

__all__ = [
    "PreemptionGuard",
    "RendezvousTimeout",
    "RetryPolicy",
    "WorkerFailed",
    "bad_steps",
    "guards",
    "loss_scale",
    "nan_guard",
    "retry",
    "retry_call",
]
