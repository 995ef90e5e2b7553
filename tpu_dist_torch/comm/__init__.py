"""`tpu_dist_torch.comm` — process group, collectives and the SPMD runner."""

from tpu_dist_torch.comm.collectives import (
    ReduceOp,
    all_reduce,
    barrier,
    rank,
    ring_perm,
    send,
    sendrecv,
    shift,
    world_size,
)
from tpu_dist_torch.comm.init import (
    BackendChoice,
    choose_backend,
    destroy_process_group,
    init_process_group,
)
from tpu_dist_torch.comm.runner import spmd

__all__ = [
    "BackendChoice",
    "ReduceOp",
    "all_reduce",
    "barrier",
    "choose_backend",
    "destroy_process_group",
    "init_process_group",
    "rank",
    "ring_perm",
    "send",
    "sendrecv",
    "shift",
    "spmd",
    "world_size",
]
