"""Synchronous data parallelism: replicas made equal at start, gradients
averaged after backward.

The JAX package averages gradients with one ``pmean`` over the parameter
tree, which XLA fuses into few AllReduces, and replicates one copy of the
parameters over the mesh at start.  Here the tensors are packed into one
flat bucket per dtype and moved with a single collective: one
``all_reduce`` per step for the gradients, one ``broadcast`` from rank 0
for the parameters and buffers, however many tensors the model has.
"""

from __future__ import annotations

from typing import Callable, Sequence

import torch
import torch.distributed as dist

from tpu_dist_torch.comm.collectives import ReduceOp, all_reduce


def _through_buckets(
    tensors: Sequence[torch.Tensor], collective: Callable[[torch.Tensor], object]
) -> None:
    """Pack ``tensors`` into one flat bucket per dtype, run ``collective``
    on each bucket in place, and copy the results back into the tensors."""
    by_dtype: dict[torch.dtype, list[torch.Tensor]] = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for group in by_dtype.values():
        flat = torch.cat([t.detach().reshape(-1) for t in group])
        collective(flat)
        offset = 0
        with torch.no_grad():
            for t in group:
                n = t.numel()
                t.copy_(flat[offset : offset + n].view_as(t))
                offset += n


def average_gradients(tensors: Sequence[torch.Tensor]) -> None:
    """Replace each tensor, in place, by its mean over all ranks.  The
    tensors share one device and dtype (gradients, and the step's loss
    riding in the same bucket)."""
    _through_buckets(tensors, lambda flat: all_reduce(flat, ReduceOp.AVG))


def broadcast_parameters(module: torch.nn.Module, src: int = 0) -> None:
    """Overwrite every parameter and buffer of ``module``, in place, with
    rank ``src``'s: replicas start equal however each rank built its
    module (the JAX trainers replicate one copy over the mesh)."""
    tensors = list(module.parameters()) + list(module.buffers())
    _through_buckets(tensors, lambda flat: dist.broadcast(flat, src))
