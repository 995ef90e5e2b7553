"""Synchronous data parallelism: replicas made equal at start, gradients
averaged after backward.

The JAX package averages gradients with one ``pmean`` over the parameter
tree, which XLA fuses into few AllReduces, and replicates one copy of the
parameters over the mesh at start.  Here the tensors are packed into one
flat bucket per dtype and moved with a single collective: one
``all_reduce`` per step for the gradients (``backend="psum"``), one
``broadcast`` from rank 0 for the parameters and buffers, however many
tensors the model has.  ``backend="ring"`` takes the hand-rolled ring
instead, one call per tensor, as the JAX package maps its ring over each
leaf: the ring kernel on the card (`ops.ring_all_reduce_pallas`), the
chunked ring on the CPU.

`accumulate_gradients` is the backward of one step, with gradient
accumulation over microbatches and the guard's loss scale
(tpu_dist/parallel/data_parallel.py:140-187, 253-288); the microbatches
run in order, so a model's batch-norm statistics thread through them as
the JAX scan carries its state.
"""

from __future__ import annotations

from typing import Callable, Sequence

import torch

from tpu_dist_torch.comm.collectives import ReduceOp, all_reduce, broadcast, world_size


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


def check_backend(backend: str) -> None:
    """Raise unless `average_gradients` takes ``backend``."""
    if backend in ("int8", "fp8", "bf16"):
        raise NotImplementedError(
            f"grad-reduce backend {backend!r} is not ported yet: it comes with "
            "comm/compress.py, ROADMAP queue 1 item 10")
    if backend not in ("psum", "ring"):
        raise ValueError(f"unknown grad-reduce backend {backend!r}")


def average_gradients(
    tensors: Sequence[torch.Tensor],
    *,
    backend: str = "psum",
    state: Sequence[torch.Tensor] = (),
) -> None:
    """Replace each tensor, in place, by its mean over all ranks
    (train_dist.py:94-100): gradients, and the step's loss riding along.

    ``backend``: ``"psum"``, one flat all-reduce per dtype (the default);
    ``"ring"``, ``ring_all_reduce_pallas(t) / n`` for each tensor, which
    on a CUDA tensor is one launch of the ring kernel (enqueued on the
    current stream, no host sync) and on a CPU tensor the chunked ring.
    The compressed backends ``"int8"``, ``"fp8"`` and ``"bf16"`` come with
    `comm/compress.py` (ROADMAP queue 1, item 10).

    ``state``: the model's floating buffers (batch-norm statistics), also
    replaced by their mean over ranks whatever the backend, as the JAX
    step pmeans its new state's floating leaves
    (tpu_dist/parallel/data_parallel.py:129-135).  Under ``"psum"`` they
    share the gradients' flat all-reduce; under ``"ring"`` they take one
    flat all-reduce of their own."""
    check_backend(backend)
    if backend == "psum":
        _through_buckets([*tensors, *state], lambda flat: all_reduce(flat, ReduceOp.AVG))
        return
    if state:
        _through_buckets(state, lambda flat: all_reduce(flat, ReduceOp.AVG))
    # imported here: ops.pallas_ring imports this package's ring module
    from tpu_dist_torch.ops.pallas_ring import ring_all_reduce_pallas

    n = world_size()
    with torch.no_grad():
        for t in tensors:
            t.copy_(ring_all_reduce_pallas(t) / n)


def broadcast_parameters(module: torch.nn.Module, src: int = 0) -> None:
    """Overwrite every parameter and buffer of ``module``, in place, with
    rank ``src``'s: replicas start equal however each rank built its
    module (the JAX trainers replicate one copy over the mesh)."""
    tensors = list(module.parameters()) + list(module.buffers())
    _through_buckets(tensors, lambda flat: broadcast(flat, src))


def accumulate_gradients(
    loss_fn: Callable[..., torch.Tensor],
    params: Sequence[torch.Tensor],
    batch: Sequence[torch.Tensor],
    *,
    accum_steps: int = 1,
    scale: torch.Tensor | None = None,
) -> torch.Tensor:
    """Forward and backward of this rank's ``batch``: leaves the mean
    gradient over the batch in each parameter's ``.grad`` and returns the
    mean loss (0-d, detached).

    ``accum_steps=k`` splits every tensor of ``batch`` along axis 0 into
    ``k`` microbatches and runs ``loss_fn(*microbatch)`` and its backward
    once each, the gradients summing into ``.grad``: only one microbatch's
    activations are live at a time.  The sums are divided by ``k``.
    ``scale`` (the guard's loss scale) multiplies each loss before its
    backward and is divided back out of the gradients."""
    if accum_steps < 1:
        raise ValueError(f"accum_steps must be >= 1, got {accum_steps}")
    n = batch[0].shape[0]
    if n % accum_steps:
        raise ValueError(f"local batch {n} not divisible by accum_steps {accum_steps}")
    for p in params:
        p.grad = None
    micro = n // accum_steps
    total = None
    for i in range(accum_steps):
        loss = loss_fn(*(t[i * micro : (i + 1) * micro] for t in batch))
        (loss if scale is None else loss * scale).backward()
        total = loss.detach() if total is None else total + loss.detach()
    grads = [p.grad for p in params if p.grad is not None]
    with torch.no_grad():
        if scale is not None:
            inv = 1.0 / scale
            for g in grads:
                g.mul_(inv)
        if accum_steps > 1:
            for g in grads:
                g.div_(accum_steps)
    return total if accum_steps == 1 else total / accum_steps
