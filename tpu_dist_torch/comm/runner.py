"""SPMD runner: the tutorial's fork-join template.

The reference forks ``size`` processes, each running ``run(rank, size)``
(train_dist.py:138-147, ptp.py:38-47); the JAX package's `spmd` runs one
program instance per mesh device and stacks the results.  Here `spmd`
spawns ``world`` processes on this host, each joins the process group
(`comm.init_process_group`, told that every rank runs here, so ranks that
share a card take the Gloo control group), runs ``fn(*args)`` and sends
its result back; the parent stacks the results on a leading ``(world,)``
axis, as the JAX `spmd` does.  The processes are a `comm.launch` gang
(`launch.run_gang`, one attempt): the parent hosts the world's store on a
port the system picks as it binds it, and keeps it until the ranks are
done, so worlds started at once cannot take each other's port.
"""

from __future__ import annotations

import functools
from typing import Any, Callable

import torch

from tpu_dist_torch.comm.launch import run_gang


def _stack(results: list) -> Any:
    first = results[0]
    if isinstance(first, (tuple, list)):
        return type(first)(_stack([r[i] for r in results]) for i in range(len(first)))
    if isinstance(first, dict):
        return {k: _stack([r[k] for r in results]) for k in first}
    if isinstance(first, (torch.Tensor, bool, int, float)):
        return torch.stack([torch.as_tensor(r) for r in results])
    return list(results)  # strings and other leaves: one per rank


def _call(fn, args, rank: int, world: int) -> Any:
    return fn(*args)


def spmd(
    fn: Callable[..., Any],
    *args: Any,
    world: int,
    device: str = "cuda",
    timeout: float = 600.0,
) -> Any:
    """Run ``fn(*args)`` on ``world`` ranks, one process each, on
    ``device`` (``"cuda"``: rank r drives ``cuda:(r % device_count)``; or
    ``"cpu"``); returns ``fn``'s result tree (tensors, numbers, tuples,
    lists, dicts) with each tensor or number stacked over ranks on a new
    leading axis (any other leaf becomes a list, one per rank).

    ``fn`` and ``args`` must pickle (a module-level function).  If a rank
    raises, `spmd` raises with that rank's traceback; if the ranks have not
    all answered after ``timeout`` seconds, every rank still running is
    killed and `spmd` raises TimeoutError."""
    if world < 1:
        raise ValueError(f"world must be >= 1, got {world}")
    if device not in ("cuda", "cpu"):
        raise ValueError(f"device must be 'cuda' or 'cpu', got {device!r}")
    if device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("spmd(device='cuda') needs a CUDA device; pass device='cpu'")
    results, failure = run_gang(functools.partial(_call, fn, args), world, device=device,
                                timeout=timeout)
    if failure is None:
        return _stack(results)
    error = TimeoutError if failure.kind == "timeout" else RuntimeError
    raise error(f"spmd: {failure}")
