"""SPMD runner: the tutorial's fork-join template.

The reference forks ``size`` processes, each running ``run(rank, size)``
(train_dist.py:138-147, ptp.py:38-47); the JAX package's `spmd` runs one
program instance per mesh device and stacks the results.  Here `spmd`
spawns ``world`` processes on this host, each joins the process group
(`comm.init_process_group`, told that every rank runs here, so ranks that
share a card take the Gloo control group), runs ``fn(*args)`` and sends
its result back; the parent stacks the results on a leading ``(world,)``
axis, as the JAX `spmd` does.
"""

from __future__ import annotations

import io
import os
import queue
import time
import traceback
from typing import Any, Callable

import torch
import torch.multiprocessing as mp

from tpu_dist_torch.comm import init as _init

_POLL_S = 0.2


def _tree_map(fn, tree):
    if isinstance(tree, (tuple, list)):
        return type(tree)(_tree_map(fn, t) for t in tree)
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _stack(results: list) -> Any:
    first = results[0]
    if isinstance(first, (tuple, list)):
        return type(first)(_stack([r[i] for r in results]) for i in range(len(first)))
    if isinstance(first, dict):
        return {k: _stack([r[k] for r in results]) for k in first}
    if isinstance(first, (torch.Tensor, bool, int, float)):
        return torch.stack([torch.as_tensor(r) for r in results])
    return list(results)  # strings and other leaves: one per rank


def _to_host(x):
    return x.detach().cpu() if isinstance(x, torch.Tensor) else x


def _rank_main(rank, world, port, device_type, fn, args, results) -> None:
    os.environ.update(MASTER_ADDR="localhost", MASTER_PORT=str(port), WORLD_SIZE=str(world),
                      RANK=str(rank), LOCAL_RANK=str(rank))
    try:
        _init.init_process_group(torch.device(device_type), local_world=world)
        out = io.BytesIO()
        torch.save(_tree_map(_to_host, fn(*args)), out)  # sent by value
        _init.destroy_process_group()
    except Exception:  # every failure goes back to the parent
        # no teardown: the other ranks may be blocked, and the parent kills them
        results.put((rank, False, traceback.format_exc()))
        return
    results.put((rank, True, out.getvalue()))


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
    killed and `spmd` raises."""
    if world < 1:
        raise ValueError(f"world must be >= 1, got {world}")
    if device not in ("cuda", "cpu"):
        raise ValueError(f"device must be 'cuda' or 'cpu', got {device!r}")
    if device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("spmd(device='cuda') needs a CUDA device; pass device='cpu'")
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    port = _init._free_port()
    procs = [
        ctx.Process(target=_rank_main, args=(r, world, port, device, fn, args, results),
                    daemon=True)
        for r in range(world)
    ]
    for p in procs:
        p.start()
    answers: dict[int, Any] = {}
    deadline = time.monotonic() + timeout
    dead_since: dict[int, float] = {}
    try:
        while len(answers) < world:
            try:
                rank, ok, value = results.get(timeout=_POLL_S)
            except queue.Empty:
                now = time.monotonic()
                for r, p in enumerate(procs):
                    # a result may still be in the pipe just after its rank exits
                    if r not in answers and p.exitcode is not None and \
                            now - dead_since.setdefault(r, now) > 2.0:
                        raise RuntimeError(
                            f"spmd: rank {r} exited with code {p.exitcode} without a result")
                if now > deadline:
                    missing = [r for r in range(world) if r not in answers]
                    raise TimeoutError(
                        f"spmd: rank(s) {missing} of {world} did not answer within "
                        f"{timeout} s; killed")
                continue
            if not ok:
                raise RuntimeError(f"spmd: rank {rank} of {world} raised:\n{value}")
            answers[rank] = torch.load(io.BytesIO(value), weights_only=False)
    finally:
        for p in procs:
            p.join(timeout=30 if len(answers) == world else 0)
            if p.is_alive():
                p.kill()
                p.join()
        results.close()
    return _stack([answers[r] for r in range(world)])
