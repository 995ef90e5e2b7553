"""Multi-process launcher: the tutorial's fork-join ``__main__`` template.

The reference spawns ``size`` local processes, each running
``init_processes(rank, size, fn)``, then joins them (train_dist.py:138-147).
`launch` is the port of `tpu_dist.comm.launch`: it starts ``world``
processes with the MASTER_ADDR/PORT/WORLD_SIZE/RANK contract
(tuto.md:421-428); each joins the process group through
`comm.init_process_group` and calls ``fn(rank, world)``.  The parent hosts
the TCP store (children join it as clients), or the children meet in a
``file://`` store (tuto.md:430-437).  With ``assign_ranks=False`` RANK is
unset and the store hands out ranks first come, first served (the
rank-less init of allreduce.py:54).

`run_gang` is the one spawn, join and teardown path, shared with
`comm.spmd`.  Each rank sends its result, waits at a barrier for the
others, and tears its group down.  Fail-stop: the first failure
terminates the other ranks.  ``restarts=N``
relaunches the whole gang on a fresh store, up to N times, and raises
`WorkerFailed` when they are spent.  The JAX launcher's elastic relaunch
(``probe_world``), its flight-recorder dumps and its supervisor event stream
come with the resilience and observability slice; `launch` takes no
argument for them.
"""

from __future__ import annotations

import io
import logging
import multiprocessing as mp
import os
import time
import traceback
from multiprocessing.connection import wait as mp_wait
from typing import Any, Callable, NamedTuple

import torch
import torch.distributed as dist

from tpu_dist_torch.comm import init as _init
from tpu_dist_torch.resilience.retry import WorkerFailed

logger = logging.getLogger("tpu_dist_torch.comm.launch")
_GRACE_S = 5.0  # survivors' time to report after the first failure


class Failure(NamedTuple):
    """A gang's first failure: the launch slot, the world, how it failed
    (``"raised"``, ``"died"`` without a result, or ``"timeout"``), the
    rank's traceback or exit code, and the slots that had not answered."""

    slot: int
    world: int
    kind: str
    detail: str = ""
    missing: tuple[int, ...] = ()

    def __str__(self) -> str:
        if self.kind == "raised":
            return f"rank {self.slot} of {self.world} raised:\n{self.detail}"
        if self.kind == "died":
            return (f"rank {self.slot} of {self.world} died without reporting a result "
                    f"({self.detail})")
        return (f"rank(s) {list(self.missing)} of {self.world} did not answer before the "
                "timeout; killed")


def _tree_map(fn, tree):
    if isinstance(tree, (tuple, list)):
        return type(tree)(_tree_map(fn, t) for t in tree)
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _to_host(x):
    return x.detach().cpu() if isinstance(x, torch.Tensor) else x


def _child(fn, slot: int, env: dict, assign_ranks: bool, device: str, conn) -> None:
    try:
        os.environ.update(env)
        if "TPU_DIST_INIT_METHOD" not in env:
            # an inherited init method must not override this launch's store
            os.environ.pop("TPU_DIST_INIT_METHOD", None)
        if assign_ranks:
            os.environ["RANK"] = str(slot)
        else:
            os.environ.pop("RANK", None)
        os.environ["LOCAL_RANK"] = str(slot)  # the card: cuda:(slot % device_count)
        rank, world = _init.init_process_group(torch.device(device))
        out = io.BytesIO()
        torch.save(_tree_map(_to_host, fn(rank, world)), out)  # sent by value
        conn.send(("ok", out.getvalue()))
        # No rank closes its connections before every rank is done making
        # its own: Gloo fails a peer's connect that finds the socket closed
        # ("connectFullMesh failed ... Connection closed by peer").
        dist.barrier()
        _init.destroy_process_group()
        conn.send(("done", None))
    except Exception:  # every failure goes back to the parent
        # no teardown: the other ranks may be blocked, and the parent ends them
        conn.send(("error", traceback.format_exc()))
    finally:
        conn.close()


def launch(
    fn: Callable[[int, int], Any],
    world: int,
    *,
    device: str = "cuda",
    addr: str = "127.0.0.1",
    port: int | None = None,
    timeout: float = 300.0,
    init_method: str | None = None,
    assign_ranks: bool = True,
    restarts: int = 0,
) -> list[Any]:
    """Fork-join ``world`` processes running ``fn(rank, world)`` on
    ``device`` (``"cuda"``: launch slot i drives ``cuda:(i %
    device_count)``; or ``"cpu"``).

    ``fn`` must pickle (a module-level function).  Returns each process's
    result (tensors moved to the host), indexed by launch slot, which is
    the rank when ``assign_ranks``.  ``port``: where the parent hosts the
    store (None: a port the system picks as it binds it).
    ``init_method='file:///path'``: the ranks meet in a ``FileStore`` on
    that path instead, which the parent removes before each attempt (a
    leftover file is a dead gang's).  ``assign_ranks=False`` leaves RANK
    unset, and the store assigns ranks.  Any failure, or a rank that has
    not answered after ``timeout`` seconds, terminates the others and
    raises `WorkerFailed` (a RuntimeError).

    ``restarts=N`` relaunches the whole gang, up to N times, each on a
    fresh store, with the attempt index in ``TORCHELASTIC_RESTART_COUNT``;
    a fork-join group has no single-rank recovery, since the survivors hold
    dead collective state.  When the restarts are spent, the last failure
    is raised."""
    if world < 1:
        raise ValueError(f"world must be >= 1, got {world}")
    if device not in ("cuda", "cpu"):
        raise ValueError(f"device must be 'cuda' or 'cpu', got {device!r}")
    if device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("launch(device='cuda') needs a CUDA device; pass device='cpu'")
    if init_method is not None and not init_method.startswith("file://"):
        raise ValueError(f"init_method must be file:///path, got {init_method!r}")
    failure = None
    for attempt in range(restarts + 1):
        results, failure = run_gang(fn, world, device=device, addr=addr, port=port,
                                    timeout=timeout, init_method=init_method,
                                    assign_ranks=assign_ranks, attempt=attempt)
        if failure is None:
            return results
        if attempt < restarts:
            logger.warning("launch attempt %d/%d failed (%s); relaunching the gang",
                           attempt + 1, restarts + 1, failure)
    raise WorkerFailed(f"launch failed — {failure}")


def run_gang(fn, world: int, *, device: str, addr: str = "127.0.0.1", port: int | None = None,
             timeout: float, init_method: str | None = None, assign_ranks: bool = True,
             attempt: int = 0) -> tuple[list[Any], Failure | None]:
    """One fail-stop fork-join attempt on a fresh store, the one spawn, join
    and teardown path of `launch` and `comm.spmd`: each slot's result (None
    where it gave none), and the first failure or None.  Every process is
    gone when it returns."""
    store = None
    if init_method is None:
        store = _init.host_store(addr, port or 0)
        env = _init.launcher_env(store, addr, world, attempt)
    else:
        path = init_method[len("file://"):]
        if os.path.exists(path):
            os.remove(path)
        env = {"TPU_DIST_INIT_METHOD": init_method, "WORLD_SIZE": str(world),
               "LOCAL_WORLD_SIZE": str(world), _init.ATTEMPT: str(attempt)}
    ctx = mp.get_context("spawn")
    procs, conns, pending = [], [], {}
    for slot in range(world):
        parent_conn, child_conn = ctx.Pipe(duplex=False)
        p = ctx.Process(target=_child, args=(fn, slot, env, assign_ranks, device, child_conn))
        p.start()
        # the parent's copy of the child's end goes now, so that a child that
        # dies without reporting shows at once as the end of its pipe
        child_conn.close()
        procs.append(p)
        conns.append(parent_conn)
        pending[parent_conn] = slot
    # each rank sends its result, then "done" once it has torn its group down
    results: list[Any] = [None] * world
    answered: set[int] = set()
    failure = None
    deadline = time.monotonic() + timeout
    try:
        while pending:
            limit = min(deadline, time.monotonic() + _GRACE_S) if failure else deadline
            ready = mp_wait(list(pending), timeout=max(limit - time.monotonic(), 0))
            if not ready:
                break
            for conn in ready:
                slot = pending[conn]
                try:
                    status, payload = conn.recv()
                except EOFError:
                    del pending[conn]
                    procs[slot].join(timeout=1)
                    failure = failure or Failure(slot, world, "died",
                                                 f"exit code {procs[slot].exitcode}")
                    continue
                if status == "ok":
                    results[slot] = torch.load(io.BytesIO(payload), weights_only=False)
                    answered.add(slot)
                    continue
                del pending[conn]
                if status == "error":
                    failure = failure or Failure(slot, world, "raised", payload)
        if pending and failure is None:
            # the ranks without a result, else those stuck in the teardown
            missing = (tuple(s for s in range(world) if s not in answered)
                       or tuple(sorted(pending.values())))
            failure = Failure(missing[0], world, "timeout", missing=missing)
    finally:  # the store lives until here: every rank is gone
        for p in procs:
            if (failure is not None or pending) and p.is_alive():
                p.terminate()
            p.join(timeout=10)
            if p.is_alive():
                p.kill()
                p.join()
        for conn in conns:
            conn.close()
    return results, failure
