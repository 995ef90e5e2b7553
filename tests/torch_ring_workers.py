"""The port's side of the ring and point-to-point parity tests: the cases,
their inputs from a seed, and the function every spawned rank runs.

Imported by the parent test process and by every rank `comm.spmd` spawns,
so it imports neither jax nor the JAX package (a rank then starts in a
few seconds).  The JAX side of the same cases is in test_torch_ring.py.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from tpu_dist_torch import comm, ops, parallel
from tpu_dist_torch.ops import pallas_ring

SEED = 7


def perms(n: int) -> dict[str, list[tuple[int, int]]]:
    return {
        "sendrecv_ring_back": [(i, (i - 1) % n) for i in range(n)],
        "sendrecv_one_pair": [(0, n - 1)],  # every other rank receives zeros
    }


def cases(n: int) -> dict[str, tuple[str, np.ndarray, str]]:
    """name -> (function, stacked inputs (n, ...) for every rank, dtype)."""
    rng = np.random.default_rng(SEED + n)

    def f32(*shape):
        return rng.standard_normal((n, *shape)).astype(np.float32) * 10

    def i32(*shape):
        return rng.integers(-1000, 1000, (n, *shape)).astype(np.int32)

    out = {
        "naive_f32": ("ring_all_reduce", f32(5, 3), "float32"),
        "naive_f32_ragged": ("ring_all_reduce", f32(1001), "float32"),
        "naive_bf16": ("ring_all_reduce", f32(12), "bfloat16"),
        "naive_i32": ("ring_all_reduce", i32(12), "int32"),
        "chunked_f32_ragged": ("ring_all_reduce_chunked", f32(7), "float32"),
        "chunked_f32_2d": ("ring_all_reduce_chunked", f32(64, 3), "float32"),
        "chunked_bf16": ("ring_all_reduce_chunked", f32(12), "bfloat16"),
        "chunked_i32": ("ring_all_reduce_chunked", i32(13), "int32"),
        "reduce_scatter_f32": ("ring_reduce_scatter", f32(16), "float32"),
        "reduce_scatter_f32_ragged": ("ring_reduce_scatter", f32(7), "float32"),
        "all_gather_f32": ("ring_all_gather", f32(3), "float32"),
        "all_gather_offset1_i32": ("ring_all_gather_offset1", i32(2), "int32"),
        "pallas_cpu_f32": ("ring_all_reduce_pallas", f32(8, 128), "float32"),
        "pallas_cpu_i32": ("ring_all_reduce_pallas", i32(33), "int32"),
        "pallas_cpu_bf16": ("ring_all_reduce_pallas", f32(3, 41), "bfloat16"),
        "pallas_cpu_f32_7": ("ring_all_reduce_pallas", f32(7), "float32"),
        "pallas_cpu_f32_fewer_than_ranks": ("ring_all_reduce_pallas", f32(n - 1), "float32"),
        "pallas_cpu_i32_ragged": ("ring_all_reduce_pallas", i32(1001), "int32"),
        "shift1_f32": ("shift1", f32(4), "float32"),
        "shift2_f32": ("shift2", f32(4), "float32"),
        "send_f32": ("send", f32(6), "float32"),
        "rank_world": ("rank_world", np.zeros((n, 1), np.float32), "float32"),
    }
    for name in perms(n):
        out[name] = (name, f32(2, 2), "float32")
    return out


def _apply(fn: str, x: torch.Tensor, n: int) -> torch.Tensor:
    if fn in ("ring_all_reduce", "ring_all_reduce_chunked", "ring_reduce_scatter"):
        return getattr(parallel, fn)(x)
    if fn == "ring_all_gather":
        return parallel.ring_all_gather(x)
    if fn == "ring_all_gather_offset1":
        return parallel.ring_all_gather(x, owner_offset=1)
    if fn == "ring_all_reduce_pallas":
        return ops.ring_all_reduce_pallas(x)
    if fn in ("shift1", "shift2"):
        return comm.shift(x, int(fn[-1]))
    if fn == "send":
        return comm.send(x, dst=n - 1, src=0)
    if fn == "rank_world":
        return torch.tensor([comm.rank(), comm.world_size()], dtype=torch.float32)
    return comm.sendrecv(x, perms(n)[fn])


def run_all() -> dict[str, torch.Tensor]:
    """One rank: every case on this rank's slice of the inputs, outputs in
    float32 (bfloat16 widened exactly) or int32."""
    n, r = comm.world_size(), comm.rank()
    comm.barrier()
    results = {}
    for name, (fn, table, dtype) in cases(n).items():
        x = torch.from_numpy(table[r]).to(getattr(torch, dtype))
        y = _apply(fn, x, n)
        results[name] = y.float() if y.dtype == torch.bfloat16 else y
    return results


def pallas_cases(n: int) -> list[str]:
    return [name for name, (fn, _, _) in cases(n).items() if fn == "ring_all_reduce_pallas"]


# ------------------------------------------------- the workspace's growth


class HostWorkspace(pallas_ring.Workspace):
    """The ring workspace's host logic over real control groups, with
    stand-in memory: its stamp exchange, handle exchange and teardown
    barrier go over the groups `_CudaWorkspace` joins, and ``late`` delays
    this rank before the handle exchange and the barrier."""

    def __init__(self, late: float = 0.0):
        super().__init__(comm.world_size(), comm.rank())
        self.join()
        self.late = late

    def _create(self, capacity):
        time.sleep(self.late)
        handles = [None] * self.world
        torch.distributed.all_gather_object(handles, self.rank, group=self.control)
        return (1, 2, 3)

    def _barrier(self):
        time.sleep(self.late)
        torch.distributed.barrier(group=self.control)

    def _release(self):
        pass


def growth_disagreements(timeout: float) -> dict:
    """Two growth exchanges over a control group whose waits end after
    ``timeout``: the ranks grow for different stamps (every rank raises),
    then only rank 0 grows (it raises after the bound, and rank 1, which
    made no exchange, is not held)."""
    pallas_ring.CONTROL_TIMEOUT_S = timeout
    r = comm.rank()
    out = {}
    ws = HostWorkspace()
    try:
        ws.reserve(64, (16 + r, 0, 0, 0))
        out["different"] = ""
    except ValueError as e:
        out["different"] = str(e)
    out["different_broken"] = ws.broken is not None
    ws = HostWorkspace()
    t0 = time.perf_counter()
    out["alone"] = ""
    if r == 0:
        try:
            ws.reserve(64, (16, 0, 0, 0))
        except RuntimeError as e:
            out["alone"] = str(e)
    out["alone_seconds"] = time.perf_counter() - t0
    out["alone_broken"] = ws.broken is not None
    comm.barrier()
    return out


def late_rank_after_the_stamps(timeout: float, late: float) -> dict:
    """A growth both ranks agree on, then teardown, with rank 1 ``late``
    seconds behind rank 0 after the stamp exchange, whose waits end after
    ``timeout``: only the stamp exchange is bounded, so neither rank
    raises; rank 0's wait in the handle exchange and the barrier is
    reported."""
    pallas_ring.CONTROL_TIMEOUT_S = timeout
    ws = HostWorkspace(late=late if comm.rank() == 1 else 0.0)
    t0 = time.perf_counter()
    grew = ws.reserve(64, (16, 0, 0, 0))
    ws.free()
    return {"grew": grew, "freed": ws.pointers is None, "broken": ws.broken is not None,
            "waited": time.perf_counter() - t0}


# ------------------------------------------------- comm.spmd's own tests


def probe(scale: float):
    """A result tree of every leaf kind `spmd` stacks."""
    r = comm.rank()
    return torch.tensor([r, comm.world_size()]), {"half": scale * r, "tag": f"rank {r}"}


def fail_on_rank_1():
    if comm.rank() == 1:
        raise ValueError("rank 1 gives up on purpose")
    return torch.zeros(1)


def hang_on_rank_1():
    if comm.rank() == 1:
        import time

        time.sleep(600)
    return torch.zeros(1)


def pallas_over_a_subgroup() -> dict:
    """One rank of a world of 4: ``ring_all_reduce_pallas`` of a CPU tensor
    over the `comm.Group` of ranks 1 and 3 (every rank makes the group,
    only its members call), and each rank's input."""
    group = comm.new_group([1, 3])
    x = torch.arange(5, dtype=torch.float32) * (comm.rank() + 1)
    y = ops.ring_all_reduce_pallas(x, group) if comm.rank() in group.ranks else x
    return {"x": x, "y": y}
