"""Collectives over ``torch.distributed``: the all-reduce that data
parallelism uses, and the point-to-point surface of the tutorial.

The JAX package calls these inside one SPMD program, where a rank is a mesh
coordinate (`tpu_dist.comm.collectives`); here every rank is a process and
each call is made by every rank of the group, with the same semantics:
`sendrecv` delivers along (src, dst) pairs and gives zeros to a rank that
receives nothing, `send` leaves every rank but ``dst`` with its input.
Without a process group a call runs a world of one.
"""

from __future__ import annotations

import enum
from typing import Sequence

import torch
import torch.distributed as dist


class ReduceOp(enum.Enum):
    SUM = "sum"
    AVG = "avg"


def all_reduce(tensor: torch.Tensor, op: ReduceOp = ReduceOp.SUM) -> torch.Tensor:
    """Reduce ``tensor`` in place across every rank and return it.  AVG is
    a SUM divided by the world size on every backend (Gloo has no AVG)."""
    dist.all_reduce(tensor, op=dist.ReduceOp.SUM)
    if op is ReduceOp.AVG:
        tensor.div_(dist.get_world_size())
    return tensor


def rank(group=None) -> int:
    """``dist.get_rank()``; 0 without a process group."""
    return dist.get_rank(group) if dist.is_initialized() else 0


def world_size(group=None) -> int:
    """``dist.get_world_size()``; 1 without a process group."""
    return dist.get_world_size(group) if dist.is_initialized() else 1


def ring_perm(n: int) -> list[tuple[int, int]]:
    """The neighbour ring: every rank sends right, receives from left
    (allreduce.py:18-20 of the tutorial)."""
    return [(i, (i + 1) % n) for i in range(n)]


def _host_staged(x: torch.Tensor, group) -> bool:
    """Gloo moves CPU tensors only, point to point: a CUDA tensor in a Gloo
    group (ranks sharing one card) goes through host memory."""
    return x.is_cuda and dist.get_backend(group) == "gloo"


def sendrecv(x: torch.Tensor, perm: Sequence[tuple[int, int]], group=None) -> torch.Tensor:
    """Each (src, dst) pair delivers src's ``x`` to dst; a rank that
    receives nothing gets zeros (``lax.ppermute``).  Every rank of the group
    calls it with the same ``perm``; no rank may send or receive twice."""
    n, me = world_size(group), rank(group)
    for s, d in perm:
        if not (0 <= s < n and 0 <= d < n):
            raise ValueError(f"sendrecv pair ({s}, {d}) out of range for world size {n}")
    srcs, dsts = [s for s, _ in perm], [d for _, d in perm]
    if len(set(srcs)) != len(srcs) or len(set(dsts)) != len(dsts):
        raise ValueError(f"sendrecv perm {list(perm)} sends or receives twice on one rank")
    out = torch.zeros(x.shape, dtype=x.dtype, device=x.device)  # contiguous, for irecv
    to = next((d for s, d in perm if s == me), None)
    frm = next((s for s, d in perm if d == me), None)
    if to == me:  # a pair (r, r) keeps its own value
        out.copy_(x)
        to = frm = None
    staged = dist.is_initialized() and _host_staged(x, group)
    wire_in = out.cpu() if staged else out

    def peer(r: int) -> int:  # P2POp takes global ranks
        return r if group is None else dist.get_global_rank(group, r)

    ops = []
    if to is not None:
        wire_out = x.detach().cpu() if staged else x.detach().contiguous()
        ops.append(dist.P2POp(dist.isend, wire_out, peer(to), group))
    if frm is not None:
        ops.append(dist.P2POp(dist.irecv, wire_in, peer(frm), group))
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    if staged and frm is not None:
        out.copy_(wire_in)
    return out


def send(x: torch.Tensor, dst: int, src: int, group=None) -> torch.Tensor:
    """One ``dist.send(x, dst)`` / ``dist.recv(x, src)`` pair as a call of
    every rank: ``dst`` gets ``src``'s value, every other rank (``src``
    included) keeps its input."""
    received = sendrecv(x, [(src, dst)], group)
    return received if rank(group) == dst else x


def shift(x: torch.Tensor, offset: int = 1, group=None) -> torch.Tensor:
    """Ring shift: every rank sends to ``(rank + offset) % n`` and receives
    from ``(rank - offset) % n``."""
    n = world_size(group)
    return sendrecv(x, [(i, (i + offset) % n) for i in range(n)], group)


def barrier(group=None) -> None:
    """``dist.barrier()``; nothing without a process group."""
    if dist.is_initialized():
        dist.barrier(group)
