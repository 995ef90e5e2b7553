"""Collectives over ``torch.distributed``: the tutorial's catalog
(tuto.md:176-202) and its point-to-point surface.

The port of `tpu_dist.comm.collectives`.  The JAX package calls these
inside one SPMD program, where a rank is a mesh coordinate; here every rank
is a process and each call is made by every rank of the world (of the
group, for the point-to-point functions), with the JAX package's semantics
where torch leaves them open:

- ``all_reduce`` with ``ReduceOp`` SUM, PRODUCT, MAX, MIN (and AVG, a SUM
  divided by the participants), ``reduce``, ``broadcast``, ``all_gather``,
  ``gather``, ``scatter``, ``reduce_scatter`` and ``all_to_all``;
- sub-groups from `new_group`, which every rank calls in the same order
  (tuto.md:180): ``dist.new_group`` is itself a collective over the world.
  A rank outside a group makes no torch call and passes its input through
  (``all_reduce``, ``reduce``, ``broadcast``) or gets zeros (``all_gather``,
  ``gather``, ``scatter``);
- ``reduce`` leaves every rank but ``dst`` with its input, ``gather`` gives
  zeros to every rank but ``dst``; ``sendrecv`` delivers along (src, dst)
  pairs and gives zeros to a rank that receives nothing, ``send`` leaves
  every rank but ``dst`` with its input.

``all_reduce``, ``reduce`` and ``broadcast`` work in place, as torch's do,
and return the tensor; the others return new tensors.  ``all_gather`` and
``all_to_all`` carry gradients, as the JAX package's ``lax`` collectives
do (expert parallelism trains through them); the other calls do not yet.
One rule for every call: a CUDA tensor in a Gloo group (ranks that share a
card) goes through host memory, the backward's collective too; under NCCL
it stays on the card; nothing on a CUDA tensor falls back to another path.
Without a process group a call runs a world of one.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import Sequence

import torch
import torch.distributed as dist


class ReduceOp(enum.Enum):
    """The four reduction ops the tutorial teaches (tuto.md:190-193), and
    AVG: a SUM divided by the number of ranks reduced."""

    SUM = "sum"
    AVG = "avg"
    PRODUCT = "product"
    MAX = "max"
    MIN = "min"


_TORCH_OPS = {ReduceOp.SUM: dist.ReduceOp.SUM, ReduceOp.AVG: dist.ReduceOp.SUM,
              ReduceOp.PRODUCT: dist.ReduceOp.PRODUCT, ReduceOp.MAX: dist.ReduceOp.MAX,
              ReduceOp.MIN: dist.ReduceOp.MIN}


@dataclass(frozen=True)
class Group:
    """A communication sub-group, ``dist.new_group(ranks)``: its world ranks,
    sorted and deduplicated, and the torch group they make (None without a
    process group).  Members communicate among themselves only."""

    ranks: tuple[int, ...]
    pg: object = field(default=None, compare=False, repr=False)

    def __post_init__(self):
        object.__setattr__(self, "ranks", tuple(sorted(set(self.ranks))))


def new_group(ranks: Sequence[int]) -> Group:
    """``dist.new_group(ranks)`` (tuto.md:180).  Every rank of the world
    calls it, members or not, in the same order: the torch group is made
    here, by a collective over the world."""
    group = Group(tuple(ranks))
    _members(group, None, "new_group")  # raises on a rank past the world
    if not dist.is_initialized() or not group.ranks:
        return group
    return Group(group.ranks, dist.new_group(list(group.ranks)))


def rank(group=None) -> int:
    """``dist.get_rank()``; 0 without a process group."""
    return dist.get_rank(group) if dist.is_initialized() else 0


def world_size(group=None) -> int:
    """``dist.get_world_size()``; 1 without a process group."""
    return dist.get_world_size(group) if dist.is_initialized() else 1


def _host_staged(x: torch.Tensor, group) -> bool:
    """Gloo moves CPU tensors only: a CUDA tensor in a Gloo group (ranks
    sharing one card) goes through host memory."""
    return x.is_cuda and dist.get_backend(group) == "gloo"


def _outgoing(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` as the group's backend sends it: a host copy for a CUDA tensor
    under Gloo, else ``x`` itself (contiguous)."""
    return x.detach().cpu() if _host_staged(x, group) else x.detach().contiguous()


def _check_root(root: int, what: str) -> None:
    n = world_size()
    if not 0 <= root < n:
        raise ValueError(f"{what} root {root} out of range for world size {n} — a "
                         f"masked select would silently produce zeros/passthrough")


def _members(group: Group | None, root: int | None, what: str) -> tuple[int, ...]:
    """The world ranks taking part; raises if ``group`` holds a rank past
    the world or lacks ``root``."""
    n = world_size()
    if group is None:
        return tuple(range(n))
    if group.ranks and not (0 <= group.ranks[0] and group.ranks[-1] < n):
        raise ValueError(f"group ranks {group.ranks} out of range for world size {n}")
    if root is not None and root not in group.ranks:
        raise ValueError(f"{what} {root} not in group {group.ranks}")
    return group.ranks


def _pg(group: Group | None):
    return None if group is None else group.pg


def all_reduce(tensor: torch.Tensor, op: ReduceOp = ReduceOp.SUM, *,
               group: Group | None = None) -> torch.Tensor:
    """``dist.all_reduce(tensor, op, group)`` in place (tuto.md:182-186),
    returning ``tensor``.  A rank outside ``group`` keeps its input.  AVG
    divides the SUM by the number of ranks reduced.  Known answer: ones
    over n ranks with SUM give n."""
    members = _members(group, None, "all_reduce")
    if len(members) <= 1 or rank() not in members:
        return tensor  # a world (or group) of one, or a rank outside the group
    staged = _host_staged(tensor, _pg(group))
    wire = tensor.detach().cpu() if staged else tensor
    dist.all_reduce(wire, op=_TORCH_OPS[op], group=_pg(group))
    if staged:
        tensor.copy_(wire)
    if op is ReduceOp.AVG:
        tensor.div_(len(members))
    return tensor


def reduce(tensor: torch.Tensor, dst: int, op: ReduceOp = ReduceOp.SUM, *,
           group: Group | None = None) -> torch.Tensor:
    """``dist.reduce(tensor, dst, op)`` in place (tuto.md:196): ``dst``
    receives the reduction, every other rank keeps its input (torch leaves
    their buffers unspecified).  With ``group``, ``dst`` must be a member."""
    _check_root(dst, "reduce")
    members = _members(group, dst, "reduce dst")
    if len(members) <= 1 or rank() not in members:
        return tensor
    # a copy: the backend may use every rank's buffer, and only dst's changes
    staged = _host_staged(tensor, _pg(group))
    wire = tensor.detach().cpu() if staged else tensor.detach().clone()
    dist.reduce(wire, dst, op=_TORCH_OPS[op], group=_pg(group))
    if rank() == dst:
        tensor.copy_(wire)
        if op is ReduceOp.AVG:
            tensor.div_(len(members))
    return tensor


def broadcast(tensor: torch.Tensor, src: int, *, group: Group | None = None) -> torch.Tensor:
    """``dist.broadcast(tensor, src)`` in place (tuto.md:195): every rank
    ends with ``src``'s value.  With ``group``, ``src`` must be a member and
    only members receive it; the others keep their input."""
    _check_root(src, "broadcast")
    members = _members(group, src, "broadcast src")
    if len(members) <= 1 or rank() not in members:
        return tensor
    staged = _host_staged(tensor, _pg(group))
    wire = tensor.detach().cpu() if staged else tensor
    dist.broadcast(wire, src, group=_pg(group))
    if staged:
        tensor.copy_(wire)
    return tensor


def all_gather(x: torch.Tensor, *, axis: int = 0, tiled: bool = False,
               group: Group | None = None) -> torch.Tensor:
    """``dist.all_gather(tensor_list, tensor)`` (tuto.md:199): every rank
    receives the contributions stacked on a new axis ``axis`` (``(n, ...)``
    by default), or concatenated along ``axis`` when ``tiled``.  With
    ``group``, members receive the ``(len(group), ...)`` stack of the
    members' contributions (by rank) and the others zeros (``axis`` and
    ``tiled`` must be the defaults).

    Differentiable, as ``lax.all_gather`` is: the gradient of a member's
    ``x`` is the sum over the members of the gradients of their outputs,
    each taken at this member's piece (JAX's transpose, a
    ``psum_scatter``)."""
    members = _members(group, None, "all_gather")
    if group is not None and (axis != 0 or tiled):
        raise ValueError("group= supports the default axis=0, tiled=False")
    if group is not None and rank() not in members:
        return x.new_zeros((len(members),) + tuple(x.shape))
    return _AllGather.apply(x, axis, tiled, group)


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, tiled, group):
        ctx.axis, ctx.tiled, ctx.group, ctx.piece = axis, tiled, group, x.shape[axis]
        members = _members(group, None, "all_gather")
        if len(members) > 1:
            wire = _outgoing(x, _pg(group))
            rows = [torch.empty_like(wire) for _ in members]  # by rank
            dist.all_gather(rows, wire, group=_pg(group))
            rows = [row.to(x.device) for row in rows]
        else:
            rows = [x]
        return torch.cat(rows, dim=axis) if tiled else torch.stack(rows, dim=axis)

    @staticmethod
    def backward(ctx, grad):
        # every member's gradient of the whole output, summed: this
        # member's piece of the sum is the gradient of its input
        total = all_reduce(grad.clone(memory_format=torch.contiguous_format),
                           ReduceOp.SUM, group=ctx.group)
        me = _members(ctx.group, None, "all_gather").index(rank())
        if ctx.tiled:
            return total.narrow(ctx.axis, me * ctx.piece, ctx.piece), None, None, None
        return total.select(ctx.axis, me), None, None, None


def gather(x: torch.Tensor, dst: int, *, group: Group | None = None) -> torch.Tensor:
    """``dist.gather(tensor, dst, gather_list)`` (tuto.md:198; the demo of
    ptp.py:21-28): ``dst`` receives the ``(n, ...)`` stack of every rank's
    ``x``, every other rank zeros.  With ``group``, ``dst`` must be a member
    and the rows of non-members are zeros."""
    _check_root(dst, "gather")
    members = _members(group, dst, "gather dst")
    out = x.new_zeros((world_size(),) + tuple(x.shape))
    me = rank()
    if me not in members:
        return out
    if len(members) == 1:
        out[me] = x
        return out
    wire = _outgoing(x, _pg(group))
    rows = [torch.empty_like(wire) for _ in members] if me == dst else None
    dist.gather(wire, rows, dst=dst, group=_pg(group))
    if me == dst:
        for r, row in zip(members, rows):
            out[r] = row
    return out


def scatter(xs: torch.Tensor, src: int, *, group: Group | None = None) -> torch.Tensor:
    """``dist.scatter(tensor, src, scatter_list)`` (tuto.md:197): ``src``'s
    chunk i (leading axis) lands on rank i; only ``src``'s ``xs`` is read.
    With ``group``, ``src`` must be a member, chunk i goes to the i-th member
    and the others get zeros; ``xs`` then holds ``len(group.ranks)``
    chunks."""
    expected = len(group.ranks) if group is not None else world_size()
    if xs.shape[0] != expected:
        raise ValueError(
            f"scatter needs one leading-axis chunk per participant: got "
            f"xs.shape[0]={xs.shape[0]} for {expected} (torch raises on "
            f"mismatched scatter_list length too)")
    _check_root(src, "scatter")
    members = _members(group, src, "scatter src")
    me = rank()
    if me not in members:
        return xs.new_zeros(xs.shape[1:])
    if len(members) == 1:
        return xs[0].clone()
    chunks = list(_outgoing(xs, _pg(group)).unbind(0))
    out = torch.empty_like(chunks[0])
    dist.scatter(out, chunks if me == src else None, src=src, group=_pg(group))
    return out.to(xs.device)


def reduce_scatter(x: torch.Tensor, op: ReduceOp = ReduceOp.SUM, *,
                   scatter_axis: int = 0) -> torch.Tensor:
    """Reduce across ranks and scatter the result: rank r gets chunk r
    (``dim / n`` long) of the reduction along ``scatter_axis``, for every
    op.  The dimension must divide by the world size.  The reduction is an
    ``all_reduce`` of a copy, sliced (Gloo has no reduce-scatter for every
    release of torch)."""
    n = world_size()
    if x.shape[scatter_axis] % n:
        raise ValueError(f"scatter axis {scatter_axis} size {x.shape[scatter_axis]} not "
                         f"divisible by world size {n}")
    piece = x.shape[scatter_axis] // n
    reduced = all_reduce(x.detach().clone(), op)
    return reduced.narrow(scatter_axis, rank() * piece, piece).clone()


def all_to_all(x: torch.Tensor, *, split_axis: int, concat_axis: int) -> torch.Tensor:
    """Split ``x`` into n chunks along ``split_axis``, send chunk i to rank
    i, and concatenate what arrives (by source rank) along
    ``concat_axis``: the resharding step of Ulysses-style sequence
    parallelism and the token dispatch of expert parallelism
    (`parallel.moe`).  Differentiable, as ``lax.all_to_all`` is: the
    gradient goes back by the all-to-all with the two axes swapped."""
    n = world_size()
    if x.shape[split_axis] % n:
        raise ValueError(f"split axis {split_axis} size {x.shape[split_axis]} not "
                         f"divisible by world size {n}")
    return _AllToAll.apply(x, split_axis, concat_axis)


def _exchange(x: torch.Tensor, split_axis: int, concat_axis: int) -> torch.Tensor:
    n = world_size()
    if n == 1:
        return x.clone()
    send = _outgoing(x.movedim(split_axis, 0), None)
    recv = torch.empty_like(send)  # chunk i of recv came from rank i
    dist.all_to_all_single(recv, send)
    chunks = recv.to(x.device).chunk(n, dim=0)
    return torch.cat([c.movedim(0, split_axis) for c in chunks], dim=concat_axis)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, split_axis, concat_axis):
        ctx.axes = (split_axis, concat_axis)
        return _exchange(x, split_axis, concat_axis)

    @staticmethod
    def backward(ctx, grad):
        split_axis, concat_axis = ctx.axes
        return _exchange(grad, concat_axis, split_axis), None, None


def all_reduce_quantized(x: torch.Tensor, *, dtype: str = "int8") -> torch.Tensor:
    """The compressed all-reduce of the JAX package: not ported yet.  It
    comes with `comm/compress.py` (ROADMAP queue 1, item 10)."""
    raise NotImplementedError(
        f"all_reduce_quantized(dtype={dtype!r}) is not ported yet: it comes with "
        "comm/compress.py, ROADMAP queue 1 item 10; use all_reduce")


def ring_perm(n: int) -> list[tuple[int, int]]:
    """The neighbour ring: every rank sends right, receives from left
    (allreduce.py:18-20 of the tutorial)."""
    return [(i, (i + 1) % n) for i in range(n)]


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
