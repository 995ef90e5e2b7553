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
and return the tensor; the others return new tensors.

Every call carries gradients, as the JAX package's ``lax`` collectives do:
the backward of each is the transpose JAX takes through its definition
(SUM's all-reduce transposes to an all-reduce, ``psum_scatter`` to a tiled
all-gather, ``ppermute`` to the inverse permutation, ``broadcast`` to a
reduce to ``src``, ``gather`` and ``scatter`` to each other), and a rank
outside the group passes its cotangent through.  PRODUCT's gradient is the
summed cotangent times the product of the other members' inputs; MAX and
MIN have none in JAX (``pmax``/``pmin``), and their backward raises.  A
tensor that does not require grad takes the plain call.  The backward is a
collective too: every rank of the group must differentiate through the
call, with inputs that require grad alike.

One rule for every call: a CUDA tensor in a Gloo group (ranks that share a
card) goes through host memory, the backward's collective too; under NCCL
it stays on the card; nothing on a CUDA tensor falls back to another path.
Without a process group a call runs a world of one.  With ``group`` the
point-to-point calls and ``all_to_all`` run among its members, indexed by
their position in ``group.ranks`` (a mesh axis, `comm.mesh`), as the JAX
package's calls run over one named axis.
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


def rank(group: Group | None = None) -> int:
    """``dist.get_rank()``: this process's rank in the world, or with
    ``group`` its index among ``group.ranks`` (the JAX package's
    ``axis_index`` of a mesh axis); 0 without a process group."""
    me = dist.get_rank() if dist.is_initialized() else 0
    if group is None:
        return me
    if me not in group.ranks:
        raise ValueError(f"rank {me} not in group {group.ranks}")
    return group.ranks.index(me)


def world_size(group: Group | None = None) -> int:
    """``dist.get_world_size()``, or the size of ``group``; 1 without a
    process group."""
    if group is not None:
        return len(group.ranks)
    return dist.get_world_size() if dist.is_initialized() else 1


def _tracks_grad(x: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and x.requires_grad


def _others_product(x: torch.Tensor, group: Group | None) -> torch.Tensor:
    """The product of every other member's ``x``: what one member's input
    multiplies in a PRODUCT reduction."""
    stacked = all_gather(x, group=group)  # (members, ...) by rank
    me = _members(group, None, "all_reduce").index(rank())
    return torch.cat([stacked[:me], stacked[me + 1 :]]).prod(dim=0)


def _differentiable(op: ReduceOp, what: str) -> None:
    """Raise for the ops JAX cannot differentiate (``pmax``, ``pmin``)."""
    if op in (ReduceOp.MAX, ReduceOp.MIN):
        raise NotImplementedError(
            f"{what} with ReduceOp.{op.name} has no gradient: the JAX package's "
            f"p{op.name.lower()} has no differentiation rule")


def _grad_of_reduction(op: ReduceOp, total: torch.Tensor, x, group, what: str) -> torch.Tensor:
    """One member's gradient of a reduction whose members' cotangents sum
    to ``total``: SUM passes it, AVG divides it by the members, PRODUCT
    multiplies it by the other members' inputs ``x``."""
    if op is ReduceOp.AVG:
        return total / len(_members(group, None, what))
    if op is ReduceOp.PRODUCT:
        return total * _others_product(x, group)
    return total


def _host_staged(x: torch.Tensor, group) -> bool:
    """Gloo moves CPU tensors only: a CUDA tensor in a Gloo group (ranks
    sharing one card) goes through host memory."""
    return x.is_cuda and dist.get_backend(group) == "gloo"


def _outgoing(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` as the group's backend sends it, contiguous: a host copy for a
    CUDA tensor under Gloo, else ``x`` itself."""
    x = x.detach().contiguous()
    return x.cpu() if _host_staged(x, group) else x


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
    if _tracks_grad(tensor):
        return _AllReduce.apply(tensor, op, group)
    staged = _host_staged(tensor, _pg(group))
    wire = tensor.detach().cpu() if staged else tensor
    dist.all_reduce(wire, op=_TORCH_OPS[op], group=_pg(group))
    if staged:
        tensor.copy_(wire)
    if op is ReduceOp.AVG:
        tensor.div_(len(members))
    return tensor


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, tensor, op, group):
        ctx.op, ctx.group = op, group
        ctx.x = tensor.detach().clone() if op is ReduceOp.PRODUCT else None
        all_reduce(tensor.detach(), op, group=group)
        ctx.mark_dirty(tensor)
        return tensor

    @staticmethod
    def backward(ctx, grad):
        _differentiable(ctx.op, "all_reduce")
        total = all_reduce(grad.clone(memory_format=torch.contiguous_format), ReduceOp.SUM,
                           group=ctx.group)
        return _grad_of_reduction(ctx.op, total, ctx.x, ctx.group, "all_reduce"), None, None


def reduce(tensor: torch.Tensor, dst: int, op: ReduceOp = ReduceOp.SUM, *,
           group: Group | None = None) -> torch.Tensor:
    """``dist.reduce(tensor, dst, op)`` in place (tuto.md:196): ``dst``
    receives the reduction, every other rank keeps its input (torch leaves
    their buffers unspecified).  With ``group``, ``dst`` must be a member."""
    _check_root(dst, "reduce")
    members = _members(group, dst, "reduce dst")
    if len(members) <= 1 or rank() not in members:
        return tensor
    if _tracks_grad(tensor):
        return _Reduce.apply(tensor, dst, op, group)
    # a copy: the backend may use every rank's buffer, and only dst's changes
    staged = _host_staged(tensor, _pg(group))
    wire = tensor.detach().cpu() if staged else tensor.detach().clone()
    dist.reduce(wire, dst, op=_TORCH_OPS[op], group=_pg(group))
    if rank() == dst:
        tensor.copy_(wire)
        if op is ReduceOp.AVG:
            tensor.div_(len(members))
    return tensor


class _Reduce(torch.autograd.Function):
    """JAX's ``where(rank == dst, all_reduce(x), x)``: every member's input
    reaches dst's output, and every rank but dst keeps its own."""

    @staticmethod
    def forward(ctx, tensor, dst, op, group):
        ctx.dst, ctx.op, ctx.group = dst, op, group
        ctx.x = tensor.detach().clone() if op is ReduceOp.PRODUCT else None
        reduce(tensor.detach(), dst, op, group=group)
        ctx.mark_dirty(tensor)
        return tensor

    @staticmethod
    def backward(ctx, grad):
        _differentiable(ctx.op, "reduce")
        from_dst = broadcast(grad.clone(memory_format=torch.contiguous_format), ctx.dst,
                             group=ctx.group)
        out = _grad_of_reduction(ctx.op, from_dst, ctx.x, ctx.group, "reduce")
        return (out if rank() == ctx.dst else out + grad), None, None, None


def broadcast(tensor: torch.Tensor, src: int, *, group: Group | None = None) -> torch.Tensor:
    """``dist.broadcast(tensor, src)`` in place (tuto.md:195): every rank
    ends with ``src``'s value.  With ``group``, ``src`` must be a member and
    only members receive it; the others keep their input."""
    _check_root(src, "broadcast")
    members = _members(group, src, "broadcast src")
    if len(members) <= 1 or rank() not in members:
        return tensor
    if _tracks_grad(tensor):
        return _Broadcast.apply(tensor, src, group)
    staged = _host_staged(tensor, _pg(group))
    wire = tensor.detach().cpu() if staged else tensor
    dist.broadcast(wire, src, group=_pg(group))
    if staged:
        tensor.copy_(wire)
    return tensor


class _Broadcast(torch.autograd.Function):
    """JAX's ``psum(where(rank == src, x, 0))``: src's input reaches every
    member, so src's gradient is the members' cotangents summed."""

    @staticmethod
    def forward(ctx, tensor, src, group):
        ctx.src, ctx.group = src, group
        broadcast(tensor.detach(), src, group=group)
        ctx.mark_dirty(tensor)
        return tensor

    @staticmethod
    def backward(ctx, grad):
        total = reduce(grad.clone(memory_format=torch.contiguous_format), ctx.src,
                       group=ctx.group)
        return (total if rank() == ctx.src else torch.zeros_like(grad)), None, None


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
    if _tracks_grad(x):
        return _Gather.apply(x, dst, group)
    wire = _outgoing(x, _pg(group))
    rows = [torch.empty_like(wire) for _ in members] if me == dst else None
    dist.gather(wire, rows, dst=dst, group=_pg(group))
    if me == dst:
        for r, row in zip(members, rows):
            out[r] = row
    return out


class _Gather(torch.autograd.Function):
    """Member r's input is row r of dst's output: its gradient is that row
    of dst's cotangent, scattered back."""

    @staticmethod
    def forward(ctx, x, dst, group):
        ctx.dst, ctx.group = dst, group
        return gather(x.detach(), dst, group=group)

    @staticmethod
    def backward(ctx, grad):
        rows = grad[list(_members(ctx.group, None, "gather"))]
        return scatter(rows, ctx.dst, group=ctx.group), None, None


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
    if _tracks_grad(xs):
        return _Scatter.apply(xs, src, group)
    chunks = list(_outgoing(xs, _pg(group)).unbind(0))
    out = torch.empty_like(chunks[0])
    dist.scatter(out, chunks if me == src else None, src=src, group=_pg(group))
    return out.to(xs.device)


class _Scatter(torch.autograd.Function):
    """Chunk i of src's input is member i's output: src's gradient is the
    members' cotangents gathered, every other rank's zeros."""

    @staticmethod
    def forward(ctx, xs, src, group):
        ctx.src, ctx.group = src, group
        return scatter(xs.detach(), src, group=group)

    @staticmethod
    def backward(ctx, grad):
        rows = gather(grad, ctx.src, group=ctx.group)[list(_members(ctx.group, None, "scatter"))]
        return (rows if rank() == ctx.src else torch.zeros_like(rows)), None, None


def reduce_scatter(x: torch.Tensor, op: ReduceOp = ReduceOp.SUM, *,
                   scatter_axis: int = 0) -> torch.Tensor:
    """Reduce across ranks and scatter the result: rank r gets chunk r
    (``dim / n`` long) of the reduction along ``scatter_axis``, for every
    op.  The dimension must divide by the world size.  The reduction is an
    ``all_reduce`` of a copy, sliced (Gloo has no reduce-scatter for every
    release of torch).  Its gradient is the cotangents all-gathered along
    ``scatter_axis`` (``psum_scatter``'s transpose)."""
    n = world_size()
    if x.shape[scatter_axis] % n:
        raise ValueError(f"scatter axis {scatter_axis} size {x.shape[scatter_axis]} not "
                         f"divisible by world size {n}")
    if _tracks_grad(x):
        return _ReduceScatter.apply(x, op, scatter_axis)
    piece = x.shape[scatter_axis] // n
    reduced = all_reduce(x.detach().clone(), op)
    return reduced.narrow(scatter_axis, rank() * piece, piece).clone()


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, op, scatter_axis):
        ctx.op, ctx.axis = op, scatter_axis
        ctx.x = x.detach().clone() if op is ReduceOp.PRODUCT else None
        return reduce_scatter(x.detach(), op, scatter_axis=scatter_axis)

    @staticmethod
    def backward(ctx, grad):
        _differentiable(ctx.op, "reduce_scatter")
        # every rank's cotangent, each in place of its own chunk
        total = all_gather(grad, axis=ctx.axis, tiled=True)
        return _grad_of_reduction(ctx.op, total, ctx.x, None, "reduce_scatter"), None, None


def all_to_all(x: torch.Tensor, *, split_axis: int, concat_axis: int,
               group: Group | None = None) -> torch.Tensor:
    """Split ``x`` into n chunks along ``split_axis``, send chunk i to rank
    i, and concatenate what arrives (by source rank) along
    ``concat_axis``: the resharding step of Ulysses-style sequence
    parallelism (`parallel.ulysses`) and the token dispatch of expert
    parallelism (`parallel.moe`).  With ``group``, n is the group's size
    and chunk i goes to its i-th member; every member calls it.
    Differentiable, as ``lax.all_to_all`` is: the gradient goes back by the
    all-to-all with the two axes swapped, over the same group."""
    n = world_size(group)
    rank(group)  # raises outside the group
    if x.shape[split_axis] % n:
        raise ValueError(f"split axis {split_axis} size {x.shape[split_axis]} not "
                         f"divisible by world size {n}")
    return _AllToAll.apply(x, split_axis, concat_axis, group)


def _exchange(x: torch.Tensor, split_axis: int, concat_axis: int, group) -> torch.Tensor:
    n = world_size(group)
    if n == 1:
        return x.clone()
    send = _outgoing(x.movedim(split_axis, 0), _pg(group))
    recv = torch.empty_like(send)  # chunk i of recv came from member i
    dist.all_to_all_single(recv, send, group=_pg(group))
    chunks = recv.to(x.device).chunk(n, dim=0)
    return torch.cat([c.movedim(0, split_axis) for c in chunks], dim=concat_axis)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, split_axis, concat_axis, group):
        ctx.axes, ctx.group = (split_axis, concat_axis), group
        return _exchange(x, split_axis, concat_axis, group)

    @staticmethod
    def backward(ctx, grad):
        split_axis, concat_axis = ctx.axes
        return _exchange(grad, concat_axis, split_axis, ctx.group), None, None, None


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


def _permute(x: torch.Tensor, perm: Sequence[tuple[int, int]], group) -> tuple[torch.Tensor, bool]:
    """``x`` delivered along ``perm`` (indices into the group): what this
    rank receives, zeros if nothing, and whether it received."""
    me = rank(group)
    out = torch.zeros(x.shape, dtype=x.dtype, device=x.device)  # contiguous, for irecv
    to = next((d for s, d in perm if s == me), None)
    frm = next((s for s, d in perm if d == me), None)
    if to == me:  # a pair (r, r) keeps its own value
        out.copy_(x)
        return out, True
    if to is None and frm is None:
        return out, False
    pg = _pg(group)
    staged = _host_staged(x, pg)
    wire_in = out.cpu() if staged else out

    def peer(i: int) -> int:  # P2POp takes world ranks
        return i if group is None else group.ranks[i]

    ops = []
    if to is not None:
        wire_out = _outgoing(x, pg)
        ops.append(dist.P2POp(dist.isend, wire_out, peer(to), pg))
    if frm is not None:
        ops.append(dist.P2POp(dist.irecv, wire_in, peer(frm), pg))
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    if staged and frm is not None:
        out.copy_(wire_in)
    return out, frm is not None


def _check_perm(perm: Sequence[tuple[int, int]], group) -> None:
    n = world_size(group)
    for s, d in perm:
        if not (0 <= s < n and 0 <= d < n):
            raise ValueError(f"sendrecv pair ({s}, {d}) out of range for world size {n}")
    srcs, dsts = [s for s, _ in perm], [d for _, d in perm]
    if len(set(srcs)) != len(srcs) or len(set(dsts)) != len(dsts):
        raise ValueError(f"sendrecv perm {list(perm)} sends or receives twice on one rank")


class _SendRecv(torch.autograd.Function):
    """``lax.ppermute``, whose transpose sends each cotangent back along the
    inverse permutation.  With ``keep`` a rank that receives nothing
    outputs its input (`send`), and its own cotangent passes through."""

    @staticmethod
    def forward(ctx, x, perm, group, keep):
        ctx.perm, ctx.group = perm, group
        out, received = _permute(x, perm, group)
        ctx.passes = keep and not received
        return x.detach().clone() if ctx.passes else out

    @staticmethod
    def backward(ctx, grad):
        back, _ = _permute(grad, [(d, s) for s, d in ctx.perm], ctx.group)
        return (back + grad if ctx.passes else back), None, None, None


def sendrecv(x: torch.Tensor, perm: Sequence[tuple[int, int]],
             group: Group | None = None) -> torch.Tensor:
    """Each (src, dst) pair delivers src's ``x`` to dst; a rank that
    receives nothing gets zeros (``lax.ppermute``).  Every rank of the world
    (of ``group``, whose members the pairs index) calls it with the same
    ``perm``; no rank may send or receive twice."""
    _check_perm(perm, group)
    if _tracks_grad(x):
        return _SendRecv.apply(x, tuple(perm), group, False)
    return _permute(x, perm, group)[0]


def send(x: torch.Tensor, dst: int, src: int, group: Group | None = None) -> torch.Tensor:
    """One ``dist.send(x, dst)`` / ``dist.recv(x, src)`` pair as a call of
    every rank: ``dst`` gets ``src``'s value, every other rank (``src``
    included) keeps its input."""
    _check_perm([(src, dst)], group)
    if _tracks_grad(x):
        return _SendRecv.apply(x, ((src, dst),), group, True)
    received, _ = _permute(x, [(src, dst)], group)
    return received if rank(group) == dst else x


def shift(x: torch.Tensor, offset: int = 1, group: Group | None = None) -> torch.Tensor:
    """Ring shift: every rank sends to ``(rank + offset) % n`` and receives
    from ``(rank - offset) % n``."""
    n = world_size(group)
    return sendrecv(x, [(i, (i + offset) % n) for i in range(n)], group)


def barrier(group=None) -> None:
    """``dist.barrier()``; nothing without a process group."""
    if dist.is_initialized():
        dist.barrier(group)
