"""The device mesh as process groups: the port of `tpu_dist.comm.mesh`.

The JAX package lays its devices out as a named grid (``jax.sharding.Mesh``)
and runs a collective over one named axis.  Here every rank is a process,
and `make_mesh` lays the ranks of the world out row-major over the named
axes, as JAX's ``np.array(devices).reshape(shape)`` lays its devices: on a
``(data, seq)`` mesh, rank ``d * n_seq + s`` has coordinates ``(d, s)``.
Along each axis this rank talks to the ranks that share every other
coordinate, through the `comm.Group` of that axis: ``mesh.group("seq")`` is
the row of ranks ``d * n_seq .. d * n_seq + n_seq - 1``.

Each group is made by ``dist.new_group``, a collective over the world, so
every rank makes every group of every axis, in the same order.  An axis
that spans the world takes the world's process group itself.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Sequence

import numpy as np

from tpu_dist_torch.comm.collectives import Group, new_group, rank, world_size

DATA_AXIS = "data"


@dataclass(frozen=True, eq=False)
class Mesh:
    """The world's ranks on a named grid, seen from this rank.

    ``shape`` maps each axis name to its size, in order; ``ranks`` is the
    grid of world ranks.  `index` is this rank's coordinate along an axis
    and `group` the group of ranks it talks to along it."""

    shape: dict[str, int]
    ranks: np.ndarray
    coords: tuple[int, ...]
    groups: tuple[Group, ...] = field(repr=False)

    @property
    def axis_names(self) -> tuple[str, ...]:
        return tuple(self.shape)

    def _axis(self, axis: str) -> int:
        if axis not in self.shape:
            raise ValueError(f"no mesh axis {axis!r}; mesh has {self.axis_names}")
        return self.axis_names.index(axis)

    def index(self, axis: str) -> int:
        """This rank's coordinate along ``axis`` (JAX's ``axis_index``)."""
        return self.coords[self._axis(axis)]

    def group(self, axis: str) -> Group:
        """The ranks that share every coordinate but ``axis`` with this
        rank, ordered along it: collectives over it run over the axis."""
        return self.groups[self._axis(axis)]


def make_mesh(shape: int | Sequence[int] | None = None,
              axis_names: Sequence[str] = (DATA_AXIS,)) -> Mesh:
    """Lay the world's ranks out row-major on a grid of ``shape`` (an int
    for one axis; None for the whole world on one axis) with the named
    axes.  The grid must hold the world exactly.  Every rank calls it, with
    the same arguments, in the same order as its other `comm.new_group`
    calls."""
    axis_names = tuple(axis_names)
    world = world_size()
    if shape is None:
        if len(axis_names) != 1:
            raise ValueError("shape required for multi-axis meshes")
        shape = (world,)
    shape = (shape,) if isinstance(shape, int) else tuple(shape)
    if len(shape) != len(axis_names):
        raise ValueError(f"mesh shape {shape} and axis names {axis_names} differ in length")
    if len(set(axis_names)) != len(axis_names):
        raise ValueError(f"mesh axis names {axis_names} repeat")
    n = int(np.prod(shape))
    if n != world:
        raise ValueError(f"mesh shape {shape} holds {n} ranks; the world has {world}")
    grid = np.arange(n).reshape(shape)
    me = rank()
    groups = []
    for i, size in enumerate(shape):
        mine = None
        # every row along axis i, in the same order on every rank
        for row in np.moveaxis(grid, i, -1).reshape(-1, size):
            members = tuple(int(r) for r in row)
            group = Group(members) if size == world else new_group(members)
            if me in members:
                mine = group
        groups.append(mine)
    coords = tuple(int(c) for c in np.unravel_index(me, shape))
    return Mesh(dict(zip(axis_names, shape)), grid, coords, tuple(groups))


def world_mesh(axis_name: str = DATA_AXIS) -> Mesh:
    """The 1-D mesh over the whole world: data parallelism's."""
    return make_mesh(None, (axis_name,))
