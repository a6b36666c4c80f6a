"""The (half, data) layout of a multi-process run (port of
``thunder_tpu.parallel.mesh``).

The JAX package lays its devices out as a (half, data) mesh:
``make_mesh(n_halves=2)`` reshapes them to (2, n / 2) when their count is
even and to (1, n) when it is odd (thunder_tpu/parallel/mesh.py:29-40).
The port lays its ranks out the same way. On (2, W/2) rank r sits at half
r // (W/2) and data index r % (W/2): it holds, inserts, symmetrises and
reconstructs only its hemisphere's images, brick tables and maps (the
local half axis has length 1), sums its insert tables over its
hemisphere's data ranks (``data_group``) and meets the rank of the other
half at its data index (``pair_group``) for the half maps. On (1, W) every
rank holds both halves' rows of its own slot range, and the data group is
the world. Results do not depend on the layout in either package.
"""

import dataclasses

from . import distributed

HALF_AXIS = "half"
DATA_AXIS = "data"


@dataclasses.dataclass(frozen=True)
class Mesh:
    """World size, this process's rank and the size of the half axis (2:
    one hemisphere a rank; 1: both halves on every rank)."""

    world: int = 1
    rank: int = 0
    halves: int = 1

    @property
    def shape(self):
        return {HALF_AXIS: self.halves, DATA_AXIS: self.n_data}

    @property
    def n_data(self):
        return self.world // self.halves

    @property
    def local_halves(self):
        """The length of this rank's half axis (``lh``): 2 // halves."""
        return 2 // self.halves

    def coords(self, index=None):
        """Rank ``index``'s (half, data) coordinates (default this
        rank's)."""
        return divmod(self.rank if index is None else index, self.n_data)

    def block(self, s, index=None):
        """Rank ``index``'s (default this rank's) block of the (2, S, ...)
        half-plane layout of ``s`` slots: (the planes, a slice of the half
        axis; the slots, a slice of S). On (2, W/2) rank r holds plane
        r // (W/2) and data slice r % (W/2) of S; on (1, W) both planes'
        slice r."""
        h, d = self.coords(index)
        planes = slice(h, h + 1) if self.halves == 2 else slice(0, 2)
        return planes, distributed.local_plane_rows(s, self.n_data, d)

    def blocks(self, s):
        """Every rank's ``block`` of ``s`` slots, in rank order (what
        ``distributed.gather_plane`` assembles)."""
        return [self.block(s, r) for r in range(self.world)]

    @property
    def planes(self):
        """This rank's slice of the half axis."""
        return self.block(0)[0]

    def _group(self, ranks):
        return layout_groups(self.world, self.halves)[ranks]

    def data_group(self):
        """This rank's hemisphere's data ranks (the world on one half)."""
        h = self.coords()[0]
        return self._group(tuple(range(h * self.n_data,
                                       (h + 1) * self.n_data)))

    def pair_group(self):
        """The ranks of both halves at this rank's data index; None on
        one half, where every rank holds both."""
        if self.halves == 1:
            return None
        d = self.coords()[1]
        return self._group((d, self.n_data + d))


def layout_groups(world, halves):
    """The sub-groups (``distributed.group``) of a (``halves``, world /
    halves) layout, keyed by their ranks: each hemisphere's data ranks and,
    on two halves, the pair of ranks at each data index. Every rank makes
    them in the same order, as ``dist.new_group`` needs (``make_mesh``
    does, in a process group)."""
    if world > 1 and distributed.world_size() != world:
        raise RuntimeError(f"a layout of {world} ranks in a process group "
                           f"of {distributed.world_size()}")
    n_data = world // halves
    sets = [tuple(range(h * n_data, (h + 1) * n_data))
            for h in range(halves)]
    if halves == 2:
        sets += [(d, n_data + d) for d in range(n_data)]
    return {ranks: distributed.group(ranks) for ranks in sets}


def make_mesh(n_halves=2):
    """The layout of the process group's ranks (one rank when this
    process joined none) as (n_halves, world / n_halves), or (1, world)
    when ``n_halves`` does not divide the world, as the JAX package's
    ``make_mesh`` does. A process group's sub-groups are made here, on
    every rank."""
    world = distributed.world_size()
    if n_halves not in (1, 2):
        raise ValueError(f"n_halves={n_halves}: a mesh has 1 or 2 halves")
    if world % n_halves:
        n_halves = 1
    mesh = Mesh(world=world, rank=distributed.rank(), halves=n_halves)
    if world > 1 and distributed.backend() is not None:
        layout_groups(world, n_halves)
    return mesh
