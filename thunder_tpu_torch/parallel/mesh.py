"""The layout of a multi-process run (port of ``thunder_tpu.parallel.mesh``).

The JAX package lays one (half, data) mesh over every device. The port
keeps the axis names and splits on the data axis only: every rank holds
both halves' rows of its own slot range (``distributed.local_plane_rows``)
and batches them on one device, as a single process does, so the half
axis has size 1. The JAX package picks the same shape itself when the
device count is odd (thunder_tpu/parallel/mesh.py:35-37); results do not
depend on the layout in either package.
"""

import dataclasses

from . import distributed

HALF_AXIS = "half"
DATA_AXIS = "data"


@dataclasses.dataclass(frozen=True)
class Mesh:
    """World size, this process's rank and the (half, data) mesh shape."""

    world: int = 1
    rank: int = 0

    @property
    def shape(self):
        return {HALF_AXIS: 1, DATA_AXIS: self.world}


def make_mesh():
    """The layout of the process group this process joined (one rank when
    it joined none)."""
    return Mesh(world=distributed.world_size(), rank=distributed.rank())
