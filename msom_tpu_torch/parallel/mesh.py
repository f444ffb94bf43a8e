"""The 2-D (y, x) process mesh of a sharded run (the port of
`msom_tpu.parallel.mesh`, over torch.distributed).

A world of W ranks is laid out as my x mx, as square as possible by the JAX
package's rule (mesh.py:27-41: my the largest divisor of W at most
sqrt(W)); the rank at mesh row yi and column xi is yi * mx + xi, and it
holds the tile [yi N/my, (yi + 1) N/my) x [xi N/mx, (xi + 1) N/mx) of every
(..., N, N) field. The x axis's collectives run on the group of the rank's
mesh row, the y axis's on the group of its column (`dist.subgroup`); an
axis of size 1 has no group and its collectives are the identity. Without
a process group the mesh is (1, 1).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from msom_tpu_torch.parallel import dist


def mesh_shape(world: int) -> tuple[int, int]:
    """(my, mx) as square as possible: my the largest divisor of `world`
    at most sqrt(world) (the JAX package's make_mesh)."""
    my = 1
    for cand in range(int(np.sqrt(world)), 0, -1):
        if world % cand == 0:
            my = cand
            break
    return my, world // my


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This rank's place in a (my, mx) mesh and the groups of its axes."""
    my: int
    mx: int
    yi: int
    xi: int
    row: object = None     # the group of this rank's mesh row (x axis)
    col: object = None     # the group of its mesh column (y axis)

    @property
    def shape(self) -> tuple[int, int]:
        return self.my, self.mx

    def rank_of(self, yi: int, xi: int) -> int:
        """The rank at (yi, xi), wrapped around each axis."""
        return (yi % self.my) * self.mx + xi % self.mx

    def tile(self, ny: int, nx: int) -> tuple[slice, slice]:
        """(rows, cols) of this rank's tile of an (ny, nx) grid."""
        ty, tx = ny // self.my, nx // self.mx
        return (slice(self.yi * ty, (self.yi + 1) * ty),
                slice(self.xi * tx, (self.xi + 1) * tx))


def make_mesh(shape: tuple[int, int] | None = None) -> Mesh:
    """This rank's Mesh of the running group (world size 1 without one):
    `shape` (my, mx), by default `mesh_shape(world)`. Every rank calls it
    together: it makes the row and column groups of the axes longer than
    one (collectively, in the same order on every rank)."""
    world, rank = dist.world_size(), dist.rank()
    my, mx = mesh_shape(world) if shape is None else map(int, shape)
    if my * mx != world:
        raise ValueError(f"a {my} x {mx} mesh on {world} ranks")
    yi, xi = divmod(rank, mx)
    row = col = None
    if dist.active():
        if mx > 1:
            for y in range(my):
                g = dist.subgroup(y * mx + x for x in range(mx))
                row = g if y == yi else row
        if my > 1:
            for x in range(mx):
                g = dist.subgroup(y * mx + x for y in range(my))
                col = g if x == xi else col
    return Mesh(my, mx, yi, xi, row, col)
