"""Halo exchanges and reductions of a sharded run (the port of
`msom_tpu.parallel.halo`, over torch.distributed).

The rows decomposition: rank r of a world of W holds the rows
[r n_loc, (r + 1) n_loc) of every (..., N, N) field, x whole. Its
y-neighbours are ranks r - 1 (the rows below, "up" in the halo slabs'
order) and r + 1, wrapped around when the domain is periodic
(`ext_rows8`).

The 2-D mesh (parallel/mesh.py; a rows decomposition is the (W, 1)
mesh): the rank at (yi, xi) holds a tile; its x-neighbours are
(yi, xi -/+ 1), its y-neighbours (yi -/+ 1, xi) (`ghosted_sharded`,
`ghosted_slip_sharded`, `gather_global`, `local_tile`). The ghost
columns come first, then the ghost rows of the x-extended tile, so that
a corner ghost is the diagonal neighbour's cell
(the JAX package's `ext_row`, halo.py:45-83) and every ghost equals
ops.bc.pad of the whole field. JAX's MSOM_HALO_OVERLAP form
(halo.py:123-180) is bitwise the plain form and is not ported: the
exchanges here are the plain ones.

The exchanges are point-to-point (batch_isend_irecv): every rank sends its
first rows (columns) to its lower neighbour and its last to its upper one.
Along an axis of size 1 nothing is sent (a send to the same rank is no
supported NCCL pattern): the slabs are the tile's own edges (periodic) or
zeros (walls). The reductions (`pmax`, `psum`) go through the group at
every world size that has one: one all_reduce over every rank is the JAX
package's pmax2 and psum2 (halo.py:182-188), which reduce over y, then x.
"""

from __future__ import annotations

import torch
import torch.distributed as td

from msom_tpu_torch.ops.bc import BC
from msom_tpu_torch.ops.ghost import Ghosted
from msom_tpu_torch.parallel import dist
from msom_tpu_torch.parallel.mesh import Mesh


def _exchange_axis(a: torch.Tensor, h: int, wrap: bool, axis: int,
                   pos: int, size: int, prev: int, nxt: int):
    """(lo, hi) along `axis` (-2 or -1): the last h rows (columns) of the
    rank `prev` below this one and the first h of the rank `nxt` above;
    `pos` is this rank's place on an axis of `size` ranks. Zeros where a
    wall has no neighbour."""
    n = a.shape[axis]
    first, last = a.narrow(axis, 0, h), a.narrow(axis, n - h, h)
    if size == 1:
        if wrap:
            return last, first
        z = torch.zeros_like(first)
        return z, z
    lo = torch.zeros_like(first)
    hi = torch.zeros_like(first)
    prev_ok, next_ok = wrap or pos > 0, wrap or pos < size - 1
    ops = []
    # sends in the order (next, prev), receives (prev, next): two messages
    # between one pair of ranks (size 2, wrapped) then match in order
    if next_ok:
        ops.append(td.P2POp(td.isend, last.contiguous(), nxt))
    if prev_ok:
        ops.append(td.P2POp(td.isend, first.contiguous(), prev))
        ops.append(td.P2POp(td.irecv, lo, prev))
    if next_ok:
        ops.append(td.P2POp(td.irecv, hi, nxt))
    for req in td.batch_isend_irecv(ops):
        req.wait()
    return lo, hi


def _exchange(a: torch.Tensor, h: int, wrap: bool):
    """(up, dn) of the rows decomposition: the last h rows of rank r - 1
    and the first h rows of rank r + 1 (axis -2); zeros where a wall has
    no neighbour."""
    W, r = dist.world_size(), dist.rank()
    return _exchange_axis(a, h, wrap, -2, r, W, (r - 1) % W, (r + 1) % W)


def ext_rows8(a: torch.Tensor, wrap: bool = False) -> torch.Tensor:
    """cat([up8, a, dn8], axis=-2): the shard extended with the 8-row halo
    slabs of its y-neighbours, the input layout of the rows mode of K1 and
    K2 (fused_rhs.rhs_fused, fused_tracer.tracer_fused). At a wall that is
    not wrapped the slab is zeros and is never read: the kernels' wall rules
    key on the global row. The shard needs 8 rows at least."""
    if a.shape[-2] < 8:
        raise ValueError(f"ext_rows8: a shard of {a.shape[-2]} rows, 8 at "
                         "least")
    up, dn = _exchange(a, 8, wrap)
    return torch.cat([up, a, dn], dim=-2).contiguous()


def split_rows8(a: torch.Tensor, world: int, wrap: bool = False) -> list:
    """The `ext_rows8` of every rank of a `world`-way rows decomposition of
    the whole field `a`, made on one process (virtual shards: for holding
    the rows mode of a kernel against its whole-field launch)."""
    N = a.shape[-2]
    n = N // world
    if n * world != N or n < 8:
        raise ValueError(f"split_rows8: {N} rows in {world} shards of 8 "
                         "rows or more")
    out = []
    for d in range(world):
        rows = torch.arange(d * n - 8, (d + 1) * n + 8, device=a.device)
        ext = a.index_select(a.ndim - 2, rows % N)
        if not wrap:
            ext[..., (rows < 0) | (rows >= N), :] = 0
        out.append(ext.contiguous())
    return out


def pmax(x: torch.Tensor) -> torch.Tensor:
    """The elementwise maximum over the ranks (the CFL maxima, the
    multigrid's residual norm)."""
    if not dist.active():
        return x
    x = x.clone()
    td.all_reduce(x, op=td.ReduceOp.MAX)
    return x


def psum(x: torch.Tensor) -> torch.Tensor:
    """The sum over the ranks (the KE partials; JAX sums over y, then x,
    the same terms in another order)."""
    if not dist.active():
        return x
    x = x.clone()
    td.all_reduce(x, op=td.ReduceOp.SUM)
    return x


# ---------------------------------------------------------------------------
# the 2-D mesh
# ---------------------------------------------------------------------------

def _ghost_pair(a, wrap: bool, sign: float, axis: int, mesh: Mesh):
    """(lo, hi) ghost slabs of width 1 along `axis`: the neighbours' edges,
    or sign * the tile's own edge at a wall."""
    if axis == -1:
        pos, size = mesh.xi, mesh.mx
        prev = mesh.rank_of(mesh.yi, mesh.xi - 1)
        nxt = mesh.rank_of(mesh.yi, mesh.xi + 1)
    else:
        pos, size = mesh.yi, mesh.my
        prev = mesh.rank_of(mesh.yi - 1, mesh.xi)
        nxt = mesh.rank_of(mesh.yi + 1, mesh.xi)
    lo, hi = _exchange_axis(a, 1, wrap, axis, pos, size, prev, nxt)
    if not wrap:
        n = a.shape[axis]
        if pos == 0:
            lo = sign * a.narrow(axis, 0, 1)
        if pos == size - 1:
            hi = sign * a.narrow(axis, n - 1, 1)
    return lo, hi


def ghosted_sharded(a: torch.Tensor, bc: BC, mesh: Mesh) -> Ghosted:
    """This rank's tile of an (..., N, N) field with its ghost ring
    (halo.py:45-83): the x-neighbours' edge columns, then the y-neighbours'
    x-extended edge rows, corners included; at a wall the rule of `bc`.
    Equal, bit for bit, to the tile's window of ops.bc.pad of the whole
    field."""
    wrap = bc is BC.PERIODIC
    sign = 1.0 if bc is BC.NEUMANN else -1.0
    lo, hi = _ghost_pair(a, wrap, sign, -1, mesh)
    ax = torch.cat([lo, a, hi], dim=-1)
    lo, hi = _ghost_pair(ax, wrap, sign, -2, mesh)
    return Ghosted(torch.cat([lo, ax, hi], dim=-2))


def ghosted_slip_sharded(zeta: torch.Tensor, psi: Ghosted, sbc: float,
                         delta: float, mesh: Mesh) -> Ghosted:
    """The tile of ops.ghost.ghosted_slip (partial-slip ghosts of a
    Laplacian-derived field, halo.py:86-107): the Dirichlet ghosts of
    `ghosted_sharded`, and at a physical wall the ghost
    c * (psi_in - psi_ghost) from the tile's ghosted psi. A corner of the
    tile's ring that lies on a wall of the whole grid, not in one of its
    corners, takes the slip value too: the whole field's law, which the
    Arakawa Jacobian reads there (the JAX package's sharded form keeps the
    Dirichlet fill: ROADMAP.md §3). Equal, bit for bit, to the tile's
    window of ghosted_slip."""
    base = ghosted_sharded(zeta, BC.DIRICHLET, mesh)
    if sbc <= 0:
        return base
    c = sbc / ((0.5 * sbc + 1.0) * delta * delta)
    P, z = psi.p, base.p.clone()
    ny, nx = z.shape[-2], z.shape[-1]
    # the ring positions that are not corners of the whole grid
    r0, r1 = (1 if mesh.yi == 0 else 0), (ny - 1 if mesh.yi == mesh.my - 1
                                         else ny)
    c0, c1 = (1 if mesh.xi == 0 else 0), (nx - 1 if mesh.xi == mesh.mx - 1
                                         else nx)
    if mesh.xi == 0:
        z[..., r0:r1, 0] = c * (P[..., r0:r1, 1] - P[..., r0:r1, 0])
    if mesh.xi == mesh.mx - 1:
        z[..., r0:r1, -1] = c * (P[..., r0:r1, -2] - P[..., r0:r1, -1])
    if mesh.yi == 0:
        z[..., 0, c0:c1] = c * (P[..., 1, c0:c1] - P[..., 0, c0:c1])
    if mesh.yi == mesh.my - 1:
        z[..., -1, c0:c1] = c * (P[..., -2, c0:c1] - P[..., -1, c0:c1])
    return Ghosted(z)


def gather_global(a: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The whole (..., ny, nx) field from every rank's (..., ny/my, nx/mx)
    tile, on every rank (halo.py:190-196): one all_gather of the world,
    the tiles put in their places. The identity on a (1, 1) mesh."""
    if mesh.my * mesh.mx == 1:
        return a
    a = a.contiguous()
    parts = [torch.empty_like(a) for _ in range(mesh.my * mesh.mx)]
    td.all_gather(parts, a)
    rows = [torch.cat(parts[y * mesh.mx:(y + 1) * mesh.mx], dim=-1)
            for y in range(mesh.my)]
    return torch.cat(rows, dim=-2)


def local_tile(a: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """This rank's (..., ny/my, nx/mx) tile of a whole field that every rank
    holds (halo.py:198-209); a unit x axis (a y-profile) is kept whole."""
    rows, cols = mesh.tile(a.shape[-2], a.shape[-1])
    if a.shape[-1] == 1:
        cols = slice(None)
    return a[..., rows, cols].contiguous()
