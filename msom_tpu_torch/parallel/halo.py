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
ops.bc.pad of the whole field.

The halo/compute overlap (JAX's MSOM_HALO_OVERLAP forms, halo.py:123-180,
which the sharded steps always take; the port reads no such variable):
`ghosted_issue` posts the whole ring's transfers at once and returns a
`PendingGhosted`, whose `wait()` completes them and gives the `Ghosted`
of `ghosted_sharded`, bit for bit. The corners come from the diagonal
neighbours, sent with the edges, so that no transfer waits for another.
`neighbor_sum_overlap_g` and `laplacian_overlap_g` enqueue the interior
of their stencil from the tile alone before that wait and the one-cell
rim after it, where a transfer is in flight and the tile holds at least
SPLIT_MIN_BYTES; otherwise they wait and sum the whole ring. Under NCCL
a wait holds the card's stream, not the host, so the interior runs while
the transfers are in flight; under gloo the host computes the interior
while gloo's thread moves the bytes.

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
from msom_tpu_torch.ops.ghost import Ghosted, neighbor_sum
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
    sends, recvs = [], []
    # sends in the order (next, prev), receives (prev, next): two messages
    # between one pair of ranks (size 2, wrapped) then match in order
    if next_ok:
        sends.append((last.contiguous(), nxt))
    if prev_ok:
        sends.append((first.contiguous(), prev))
        recvs.append((lo, prev))
    if next_ok:
        recvs.append((hi, nxt))
    for req in _post(sends, recvs):
        req.wait()
    return lo, hi


def _post(sends, recvs) -> list:
    """Post the point-to-point transfers `sends` [(tensor, to rank)] and
    `recvs` [(buffer, from rank)] in one batch; the pending works. The
    caller keeps every tensor referenced until it has waited on them."""
    ops = [td.P2POp(td.isend, t, r) for t, r in sends]
    ops += [td.P2POp(td.irecv, t, r) for t, r in recvs]
    return td.batch_isend_irecv(ops) if ops else []


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


# ---------------------------------------------------------------------------
# the halo/compute overlap
# ---------------------------------------------------------------------------

# The interior/rim split adds the rim's six launches to a stencil and pays
# only where the card, not the host, sets the pace: where the interior's
# three adds (nine tile-sized reads and writes) keep the card busy at
# least as long as six launches keep the host. With one H100's 3.35 TB/s
# and the sharded multigrid's host at about 20 us a launch (12,074
# launches in 235.5 ms a step at 2048^2 x 4 f32, chip_smoke.py's shard
# phase), that is a tile of about 45 MB: one rank's 2048^2 x 4 f32 tile
# (67 MB) splits; its coarser levels, and the 2048^2 x 4 tiles of two or
# more ranks, wait and sum the whole ring (split on every level, with the
# rings held in flight at world size 1, it cost that step 9-14%).
SPLIT_MIN_BYTES = 6 * 20e-6 * 3.35e12 / 9


# the ring's sides (dy, dx), edges first: the order of the sends, and of
# the receives of the same transfers at the other end, so that two
# messages between one pair of ranks match in the order they were posted
_SIDES = ((0, 1), (0, -1), (1, 0), (-1, 0), (1, 1), (1, -1), (-1, 1),
          (-1, -1))


def _edge(n: int, d: int) -> slice:
    """The tile's cells on side d of an axis of n: the last (d = 1), the
    first (d = -1), all (d = 0)."""
    return slice(n - 1, n) if d == 1 else slice(0, 1) if d == -1 \
        else slice(0, n)


def _ring(n: int, d: int) -> slice:
    """The padded array's ghost cells on side d of an axis of n cells."""
    return slice(n + 1, n + 2) if d == 1 else slice(0, 1) if d == -1 \
        else slice(1, n + 1)


def _inner(n: int, d: int) -> slice:
    """The padded array's cells of the tile's edge on side d."""
    return slice(n, n + 1) if d == 1 else slice(1, 2) if d == -1 \
        else slice(1, n + 1)


class PendingGhosted:
    """A ghost ring whose transfers are in flight (`ghosted_issue`): `a`
    is the tile, there at once; `wait()` completes the transfers and
    returns the Ghosted of `ghosted_sharded` (made once, then kept). It
    holds the send temporaries and the receive buffers until then."""

    def __init__(self, a: torch.Tensor, works=(), finish=None,
                 ghosted: Ghosted | None = None, keep=()):
        self.a = a
        self._works, self._finish, self._g = list(works), finish, ghosted
        self._keep = keep

    @classmethod
    def ready(cls, g: Ghosted) -> "PendingGhosted":
        """A completed ring (nothing in flight)."""
        return cls(g.a, ghosted=g)

    @property
    def done(self) -> bool:
        """Whether the ring is complete (waited on, or never in flight)."""
        return self._g is not None

    def wait(self) -> Ghosted:
        if self._g is None:
            for w in self._works:
                w.wait()
            self._g = self._finish()
            self._works, self._finish, self._keep = [], None, ()
        return self._g


def ghosted_issue(a: torch.Tensor, bc: BC, mesh: Mesh) -> PendingGhosted:
    """`ghosted_sharded` with its transfers posted and not waited on. Every
    rank sends its edge rows and columns and its corner cells to the eight
    neighbours at once (the diagonal ones give the corners, which
    ghosted_sharded takes from the x-extended rows); `wait()` writes them
    into the padded tile, with the rule of `bc` where a wall has no
    neighbour: sign * the edge cell, and at a corner sign * the ring's
    cell beside it along the wall. Where no axis has a neighbour to send
    to, the ring is ghosted_sharded's, complete at once."""
    if mesh.my * mesh.mx == 1:
        return PendingGhosted.ready(ghosted_sharded(a, bc, mesh))
    wrap = bc is BC.PERIODIC
    sign = 1.0 if bc is BC.NEUMANN else -1.0
    ny, nx = a.shape[-2], a.shape[-1]
    me = mesh.rank_of(mesh.yi, mesh.xi)

    def nbr(dy, dx):
        y, x = mesh.yi + dy, mesh.xi + dx
        if not wrap and not (0 <= y < mesh.my and 0 <= x < mesh.mx):
            return None
        return mesh.rank_of(y, x)

    def edge(dy, dx):
        return a[..., _edge(ny, dy), _edge(nx, dx)]

    sends, recvs, bufs = [], [], {}
    for d in _SIDES:
        r = nbr(*d)
        if r is not None and r != me:
            sends.append((edge(*d).contiguous(), r))
    for dy, dx in _SIDES:
        # the ghosts on side -d: what that neighbour sent towards d
        e = (-dy, -dx)
        r = nbr(*e)
        if r is not None and r != me:
            bufs[e] = a.new_empty(edge(*e).shape)
            recvs.append((bufs[e], r))
    works = _post(sends, recvs)
    keep = (sends, recvs)

    def finish():
        p = a.new_empty((*a.shape[:-2], ny + 2, nx + 2))
        p[..., 1:-1, 1:-1] = a
        for e in _SIDES:
            ey, ex = e
            r = nbr(*e)
            if e in bufs:
                v = bufs[e]
            elif r == me:                        # wrapped onto this rank
                v = edge(-ey, -ex)
            elif ey == 0 or ex == 0:             # an edge at a wall
                v = sign * edge(*e)
            elif nbr(ey, 0) is None and nbr(0, ex) is None:
                v = sign * (sign * edge(*e))     # a corner of the grid
            elif nbr(ey, 0) is None:             # a y wall: the x ghost
                v = sign * p[..., _inner(ny, ey), _ring(nx, ex)]
            else:                                # an x wall: the y ghost
                v = sign * p[..., _ring(ny, ey), _inner(nx, ex)]
            p[..., _ring(ny, ey), _ring(nx, ex)] = v
        return Ghosted(p)

    return PendingGhosted(a, works, finish, keep=keep)


def _rim_sum(out: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """Write the one-cell rim of the neighbour sum E + W + N + S into
    `out` from the padded tile `p`, in that association order (each cell
    the bits of ops.ghost.neighbor_sum): the first and last rows in three
    launches, the first and last columns between them in three more."""
    ny, nx = out.shape[-2], out.shape[-1]
    rows = out[..., 0:ny:ny - 1, :]
    torch.add(p[..., 1:ny + 1:ny - 1, 2:], p[..., 1:ny + 1:ny - 1, :-2],
              out=rows)
    rows.add_(p[..., 2:ny + 2:ny - 1, 1:-1])
    rows.add_(p[..., 0:ny:ny - 1, 1:-1])
    cols = out[..., 1:-1, 0:nx:nx - 1]
    torch.add(p[..., 2:ny, 2:nx + 2:nx - 1], p[..., 2:ny, 0:nx:nx - 1],
              out=cols)
    cols.add_(p[..., 3:ny + 1, 1:nx + 1:nx - 1])
    cols.add_(p[..., 1:ny - 1, 1:nx + 1:nx - 1])
    return out


def neighbor_sum_overlap_g(pg: PendingGhosted) -> torch.Tensor:
    """E + W + N + S of a tile whose ring is in flight (halo.py:147-158):
    the interior from the tile alone, enqueued before `pg.wait()`, the rim
    from the ring after it. Bit for bit neighbor_sum(pg.wait()), which is
    what a complete ring, a tile with no interior or a tile of fewer than
    SPLIT_MIN_BYTES takes."""
    a = pg.a
    ny, nx = a.shape[-2], a.shape[-1]
    if pg.done or ny < 3 or nx < 3 or \
            a.numel() * a.element_size() < SPLIT_MIN_BYTES:
        return neighbor_sum(pg.wait())
    out = torch.empty_like(a)
    mid = out[..., 1:-1, 1:-1]
    torch.add(a[..., 1:-1, 2:], a[..., 1:-1, :-2], out=mid)
    mid.add_(a[..., 2:, 1:-1])
    mid.add_(a[..., :-2, 1:-1])
    return _rim_sum(out, pg.wait().p)


def neighbor_sum_overlap(a: torch.Tensor, bc: BC, mesh: Mesh
                         ) -> torch.Tensor:
    """neighbor_sum_overlap_g of a fresh `ghosted_issue`."""
    return neighbor_sum_overlap_g(ghosted_issue(a, bc, mesh))


def laplacian_overlap_g(pg: PendingGhosted, delta: float) -> torch.Tensor:
    """(E + W + N + S - 4 C) / delta^2 of a tile whose ring is in flight,
    bit for bit laplacian_g(pg.wait(), delta)."""
    return (neighbor_sum_overlap_g(pg) - 4.0 * pg.a) / (delta * delta)


def laplacian_overlap(a: torch.Tensor, bc: BC, delta: float, mesh: Mesh
                      ) -> torch.Tensor:
    """laplacian_overlap_g of a fresh `ghosted_issue`."""
    return laplacian_overlap_g(ghosted_issue(a, bc, mesh), delta)


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
