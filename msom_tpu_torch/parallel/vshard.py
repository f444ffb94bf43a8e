"""Vertex-grid sharding of the qg-node model (the port of
`msom_tpu.parallel.vshard`, over torch.distributed).

**The owned-node representation.** A whole (nl, N+1, N+1) vertex field is
held as its (nl, N, N) "owned" block, rows and columns 0..N-1, which cuts
evenly into the tiles of a (my, mx) mesh (parallel/mesh.py). A node that
two tiles share is owned by the lower or left tile; the other sees it as a
ghost. The dropped row and column N are the wall ring: zero for psi and for
every multigrid field (masked, ring zeroed), or the frozen partial-slip
values of q that comp_q's bc_deriv sets (`VertexRing`, a small field that
every rank holds whole), which `vghost` puts into the ghosts where a
stencil reads them. The reductions (the CFL maximum, the residual norm,
the KE sums) run over owned nodes only and then over the ranks
(`halo.pmax`, `halo.psum`), so no node is counted twice.

**The sharded vertex multigrid** (`vpoisson_sharded`) follows
parallel/shard_mg.py: the fine levels stay cut into tiles, with a ghost
exchange for each red-black colour and across the transfers; at the first
level whose tile would fall below 2 x 2 owned nodes the residual is
gathered once (`halo.gather_global`) and the rest of the V-cycle runs whole
and alike on every rank through solvers/vmg.py (kernel K6 on a CUDA
tensor), cut back to the tile where it meets the sharded levels again. At
world size 1 every level down to n = 3 nodes is a tile, so the sharded
step launches neither K5 nor K6: like the JAX package's, it is tensor ops.

**Arithmetic.** Every operation repeats the unsharded port's arithmetic
term for term (models/qg_node.py, fused_node_rhs.rhs_node_reference,
solvers/vmg.py), so q and psi of a sharded step are the same bits on every
mesh and the same as the unsharded step's plain version; only the KE sums
of `diag_1d_sharded` add their terms in another order.

**The stochastic kick.** Every rank draws the whole (nl, N+1, N+1) noise
from its own generator, seeded alike, and keeps its tile: the kick is the
unsharded draw bit for bit (JAX draws it whole from the shared key, the
same idea).

**The filter event** (`make_node_filter_sharded`) runs the masked wavelet
pyramid with the fine levels on tiles and one gather where the levels stop
cutting (the shard_mg rule), and refreezes the q ring from the filtered
psi.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from msom_tpu_torch.models import qg_node as node
from msom_tpu_torch.models.qg import dtnext
from msom_tpu_torch.ops import tridiag, vertex
from msom_tpu_torch.ops.bc import BC
from msom_tpu_torch.ops.ghost import Ghosted, arakawa_mjac_g
from msom_tpu_torch.ops.stretch import stretch
from msom_tpu_torch.parallel import halo, shard_mg
from msom_tpu_torch.parallel.mesh import Mesh
from msom_tpu_torch.solvers import mg, vmg
from msom_tpu_torch.solvers.mg import MGStats

PERIODIC_REFUSAL = ("vertex sharding covers wall domains; run periodic "
                    "qg-node configs on the unsharded/GSPMD path")


# ---------------------------------------------------------------------------
# the owned-node representation
# ---------------------------------------------------------------------------

def to_owned(a_full: torch.Tensor) -> torch.Tensor:
    """(..., N+1, N+1) -> (..., N, N): the wall ring row and column N
    dropped (a view)."""
    return a_full[..., :-1, :-1]


def to_full(a_own: torch.Tensor, ring_row=None,
            ring_col=None) -> torch.Tensor:
    """The dropped ring put back: `ring_row` the (..., N) values of row N
    over columns 0..N-1, `ring_col` those of column N over rows 0..N-1
    (zeros by default, right for psi and every multigrid field), the
    corner (N, N) zero."""
    lead, (ny, nx) = a_own.shape[:-2], a_own.shape[-2:]
    if ring_row is None:
        ring_row = a_own.new_zeros(lead + (nx,))
    if ring_col is None:
        ring_col = a_own.new_zeros(lead + (ny,))
    top = torch.cat([ring_row, a_own.new_zeros(lead + (1,))], dim=-1)
    mid = torch.cat([a_own, ring_col[..., :, None]], dim=-1)
    return torch.cat([mid, top[..., None, :]], dim=-2)


@dataclasses.dataclass(frozen=True)
class VertexRing:
    """The frozen dropped ring of q (set by comp_q's bc_deriv, qg-node/
    qg.h:211-214; dq is masked there, so a step never changes it), on
    every rank whole: O(N) data. psi_pg's and the topography's rings are
    held the same way."""
    q_top: torch.Tensor      # (nl, N): q[..., N, :N]
    q_right: torch.Tensor    # (nl, N): q[..., :N, N]


def owned_state(state: node.NodeQGState) -> node.NodeQGState:
    """A whole NodeQGState in the owned representation (views)."""
    return dataclasses.replace(
        state, q=to_owned(state.q), psi=to_owned(state.psi),
        psi_f=None if state.psi_f is None else to_owned(state.psi_f))


# ---------------------------------------------------------------------------
# ghosts of an owned tile
# ---------------------------------------------------------------------------

def vghost(a: torch.Tensor, mesh: Mesh, high_row=None,
           high_col=None) -> Ghosted:
    """This rank's owned tile of a vertex field with its ghost ring
    (vshard.py:113-156). Tile edges inside the grid take the neighbours'
    edges (the x-neighbours' columns first, then the y-neighbours' rows of
    the x-extended tile, corners included); the LOW walls (beyond row and
    column 0, read only by ring nodes, which are masked) take zeros; the
    HIGH walls (the dropped row and column N) take `high_row` (this
    tile's (..., nx) slice) and `high_col` ((..., ny)), or zeros. The
    corners of the high row come from the x-neighbours' high rows, zero at
    the grid's x walls (bc_deriv's corners are 0). `high_row` and
    `high_col` are read on the tiles of the top row and right column only,
    where the caller's values lie at the wall."""
    yi, xi, my, mx = mesh.yi, mesh.xi, mesh.my, mesh.mx
    top = high_row is not None and yi == my - 1
    # the top row's slip row rides along the column exchange, which then
    # brings its corner entries too
    src = torch.cat([a, high_row[..., None, :]], dim=-2) if top else a
    gl, gr = halo._exchange_axis(src, 1, False, -1, xi, mx,
                                 mesh.rank_of(yi, xi - 1),
                                 mesh.rank_of(yi, xi + 1))
    if top:
        cl, cr = gl[..., -1, :], gr[..., -1, :]
        gl, gr = gl[..., :-1, :], gr[..., :-1, :]
    if high_col is not None and xi == mx - 1:
        gr = high_col[..., :, None]
    ax = torch.cat([gl, a, gr], dim=-1)
    gb, gt = halo._exchange_axis(ax, 1, False, -2, yi, my,
                                 mesh.rank_of(yi - 1, xi),
                                 mesh.rank_of(yi + 1, xi))
    if top:
        gt = torch.cat([cl, high_row, cr], dim=-1)[..., None, :]
    return Ghosted(torch.cat([gb, ax, gt], dim=-2))


def bc_psi_own(psi: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """vertex.bc_psi on a tile: the stored ring, global row and column 0,
    zeroed (the dropped ring is zero by construction)."""
    return _set_stored_ring(psi, 0.0, 0.0, mesh)


def _set_stored_ring(field, row0, col0, mesh: Mesh):
    """A copy of `field` whose stored wall ring (global row 0 and column 0,
    on the tiles there) takes `row0` and `col0`, corner (0, 0) zero."""
    if mesh.yi and mesh.xi:
        return field
    out = field.clone()
    if mesh.yi == 0:
        out[..., 0, :] = row0
    if mesh.xi == 0:
        out[..., :, 0] = col0
        if mesh.yi == 0:
            out[..., 0, 0] = 0.0
    return out


def bc_deriv_own(field, psi, bc_fac: float, delta: float, mesh: Mesh):
    """vertex.bc_deriv on a tile: the stored ring takes 2 bc_fac / Delta^2
    times psi one node inward, corners 0; the dropped ring comes as
    `slip_high` ghosts. The wall tiles hold 2 rows and columns at least,
    so the node inward is the tile's own."""
    c = 2.0 * bc_fac / (delta * delta)
    return _set_stored_ring(field, c * psi[..., 1, :], c * psi[..., :, 1],
                            mesh)


def slip_high(psi, bc_fac: float, delta: float):
    """(high_row, high_col) ghosts of a zeta-like field at the dropped
    ring: 2 bc_fac / Delta^2 times the tile's last row and column (global
    row and column N-1 on the tiles at the high walls, where they are
    read)."""
    c = 2.0 * bc_fac / (delta * delta)
    return c * psi[..., -1, :], c * psi[..., :, -1]


def bc_deriv_rel_own(field, parent, bc_fac: float, delta: float,
                     mesh: Mesh):
    """vertex.bc_deriv_rel on a tile (set_bc_ms's rule for tmp,
    qg_baroclinic_ms.h:67-69): the stored ring takes 2 bc_fac / Delta^2
    (parent one node inward - the parent's ring); corners 0."""
    c = 2.0 * bc_fac / (delta * delta)
    return _set_stored_ring(field, c * (parent[..., 1, :] - parent[..., 0, :]),
                            c * (parent[..., :, 1] - parent[..., :, 0]),
                            mesh)


def slip_high_rel(parent, parent_hr, parent_hc, bc_fac: float,
                  delta: float):
    """The dropped-ring ghosts of the tmp rule: 2 bc_fac / Delta^2 (parent
    one node inward - the parent's own dropped-ring value)."""
    c = 2.0 * bc_fac / (delta * delta)
    return (c * (parent[..., -1, :] - parent_hr),
            c * (parent[..., :, -1] - parent_hc))


def ring_slices(ring: VertexRing, mesh: Mesh, ny: int, nx: int):
    """This tile's slices of a dropped ring, q's, psi_pg's or the
    topography's (read by the tiles at the high walls only)."""
    return (ring.q_top[..., mesh.xi * nx:(mesh.xi + 1) * nx],
            ring.q_right[..., mesh.yi * ny:(mesh.yi + 1) * ny])


def _vlap_own(g: Ghosted, delta: float) -> torch.Tensor:
    """(E + W + N + S - 4 C) / Delta^2 in vertex.vlap's order; the values
    at ring nodes are masked by the caller."""
    return (g.shift(0, 1) + g.shift(0, -1) + g.shift(1, 0) + g.shift(-1, 0)
            - 4 * g.a) / (delta * delta)


# ---------------------------------------------------------------------------
# the sharded vertex multigrid
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class TileLevel:
    """A vmg.VLevel cut to this rank's owned tile (the fields vmg's
    relaxation and residual read)."""
    delta: float
    S2: torch.Tensor | None
    lam: float
    mask: torch.Tensor
    t0: torch.Tensor
    cp: torch.Tensor
    im: torch.Tensor
    red: torch.Tensor
    black: torch.Tensor


def level_is_sharded(n_owned: int, my: int, mx: int) -> bool:
    """shard_mg's rule on the owned nodes: every tile keeps 2 x 2 nodes at
    least and even sides, so the colours and the restriction's even nodes
    stay aligned with the tile (vshard.py:305-309)."""
    return (n_owned % (2 * my) == 0 and n_owned % (2 * mx) == 0
            and n_owned // my >= 2 and n_owned // mx >= 2)


def prepare_vlevels(levels, mesh: Mesh):
    """(levels, flags): a TileLevel of each level that shards, the whole
    vmg.VLevel of each level of the replicated tail (vshard.py:319-328).
    Raises ValueError when the finest level does not cut into the mesh."""
    out, flags = [], []
    for lvl in levels:
        n = lvl.mask.shape[-1] - 1
        sh = level_is_sharded(n, mesh.my, mesh.mx)
        flags.append(sh)
        if not sh:
            out.append(lvl)
            continue

        def tile(x):
            return None if x is None else halo.local_tile(to_owned(x), mesh)

        red = tile(lvl.red)
        out.append(TileLevel(delta=lvl.delta, S2=tile(lvl.S2), lam=lvl.lam,
                             mask=tile(lvl.mask), t0=tile(lvl.t0),
                             cp=tile(lvl.cp), im=tile(lvl.im), red=red,
                             black=~red))
    if not flags[0]:
        n = levels[0].mask.shape[-1]
        raise ValueError(f"the finest vertex level ({n} nodes a side) does "
                         f"not cut into {mesh.my} x {mesh.mx} "
                         "tiles of 2 x 2 nodes or more with even sides")
    return out, tuple(flags)


def residual_v_sharded(a, b, lvl: TileLevel, idh0, idh1, mesh: Mesh):
    """(res, max|res| over the mesh) on a tile (vmg.residual_v)."""
    res = b - _vlap_own(vghost(a, mesh), lvl.delta)
    if lvl.S2 is not None:
        res = res - stretch(a, lvl.S2, idh0, idh1)
    if lvl.lam != 0.0:
        res = res + lvl.lam * a
    res = res * lvl.mask
    return res, halo.pmax(res.abs().max())


def relax_v_sharded(da, res, lvl: TileLevel, mesh: Mesh):
    """vmg.NRELAX red-black masked vertical-line sweeps on a tile, the
    ghosts exchanged for each colour (fused_vmg.one_color's arithmetic)."""
    d2 = lvl.delta * lvl.delta
    for _ in range(vmg.NRELAX):
        for cmask in (lvl.red, lvl.black):
            g = vghost(da, mesh)
            nb = g.shift(0, 1) + g.shift(0, -1) + g.shift(1, 0) \
                + g.shift(-1, 0)
            rhs = (-d2 * res + nb) * lvl.mask
            x = tridiag.solve_factored(lvl.cp, lvl.im, lvl.t0, rhs)
            da = torch.where(cmask, x * lvl.mask, da)
    return da


def vrestrict_weighted_sharded(f, mesh: Mesh):
    """vertex.vrestrict_weighted on a tile: (2 C + E + W + N + S) / 6 at
    the even nodes, zero beyond every wall."""
    g = vghost(f, mesh)

    def even(x):
        return x[..., ::2, ::2]

    return (2 * even(f) + even(g.shift(0, 1)) + even(g.shift(0, -1))
            + even(g.shift(1, 0)) + even(g.shift(-1, 0))) / 6.0


def vprolong_sharded(c, mesh: Mesh):
    """vertex.vprolong on a tile (injection, the 2-point and the 4-point
    means), the coarse correction's dropped ring (zero) as the high
    ghosts; the stored ring stays zero, as vmg's zero_ring_ leaves it."""
    g = vghost(c, mesh)
    E, Nn, NE = g.shift(0, 1), g.shift(1, 0), g.shift(1, 1)
    ny, nx = c.shape[-2:]
    out = c.new_empty(*c.shape[:-2], 2 * ny, 2 * nx)
    out[..., ::2, ::2] = c
    out[..., ::2, 1::2] = 0.5 * (c + E)
    out[..., 1::2, ::2] = 0.5 * (c + Nn)
    out[..., 1::2, 1::2] = 0.25 * (c + E + Nn + NE)
    return out


def vpoisson_sharded(a0, b, *, levels, sharded_flags, mesh: Mesh, idh0,
                     idh1, tolerance: float = 1e-5,
                     nitermax: int = vmg.NITERMAX):
    """vmg.vpoisson on this rank's (nl, ny, nx) owned tiles a0 and b; the
    ranks call it together. The same cycles and stopping rule (f32 stall
    cutoff included), the residual norm read on the host once a cycle,
    alike on every rank. Returns (the tile of a, MGStats)."""
    nlev = len(levels)
    sharded = sharded_flags
    stall_ratio = vmg.STALL_RATIO_F32 if b.element_size() <= 4 \
        else float("inf")

    def cycle(a, res):
        pyr = [res]
        for k in range(1, nlev):
            r = pyr[-1]
            if sharded[k - 1]:
                r = vrestrict_weighted_sharded(r, mesh)
                if not sharded[k]:
                    # the owned coarse grid whole, its zero ring put back
                    r = to_full(halo.gather_global(r, mesh))
            else:
                r = vertex.vrestrict_weighted(r)
            pyr.append(r)
        da = torch.zeros_like(pyr[-1])
        for k in range(nlev - 1, -1, -1):
            if k < nlev - 1:
                if sharded[k + 1]:
                    da = vprolong_sharded(da, mesh)
                else:
                    da = vertex.zero_ring_(vertex.vprolong(da))
                    if sharded[k]:        # whole -> tile
                        da = halo.local_tile(to_owned(da), mesh)
            if sharded[k]:
                da = relax_v_sharded(da, pyr[k], levels[k], mesh)
            else:
                da = vmg.relax_v(da, pyr[k], levels[k])
        return a + da

    def residual0(a):
        return residual_v_sharded(a, b, levels[0], idh0, idh1, mesh)

    a = a0
    res, maxres = residual0(a)
    resb = resa = maxres.item()
    resp = torch.finfo(b.dtype).max / 4
    iters = 0
    while iters < nitermax and (iters < 1 or (
            resa > tolerance and resa <= stall_ratio * resp)):
        a = cycle(a, res)
        res, maxres = residual0(a)
        resp, resa = resa, maxres.item()   # one device-to-host read a cycle
        iters += 1
    return a, MGStats(iters=iters, resb=resb, resa=resa, nrelax=vmg.NRELAX)


# ---------------------------------------------------------------------------
# the sharded node step
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class VertexShardConst:
    """This rank's constants of the sharded qg-node step: the owned tiles
    of the fields, the whole O(N) rings and y-column, the mixed multigrid
    levels and the filter pyramids (a level that shards as tiles)."""
    mesh: Mesh
    mask: torch.Tensor
    psi_pg: torch.Tensor | None       # None where psi_pg is zero
    pp_ring: VertexRing | None        # psi_pg's dropped ring
    S2: torch.Tensor | None
    yv: torch.Tensor                  # (N+1, 1) whole: the wind's y
    vlevels: list
    sharded_flags: tuple
    ring: VertexRing
    topo: torch.Tensor | None         # None where the topography is zero
    topo_ring: VertexRing | None
    q_forcing_3d: torch.Tensor | None
    noise: node.NodeQGConstants | None   # the whole draw's (stochastic)
    sig_lev_c: tuple | None
    mask_c: tuple | None
    wl_flags: tuple | None            # sharded flag a pyramid level
    idh0: tuple
    idh1: tuple


def _ring(a_full: torch.Tensor) -> VertexRing:
    """The dropped ring row and column N of a whole vertex field."""
    return VertexRing(q_top=a_full[..., -1, :-1].contiguous(),
                      q_right=a_full[..., :-1, -1].contiguous())


def _pyramid_flags(N: int, mesh: Mesh) -> tuple:
    """Whether each centred pyramid level l = 0..log2 N (2^l cells a side)
    is cut into tiles (the shard_mg rule)."""
    depth = int(round(np.log2(N)))
    return tuple(shard_mg.level_is_sharded(2 ** l, mesh.my, mesh.mx)
                 for l in range(depth + 1))


def shard_const(cfg: node.NodeQGConfig, const: node.NodeQGConstants,
                q0_full: torch.Tensor, mesh: Mesh) -> VertexShardConst:
    """This rank's VertexShardConst from the whole NodeQGConstants and the
    whole initial q, whose ring row and column N are the frozen q ring
    (vshard.py:429-452). Constants built for the nodal spectral solve
    (vlevels None) get the vertex-multigrid levels here: the sharded step
    runs the multigrid. A periodic config raises NotImplementedError, as
    in the JAX package."""
    if cfg.periodic:
        raise NotImplementedError(PERIODIC_REFUSAL)
    levels = const.vlevels
    if levels is None:
        levels = vmg.build_vlevels(
            nl=cfg.nl, N=cfg.N, L0=cfg.L0, S2=const.S2, idh0=const.idh0,
            idh1=const.idh1, iRd2_low=cfg.iRd2_low, mask=const.mask,
            dtype=const.mask.dtype)
    levels, flags = prepare_vlevels(levels, mesh)

    def tile(x):
        return None if x is None else halo.local_tile(to_owned(x), mesh)

    wl_flags = sig_c = mask_c = None
    if cfg.dtflt > 0:
        wl_flags = _pyramid_flags(cfg.N, mesh)

        def per_level(pyr):
            return tuple(halo.local_tile(p, mesh) if f else p
                         for p, f in zip(pyr, wl_flags))

        sig_c, mask_c = per_level(const.sig_lev_c), per_level(const.mask_c)
    noise = None
    if cfg.stochastic:
        noise = node.NodeQGConstants(
            mask=const.mask, psi_pg=None, S2=None, S2_prof=None, topo=None,
            q_forcing_3d=None, vlevels=None, yv=const.yv, idh0=const.idh0,
            idh1=const.idh1, sig_noise=const.sig_noise)
    topo = const.topo if const.has_topo else None
    return VertexShardConst(
        mesh=mesh, mask=tile(const.mask),
        psi_pg=tile(const.psi_pg) if const.has_pg else None,
        pp_ring=_ring(const.psi_pg) if const.has_pg else None,
        S2=tile(const.S2), yv=const.yv, vlevels=levels, sharded_flags=flags,
        ring=_ring(q0_full), topo=tile(topo),
        topo_ring=None if topo is None else _ring(topo),
        q_forcing_3d=tile(const.q_forcing_3d), noise=noise,
        sig_lev_c=sig_c, mask_c=mask_c, wl_flags=wl_flags,
        idh0=const.idh0, idh1=const.idh1)


def _wind(cfg, c: VertexShardConst, t, ny: int) -> torch.Tensor:
    """The wind on this tile's rows, (ny, 1): the unsharded profile over
    the whole y column (O(N)), sliced, so that its bits are the unsharded
    step's."""
    y0 = c.mesh.yi * ny
    return node.q_forcing_profile(cfg, c.yv[:, 0], t)[y0:y0 + ny, None]


def rhs_pv_sharded(cfg: node.NodeQGConfig, c: VertexShardConst, q, psi, t):
    """models/qg_node.rhs_pv on owned tiles (vshard.py:486-550), in the
    term order of fused_node_rhs.rhs_node_reference."""
    d, nl, m, mesh = cfg.delta, cfg.nl, c.mask, c.mesh
    ny, nx = q.shape[-2:]
    qf = _wind(cfg, c, t, ny)
    fric = -cfg.hEkb * cfg.f0 / (2 * cfg.dh[nl - 1])

    def J(p_gh, q_gh):
        # J(p, q) = arakawa_mjac(q, p): the qg-node macro's roles
        return arakawa_mjac_g(q_gh, p_gh, d)

    def betaterm(p_gh):
        return cfg.beta * (p_gh.shift(0, 1) - p_gh.shift(0, -1)) / (2 * d)

    if nl == 1:
        q_top, q_right = ring_slices(c.ring, mesh, ny, nx)
        q_gh = vghost(q, mesh, q_top, q_right)
        psi_gh = vghost(psi, mesh)
        dq = (-J(psi_gh, q_gh) - betaterm(psi_gh) + fric * q + qf[None]
              + cfg.nu * _vlap_own(q_gh, d))
        return dq * m

    psi = psi * m
    psi_gh = vghost(psi, mesh)
    zeta = bc_deriv_own(_vlap_own(psi_gh, d), psi, cfg.bc_fac, d, mesh)
    z_hr, z_hc = slip_high(psi, cfg.bc_fac, d)
    zeta_gh = vghost(zeta, mesh, z_hr, z_hc)
    dq = -J(psi_gh, zeta_gh)
    if c.psi_pg is not None:
        pp_gh = vghost(c.psi_pg, mesh, *ring_slices(c.pp_ring, mesh, ny, nx))
        dq = dq - J(pp_gh, zeta_gh)
    dq = dq - betaterm(psi_gh)
    Jd = J(psi_gh[:-1], psi_gh[1:])
    if c.psi_pg is not None:
        Jd = Jd + J(pp_gh[:-1], psi_gh[1:]) + J(psi_gh[:-1], pp_gh[1:])
    i0 = torch.tensor(c.idh0, dtype=q.dtype, device=q.device).reshape(nl, 1, 1)
    i1 = torch.tensor(c.idh1, dtype=q.dtype, device=q.device).reshape(nl, 1, 1)
    dq[:-1] += -c.S2 * Jd * i1[:-1]
    dq[1:] += c.S2 * Jd * i0[1:]
    bot = fric * zeta[nl - 1]
    if c.topo is not None:
        topo_gh = vghost(c.topo, mesh, *ring_slices(c.topo_ring, mesh, ny,
                                                    nx))
        bot = bot - J(psi_gh[nl - 1], topo_gh) * cfg.f0 / cfg.dh[nl - 1]
    dq[nl - 1] += bot
    dq = dq + cfg.nu * stretch(zeta, c.S2, c.idh0, c.idh1)
    tmp = bc_deriv_rel_own(_vlap_own(zeta_gh, d), zeta, cfg.bc_fac, d, mesh)
    dq = dq + cfg.nu * tmp
    if cfg.nu4 != 0.0:
        t_hr, t_hc = slip_high_rel(zeta, z_hr, z_hc, cfg.bc_fac, d)
        tmp_gh = vghost(tmp, mesh, t_hr, t_hc)
        dq = dq - cfg.nu4 * (stretch(tmp, c.S2, c.idh0, c.idh1)
                             + _vlap_own(tmp_gh, d))
    dq[0] += qf
    if c.q_forcing_3d is not None:
        dq = dq + c.q_forcing_3d
    return dq * m


def adjust_dt_sharded(cfg: node.NodeQGConfig, psi, dtmax0: float, prev,
                      mesh: Mesh):
    """models/qg_node.adjust_dt on owned tiles: the forward differences
    over owned nodes, the face into the dropped ring against its zero psi
    (the value the unsharded maximum sees), the maximum over the ranks."""
    d = cfg.delta
    g = vghost(psi, mesh)
    u1 = torch.abs(g.shift(1, 0) - psi) / d
    u2 = torch.abs(g.shift(0, 1) - psi) / d
    umax = halo.pmax(torch.maximum(u1.max(), u2.max()))
    big = torch.finfo(psi.dtype).max / 4
    dtm = torch.clamp(torch.where(umax > 0, cfg.CFL * d / umax, big),
                      max=dtmax0)
    dtm = torch.where(dtm > prev, (prev + 0.1 * dtm) / 1.1, dtm)
    return dtm, dtm


def diag_1d_sharded(cfg: node.NodeQGConfig, c: VertexShardConst, psi, q, t):
    """(ke, d_ke, f_ke) of models/qg_node.diag_1d: owned-node sums of the
    top layer, summed over the ranks in one all_reduce (the dropped ring
    adds nothing unsharded, psi being zero there, qg.h:377-380)."""
    mesh = c.mesh
    d2 = cfg.delta ** 2
    ny, nx = q.shape[-2:]
    q_top, q_right = ring_slices(c.ring, mesh, ny, nx)
    p0 = psi[0]
    # psi is zero on the ring, whatever the Laplacians hold there
    lap_psi = _vlap_own(vghost(psi[:1], mesh), cfg.delta)[0]
    lap_q = _vlap_own(vghost(q[:1], mesh, q_top[:1], q_right[:1]),
                      cfg.delta)[0]
    qf = _wind(cfg, c, t, ny)
    part = torch.stack([-torch.sum(0.5 * p0 * lap_psi),
                        -cfg.nu * torch.sum(p0 * lap_q),
                        -torch.sum(p0 * qf)])
    ke, d_ke, f_ke = halo.psum(part) * d2
    return ke, d_ke, f_ke


def make_node_step_sharded(cfg: node.NodeQGConfig, const: node.NodeQGConstants,
                           q0_full: torch.Tensor, mesh: Mesh,
                           generator: torch.Generator | None = None):
    """(step, place, csh): the qg-node predictor-corrector on owned tiles
    (vshard.py:611-688) on `mesh` (parallel/mesh.make_mesh's, every rank of
    the running group).

    step(state, csh, tnext) -> (state, NodeStepDiag) takes and returns this
    rank's tile state (q, psi, psi_f owned tiles; t, dt_prev, i, nbar
    alike on every rank); `place(owned)` cuts an owned whole state
    (`owned_state`) into this rank's tiles; `csh` is this rank's
    VertexShardConst (`shard_const`). A stochastic config needs
    `generator`, seeded alike on every rank."""
    if cfg.stochastic and generator is None:
        raise ValueError("a stochastic step needs a torch.Generator on the "
                         "state's device, seeded alike on every rank")
    csh = shard_const(cfg, const, q0_full, mesh)
    DT = cfg.dt_clamped()
    whole = (cfg.nl, cfg.N + 1, cfg.N + 1)

    def update(c, q, psi_guess, prev, t):
        psi, st = vpoisson_sharded(
            psi_guess, q, levels=c.vlevels, sharded_flags=c.sharded_flags,
            mesh=mesh, idh0=c.idh0, idh1=c.idh1, tolerance=cfg.TOLERANCE)
        psi = bc_psi_own(psi, mesh)
        dq = rhs_pv_sharded(cfg, c, q, psi, t)
        dtm, prev = adjust_dt_sharded(cfg, psi, DT, prev, mesh)
        return dq, psi, prev, dtm, st

    def step(state: node.NodeQGState, c: VertexShardConst, tnext):
        dq, psi1, prev, dtm, st = update(c, state.q, state.psi,
                                         state.dt_prev, state.t)
        dt = dtnext(state.t, tnext, dtm)
        noise = None
        if cfg.stochastic:
            noise = halo.local_tile(to_owned(node.generate_noise(
                cfg, c.noise, generator, whole)), mesh)
        q_half = state.q + dq * (dt / 2)
        if noise is not None:
            q_half = q_half + noise * torch.sqrt(dt) / 2.0
        dq2, psi2, prev, _, _ = update(c, q_half, psi1, prev, state.t)
        q_new = state.q + dq2 * dt
        if noise is not None:
            q_new = q_new + noise * torch.sqrt(dt)
        ke, d_ke, f_ke = diag_1d_sharded(cfg, c, psi2, q_new, state.t)
        new = node.NodeQGState(q=q_new, psi=psi2, psi_f=state.psi_f,
                               t=state.t + dt, dt_prev=prev, i=state.i + 1,
                               nbar=state.nbar)
        return new, node.NodeStepDiag(dt=dt, ke=ke, d_ke=d_ke, f_ke=f_ke,
                                      mg_iters=st.iters)

    def place(own: node.NodeQGState) -> node.NodeQGState:
        def tile(x):
            return None if x is None else halo.local_tile(x, mesh)
        return dataclasses.replace(own, q=tile(own.q), psi=tile(own.psi),
                                   psi_f=tile(own.psi_f))

    return step, place, csh


def full_state(s: node.NodeQGState, csh: VertexShardConst
               ) -> node.NodeQGState:
    """The whole (nl, N+1, N+1) state from every rank's tile state, on
    every rank (a collective): q with the frozen ring, psi with its zero
    ring. psi_f's dropped ring is zero, as in the JAX package's sharded
    run (the unsharded filter mean holds the mean of psi_loc there)."""
    mesh = csh.mesh

    def whole(x, **ring):
        return None if x is None else to_full(halo.gather_global(x, mesh),
                                              **ring)

    return dataclasses.replace(
        s, q=whole(s.q, ring_row=csh.ring.q_top, ring_col=csh.ring.q_right),
        psi=whole(s.psi), psi_f=whole(s.psi_f))


# ---------------------------------------------------------------------------
# the sharded filter event
# ---------------------------------------------------------------------------

def _wprolong(coarse, fine_sharded: bool, coarse_sharded: bool,
              mesh: Mesh):
    """The bilinear prolongation from a pyramid level to the next across
    the tiles / whole boundary, bit for bit mg.prolong_bilinear of the
    whole field (BC.DIRICHLET)."""
    if fine_sharded:
        if coarse_sharded:
            return shard_mg._prolong_sharded(coarse, BC.DIRICHLET, mesh)
        return halo.local_tile(mg.prolong_bilinear(coarse, BC.DIRICHLET),
                               mesh)
    return mg.prolong_bilinear(coarse, BC.DIRICHLET)


def wavelet_sharded(s, wl_flags, mask_c, mesh: Mesh):
    """ops.wavelet.wavelet with the mask pyramid on a centred tile: the
    4-cell restriction is local on every level, one gather where the
    levels stop cutting into tiles."""
    depth = len(wl_flags) - 1
    pyr = [s]                                  # the finest level first
    for l in range(depth - 1, -1, -1):
        r = mg.restrict_cell(pyr[-1])
        if wl_flags[l + 1] and not wl_flags[l]:
            r = halo.gather_global(r, mesh)
        pyr.append(r)
    pyr.reverse()                              # pyr[l] at level l
    w = [pyr[0]]
    for l in range(1, depth + 1):
        w.append(pyr[l] - _wprolong(pyr[l - 1], wl_flags[l], wl_flags[l - 1],
                                    mesh))
    return [wl * ml for wl, ml in zip(w, mask_c)]


def inverse_wavelet_sharded(w, wl_flags, mask_c, mesh: Mesh):
    """ops.wavelet.inverse_wavelet with the mask pyramid."""
    s = w[0] * mask_c[0]
    for l in range(1, len(w)):
        s = (_wprolong(s, wl_flags[l], wl_flags[l - 1], mesh) + w[l]) \
            * mask_c[l]
    return s


def comp_q_sharded(cfg: node.NodeQGConfig, c: VertexShardConst, psi):
    """(q, ring): models/qg_node.comp_q on owned tiles, and the refrozen
    dropped ring of q (bc_deriv's row and column N, from psi's global row
    and column N-1, gathered; corners 0)."""
    mesh = c.mesh
    q = _vlap_own(vghost(psi, mesh), cfg.delta)
    if cfg.nl > 1:
        q = q + stretch(psi, c.S2, c.idh0, c.idh1)
    else:
        q = q - cfg.iRd2_low * psi
    q = bc_deriv_own(q, psi, cfg.bc_fac, cfg.delta, mesh)
    cc = 2.0 * cfg.bc_fac / (cfg.delta * cfg.delta)
    q_top = cc * halo.gather_global(psi[..., -1:, :].contiguous(),
                                    mesh)[..., -1, :]
    q_right = cc * halo.gather_global(psi[..., :, -1:].contiguous(),
                                      mesh)[..., :, -1]
    q_top[..., 0] = 0.0
    q_right[..., 0] = 0.0
    return q, VertexRing(q_top=q_top.contiguous(),
                         q_right=q_right.contiguous())


def make_node_filter_sharded(cfg: node.NodeQGConfig, mesh: Mesh):
    """filter(state, csh) -> (state, ring): models/qg_node.wavelet_filter
    on this rank's tile state (vshard.py:775-835). The caller puts `ring`
    into csh (`dataclasses.replace(csh, ring=ring)`): comp_q refreezes the
    q ring from the filtered psi. The finest level must cut into the
    mesh."""
    if not shard_mg.level_is_sharded(cfg.N, mesh.my, mesh.mx):
        raise ValueError(f"the sharded filter: the finest level ({cfg.N} "
                         f"cells) does not cut into {mesh.my} x {mesh.mx} "
                         "tiles")

    def filt(state: node.NodeQGState, c: VertexShardConst):
        psi, _ = vpoisson_sharded(
            state.psi, state.q, levels=c.vlevels,
            sharded_flags=c.sharded_flags, mesh=mesh, idh0=c.idh0,
            idh1=c.idh1, tolerance=cfg.TOLERANCE)
        psi = bc_psi_own(psi, mesh)
        # vertices -> cells (qg_baroclinic_ms.h:369-371)
        g = vghost(psi, mesh)
        pc = 0.25 * (psi + g.shift(1, 0) + g.shift(0, 1) + g.shift(1, 1))
        w = wavelet_sharded(pc, c.wl_flags, c.mask_c, mesh)
        w = [wl * sl for wl, sl in zip(w, c.sig_lev_c)]
        pl = inverse_wavelet_sharded(w, c.wl_flags, c.mask_c, mesh)
        # cells -> vertices, the 4 surrounding cells (:385)
        gpl = vghost(pl, mesh)
        psi_loc = 0.25 * (gpl.shift(-1, -1) + gpl.shift(0, -1)
                          + gpl.shift(-1, 0) + pl)
        psi_f = (state.psi_f * state.nbar + psi_loc / cfg.dtflt) \
            / (state.nbar + 1)
        psi_new = (psi - psi_loc) * c.mask
        q_new, ring = comp_q_sharded(cfg, c, psi_new)
        return dataclasses.replace(state, psi=psi_new, q=q_new, psi_f=psi_f,
                                   nbar=state.nbar + 1), ring

    return filt
