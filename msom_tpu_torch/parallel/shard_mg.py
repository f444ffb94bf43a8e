"""The sharded geometric multigrid (the port of `msom_tpu.parallel.shard_mg`,
:37-194, over torch.distributed).

solvers/mg.py's solve_layered on a (my, mx) mesh (parallel/mesh.py):

* the fine levels stay cut into tiles: the relaxation and the residual take
  their ghosts from `halo.ghosted_issue` (one halo exchange a red-black
  colour: the sharded `boundary_level()`), the interior of the neighbour
  sum enqueued while the exchange is in flight (JAX's overlapped form);
  the restriction is local, the prolongation exchanges one coarse halo
  cell;
* a level whose tile would fall below 2 x 2 cells (`level_is_sharded`) is
  whole on every rank: the residual is gathered once
  (`halo.gather_global`) at the first such level and the rest of the
  V-cycle runs on every rank alike (mg.py's `_relax_layered`, the
  prolongation), cut back to the tile (`halo.local_tile`) where it meets
  the sharded levels again;
* the convergence test is the maximum of the tiles' residual norms over
  the ranks (`halo.pmax`), read on the host once a cycle, so that every
  rank runs the same cycles with the same adaptive relaxation count.

Like the JAX package's, this multigrid runs as tensor ops on every level:
`shard_levels` drops the levels' y-profiles, so that neither K3 nor K4
launches (the unsharded solver="mg" keeps them).
"""

from __future__ import annotations

import dataclasses

import torch

from msom_tpu_torch.ops.bc import BC
from msom_tpu_torch.parallel import halo
from msom_tpu_torch.parallel.mesh import Mesh
from msom_tpu_torch.solvers import fused_mg, mg

NITERMAX = mg.NITERMAX


def level_is_sharded(n: int, my: int, mx: int) -> bool:
    """A level of n x n cells stays cut into tiles while each keeps 2 x 2
    cells at least and an even width (the restriction stays local, the
    checkerboard of every tile starts red; shard_mg.py:37-43)."""
    return (n % (2 * my) == 0 and n % (2 * mx) == 0
            and n // my >= 2 and n // mx >= 2)


@dataclasses.dataclass(frozen=True)
class ShardedLevels:
    """A levels tuple of solvers/mg.py for one rank of a mesh: the sharded
    levels' coefficient fields cut to the tile (a unit x axis kept whole),
    the others whole; `sharded[k]` says which (level_specs, :45-62)."""
    levels: tuple
    sharded: tuple
    mesh: Mesh


def shard_levels(levels, mesh: Mesh) -> ShardedLevels:
    """This rank's ShardedLevels of a whole levels tuple."""
    out, flags = [], []
    for lvl in levels:
        n = lvl.red.shape[-1]
        sh = level_is_sharded(n, mesh.my, mesh.mx)
        kw = dict(sw=None, rp=None)
        if sh:
            kw.update({name: None if getattr(lvl, name) is None
                       else halo.local_tile(getattr(lvl, name), mesh)
                       for name in ("s", "lam", "t0", "cp", "im")})
            kw["red"] = fused_mg.checkerboard(n // mesh.my, n // mesh.mx,
                                              lvl.red.device)
        out.append(dataclasses.replace(lvl, **kw))
        flags.append(sh)
    if not flags[0]:
        raise ValueError(f"the finest multigrid level "
                         f"({levels[0].red.shape[-1]} cells) does not cut "
                         f"into {mesh.my} x {mesh.mx} tiles of an even width")
    return ShardedLevels(tuple(out), tuple(flags), mesh)


def _relax_sharded(da, res, lvl, nrelax: int, bc: BC, mesh: Mesh):
    """nrelax red-black line sweeps on a tile, the ghosts exchanged for
    each colour (shard_mg.py:65-90): a colour issues its exchange,
    enqueues the interior of the neighbour sum and waits only for the rim
    (halo.neighbor_sum_overlap; bit for bit fused_mg.relax_color)."""
    rhs0 = -(lvl.delta * lvl.delta) * res
    for _ in range(nrelax):
        for mask in (lvl.red, ~lvl.red):
            nb = halo.neighbor_sum_overlap(da, bc, mesh)
            da = fused_mg.relax_color_sum(nb, da, rhs0, lvl.t0, lvl.cp,
                                          lvl.im, mask)
    return da


def _residual_sharded(a, b, lvl, bc: BC, idh0, idh1, mesh: Mesh):
    """(res, max|res| over the mesh), res = b - lap(a) - Gamma(a) - lam*a
    on a tile (shard_mg.py:93-103); the Laplacian overlapped with its
    exchange (halo.laplacian_overlap)."""
    res, m = fused_mg.residual_lap(
        halo.laplacian_overlap(a, bc, lvl.delta, mesh), a, b, lvl.s,
        lvl.lam, idh0, idh1)
    return res, halo.pmax(m)


def _prolong_sharded(c, bc: BC, mesh: Mesh):
    """The bilinear prolongation of a sharded coarse tile: its ghost ring
    exchanged, then mg.prolong_padded (shard_mg.py:106-122)."""
    return mg.prolong_padded(halo.ghosted_sharded(c, bc, mesh).p)


def solve_layered_sharded(a0: torch.Tensor, b: torch.Tensor, *,
                          levels: ShardedLevels, idh0=None, idh1=None,
                          bc: BC = BC.DIRICHLET, tolerance: float = 1e-3,
                          nrelax0: int = 4, nitermax: int = NITERMAX):
    """mg.solve_layered on this rank's (nl, ny_l, nx_l) tiles a0 and b
    (shard_mg.py:125-194); the ranks call it together. Returns (the tile
    of a, MGStats with host numbers, alike on every rank)."""
    lv, sharded, mesh = levels.levels, levels.sharded, levels.mesh
    nlev = len(lv)
    nl = a0.shape[0]
    idh0 = [0.0] * nl if idh0 is None else idh0
    idh1 = [0.0] * nl if idh1 is None else idh1

    def cycle(a, res, nrelax):
        # restrict the residual down the levels; gather it whole at the
        # first level that is not sharded
        pyr = [res]
        for k in range(1, nlev):
            r = mg.restrict_cell(pyr[-1])
            if sharded[k - 1] and not sharded[k]:
                r = halo.gather_global(r, mesh)
            pyr.append(r)
        da = torch.zeros_like(pyr[-1])
        for k in range(nlev - 1, -1, -1):
            if k < nlev - 1:
                if sharded[k + 1]:
                    da = _prolong_sharded(da, bc, mesh)
                else:
                    da = mg.prolong_bilinear(da, bc)
                    if sharded[k]:       # whole -> tile
                        da = halo.local_tile(da, mesh)
            if sharded[k]:
                da = _relax_sharded(da, pyr[k], lv[k], nrelax, bc, mesh)
            else:
                da = mg._relax_layered(da, pyr[k], lv[k], nrelax, bc)
        return a + da

    a = a0
    res, maxres = _residual_sharded(a, b, lv[0], bc, idh0, idh1, mesh)
    resb = resa = maxres.item()          # the residual norm, on the host
    nrelax, iters = nrelax0, 0
    while iters < nitermax and (iters < 1 or resa > tolerance):
        a = cycle(a, res, nrelax)
        res, maxres = _residual_sharded(a, b, lv[0], bc, idh0, idh1, mesh)
        resa_new = maxres.item()         # one device-to-host read a cycle
        ratio = resa / max(resa_new, 1e-300)
        if resa_new > tolerance and ratio < 1.2 and nrelax < 100:
            nrelax += 1
        if resa_new > tolerance and ratio > 10.0 and nrelax > 2:
            nrelax -= 1
        resa = resa_new
        iters += 1
    return a, mg.MGStats(iters=iters, resb=resb, resa=resa, nrelax=nrelax)
