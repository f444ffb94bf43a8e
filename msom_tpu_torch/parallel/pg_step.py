"""The sharded mspg step: the port's explicit form of the JAX package's
GSPMD run_pg(sharded=True) (msom_tpu/driver.py:311-340), over
torch.distributed.

A rows split on the (W, 1) mesh (parallel/mesh.py): rank r holds the rows
[r n, (r + 1) n) of b (nl, N, N) and ux (nl, N, N+1), n = N / W, and the
same n y-faces of uy (nl, N+1, N), its cells' south faces; the last rank
also holds the north wall's face N. The stencils (advection, hdiffusion,
momentum's pressure gradient, vbar, ubar and face Laplacians, comp_gm)
read one ghost row each side, which `halo.ghosted_sharded` exchanges with
the neighbours (mirrored at the walls, as models/mspg.py's whole-domain
pads): the step's `mspg.Halo` of the rank. The column-local work
(vdiff_implicit, convection, forcing_implicit, adjust_bt_velocity, the
means) runs unchanged on the rank's rows, and the CFL chain takes the
per-layer maxima of every rank (one all_reduce of an (nl,) vector an
evaluation) before its sequential smoothing. Every rank builds the whole
constants, the set-up solve_bt included, and keeps its rows: the step's
arithmetic is the unsharded step's, term for term.

The grid must cut: N divisible by W with N / W >= 2, else ValueError (the
JAX package leaves such an axis unsharded instead).
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from msom_tpu_torch.models import mspg
from msom_tpu_torch.ops.bc import BC
from msom_tpu_torch.parallel import dist, halo
from msom_tpu_torch.parallel.mesh import Mesh, make_mesh
from msom_tpu_torch.params import PGConfig


def rows_refusal(N: int, world: int) -> str | None:
    """Why an N-row grid does not cut into `world` ranks of rows, or None
    where it does."""
    if N % world:
        return f"N = {N} is not divisible by {world} ranks"
    if N // world < 2:
        return f"N = {N} leaves {N // world} row a rank (2 at least)"
    return None


@dataclasses.dataclass(frozen=True)
class ShardedPGStep:
    """The sharded step of a world: `step(state, const, tnext)` on this
    rank's rows, `shard` of a whole PGState or PGConstants, `gather` of a
    rank's PGState into the whole state on every rank (a collective)."""
    step: Callable
    shard: Callable
    gather: Callable


def _halo(mesh: Mesh) -> mspg.Halo:
    """This rank's ghost rules: one ghost row from each neighbour, mirrored
    at the walls, the x ghosts mirrored."""
    def ghosts(a):
        return halo.ghosted_sharded(a, BC.NEUMANN, mesh).p
    return mspg.Halo(cells=ghosts, x_faces=ghosts, y_faces=ghosts,
                     pmax=halo.pmax, first=mesh.yi == 0,
                     last=mesh.yi == mesh.my - 1)


def make_pg_step_sharded(cfg: PGConfig) -> ShardedPGStep:
    """The rows-sharded mspg step on the (W, 1) mesh of the running group
    (world size 1 without one); every rank calls it together. Raises
    ValueError where N does not cut into the ranks (`rows_refusal`)."""
    world = dist.world_size()
    why = rows_refusal(cfg.N, world)
    if why is not None:
        raise ValueError(f"the sharded mspg step splits the rows: {why}")
    mesh = make_mesh((world, 1))
    n = cfg.N // world
    r0, r1 = mesh.yi * n, (mesh.yi + 1) * n
    last = mesh.yi == world - 1
    f1 = r1 + 1 if last else r1          # the owned y-faces [r0, f1)

    def shard(x):
        if isinstance(x, mspg.PGConstants):
            rows = slice(r0, r1)
            return dataclasses.replace(
                x, ubtx=x.ubtx[rows], ubty=x.ubty[r0:f1],
                b_surf=x.b_surf[rows],
                b_forc=None if x.b_forc is None else x.b_forc[:, rows],
                kx_face=x.kx_face[:, rows],
                ky_face=x.ky_face[:, r0:r1 + 1],   # the cells' y-faces
                kv_prof=x.kv_prof[:, rows], yc=x.yc[rows], yf=x.yf[r0:f1])
        c = {k: getattr(x, k)[:, r0:r1].contiguous()
             for k in ("b", "ux", "b_me", "ux_me")}
        c.update({k: getattr(x, k)[:, r0:f1].contiguous()
                  for k in ("uy", "uy_me")})
        return dataclasses.replace(x, **c)

    def faces(uy):
        # every rank sends n + 1 rows (the last rank's wall face, the
        # others a pad row), then each keeps its n
        if world == 1:
            return uy
        pad = uy if last else torch.cat([uy, torch.zeros_like(uy[:, :1])],
                                        dim=-2)
        g = halo.gather_global(pad, mesh)
        nl, _, nx = g.shape
        own = g.reshape(nl, world, n + 1, nx)[:, :, :n].reshape(nl, -1, nx)
        return torch.cat([own, g[:, -1:]], dim=-2)

    def gather(s: mspg.PGState) -> mspg.PGState:
        return dataclasses.replace(
            s, b=halo.gather_global(s.b, mesh),
            ux=halo.gather_global(s.ux, mesh), uy=faces(s.uy),
            b_me=halo.gather_global(s.b_me, mesh),
            ux_me=halo.gather_global(s.ux_me, mesh), uy_me=faces(s.uy_me))

    return ShardedPGStep(step=mspg.make_step(cfg, _halo(mesh)), shard=shard,
                         gather=gather)
