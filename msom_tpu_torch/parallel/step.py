"""The rows-sharded msqg step (the port of the kernel-keeping rows path of
`msom_tpu.parallel.step`, :93-321, on a (W, 1) mesh over
torch.distributed).

Rank r of W steps the rows [r n_loc, (r + 1) n_loc), n_loc = N / W, of the
state, and keeps the single-card fast paths on its shard:

* the PV inversion is the pencil decomposition of the direct spectral
  solve (spectral_shard.solve_spectral_pencil: the fold or the matmul
  basis, two all_to_all transposes a solve);
* the tendency is K1 in rows mode and the tracers' K2 in rows mode
  (fused_rhs.rhs_fused / fused_tracer.tracer_fused with psi_ext, q_ext,
  tr_ext and row0), fed by the 8-row halo slabs of halo.ext_rows8;
* the CFL maxima are reduced by halo.pmax before the scalar tail of
  qg.cfl_from_umax, and the KE's partial sums by halo.psum after a 1-row
  ghost exchange (halo.ghosted_rows).

The constants stay whole on every rank (the kernels read them at the
global rows); `shard(const)` only replaces the spectral data by the rank's
PencilData and cuts the stochastic amplitude s_stoch to the rank's rows.
`shard(state)` cuts every (..., N, N) field of a QGState to the rank's
rows and `gather(state)` puts the whole state together on every rank.
Stochastic forcing draws from a generator of the rank's own, seeded from
(seed, rank): the ranks' noise agrees with the unsharded draw in
distribution only (the JAX package folds the device index into its key,
step.py:228-235), and at world size 1 it is the unsharded draw.

Not ported yet (NotImplementedError naming ROADMAP.md queue 1, item 15):
solver="mg" and mode_pv_invert on shards (the sharded multigrid,
parallel/shard_mg.py), a 2-D mesh and the configurations the rows path
cannot take (varRo or a strl that varies, N % W != 0 or (N / W) % 8 != 0:
the JAX package's GSPMD run, solve_spectral_sharded with force_matmul).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple

import torch

from msom_tpu_torch.models import fused_rhs, fused_tracer, qg
from msom_tpu_torch.parallel import dist, halo, spectral_shard

MODE = "rows"
SHARD_MG_UNPORTED = ("is not ported yet: the sharded multigrid "
                     "(parallel/shard_mg.py) on a rows decomposition, "
                     "ROADMAP.md queue 1, item 15")
GSPMD_UNPORTED = ("is not ported yet: the JAX package runs it as a GSPMD "
                  "or 2-D mesh step (solve_spectral_sharded with "
                  "force_matmul), ROADMAP.md queue 1, item 15")


class ShardedStep(NamedTuple):
    """What make_qg_step_sharded returns: the step, the shard and gather
    functions, and the mode the step takes ("rows")."""
    step: Callable
    shard: Callable
    gather: Callable
    mode: str


def check_rows(cfg, world: int, mesh=None) -> None:
    """Raise NotImplementedError, naming what is left of ROADMAP.md item
    15, for a configuration the rows step does not take."""
    if mesh is not None and tuple(mesh) != (world, 1):
        raise NotImplementedError(f"a {mesh[0]} x {mesh[1]} mesh "
                                  + GSPMD_UNPORTED)
    if cfg.solver != "spectral":
        raise NotImplementedError(f"solver={cfg.solver!r} on shards "
                                  + SHARD_MG_UNPORTED)
    if cfg.mode_pv_invert:
        raise NotImplementedError("mode_pv_invert (the modal inversion) on "
                                  "shards " + SHARD_MG_UNPORTED)
    if cfg.varRo:
        raise NotImplementedError("varRo (the y-profile solve) on shards "
                                  + GSPMD_UNPORTED)
    if cfg.N % world or (cfg.N // world) % 8:
        raise NotImplementedError(
            f"N = {cfg.N} on {world} ranks (the rows path needs N % W == 0 "
            f"and (N / W) % 8 == 0, pallas_rhs.py:196-198) "
            + GSPMD_UNPORTED)


def make_qg_step_sharded(cfg, *, device="cuda", generator=None, seed=0,
                         mesh=None) -> ShardedStep:
    """The rows step of this rank of the running group (world size 1
    without one). `step(state, const, tnext) -> (state, StepDiag)` takes
    this rank's shard of the state and the constants from `shard(const)`;
    the ranks call it together. A stochastic step draws from `generator`,
    else from one on `device` seeded from (seed, rank). `mesh` (my, mx)
    must be (W, 1)."""
    W, r = dist.world_size(), dist.rank()
    check_rows(cfg, W, mesh)
    nl, N = cfg.nl, cfg.N
    n_loc = N // W
    row0 = r * n_loc
    rows = slice(row0, row0 + n_loc)
    periodic = cfg.sbc == -1
    need_q = cfg.energy_conserv or cfg.stochastic
    DT = cfg.dt_clamped()
    if cfg.stochastic and generator is None:
        generator = torch.Generator(device=device).manual_seed(
            seed + (r << 32))

    def shard(x):
        if isinstance(x, qg.QGConstants):
            if x.spec is not None and isinstance(
                    x.spec, spectral_shard.PencilData):
                return x
            if not x.rhs_kernel or x.strl is not None and not bool(
                    (x.strl == x.strl[:, :1, :1]).all()):
                raise NotImplementedError("a strl that varies on shards "
                                          + GSPMD_UNPORTED)
            spec = spectral_shard.build_pencil(cfg, x.spec, x.strl,
                                               device=x.wind.device)
            return dataclasses.replace(
                x, spec=spectral_shard.pencil_data(spec, r, W),
                s_stoch=None if x.s_stoch is None
                else x.s_stoch[..., rows, :].contiguous())
        if isinstance(x, qg.QGState):
            return dataclasses.replace(x, **{
                f.name: getattr(x, f.name)[..., rows, :].contiguous()
                for f in dataclasses.fields(x)
                if _is_field(getattr(x, f.name), N)})
        return x[..., rows, :].contiguous()

    def gather(x):
        if isinstance(x, qg.QGState):
            return dataclasses.replace(x, **{
                f.name: dist.fetch_global(getattr(x, f.name))
                for f in dataclasses.fields(x)
                if _is_field(getattr(x, f.name), n_loc)})
        return dist.fetch_global(x)

    def update(const, q, tr, prev):
        psi = spectral_shard.solve_spectral_pencil(const.spec, q)
        psi_ext = halo.ext_rows8(psi, periodic)
        q_ext = halo.ext_rows8(q, periodic) if need_q else None
        dq, umax = fused_rhs.rhs_fused(cfg, const, psi, psi_ext=psi_ext,
                                       q_ext=q_ext, row0=row0)
        dtr = None
        if tr is not None:
            tr_ext = halo.ext_rows8(tr.reshape(-1, n_loc, N), periodic)
            dtr = fused_tracer.tracer_fused(cfg, const, psi, tr,
                                            psi_ext=psi_ext, tr_ext=tr_ext,
                                            row0=row0)
        dtm, prev = qg.cfl_from_umax(cfg, umax, const.umax_pp, DT, prev,
                                     reduce_fn=halo.pmax)
        return dq, dtr, psi, prev, dtm

    def step(state: qg.QGState, const: qg.QGConstants, tnext):
        if not isinstance(const.spec, spectral_shard.PencilData):
            raise ValueError("the rows step takes the constants of "
                             "shard(const)")
        q0, tr0 = state.q, state.tracers
        if tuple(q0.shape) != (nl, n_loc, N):
            raise ValueError(f"the rows step takes a shard {(nl, n_loc, N)}"
                             f", got {tuple(q0.shape)}")
        noise = qg.draw_noise(cfg, const, q0, generator) \
            if cfg.stochastic else None
        # the spectral solve reads no guess: psi_old (mg_extrap) is only
        # carried, as the JAX step carries it (step.py:251-268)
        dq, dtr, psi1, prev, dtm = update(const, q0, tr0, state.dt_prev)
        dt = qg.dtnext(state.t, tnext, dtm)
        q1 = q0 + dq * (0.5 * dt)
        if noise is not None:
            q1 = q1 + noise * torch.sqrt(dt) * 0.5
        tr1 = None if tr0 is None else tr0 + dtr * (0.5 * dt)
        dq, dtr, psi2, prev, _ = update(const, q1, tr1, prev)
        q_new = q0 + dq * (1.0 * dt)
        if noise is not None:
            q_new = q_new + noise * torch.sqrt(dt)
        tr_new = None if tr0 is None else tr0 + dtr * (1.0 * dt)
        new = qg.QGState(q=q_new, psi=psi2, t=state.t + dt, dt_prev=prev,
                         i=state.i + 1, tracers=tr_new,
                         psi_old=None if state.psi_old is None
                         else state.psi, qof=state.qof, nbar=state.nbar)
        ke = qg.kinetic_energy(cfg, psi2, ghost_fn=halo.ghosted_rows,
                               reduce_fn=halo.psum)
        return new, qg.StepDiag(dt=dt, ke=ke, mg_iters=0, mg_res=0.0)

    return ShardedStep(step, shard, gather, MODE)


def _is_field(x, rows: int) -> bool:
    """A state leaf that is a field of `rows` rows (not a scalar)."""
    return isinstance(x, torch.Tensor) and x.ndim >= 2 \
        and x.shape[-2] == rows
