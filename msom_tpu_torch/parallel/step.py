"""The sharded msqg step (the port of `msom_tpu.parallel.step`, :93-321,
over torch.distributed): the rows step on a (W, 1) mesh, and the
general-mesh step on any (my, mx) mesh, which is the port's explicit form
of the JAX package's GSPMD run.

The rows step ("rows"; JAX's rows fast path). Rank r of W steps the rows
[r n_loc, (r + 1) n_loc), n_loc = N / W, of the state and keeps the
single-card fast paths on its shard:

* the PV inversion is the pencil decomposition of the direct spectral
  solve (spectral_shard.solve_spectral_pencil: the fold or the matmul
  basis, two all_to_all transposes a solve), or with solver="mg" the
  sharded multigrid (shard_mg.solve_layered_sharded, warm-started from
  2 psi - psi_old as step.py:251-254 does);
* the tendency is K1 in rows mode and the tracers' K2 in rows mode
  (fused_rhs.rhs_fused / fused_tracer.tracer_fused with psi_ext, q_ext,
  tr_ext and row0), fed by the 8-row halo slabs of halo.ext_rows8;
* the CFL maxima are reduced by halo.pmax before the scalar tail of
  qg.cfl_from_umax, and the KE's partial sums by halo.psum after a 1-row
  ghost exchange (halo.ghosted_sharded on the (W, 1) mesh).

The constants stay whole on every rank (the kernels read them at the
global rows); `shard(const)` replaces the spectral data by the rank's
PencilData, the multigrid levels by the rank's ShardedLevels and cuts the
stochastic amplitude s_stoch to the rank's rows.

The general-mesh step ("gspmd"; JAX's shard_map step with kernels off,
step.py:93-321, which computes what JAX's GSPMD run of models.qg.make_step
computes). The rank at (yi, xi) of a (my, mx) mesh steps its tile of the
state. Under GSPMD the JAX package strips the Pallas kernels
(driver.py:92-118, sharded_cfg and _strip_kernels), so this step runs no
K1 or K2: that is the mode's definition, not a fallback. The tendency is
qg.rhs as torch ops with the sharded ghosts (halo.ghosted_sharded,
ghosted_slip_sharded; zeta overlapped with psi's exchange,
halo.laplacian_overlap_g, as JAX's step.py:206-211) and the tile's
windows of the padded constants
(JAX's from_padded_local, step.py:124-135), the CFL maxima reduced by
halo.pmax and the KE by halo.psum; tracers take qg.tracer_rhs. The
inversion is, as qg.invert_q decides:

* the basis-matmul spectral solve on the mesh
  (spectral_shard.solve_spectral_sharded);
* with a stratification that varies in y (varRo), the y-profile solve on
  the mesh (spectral_shard.solve_vary_sharded: KV on whole y columns);
* with the modal inversion (mode_pv_invert), the local l2m projection,
  the sharded multigrid on the modal levels, and m2l back;
* else the sharded multigrid on the layered levels.

`shard(const)` cuts the constants to the tile (the padded ones to the
tile's window with its ghost ring). Stochastic forcing draws from a
generator of the rank's own, seeded from (seed, yi mx + xi): the ranks'
noise agrees with the unsharded draw in distribution only (the JAX
package folds the device index into its key, step.py:228-235), and at
world size 1 it is the unsharded draw. `shard(state)` cuts every
(..., N, N) field of a QGState to the rank's rows or tile and
`gather(state)` puts the whole state together on every rank.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple

import torch

from msom_tpu_torch.models import fused_rhs, fused_tracer, qg
from msom_tpu_torch.parallel import dist, halo, shard_mg, spectral_shard
from msom_tpu_torch.parallel.mesh import Mesh, make_mesh, mesh_shape
from msom_tpu_torch.solvers import mg, vary

MODES = ("rows", "gspmd")
# the least N of the rows mode: the JAX package's kernels take no smaller
# grid (pallas_rhs.py:116, _pick_tile), so its run_qg routes it to GSPMD
ROWS_MIN_N = 64


class ShardedStep(NamedTuple):
    """What make_qg_step_sharded returns: the step, the shard and gather
    functions, the mode the step takes ("rows" or "gspmd") and the mesh."""
    step: Callable
    shard: Callable
    gather: Callable
    mode: str
    mesh: Mesh


def _modal(cfg) -> bool:
    """The modal inversion is built (the JAX package's iBu is not None)."""
    return bool(cfg.mode_pv_invert and cfg.nl > 1)


def _strl_uniform(cfg, const) -> bool:
    if const is None:
        return not cfg.varRo
    s = const.strl
    return s is None or bool((s == s[:, :1, :1]).all())


def rows_refusal(cfg, world: int, const=None, mesh=None) -> str | None:
    """Why the rows step does not take this configuration on `world`
    ranks, or None where it does: the JAX package's `ok` (driver.py:
    197-208 with the kernels' gates of step.py:115-121). `const`, where
    given, decides on its stratification (a frpg input)."""
    if mesh is not None and tuple(mesh) != (world, 1):
        return f"a {mesh[0]} x {mesh[1]} mesh (the rows step is {world} x 1)"
    if cfg.N % world or (cfg.N // world) % 8:
        return (f"N = {cfg.N} on {world} ranks (the rows step needs "
                f"N % W == 0 and (N / W) % 8 == 0, pallas_rhs.py:196-198)")
    if cfg.N < ROWS_MIN_N:
        return (f"N = {cfg.N} (the kernels' rows mode takes N >= "
                f"{ROWS_MIN_N}, pallas_rhs.py:116)")
    if _modal(cfg):
        return "the modal inversion (mode_pv_invert)"
    if not cfg.use_pallas:
        return "use_pallas=False (the rows step runs the kernels)"
    if const is not None and not const.rhs_kernel:
        return "a strl that varies in x (no mode of the kernels)"
    if cfg.solver == "spectral" and not _strl_uniform(cfg, const):
        return ("a strl that varies with solver='spectral' (the pencil "
                "solve needs a uniform one)")
    if const is not None and getattr(const.spec, "refine", False):
        # JAX's rows step rebuilds its solve from the config and drops the
        # refinement; the port sends it to the mesh solve, which runs it
        return ("the bf16 + refinement solve (the pencil solve refuses it, "
                "spectral_shard.py:148)")
    return None


def route(cfg, world: int, const=None, mesh=None) -> str:
    """The mode that sharded="auto" takes: "rows" where the rows step
    takes the configuration, else "gspmd" (driver.py:193-218)."""
    return "rows" if rows_refusal(cfg, world, const, mesh) is None \
        else "gspmd"


def _fits(cfg, my: int, mx: int) -> bool:
    """Whether a (my, mx) mesh cuts the grid (and, for the multigrid, its
    finest level into tiles of an even width)."""
    if cfg.N % my or cfg.N % mx:
        return False
    return cfg.solver != "mg" or shard_mg.level_is_sharded(cfg.N, my, mx)


def choose_mesh(cfg, world: int) -> tuple[int, int]:
    """The general-mesh step's (my, mx) on `world` ranks: mesh_shape's
    where it cuts the grid, else the squarest other factorization that
    does. The JAX package's GSPMD pads a grid that its mesh does not
    divide; explicit tiles cannot, so where no factorization of the world
    cuts the grid this raises ValueError."""
    shapes = [mesh_shape(world)] + sorted(
        ((my, world // my) for my in range(1, world + 1) if world % my == 0),
        key=lambda s: (abs(s[0] - s[1]), s))
    for my, mx in shapes:
        if _fits(cfg, my, mx):
            return my, mx
    raise ValueError(
        f"N = {cfg.N} on {world} ranks: no factorization of {world} into "
        "a mesh cuts the grid into equal tiles"
        + (" of an even width (the multigrid's)" if cfg.solver == "mg"
           else "") + " (the JAX package's GSPMD pads such a grid; the "
        "port's explicit tiles do not)")


def make_qg_step_sharded(cfg, *, device="cuda", generator=None, seed=0,
                         mesh=None, mode="auto", const=None) -> ShardedStep:
    """The sharded step of this rank of the running group (world size 1
    without one). `step(state, const, tnext) -> (state, StepDiag)` takes
    this rank's shard of the state and the constants from `shard(const)`;
    the ranks call it together. `mode` is "rows", "gspmd" or "auto"
    (`route`, on `const` where given); "rows" on a configuration the rows
    step does not take raises ValueError. `mesh` (my, mx): (W, 1) for
    "rows"; for "gspmd" any mesh whose tiles cut the grid (default
    `choose_mesh`). A stochastic step draws from `generator`, else from
    one on `device` seeded from (seed, rank)."""
    W = dist.world_size()
    if mode == "auto":
        mode = route(cfg, W, const, mesh)
    if mode not in MODES:
        raise ValueError(f"mode={mode!r}: 'auto', 'rows' or 'gspmd'")
    if mode == "rows":
        why = rows_refusal(cfg, W, const, mesh)
        if why is not None:
            raise ValueError(f"sharded='rows' does not take {why}; "
                             "sharded='gspmd' or 'auto' runs it")
    if cfg.stochastic and generator is None:
        generator = torch.Generator(device=device).manual_seed(
            seed + (dist.rank() << 32))
    if mode == "rows":
        return _rows_step(cfg, make_mesh((W, 1)), generator)
    shape = choose_mesh(cfg, W) if mesh is None else tuple(mesh)
    if not _fits(cfg, *shape):
        raise ValueError(f"a {shape[0]} x {shape[1]} mesh does not cut "
                         f"N = {cfg.N} into equal tiles"
                         + (" of an even width" if cfg.solver == "mg"
                            else ""))
    return _mesh_step(cfg, make_mesh(shape), generator)


def _sharded(c: qg.QGConstants) -> bool:
    """Whether constants come from a sharded step's shard(const)."""
    return isinstance(c.spec, (spectral_shard.PencilData,
                               spectral_shard.MeshSpectralData,
                               spectral_shard.MeshVaryData)) or any(
        isinstance(lv, shard_mg.ShardedLevels)
        for lv in (c.levels, c.mlevels))


def _is_field(x, rows: int) -> bool:
    """A state leaf that is a field of `rows` rows (not a scalar)."""
    return isinstance(x, torch.Tensor) and x.ndim >= 2 \
        and x.shape[-2] == rows


def _predictor_corrector(cfg, update, kinetic_energy, generator):
    """step(state, const, tnext) of the sharded steps: qg.make_step's
    predictor-corrector around `update(const, q, guess, tr, prev) -> (dq,
    dtr, psi, prev, dtm, MGStats)`, the KE from `kinetic_energy(psi)`."""
    DT = cfg.dt_clamped()

    def step(state: qg.QGState, const: qg.QGConstants, tnext):
        q0, tr0 = state.q, state.tracers
        noise = qg.draw_noise(cfg, const, q0, generator) \
            if cfg.stochastic else None
        guess = state.psi
        if state.psi_old is not None:
            guess = 2.0 * state.psi - state.psi_old
        dq, dtr, psi1, prev, dtm, st1 = update(const, q0, guess, tr0,
                                               state.dt_prev, DT)
        dt = qg.dtnext(state.t, tnext, dtm)
        q1 = q0 + dq * (0.5 * dt)
        if noise is not None:
            q1 = q1 + noise * torch.sqrt(dt) * 0.5
        tr1 = None if tr0 is None else tr0 + dtr * (0.5 * dt)
        dq, dtr, psi2, prev, _, _ = update(const, q1, psi1, tr1, prev, DT)
        q_new = q0 + dq * (1.0 * dt)
        if noise is not None:
            q_new = q_new + noise * torch.sqrt(dt)
        tr_new = None if tr0 is None else tr0 + dtr * (1.0 * dt)
        new = qg.QGState(q=q_new, psi=psi2, t=state.t + dt, dt_prev=prev,
                         i=state.i + 1, tracers=tr_new,
                         psi_old=None if state.psi_old is None
                         else state.psi, qof=state.qof, nbar=state.nbar)
        return new, qg.StepDiag(dt=dt, ke=kinetic_energy(psi2),
                                mg_iters=st1.iters, mg_res=st1.resa)

    return step


_NO_CYCLES = mg.MGStats(iters=0, resb=0.0, resa=0.0, nrelax=0)


def _rows_step(cfg, mesh: Mesh, generator) -> ShardedStep:
    """The rows step on the (W, 1) `mesh` (module docstring)."""
    W, r = mesh.my, mesh.yi
    nl, N = cfg.nl, cfg.N
    n_loc = N // W
    row0 = r * n_loc
    rows = slice(row0, row0 + n_loc)
    periodic = cfg.sbc == -1
    need_q = cfg.energy_conserv or cfg.stochastic
    bc = qg._bc_psi(cfg)

    def shard(x):
        if isinstance(x, qg.QGConstants):
            if _sharded(x):
                return x
            why = rows_refusal(cfg, W, x)
            if why is not None:
                raise ValueError(f"the rows step does not take {why}")
            spec = levels = None
            if x.spec is not None:
                spec = x.spec
                if spec.fused_mm or (spec.S is None and spec.fac is None):
                    # the FFT forms and K7 do not split: the matmul
                    # basis, as the JAX package rebuilds it (step.py:
                    # 147-166)
                    spec = spectral_shard.build_matmul(
                        cfg, x.strl, device=x.wind.device)
                spec = spectral_shard.pencil_data(spec, r, W)
            if x.levels is not None:
                levels = shard_mg.shard_levels(x.levels, mesh)
            return dataclasses.replace(
                x, spec=spec, levels=levels,
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

    def update(const, q, guess, tr, prev, DT):
        if tuple(q.shape) != (nl, n_loc, N):
            raise ValueError(f"the rows step takes a shard {(nl, n_loc, N)}"
                             f", got {tuple(q.shape)}")
        if isinstance(const.spec, spectral_shard.PencilData):
            # the spectral solve reads no guess: psi_old (mg_extrap) is
            # only carried, as the JAX step carries it (step.py:251-268)
            psi, st = spectral_shard.solve_spectral_pencil(const.spec, q), \
                _NO_CYCLES
        elif isinstance(const.levels, shard_mg.ShardedLevels):
            psi, st = shard_mg.solve_layered_sharded(
                guess, q, levels=const.levels, idh0=const.idh0,
                idh1=const.idh1, bc=bc, tolerance=cfg.tol)
        else:
            raise ValueError("the rows step takes the constants of "
                             "shard(const)")
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
        return dq, dtr, psi, prev, dtm, st

    def kinetic_energy(psi):
        return qg.kinetic_energy(
            cfg, psi, ghost_fn=lambda f, b: halo.ghosted_sharded(f, b, mesh),
            reduce_fn=halo.psum)

    step = _predictor_corrector(cfg, update, kinetic_energy, generator)
    return ShardedStep(step, shard, gather, "rows", mesh)


def _mesh_const(cfg, c: qg.QGConstants, mesh: Mesh) -> qg.QGConstants:
    """The constants of this rank's tile (module docstring)."""
    N = cfg.N
    rows, cols = mesh.tile(N, N)
    device = c.wind.device

    def cut(t):
        return None if t is None else halo.local_tile(t, mesh)

    def window(t):
        return None if t is None else \
            t[..., rows.start:rows.stop + 2, cols.start:cols.stop + 2] \
            .contiguous()

    spec = c.spec
    if isinstance(spec, vary.VarySpectralData):
        spec = spectral_shard.vary_data(spectral_shard.build_vary_matmul(
            cfg, spec, c.strl, c.idh0, c.idh1, device=device), mesh)
    elif spec is not None:
        if spec.S is None or spec.fac is not None:
            spec = spectral_shard.build_matmul(cfg, c.strl, device=device)
        spec = spectral_shard.mesh_data(spec, mesh)
    l2m, m2l = c.l2m, c.m2l
    if l2m is not None and l2m.ndim > 2:
        # a projection a row of y (N, nl, nl) or a cell (N, N, nl, nl)
        def cut_modes(t):
            return t[rows].contiguous() if t.ndim == 3 \
                else t[rows, cols].contiguous()
        l2m, m2l = cut_modes(l2m), cut_modes(m2l)
    return dataclasses.replace(
        c, strl=cut(c.strl), wind=cut(c.wind), Ro=cut(c.Ro),
        pp_pad=window(c.pp_pad), zetap_pad=window(c.zetap_pad),
        topo_pad=window(c.topo_pad), qforc=cut(c.qforc),
        ptr_relax=cut(c.ptr_relax), pp=cut(c.pp), pp_t=None, zetap_t=None,
        topo=cut(c.topo), iro=cut(c.iro), s_stoch=cut(c.s_stoch),
        spec=spec, iBu=cut(c.iBu), l2m=l2m, m2l=m2l,
        levels=None if c.levels is None
        else shard_mg.shard_levels(c.levels, mesh),
        mlevels=None if c.mlevels is None
        else shard_mg.shard_levels(c.mlevels, mesh),
        sig_lev=None, sig_filt=cut(c.sig_filt), Rd=cut(c.Rd))


def _mesh_step(cfg, mesh: Mesh, generator) -> ShardedStep:
    """The general-mesh step on `mesh` (module docstring)."""
    nl, N = cfg.nl, cfg.N
    ny, nx = N // mesh.my, N // mesh.mx
    rows, cols = mesh.tile(N, N)
    bc = qg._bc_psi(cfg)
    delta = cfg.delta

    def ghost_fn(f, b):
        return halo.ghosted_sharded(f, b, mesh)

    def ghost_deriv_fn(f, parent_g):
        if cfg.sbc == -1:
            return halo.ghosted_sharded(f, bc, mesh)
        return halo.ghosted_slip_sharded(f, parent_g, cfg.sbc, delta, mesh)

    def shard(x):
        if isinstance(x, qg.QGConstants):
            return x if _sharded(x) else _mesh_const(cfg, x, mesh)
        if isinstance(x, qg.QGState):
            return dataclasses.replace(x, **{
                f.name: getattr(x, f.name)[..., rows, cols].contiguous()
                for f in dataclasses.fields(x)
                if _is_field(getattr(x, f.name), N)})
        return x[..., rows, cols].contiguous()

    def gather(x):
        if isinstance(x, qg.QGState):
            return dataclasses.replace(x, **{
                f.name: halo.gather_global(getattr(x, f.name), mesh)
                for f in dataclasses.fields(x)
                if _is_field(getattr(x, f.name), ny)})
        return halo.gather_global(x, mesh)

    def invert(const, q, guess):
        spec = const.spec
        if isinstance(spec, spectral_shard.MeshSpectralData):
            return spectral_shard.solve_spectral_sharded(spec, q), _NO_CYCLES
        if isinstance(spec, spectral_shard.MeshVaryData):
            return spectral_shard.solve_vary_sharded(spec, q), _NO_CYCLES
        if isinstance(const.mlevels, shard_mg.ShardedLevels):
            # the modal inversion (JAX qg.py:322-330): the projections are
            # local, the modal Helmholtz solves the sharded multigrid
            cols_ = {2: "", 3: "y", 4: "yx"}[const.l2m.ndim]
            qm = torch.einsum(f"{cols_}ml,lyx->myx", const.l2m, q)
            pm_guess = torch.einsum(f"{cols_}ml,lyx->myx", const.l2m, guess)
            pm, st = shard_mg.solve_layered_sharded(
                pm_guess, qm, levels=const.mlevels, bc=bc,
                tolerance=cfg.tol)
            return torch.einsum(f"{cols_}lm,myx->lyx", const.m2l, pm), st
        if isinstance(const.levels, shard_mg.ShardedLevels):
            return shard_mg.solve_layered_sharded(
                guess, q, levels=const.levels, idh0=const.idh0,
                idh1=const.idh1, bc=bc, tolerance=cfg.tol)
        raise ValueError("the general-mesh step takes the constants of "
                         "shard(const)")

    def update(const, q, guess, tr, prev, DT):
        if tuple(q.shape) != (nl, ny, nx):
            raise ValueError(f"the general-mesh step takes a tile "
                             f"{(nl, ny, nx)}, got {tuple(q.shape)}")
        psi, st = invert(const, q, guess)
        # zeta's interior is enqueued while psi's ring is in flight
        pending = halo.ghosted_issue(psi, bc, mesh)
        zeta = halo.laplacian_overlap_g(pending, delta)
        psi_g = pending.wait()
        dq, dtr = qg.rhs(cfg, const, q, psi_g, zeta,
                         ghost_deriv_fn(zeta, psi_g), tr, ghost_fn=ghost_fn,
                         ghost_deriv_fn=ghost_deriv_fn)
        dtm, prev = qg.cfl_dtmax(cfg, const, psi_g, DT, prev,
                                 reduce_fn=halo.pmax)
        return dq, dtr, psi, prev, dtm, st

    def kinetic_energy(psi):
        return qg.kinetic_energy(cfg, psi, ghost_fn=ghost_fn,
                                 reduce_fn=halo.psum)

    step = _predictor_corrector(cfg, update, kinetic_energy, generator)
    return ShardedStep(step, shard, gather, "gspmd", mesh)
