"""The tendency API (the port of `msom_tpu.api`): the reference's SWIG
embedding layer as plain functions.

The reference exposes its steppers to Python for data assimilation
(back-and-forth nudging, msqg/qg_bfn.h), offline energy budgets
(qg_energy.h pystep_de) and bifurcation continuation around a flat state
vector (mspg/pg.h:1058-1153, driven by pg_trilinos.py's matrix-free
NOX/LOCA). Here:

- msqg: `q_to_psi`, `psi_to_q`, `qg_tendency` (on a CUDA tensor the fused
  tendency K1, with tracers K2, as `models/qg.py:update` routes them),
  `qg_energy_tendencies` and `bfn_integrate`, the AB3 loop of the BFN
  driver as a Python loop with no host read a step on the spectral path
  (the multigrid reads its residual once a V-cycle);
- mspg: `pg_pack`, `pg_unpack`, `pg_tendency` (numpy vectors in and out:
  one host read an evaluation, which scipy needs), and the steady state
  and continuation solvers over it, scipy's `newton_krylov` on the host:
  `pg_steady_state`, `pg_continuation`, `arclength_continuation`,
  `pg_arclength`.

Every function takes the device of the constants and tensors it is given.
"""

from __future__ import annotations

import dataclasses
import warnings

import numpy as np
import torch

from msom_tpu_torch.analysis import to_numpy
from msom_tpu_torch.models import fused_rhs, fused_tracer, mspg
from msom_tpu_torch.models import qg as _qg
from msom_tpu_torch.models import qg_energy as _en


# ---------------------------------------------------------------------------
# msqg: q <-> psi conversions and the BFN tendency
# ---------------------------------------------------------------------------

def q_to_psi(cfg, const, q, psi_guess=None):
    """pyq2p (msqg/qg_bfn.h:85-93): the PV inversion, from a zero guess
    unless one is given (the multigrid's warm start)."""
    if psi_guess is None:
        psi_guess = torch.zeros_like(q)
    psi, _ = _qg.invert_q(cfg, const, psi_guess, q)
    return psi


def psi_to_q(cfg, const, psi):
    """pyp2q (msqg/qg_bfn.h:95-103)."""
    return _qg.comp_q(cfg, const, psi)


def signed_config(cfg, direction: float):
    """The config of the BFN direction: `cfg` forward; for direction <= 0
    the irreversible terms flip (msqg/qg_bfn.h:34-44): Re -> -Re,
    Re4 -> -Re4, Eks -> -|Eks|, Ekb -> -|Ekb|. The fused tendency reads
    iRe, iRe4 and the Ekman factors as run-time scalars, so the flipped
    config takes the same kernel."""
    if direction > 0:
        return cfg
    return dataclasses.replace(cfg, Re=-cfg.Re, Re4=-cfg.Re4,
                               Eks=-abs(cfg.Eks), Ekb=-abs(cfg.Ekb))


def qg_tendency(cfg, const, q, direction: float = 1.0, tracers=None):
    """The PV tendency f(q) -> dq/dt, the BFN hook (pystep_bfn vartype=1,
    msqg/qg_bfn.h:65-79): psi from q from a zero guess, then the tendency.
    direction = -1 flips the irreversible terms (`signed_config`) for
    backward integration; advection, beta and forcing keep their signs.
    With `tracers` (nl, nptr, N, N) returns (dq, dtracers). The CFL maxima
    of the fused tendency are dropped."""
    c = signed_config(cfg, direction)
    psi, _ = _qg.invert_q(c, const, torch.zeros_like(q), q)
    rhs_fn = fused_rhs.rhs_fused if const.rhs_kernel \
        else fused_rhs.rhs_fused_reference
    dq, _ = rhs_fn(c, const, psi, q if c.energy_conserv or c.stochastic
                   else None)
    if tracers is None:
        return dq
    return dq, fused_tracer.tracer_fused(c, const, psi, tracers)


def qg_energy_tendencies(cfg, const, psi):
    """pystep_de (msqg/qg_energy.h:294-340): the per-term energy tendency
    fields of psi with ediag = 1 and dt = 1."""
    c = dataclasses.replace(cfg, ediag=1)
    acc = _en.energy_tend(c, const, _en.init_energy(c, device=psi.device),
                          psi, dt=1.0)
    return dict(de_j1=acc.de_j1, de_j2=acc.de_j2, de_j3=acc.de_j3,
                de_vd=acc.de_vd, de_bf=acc.de_bf)


def bfn_integrate(cfg, const, var0, nsteps: int, *, direction: float = 1.0,
                  flag_q: bool = True, nudge_fn=None, dt: float | None = None):
    """The AB3 back-and-forth-nudging loop of the reference's driver
    (msqg/scripts/qg_bfn.py:62-73): nsteps steps var += dt/12 (23 F1 -
    16 F2 + 5 F3) from a zero history (F2 = F3 = 0).

    var0 is q when flag_q, else psi (converted at both ends);
    nudge_fn(q, i), i the step index as a Python int, is added to the
    tendency F1 (the "BFN nudging goes here" hook, qg_bfn.py:66-67).
    direction = -1 runs the dissipation-flipped backward model; backward
    in time means a negative dt. dt defaults to cfg.DT."""
    if dt is None:
        dt = cfg.DT
    q = var0 if flag_q else psi_to_q(cfg, const, var0)
    F2 = torch.zeros_like(q)
    F3 = torch.zeros_like(q)
    for i in range(nsteps):
        F1 = qg_tendency(cfg, const, q, direction)
        if nudge_fn is not None:
            F1 = F1 + nudge_fn(q, i)
        q = q + dt / 12.0 * (23.0 * F1 - 16.0 * F2 + 5.0 * F3)
        F2, F3 = F1, F2
    return q if flag_q else q_to_psi(cfg, const, q)


# ---------------------------------------------------------------------------
# mspg: flat-vector tendency and the steady-state / continuation solvers
# ---------------------------------------------------------------------------

def pg_pack(state):
    """The flat state vector [b, ux, uy] (pyget_field's layout,
    mspg/pg.h:1094-1120, modulo the ordering inside a block), numpy."""
    return np.concatenate([to_numpy(a).ravel()
                           for a in (state.b, state.ux, state.uy)])


def pg_unpack(cfg, vec):
    """(b, ux, uy) views of a flat vector: (nl, N, N), (nl, N, N+1),
    (nl, N+1, N)."""
    nl, N = cfg.nl, cfg.N
    nb = nl * N * N
    nx = nl * N * (N + 1)
    b = vec[:nb].reshape(nl, N, N)
    ux = vec[nb:nb + nx].reshape(nl, N, N + 1)
    uy = vec[nb + nx:].reshape(nl, N + 1, N)
    return b, ux, uy


def pg_tendency(cfg, const, vec, dtconv: float = 1e-1):
    """pystep (mspg/pg.h:1123-1153): the all-explicit PG tendency of a flat
    numpy vector, on const's device and dtype: advection, horizontal
    diffusion, the explicit surface forcing, explicit vertical diffusion,
    the convection tendency (a finite difference over dtconv) and the
    momentum, with the barotropic adjustment applied to u on entry
    (btfac = 1) and to du with btfac = 0. Returns a numpy vector."""
    dev, dt = const.yc.device, const.yc.dtype
    b, ux, uy = (torch.as_tensor(np.ascontiguousarray(a), dtype=dt).to(dev)
                 for a in pg_unpack(cfg, np.asarray(vec)))

    ux, uy = mspg.adjust_bt_velocity(cfg, const, ux, uy, 1.0)
    ux, uy = mspg._zero_walls(ux, uy)

    db, _ = mspg.advection(cfg, const, b, ux, uy)
    db = db + mspg.hdiffusion(cfg, const, b)
    # explicit surface relaxation (forcing_explicit, pg.h:1002-1009)
    db = torch.cat([(db[0] + (const.b_surf - b[0]) / cfg.tau_s)[None],
                    db[1:]])
    # explicit vertical diffusion (vdiff_explicit, pg.h:964-977): mirror
    # vertical ghosts (vertbc) make the surface and bottom fluxes vanish;
    # the surface input enters through forcing_explicit only
    ds = 1.0 / cfg.nl
    dif = const.kv_prof[1:cfg.nl] * (b[:-1] - b[1:])      # interface fluxes
    flux_up = torch.cat([torch.zeros_like(b[:1]), dif])
    flux_dn = torch.cat([dif, torch.zeros_like(b[:1])])
    db = db + (flux_up - flux_dn) / (ds * ds)
    # convection tendency (convection_tend, pg.h:979-1000)
    db = db + (mspg.convection(b) - b) / dtconv
    dux, duy = mspg.momentum(cfg, const, b, ux, uy)
    dux, duy = mspg.adjust_bt_velocity(cfg, const, dux, duy, 0.0)
    return torch.cat([db.ravel(), dux.ravel(), duy.ravel()]).cpu().numpy()


def _scaled(const, mag):
    """const with b_surf scaled by the continuation parameter
    (pyadjust_contpar, mspg/pg.h:1022-1028)."""
    return dataclasses.replace(const, b_surf=const.b_surf * mag)


def pg_steady_state(cfg, const, vec0=None, *, f_tol=1e-8, maxiter=50,
                    forcing_mag: float = 1.0, verbose=False, strict=False,
                    callback=None):
    """Steady state F(x) = 0 by matrix-free Newton-Krylov, the capability
    of pg_trilinos.py's NOX driver. `forcing_mag`, the continuation
    parameter, scales b_surf; vec0 defaults to the rest state.
    `callback(x, f)` is scipy's, called after each Newton iteration.

    If NK stalls before f_tol (a damped step reaching maxiter), the best
    iterate found is returned with a RuntimeWarning (LOCA's behaviour on
    a hard solve); strict=True raises scipy's NoConvergence instead."""
    import scipy.optimize

    const2 = const if forcing_mag == 1.0 else _scaled(const, forcing_mag)
    if vec0 is None:
        vec0 = pg_pack(mspg.init_state(cfg, const2))

    def F(x):
        return pg_tendency(cfg, const2, x)

    try:
        sol = scipy.optimize.newton_krylov(F, vec0, f_tol=f_tol,
                                           maxiter=maxiter, verbose=verbose,
                                           callback=callback)
    except scipy.optimize.NoConvergence as e:
        if strict:
            raise
        sol = np.asarray(e.args[0])
        warnings.warn("pg_steady_state: NK did not reach f_tol; returning "
                      "the best iterate", RuntimeWarning)
    return sol


def pg_continuation(cfg, const, mags, vec0=None, **kw):
    """Natural-parameter continuation: steady states over a list of forcing
    magnitudes, each warm-started from the last (the simple-continuation
    mode of pg_trilinos.py). Returns [(mag, x), ...]."""
    branch = []
    x = vec0
    for mag in mags:
        x = pg_steady_state(cfg, const, x, forcing_mag=mag, **kw)
        branch.append((mag, x.copy()))
    return branch


def arclength_continuation(F, x0, lam0, ds, nsteps, *, f_tol=1e-8,
                           maxiter=60):
    """Keller pseudo-arclength continuation of F(x, lam) = 0, matrix-free
    (the LOCA arclength stepper of mspg/scripts/pg_trilinos.py). Solves
    the bordered system

        F(x, lam) = 0
        t_x . (x - x_c) + t_lam (lam - lam_c) - ds = 0

    with secant tangents (t_x, t_lam), so the branch is parameterised by
    arclength and continues through folds, where natural continuation in
    lam fails (dF/dx singular). A bordered solve that fails is retried
    with ds halved, up to six times. Returns [(lam, x), ...] of 2 + nsteps
    points (the two secant seeds, then the arclength steps)."""
    import scipy.optimize

    x0 = np.asarray(x0, float)

    def solve_nat(lam, xg):
        return scipy.optimize.newton_krylov(lambda x: F(x, lam), xg,
                                            f_tol=f_tol, maxiter=maxiter)

    x0 = solve_nat(lam0, x0)
    branch = [(float(lam0), x0.copy())]
    lam1 = lam0 + ds
    x1 = solve_nat(lam1, x0)
    branch.append((float(lam1), x1.copy()))

    for _ in range(nsteps):
        (lamp, xp), (lamc, xc) = branch[-2], branch[-1]
        dx, dlam = xc - xp, lamc - lamp
        nrm = np.sqrt(dx @ dx + dlam * dlam)
        tx, tlam = dx / nrm, dlam / nrm

        # LOCA's step-size control: near a fold the predictor can
        # overshoot the turning point
        ds_try, y = ds, None
        for _ in range(6):
            def G(y, tx=tx, tlam=tlam, xc=xc, lamc=lamc, ds_try=ds_try):
                x, lam = y[:-1], y[-1]
                arc = tx @ (x - xc) + tlam * (lam - lamc) - ds_try
                return np.concatenate([F(x, lam), [arc]])

            yg = np.concatenate([xc + ds_try * tx, [lamc + ds_try * tlam]])
            try:
                y = scipy.optimize.newton_krylov(G, yg, f_tol=f_tol,
                                                 maxiter=maxiter)
                break
            except (scipy.optimize.NoConvergence, ValueError):
                ds_try *= 0.5
        if y is None:
            raise RuntimeError(
                "arclength_continuation: bordered solve failed even at "
                f"ds = {ds_try * 2}")
        branch.append((float(y[-1]), y[:-1].copy()))
    return branch


def pg_arclength(cfg, const, lam0, ds, nsteps, vec0=None, **kw):
    """Pseudo-arclength continuation of the PG steady branch in the
    surface-forcing magnitude (the b_surf scale, pyadjust_contpar,
    mspg/pg.h:1022-1028)."""
    if vec0 is None:
        vec0 = pg_pack(mspg.init_state(cfg, const))

    def F(x, lam):
        return pg_tendency(cfg, _scaled(const, lam), x)

    return arclength_continuation(F, vec0, lam0, ds, nsteps, **kw)
