"""The offline mspg <-> msqg multiple-scale coupling (the port's own copy
of `msom_tpu.coupling`).

The large-scale PG thermocline state conditions the small-scale QG eddy
model, and the QG wavelet-filtered eddy flux feeds back as PG buoyancy
forcing (README.org:12). The reference runs this as a chain of scripts;
here each stage is one function:

    run mspg -> mean state (b, u, v)
      pg_to_qg_inputs      <- mspg/scripts/modes.py (stratification floors,
                              layer aggregation, gp/Fr/Rd, per-column modes,
                              psi from the velocity curl) + regrid.py
                              (bicubic PG grid -> QG grid)
    run msqg with psipg/frpg/rdpg, the wavelet filter accumulating qof
      qg_feedback_forcing  <- mspg/scripts/pgforcing.py (dimensionalise the
                              filtered flux, vertical derivative ->
                              buoyancy, QG-modal -> PG-modal projection,
                              adim Ts/Bs)
    run mspg with b_forc (qg_forcing, mspg/pg.h:598-606)

The dimensional scales follow modes.py:36-53 (PG: L, H, beta, N2 ->
Ts/Us/Bs; QG: u_qg, l_qg). Layouts: PG layer 0 is the surface; its faces
are (nl, N, N+1) and (nl, N+1, N), and the caller averages them to the
cells. The stages are host NumPy, but for the per-layer Poisson solve of
`pg_to_qg_inputs`, which runs the port's spectral solve on `device`.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from msom_tpu_torch.analysis import qg_flux_to_pg_forcing, regrid_bicubic
from msom_tpu_torch.ops import modes
from msom_tpu_torch.solvers import spectral


@dataclasses.dataclass(frozen=True)
class PGScales:
    """Dimensional PG scales (mspg/scripts/modes.py:36-47) and the QG eddy
    scales (modes.py:52-53, pgforcing.py:14-15)."""
    L: float = 5000e3        # basin width (m)
    H: float = 5000.0        # depth (m)
    beta: float = 2.0e-11    # 1/m/s
    N2: float = 1e-6         # background stratification (1/s^2)
    u_qg: float = 0.1        # QG velocity scale (m/s)
    l_qg: float = 50e3       # QG length scale (m)

    @property
    def Bs(self):            # buoyancy scale
        return self.N2 * self.H

    @property
    def Ts(self):            # PG time scale
        return self.beta * self.L ** 3 / (self.N2 * self.H ** 2)

    @property
    def Us(self):            # PG velocity scale
        return self.N2 * self.H ** 2 / (self.beta * self.L ** 2)


def _aggregate_layers(x, il, axis=0):
    """Mean over the PG sigma-layer bands il[k]:il[k+1] (modes.py:142-
    146)."""
    x = np.asarray(x)
    return np.stack([np.take(x, range(il[k], il[k + 1]), axis=axis)
                     .mean(axis=axis) for k in range(len(il) - 1)],
                    axis=axis)


def pg_to_qg_inputs(pg_cfg, b, u, v, *, il, N_qg, scales: PGScales = None,
                    N2_min: float = 2e-7, adjust_psi_coef: float = 1.0,
                    device="cuda"):
    """PG mean state -> msqg input fields (the modes.py + regrid.py stage).

    b: (nl_pg, N, N) nondimensional PG buoyancy; u, v: (nl_pg, N, N)
    nondimensional velocities at the cell centres; il: the QG layers'
    interface indices into the sigma layers (modes.py:129-134), len(il)-1
    = nl_qg. The per-layer Poisson solve runs on `device` in f64.

    Returns dict(psipg, frpg, rdpg, dh, Rom) on the (N_qg, N_qg) grid, for
    qg.build_constants(cfg, psipg=, frpg=, rdpg=) with cfg.dh = dh."""
    sc = scales or PGScales()
    b = np.asarray(b, np.float64)
    nl_pg, N, _ = b.shape
    dz = sc.H / nl_pg

    # stratification floor above the mixed layer (modes.py:100-110): lower
    # b below any interface whose N^2 < N2_min, so every gp is positive
    bb = b.copy()
    for nz in range(nl_pg - 1):
        N2_l = sc.Bs * (bb[nz] - bb[nz + 1]) / dz
        lift = np.maximum(N2_min - N2_l, 0.0)
        bb[nz + 1:] -= (lift * dz) / sc.Bs

    # y-dependent Coriolis and Rossby number (modes.py:122-127); msqg's Rom
    # takes 1/f at the mean latitude (modes.py's f0 = yc.mean() L beta)
    ys = float(getattr(pg_cfg, "ys", 0.0))
    yy = ys + (np.arange(N) + 0.5) / N
    f0 = yy * sc.L * sc.beta                            # (N,)
    Rom = float(sc.u_qg / (f0.mean() * sc.l_qg))

    # QG layer aggregation (modes.py:136-158)
    il = list(il)
    nl_qg = len(il) - 1
    bt = _aggregate_layers(bb, il)
    ut = _aggregate_layers(np.asarray(u, np.float64), il)
    vt = _aggregate_layers(np.asarray(v, np.float64), il)
    dzt = np.array([dz * (il[k + 1] - il[k]) for k in range(nl_qg)])
    dzi = 0.5 * (dzt[:-1] + dzt[1:])
    gpt = np.maximum(-sc.Bs * np.diff(bt, axis=0), 1e-8)  # (nl_qg-1, N, N)
    N2lt = gpt / dzi[:, None, None]
    Fr = sc.u_qg / (np.sqrt(N2lt) * sc.H)               # (nl_qg-1, N, N)

    # deformation radii from the aggregated stratification: eigmod a
    # column (def_radius.cal_rad's loop, modes.py:168-175) with
    # s = f0^2/N^2 at the interfaces
    s_cols = (f0[:, None] ** 2)[None] / N2lt            # (nl-1, N, N)
    vm = modes.eigmod(dzt, np.moveaxis(s_cols, 0, -1), htotal=sc.H)
    lam1 = -vm.iBu[..., 1]                              # (N, N)
    rd_a = 1.0 / np.sqrt(np.maximum(lam1, 1e-30)) / sc.l_qg

    # the large-scale streamfunction from the velocity curl (modes.py:204-
    # 210): dimensional zeta -> a Poisson solve a layer -> psi, /(l u)
    Dd = sc.L / N
    fu, fv = sc.Us * ut, sc.Us * vt
    zeta = ((np.roll(fv, -1, axis=2) - fv)
            - (np.roll(fu, -1, axis=1) - fu)) / Dd
    zeta[:, -1, :] = 0.0
    zeta[:, :, -1] = 0.0
    sd = spectral.build_spectral(nl=1, N=N, L0=N * Dd, periodic=False,
                                 dtype=torch.float64, transform="matmul",
                                 device=device)
    zt = torch.as_tensor(zeta, dtype=torch.float64).to(device)
    psi = np.stack([spectral.solve_spectral(sd, zt[k][None])[0].cpu()
                    .numpy() for k in range(nl_qg)])
    psi_a = adjust_psi_coef * psi / (sc.l_qg * sc.u_qg)

    # bicubic regrid PG grid -> QG grid (regrid.py)
    psipg = regrid_bicubic(psi_a, 1.0, N_qg)
    frpg = np.concatenate([regrid_bicubic(Fr, 1.0, N_qg),
                           np.zeros((1, N_qg, N_qg))], axis=0)
    rdpg = regrid_bicubic(rd_a, 1.0, N_qg)[0]
    return dict(psipg=psipg, frpg=frpg, rdpg=rdpg,
                dh=tuple(dzt / sc.H), Rom=Rom)


def qg_feedback_forcing(pf_qg, dh_qg, Fr_prof, Rom, nl_pg,
                        scales: PGScales = None, mode_cut=None):
    """QG filtered-flux accumulator -> PG buoyancy forcing b_forc (the
    pgforcing.py stage): dimensionalise the psi flux (u^2 u / l,
    pgforcing.py:14-25), its vertical derivative -> interface buoyancy
    flux centred on the layers (:74-79), QG-modal -> PG-modal projection
    through the vertical modes (:94-105), nondimensionalise with Ts/Bs
    (:119).

    pf_qg: (nl_qg, N, N) filtered streamfunction flux (the qof-inverted
    mean); Fr_prof: (nl_qg-1,) uniform Fr values (for the modes); returns
    (nl_pg, N, N) nondimensional b_forc on the same horizontal grid (regrid
    it where PG runs coarser)."""
    sc = scales or PGScales()
    pf = np.asarray(pf_qg, np.float64) * sc.u_qg ** 2 * sc.u_qg / sc.l_qg
    dh_qg = np.asarray(dh_qg, np.float64)
    dh2 = 0.5 * (dh_qg[1:] + dh_qg[:-1])
    bf = np.diff(pf, axis=0) / dh2[:, None, None]
    bf2 = np.empty_like(pf)
    bf2[0] = bf[0]
    bf2[-1] = bf[-1]
    if pf.shape[0] > 2:
        bf2[1:-1] = 0.5 * (bf[:-1] + bf[1:])
    s_prof = (np.asarray(Fr_prof, np.float64) / Rom) ** 2
    bf_pg = qg_flux_to_pg_forcing(bf2, dh_qg, s_prof, nl_pg,
                                  mode_cut=mode_cut)
    return bf_pg * sc.Ts / sc.Bs
