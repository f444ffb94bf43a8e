"""The analysis and offline-coupling toolchain (the port's own copy of
`msom_tpu.analysis`, the reference's msqg/scripts and mspg/scripts):
isotropic spectra and spectral fluxes (fftlib.py, spectra.py), velocity
from the streamfunction (read_data.py:44-52), the energy-budget closure
(energy_diag.py), .bas -> NetCDF (writenc.py), the bicubic PG -> QG regrid
(regrid.py), the QG filter flux -> PG buoyancy forcing projection
(pgforcing.py), the time-mean filter forcing (comp_mean_filter.py), the
PG deformation radii (modes.py), passive-tracer initial conditions
(init_ptracer.py) and the local QG linear stability (linearmode.py).

Host NumPy and scipy throughout; `ke_spectrum` and `uv_from_psi` also
take a tensor, which they bring to the host once.
"""

from __future__ import annotations

import numpy as np
import torch

from msom_tpu_torch.ops import modes


def to_numpy(a) -> np.ndarray:
    """An array as numpy; a tensor comes to the host once."""
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


# ---------------------------------------------------------------------------
# spectra (msqg/scripts/fftlib.py, Parseval-normalised)
# ---------------------------------------------------------------------------

def get_wavenumber(N, delta):
    """fftlib.py:26-33."""
    kx = np.fft.fftshift(np.fft.fftfreq(N, delta))
    k, l = np.meshgrid(kx, kx)
    K = np.sqrt(k**2 + l**2)
    dk = np.abs(kx[2] - kx[1])
    kr = dk * np.arange(1, int(k.max() / dk))
    return k, l, K, kr


def spec_2d(f1, f2, delta):
    """Cross power spectrum, Parseval normalisation (fftlib.py:36-48):
    sum(f^2) Delta^2 = sum(spec_2D) dk^2."""
    h1 = np.fft.fft2(f1) * delta**2
    h2 = np.fft.fft2(f2) * delta**2
    return np.fft.fftshift((h1 * h2.conj()).real)


def radial_average(s2, delta):
    """Azimuthal average onto the radial wavenumber bins (fftlib.py:6-17)."""
    N = s2.shape[0]
    _, _, K, kr = get_wavenumber(N, delta)
    out = np.zeros(len(kr))
    for i in range(kr.size):
        kfilt = (K >= kr[i] - kr[0]) & (K <= kr[i])
        nbin = kfilt.sum()
        out[i] = s2[kfilt].sum() * kr[i] / max(nbin, 1)
    return kr, out * 2 * np.pi


def spec_1d(f1, f2, delta):
    return radial_average(spec_2d(f1, f2, delta), delta)


def spectral_flux(f1, f2, delta):
    """Cumulative flux from high wavenumbers (fftlib.py:60-76)."""
    s2 = spec_2d(f1, f2, delta)
    N = f1.shape[0]
    _, _, K, kr = get_wavenumber(N, delta)
    dk = kr[1] - kr[0]
    flux = np.zeros(len(kr))
    for i in range(kr.size):
        flux[i] = s2[kr[i] <= K].sum() * dk * dk
    return kr, flux


def ke_spectrum(psi, delta, Ro=1.0):
    """Isotropic KE spectrum of a (possibly layered) streamfunction, summed
    over layers; the velocity u = Ro grad(p) of the scripts
    (read_data.py:44-52). Returns (kr, E)."""
    psi = np.atleast_3d(to_numpy(psi).T).T
    out = None
    kr = None
    for p in psi:
        u = -Ro * np.gradient(p, delta, axis=0)
        v = Ro * np.gradient(p, delta, axis=1)
        kr, su = spec_1d(u, u, delta)
        _, sv = spec_1d(v, v, delta)
        e = 0.5 * (su + sv)
        out = e if out is None else out + e
    return kr, out


# ---------------------------------------------------------------------------
# velocity from psi (msqg/scripts/read_data.py:44-52)
# ---------------------------------------------------------------------------

def uv_from_psi(psi, delta, Ro=1.0):
    psi = to_numpy(psi)
    u = -Ro * np.gradient(psi, delta, axis=-2)
    v = Ro * np.gradient(psi, delta, axis=-1)
    return u, v


# ---------------------------------------------------------------------------
# energy budget closure (msqg/scripts/energy_diag.py)
# ---------------------------------------------------------------------------

def budget_closure(de_terms: dict, psi_before, psi_after, q_before, q_after,
                   dh, delta):
    """The accumulated -psi dq budget terms against the energy change
    dE = -sum_l dh_l psi (q_after - q_before) over the window, psi the
    window's mean. Returns (sum_of_terms, dE, residual)."""
    dh = np.asarray(dh)[:, None, None]
    total = sum(np.asarray(v) for v in de_terms.values())
    total_int = float((dh * total).sum() * delta**2)
    psi_m = 0.5 * (np.asarray(psi_before) + np.asarray(psi_after))
    dE = float(-(dh * psi_m * (np.asarray(q_after)
                               - np.asarray(q_before))).sum() * delta**2)
    return total_int, dE, total_int - dE


# ---------------------------------------------------------------------------
# .bas -> NetCDF (writenc.py of both script directories)
# ---------------------------------------------------------------------------

def bas_to_netcdf(bas_paths, out_path, L0, nl=None, var="psi"):
    """One NetCDF record a .bas file, at times 0, 1, 2, ..."""
    from msom_tpu_torch.io.bas import read_bas
    from msom_tpu_torch.io.netcdf import NCWriter

    first, _, _ = read_bas(bas_paths[0], nl)
    nlr, n, _ = first.shape
    w = NCWriter(out_path, [var], n=n, nl=nlr, L0=L0)
    w.append(0.0, **{var: first})
    for it, p in enumerate(bas_paths[1:], start=1):
        f, _, _ = read_bas(p, nl)
        w.append(float(it), **{var: f})
    w.close()
    return out_path


# ---------------------------------------------------------------------------
# PG -> QG regrid (mspg/scripts/regrid.py, bicubic with edge handling)
# ---------------------------------------------------------------------------

def regrid_bicubic(field, L0_src, N_dst, x0_src=0.0, y0_src=0.0,
                   x0_dst=0.0, y0_dst=0.0, L0_dst=None):
    """Bicubic interpolation of cell-centred layers onto an N_dst grid
    (regrid.py:50-80: a spline on the source centres, extrapolated at the
    edges). `field` is (..., n, n); returns (..., N_dst, N_dst), a 2-D
    field as (1, N_dst, N_dst)."""
    from scipy.interpolate import RectBivariateSpline

    if L0_dst is None:
        L0_dst = L0_src
    f = np.asarray(field, np.float64)
    if f.ndim == 2:
        f = f[None]
    ns = f.shape[-1]
    ds = L0_src / ns
    xs = x0_src + (np.arange(ns) + 0.5) * ds
    dd = L0_dst / N_dst
    xd = x0_dst + (np.arange(N_dst) + 0.5) * dd
    yd = y0_dst + (np.arange(N_dst) + 0.5) * dd
    out = np.zeros(f.shape[:-2] + (N_dst, N_dst))
    for idx in np.ndindex(f.shape[:-2]):
        sp = RectBivariateSpline(xs, xs, f[idx], kx=3, ky=3)
        out[idx] = sp(yd, xd)
    return out


# ---------------------------------------------------------------------------
# QG filter flux -> PG buoyancy forcing (mspg/scripts/pgforcing.py)
# ---------------------------------------------------------------------------

def qg_flux_to_pg_forcing(qof_psi, dh_qg, Fr_over_Ro2_qg, nl_pg,
                          mode_cut=None):
    """Project the QG wavelet-filtered eddy flux onto the PG vertical grid
    through the vertical modes (pgforcing.py:63-68's l2m/m2l projection):
    the QG modes' amplitudes a column, the modal structures interpolated
    linearly in depth onto nl_pg uniform sigma layers, and summed there.
    `mode_cut` drops the modes from that index on."""
    vm = modes.eigmod(np.asarray(dh_qg), np.asarray(Fr_over_Ro2_qg))
    f = np.asarray(qof_psi)                     # (nl_qg, N, N)
    amps = np.einsum("ml,lyx->myx", vm.l2m, f)  # modal amplitudes
    if mode_cut is not None:
        amps[mode_cut:] = 0.0
    zq = -np.cumsum(np.asarray(dh_qg)) + 0.5 * np.asarray(dh_qg)
    zp = -(np.arange(nl_pg) + 0.5) / nl_pg
    phi = np.stack([np.interp(zp[::-1], zq[::-1], vm.m2l[::-1, m])[::-1]
                    for m in range(len(dh_qg))], axis=1)  # (nl_pg, nmodes)
    return np.einsum("pm,myx->pyx", phi, amps)


# ---------------------------------------------------------------------------
# time-mean filtered fields -> PG buoyancy forcing
# (msqg/scripts/comp_mean_filter.py)
# ---------------------------------------------------------------------------

def mean_filter_forcing(pf_series, dh, Ro):
    """The time mean of the wavelet-filtered streamfunction snapshots and
    the buoyancy forcing bf = d(pf_mean)/dz / Ro derived from it
    (comp_mean_filter.py:60-80: bf = diff(pf_me, axis=0)/dhi/Ro with
    dhi = 0.5 (dh[:-1] + dh[1:])).

    pf_series: (nt, nl, N, N) snapshots, or an iterable of (nl, N, N)
    arrays; dh: (nl,) layer thicknesses; Ro: a scalar or an (N, N) field.
    Returns (pf_mean, bf), bf (nl-1, N, N)."""
    it = iter(pf_series)
    first = np.asarray(next(it), np.float64)
    acc = first.copy()
    n = 1
    for snap in it:
        acc += np.asarray(snap, np.float64)
        n += 1
    pf_me = acc / n
    dh = np.asarray(dh, np.float64)
    dhi = 0.5 * (dh[:-1] + dh[1:])
    Ro = np.asarray(Ro, np.float64)
    bf = np.diff(pf_me, axis=0) / dhi.reshape(-1, 1, 1) / Ro
    return pf_me, bf


# ---------------------------------------------------------------------------
# PG stratification -> deformation radii (mspg/scripts/modes.py)
# ---------------------------------------------------------------------------

def pg_deformation_radii(b_profile, H=5000.0, L=5000e3, beta=2.0e-11,
                         f0=None, lat=45.0):
    """The deformation radii (m) of the baroclinic modes, gravest first,
    from a PG mean buoyancy profile b_profile (nl,), top layer first, with
    modes.py:36-47's dimensional scales."""
    b = np.asarray(b_profile, np.float64)
    nl = b.shape[0]
    if f0 is None:
        f0 = 2 * 7.2921e-5 * np.sin(np.deg2rad(lat))
    dz = H / nl
    N2 = np.maximum(np.diff(b[::-1])[::-1] / dz, 1e-12)  # at interfaces
    # with dh in metres and the stretching f0^2/N^2, the stretching
    # matrix's eigenvalues are 1/Rd^2 in 1/m^2
    dh = np.full(nl, dz)
    vm = modes.eigmod(dh, f0**2 / N2, htotal=H)
    lam = -vm.iBu[1:]
    return 1.0 / np.sqrt(np.maximum(lam, 1e-30))


# ---------------------------------------------------------------------------
# passive tracer ICs (msqg/scripts/init_ptracer.py)
# ---------------------------------------------------------------------------

def tracer_ics(N, nl, nptr, L0, kind="bands"):
    """Tracer initial conditions (init_ptracer.py:22-28's l*nptr + nt
    layout): sin((nt + 1) pi y / L0) bands, or else a Gaussian blob in the
    middle of the basin. Returns (nl, nptr, N, N)."""
    x = (np.arange(N) + 0.5) * L0 / N
    X, Y = np.meshgrid(x, x, indexing="xy")
    out = np.zeros((nl, nptr, N, N))
    for nt in range(nptr):
        if kind == "bands":
            out[:, nt] = np.sin((nt + 1) * np.pi * Y / L0)
        else:
            out[:, nt] = np.exp(-((X - L0 / 2) ** 2 + (Y - L0 / 2) ** 2)
                                / (L0 / 10) ** 2)
    return out


# ---------------------------------------------------------------------------
# QG linear stability of a mean state (mspg/scripts/linearmode.py)
# ---------------------------------------------------------------------------

def stretching_matrix_dim(dh, gp, f0):
    """The dimensional QG stretching operator Gamma, whose stretching part
    of the PV is (Gamma psi)_l = f0^2/dh_l [(psi_{l+1} - psi_l)/gp_l +
    (psi_{l-1} - psi_l)/gp_{l-1}] (linearmode.py's `construct_mat` returns
    -Gamma, linearmode.py:144-146: p2q = -mata - k^2)."""
    dh = np.asarray(dh, np.float64)
    gp = np.asarray(gp, np.float64)
    nl = len(dh)
    G = np.zeros((nl, nl))
    for l in range(nl):
        if l < nl - 1:
            c = f0 ** 2 / (dh[l] * gp[l])
            G[l, l + 1] += c
            G[l, l] -= c
        if l > 0:
            c = f0 ** 2 / (dh[l] * gp[l - 1])
            G[l, l - 1] += c
            G[l, l] -= c
    return G


def qg_linear_stability(dh, gp, f0, dpsibdx, dpsibdy, k, l, *, beta=0.0,
                        nu=0.0, nu4=0.0, bf=0.0):
    """Local QG linear stability of a sheared mean state at the wavenumber
    (k, l), the generalised eigenproblem of linearmode.py:162-181:

        [diag(k dqby - l dqbx - (k2^2 nu + k2^3 nu4) - k2 bf e_bot)
         + diag(l dpsibdx - k dpsibdy) (Gamma - k2 I)] v
            = omega (Gamma - k2 I) v

    with dqb = Gamma dpsib + beta (the flag_gradqbar == 0 form,
    linearmode.py:141-160); dpsibdx, dpsibdy (nl,) are the mean shear at
    the point. Returns the complex frequencies omega (rad/s); the growth
    rate is omega.imag."""
    import scipy.linalg

    G = stretching_matrix_dim(dh, gp, f0)
    nl = len(np.asarray(dh))
    dqbdy = G @ np.asarray(dpsibdy, np.float64) + beta
    dqbdx = G @ np.asarray(dpsibdx, np.float64)
    k2 = k ** 2 + l ** 2
    p2q = G - k2 * np.eye(nl)
    diag1 = k * dqbdy - l * dqbdx - (k2 ** 2 * nu + k2 ** 3 * nu4)
    diag1 = np.asarray(diag1, np.float64).copy()
    diag1[-1] -= k2 * bf
    diag2 = l * np.asarray(dpsibdx) - k * np.asarray(dpsibdy)
    mat1 = np.diag(diag1) + np.diag(diag2) @ p2q
    return scipy.linalg.eig(mat1, p2q, right=False)


def qg_growth_rate(dh, gp, f0, dpsibdx, dpsibdy, k_grid, l_grid, **kw):
    """The largest growth rate over a (k, l) grid: (sigma_max, k*, l*), the
    reference's scipy-optimize and peak_local_max search
    (linearmode.py:241-330) as a deterministic grid scan."""
    best = (-np.inf, 0.0, 0.0)
    for k in np.atleast_1d(k_grid):
        for l in np.atleast_1d(l_grid):
            if k == 0 and l == 0:
                continue
            w = qg_linear_stability(dh, gp, f0, dpsibdx, dpsibdy, k, l, **kw)
            s = float(np.max(w.imag))
            if s > best[0]:
                best = (s, float(k), float(l))
    return best
