"""The offline coupling's two analysis functions (the port's own copy of
`msom_tpu.analysis.regrid_bicubic` and `qg_flux_to_pg_forcing`, the
reference's mspg/scripts/regrid.py and pgforcing.py). Host NumPy and
scipy; the rest of the analysis toolchain is not ported yet (ROADMAP.md
queue 1, item 14).
"""

from __future__ import annotations

import numpy as np

from msom_tpu_torch.ops import modes


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
