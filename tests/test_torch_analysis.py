"""The port's analysis toolchain (msom_tpu_torch/analysis.py) against the
JAX package's msom_tpu.analysis on identical numpy inputs: the spectra
(get_wavenumber, spec_2d, radial_average, spec_1d, spectral_flux,
ke_spectrum), uv_from_psi, budget_closure, bas_to_netcdf,
regrid_bicubic, qg_flux_to_pg_forcing, mean_filter_forcing,
pg_deformation_radii, tracer_ics, stretching_matrix_dim,
qg_linear_stability and qg_growth_rate; and the checks of
tests/test_api_analysis.py and tests/test_linear_stability.py on the
port's functions.

Tolerances: both packages run the same numpy and scipy code, so every
result is expected bitwise equal (assert_array_equal), and
bas_to_netcdf's file byte for byte; ke_spectrum and uv_from_psi of a
float64 tensor equal those of its array. The physics checks keep their
own tolerances."""

import numpy as np
import pytest
import torch

from msom_tpu import analysis as jan
from msom_tpu.io.bas import write_bas
from msom_tpu_torch import analysis as tan

torch.set_num_threads(1)

RNG = np.random.default_rng(31)


def same(got, want):
    """Equal bit for bit, element by element through nested tuples."""
    if isinstance(want, (tuple, list)):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            same(g, w)
    else:
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


def field(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape)


@pytest.mark.parametrize("N,delta", [(64, 0.5), (48, 80.0 / 48)])
def test_spectra_match_jax(N, delta):
    f1, f2 = field((N, N), 1), field((N, N), 2)
    same(tan.get_wavenumber(N, delta), jan.get_wavenumber(N, delta))
    s2 = jan.spec_2d(f1, f2, delta)
    same(tan.spec_2d(f1, f2, delta), s2)
    same(tan.radial_average(s2, delta), jan.radial_average(s2, delta))
    same(tan.spec_1d(f1, f2, delta), jan.spec_1d(f1, f2, delta))
    same(tan.spectral_flux(f1, f2, delta), jan.spectral_flux(f1, f2, delta))


@pytest.mark.parametrize("layers", [None, 3])
def test_ke_spectrum_and_uv_match_jax(layers):
    """A 2-D and a layered psi, as arrays and as float64 tensors, with
    Ro != 1."""
    shape = (64, 64) if layers is None else (layers, 64, 64)
    psi = field(shape, 3)
    want = jan.ke_spectrum(psi, 0.3, Ro=0.5)
    same(tan.ke_spectrum(psi, 0.3, Ro=0.5), want)
    same(tan.ke_spectrum(torch.as_tensor(psi), 0.3, Ro=0.5), want)
    want = jan.uv_from_psi(psi, 0.3, Ro=0.5)
    same(tan.uv_from_psi(psi, 0.3, Ro=0.5), want)
    same(tan.uv_from_psi(torch.as_tensor(psi), 0.3, Ro=0.5), want)


def test_budget_closure_matches_jax():
    de = {"a": field((2, 8, 8), 4), "b": field((2, 8, 8), 5)}
    psi0, psi1 = field((2, 8, 8), 6), field((2, 8, 8), 7)
    q0 = field((2, 8, 8), 8)
    args = (de, psi0, psi1, q0, q0 + 0.1, [0.3, 0.7], 0.1)
    got = tan.budget_closure(*args)
    assert np.isfinite(got).all()
    same(got, jan.budget_closure(*args))


@pytest.mark.parametrize("nl", [None, 2])
def test_bas_to_netcdf_bytes_match_jax(tmp_path, nl):
    """Three .bas snapshots of a 3-layer field to one NetCDF file, all
    layers or the first nl: the file is JAX's byte for byte."""
    paths = []
    for k in range(3):
        p = str(tmp_path / f"psi{k}.bas")
        write_bas(p, field((3, 16, 16), 10 + k), L0=80.0)
        paths.append(p)
    got = tan.bas_to_netcdf(paths, str(tmp_path / "t.nc"), 80.0, nl=nl)
    want = jan.bas_to_netcdf(paths, str(tmp_path / "j.nc"), 80.0, nl=nl)
    assert got == str(tmp_path / "t.nc")
    assert open(got, "rb").read() == open(want, "rb").read()


def test_regrid_and_flux_projection_match_jax():
    f = field((3, 16, 16), 11)
    same(tan.regrid_bicubic(f, 1.0, 24, x0_dst=0.1, y0_dst=-0.05,
                            L0_dst=0.8),
         jan.regrid_bicubic(f, 1.0, 24, x0_dst=0.1, y0_dst=-0.05,
                            L0_dst=0.8))
    same(tan.regrid_bicubic(f[0], 1.0, 24), jan.regrid_bicubic(f[0], 1.0, 24))
    for cut in (None, 2):
        same(tan.qg_flux_to_pg_forcing(f, [0.06, 0.14, 0.8], [8.96, 92.8],
                                       nl_pg=10, mode_cut=cut),
             jan.qg_flux_to_pg_forcing(f, [0.06, 0.14, 0.8], [8.96, 92.8],
                                       nl_pg=10, mode_cut=cut))


def test_mean_filter_forcing_matches_jax():
    """An array of snapshots and a generator of them, a scalar and a field
    Ro; and JAX's test's own check of the mean and bf."""
    snaps = field((5, 3, 8, 8), 12)
    dh = np.array([0.2, 0.3, 0.5])
    Ro_field = 0.025 + 0.001 * field((8, 8), 13)
    for Ro in (0.025, Ro_field):
        want = jan.mean_filter_forcing(snaps, dh, Ro)
        same(tan.mean_filter_forcing(snaps, dh, Ro), want)
        same(tan.mean_filter_forcing(iter(list(snaps)), dh, Ro), want)
    pf_me, bf = tan.mean_filter_forcing(snaps, dh, 0.025)
    np.testing.assert_allclose(pf_me, snaps.mean(0), rtol=1e-12)
    dhi = 0.5 * (dh[:-1] + dh[1:])
    np.testing.assert_allclose(
        bf, np.diff(snaps.mean(0), axis=0) / dhi.reshape(-1, 1, 1) / 0.025,
        rtol=1e-12)
    assert bf.shape == (2, 8, 8)


def test_deformation_radii_match_jax():
    """A uniform stratification, where Rd_1 = N H / (f0 pi) (JAX's test),
    and a thermocline profile at the default latitude."""
    H, f0, Nbv, nl = 4000.0, 1e-4, 2e-3, 50
    b = Nbv**2 * (H - (np.arange(nl) + 0.5) * H / nl)
    Rd = tan.pg_deformation_radii(b, H=H, f0=f0)
    same(Rd, jan.pg_deformation_radii(b, H=H, f0=f0))
    assert abs(Rd[0] - Nbv * H / (f0 * np.pi)) / (Nbv * H / (f0 * np.pi)) \
        < 0.05
    z = (np.arange(30) + 0.5) / 30
    b2 = 0.02 * np.exp(-z / 0.15) + 0.002 * (1 - z)
    same(tan.pg_deformation_radii(b2), jan.pg_deformation_radii(b2))


@pytest.mark.parametrize("kind", ["bands", "blob"])
def test_tracer_ics_match_jax(kind):
    got = tan.tracer_ics(16, 3, 2, 80.0, kind=kind)
    assert got.shape == (3, 2, 16, 16)
    same(got, jan.tracer_ics(16, 3, 2, 80.0, kind=kind))


# Phillips two-layer physics (tests/test_linear_stability.py)
F0, G1, H = 1e-4, 0.02, 500.0
DH, GP = [H, H], [G1]
RD = np.sqrt(G1 * H / 2) / F0
BETA = 1.6e-11
KS = np.linspace(0.1 / RD, 2.0 / RD, 20)


def test_linear_stability_matches_jax():
    """Gamma, the eigenproblem's frequencies at one wavenumber with every
    term on, and the grid scan's maximum, on three layers."""
    dh, gp = [300.0, 700.0, 3000.0], [0.02, 0.01]
    G = tan.stretching_matrix_dim(dh, gp, F0)
    same(G, jan.stretching_matrix_dim(dh, gp, F0))
    kw = dict(beta=BETA, nu=10.0, nu4=1e9, bf=1e-7)
    dx, dy = np.array([0.01, 0.0, -0.005]), np.array([-0.05, 0.02, 0.0])
    same(tan.qg_linear_stability(dh, gp, F0, dx, dy, 2e-5, 1e-5, **kw),
         jan.qg_linear_stability(dh, gp, F0, dx, dy, 2e-5, 1e-5, **kw))
    same(tan.qg_growth_rate(dh, gp, F0, dx, dy, KS, [0.0, 1e-5], **kw),
         jan.qg_growth_rate(dh, gp, F0, dx, dy, KS, [0.0, 1e-5], **kw))


def test_phillips_oracles():
    """Gamma's rows sum to zero and it is symmetric in the dh-weighted
    product; supercritical shear is unstable near k Rd = 0.64, zero shear
    and beta-subcritical shear are neutral."""
    G = tan.stretching_matrix_dim(DH, GP, F0)
    np.testing.assert_allclose(G.sum(axis=1), 0.0, atol=1e-20)
    W = np.diag(DH)
    np.testing.assert_allclose(W @ G, (W @ G).T, rtol=1e-12)
    s, kb, _ = tan.qg_growth_rate(DH, GP, F0, np.zeros(2),
                                  np.array([-0.05, 0.0]), KS, [0.0],
                                  beta=BETA)
    assert s > 1e-8 and 0.4 < kb * RD < 1.0
    s, _, _ = tan.qg_growth_rate(DH, GP, F0, np.zeros(2), np.zeros(2), KS,
                                 [0.0], beta=BETA)
    assert abs(s) < 1e-14
    s, _, _ = tan.qg_growth_rate(DH, GP, F0, np.zeros(2),
                                 np.array([-0.2 * BETA * RD ** 2, 0.0]), KS,
                                 [0.0], beta=BETA)
    assert abs(s) < 1e-14


def test_spectra_parseval_and_peak():
    """sum(f^2) Delta^2 = sum(spec_2d) dk^2; a single-wavenumber psi has
    its KE peak at that wavenumber (JAX's tests)."""
    N, delta = 64, 0.5
    f = RNG.standard_normal((N, N))
    s2 = tan.spec_2d(f, f, delta)
    dk = 1.0 / (N * delta)
    np.testing.assert_allclose((f**2).sum() * delta**2, s2.sum() * dk**2,
                               rtol=1e-10)
    N, delta = 128, 1.0 / 128
    x = (np.arange(N) + 0.5) * delta
    X, Y = np.meshgrid(x, x, indexing="xy")
    kf = 8
    kr, E = tan.ke_spectrum(np.sin(2 * np.pi * kf * X)
                            * np.sin(2 * np.pi * kf * Y), delta)
    assert abs(kr[np.argmax(E)] - kf * np.sqrt(2)) / (kf * np.sqrt(2)) < 0.3


def test_regrid_recovers_smooth_field():
    x = (np.arange(32) + 0.5) / 32
    X, Y = np.meshgrid(x, x, indexing="xy")
    g = tan.regrid_bicubic(np.sin(2 * np.pi * X) * np.cos(2 * np.pi * Y),
                           1.0, 64)
    x2 = (np.arange(64) + 0.5) / 64
    X2, Y2 = np.meshgrid(x2, x2, indexing="xy")
    want = np.sin(2 * np.pi * X2) * np.cos(2 * np.pi * Y2)
    assert np.abs(g[0] - want)[4:-4, 4:-4].max() < 5e-3
