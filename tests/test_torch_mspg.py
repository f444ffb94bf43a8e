"""The port's mspg model (models/mspg.py, solvers/mg.solve_bt,
ops/tridiag.thomas_scan, params.PGConfig) against the JAX package's on
identical float64 inputs on the CPU, at the lockstep test's 32^2 x 8
configuration (tests/test_lockstep_pg.py).

Tolerances: the operators to 1e-12 of their output's max|value| (both
sides evaluate the same formulas; the perimeter solve is a product with
the system's inverse in the port, a sequential Thomas sweep in JAX); the
barotropic solve psibt to 1e-11 with the same V-cycle count; 20 steps to
1e-11 of max|b| and max|u|."""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from msom_tpu.models import mspg as jm
from msom_tpu.ops import tridiag as jtri
from msom_tpu.params import PGConfig as JPG
from msom_tpu.params import load_pg_config as jload
from msom_tpu.solvers import mg as jmg
from msom_tpu_torch.models import mspg as tm
from msom_tpu_torch.ops import tridiag as ttri
from msom_tpu_torch.params import PGConfig as TPG
from msom_tpu_torch.params import load_pg_config as tload
from msom_tpu_torch.solvers import mg as tmg

torch.set_num_threads(1)

BASE = dict(N=32, nl=8, ys=0.3, r=0.02, tau_s=3e-2, tau0=0.12, kv=1e-4,
            kh=1e-4, omega=0.2, DT=1e-2, CFL=0.4, tend=0.1, dtout=1.0,
            dtype="float64")


def configs(**kw):
    return JPG(**{**BASE, **kw}), TPG(**{**BASE, **kw})


def rel(got, want):
    """max|got - want| over max|want|."""
    if isinstance(got, torch.Tensor):
        got = got.numpy()
    want = np.asarray(want)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-300)


def fields(cfg, seed):
    """A numpy-seeded state: a stable stratification with noise (some
    pairs unstable), random face velocities."""
    rng = np.random.default_rng(seed)
    N, nl = cfg.N, cfg.nl
    b = (np.linspace(1.0, 0.0, nl)[:, None, None]
         + 0.2 * rng.standard_normal((nl, N, N)))
    ux = 0.1 * rng.standard_normal((nl, N, N + 1))
    uy = 0.1 * rng.standard_normal((nl, N + 1, N))
    return b, ux, uy


@pytest.fixture(scope="module")
def built():
    """Both packages' constants for the GM configuration (k_gm does not
    enter build_constants, so they serve the plain runs too)."""
    jcfg, tcfg = configs(k_gm=0.05)
    return jcfg, tcfg, jm.build_constants(jcfg), tm.build_constants(
        tcfg, device="cpu")


def test_pg_config_parses_like_jax():
    text = ("N = 64\nnl = 30\nys = 0.3\nr = 0.02\nomega = 0.2\nkd = 1.0\n"
            "a = 2.0\nnu = 1e-3\nkv = 1e-4\nDT = 1e-2\n# tend = 5\n")
    got, want = tload(text, dtype="float64"), jload(text, dtype="float64")
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.nu == 3e-4 and got.delta == want.delta


def test_thomas_scan_matches_jax():
    rng = np.random.default_rng(3)
    n = 40
    t0, t2 = 0.2 * rng.standard_normal(n), 0.2 * rng.standard_normal(n)
    t1 = 2 + np.abs(rng.standard_normal(n))
    rhs = rng.standard_normal(n)
    got = ttri.thomas_scan(*map(torch.as_tensor, (t0, t1, t2, rhs)))
    want = jtri.thomas_scan(*map(jnp.asarray, (t0, t1, t2, rhs)))
    assert rel(got, want) < 1e-12
    # coefficients broadcast against a batch of right-hand sides
    many = rng.standard_normal((n, 3))
    got = ttri.thomas_scan(*[torch.as_tensor(v)[:, None]
                             for v in (t0, t1, t2)], torch.as_tensor(many))
    for k in range(3):
        want = jtri.thomas_scan(*map(jnp.asarray, (t0, t1, t2, many[:, k])))
        assert rel(got[:, k], want) < 1e-12


@pytest.mark.parametrize("N", [8, 32])
def test_circ_bc_pad_matches_jax(N):
    psi = np.random.default_rng(N).standard_normal((N, N))
    want = jm.circ_bc_pad(jnp.asarray(psi), 0.02, 0.3, 1.0)
    got = tm.circ_bc_pad(torch.as_tensor(psi), 0.02, 0.3, 1.0)
    assert rel(got, want) < 1e-12
    minv = tm.perimeter_inverse(N, 0.02, 0.3, 1.0)
    assert torch.equal(tm.circ_bc_pad(torch.as_tensor(psi), 0.02, 0.3, 1.0,
                                      minv), got)


def test_solve_bt_matches_jax(built):
    """The barotropic solve from build_constants' coefficients: the same
    cycles and nrelax, psibt to 1e-11; the constants it derives."""
    jcfg, tcfg, jc, tc = built
    N, r = tcfg.N, tcfg.r
    delta = tcfg.L0 / N
    y = tcfg.ys + (np.arange(N) + 0.5) * delta
    yf = tcfg.ys + np.arange(N + 1) * delta
    Y = np.broadcast_to(y[:, None], (N, N))
    wind = tcfg.tau0 * 2 * np.pi * Y * np.cos(2 * (Y - tcfg.ys) * np.pi)
    coef = dict(ax=np.broadcast_to((r / (r**2 + y**2))[:, None], (N, N + 1)),
                ay=np.broadcast_to(r / (r**2 + yf[:, None]**2), (N + 1, N)),
                bx=np.zeros((N, N)), by=-(r**2 - Y**2) / (r**2 + Y**2)**2)
    jpsi, jst = jmg.solve_bt(
        jnp.zeros((N, N)), jnp.asarray(wind), L0=1.0,
        alpha_x=jnp.asarray(coef["ax"]), alpha_y=jnp.asarray(coef["ay"]),
        beta_x=jnp.asarray(coef["bx"]), beta_y=jnp.asarray(coef["by"]),
        omega=tcfg.omega, tolerance=tcfg.tol,
        pad_fn=lambda a: jm.circ_bc_pad(a, r, tcfg.ys, tcfg.L0))
    t = {k: torch.as_tensor(np.ascontiguousarray(v)) for k, v in coef.items()}
    tpsi, tst = tmg.solve_bt(
        torch.zeros((N, N), dtype=torch.float64), torch.as_tensor(wind),
        L0=1.0, alpha_x=t["ax"], alpha_y=t["ay"], beta_x=t["bx"],
        beta_y=t["by"], omega=tcfg.omega, tolerance=tcfg.tol,
        pad_fn=lambda a: tm.circ_bc_pad(a, r, tcfg.ys, tcfg.L0))
    assert tst.iters == int(jst.iters) > 1
    assert tst.nrelax == int(jst.nrelax)
    assert abs(tst.resa - float(jst.resa)) <= 1e-11 * float(jst.resb)
    assert rel(tpsi, jpsi) < 1e-11
    assert tc.bt_stats == tst and rel(tc.psibt, jc.psibt) < 1e-11
    for name in ("ubtx", "ubty", "b_surf", "kx_face", "ky_face", "kv_prof",
                 "yc"):
        assert rel(getattr(tc, name), getattr(jc, name)) < 1e-11, name
    assert tc.sc == jc.sc and tc.sf == jc.sf


def test_bt_levels_restrict_like_jax():
    rng = np.random.default_rng(2)
    ax, ay = rng.standard_normal((16, 17)), rng.standard_normal((17, 16))
    assert rel(tmg.restrict_face_x(torch.as_tensor(ax)),
               jmg.restrict_face_x(jnp.asarray(ax))) == 0
    assert rel(tmg.restrict_face_y(torch.as_tensor(ay)),
               jmg.restrict_face_y(jnp.asarray(ay))) == 0


OPERATORS = ["advection", "hdiffusion", "vdiff_implicit", "convection",
             "forcing_implicit", "momentum", "adjust_bt_velocity", "comp_gm",
             "cfl_dtmax", "_zero_walls"]


@pytest.mark.parametrize("name", OPERATORS)
def test_operator_matches_jax(built, name):
    jcfg, tcfg, jc, tc = built
    b, ux, uy = fields(tcfg, 7)
    j = dict(b=jnp.asarray(b), ux=jnp.asarray(ux), uy=jnp.asarray(uy))
    t = {k: torch.as_tensor(v) for k, v in (("b", b), ("ux", ux),
                                            ("uy", uy))}
    calls = {
        "advection": lambda m, cfg, c, a: m.advection(cfg, c, a["b"],
                                                      a["ux"], a["uy"]),
        "hdiffusion": lambda m, cfg, c, a: m.hdiffusion(cfg, c, a["b"]),
        "vdiff_implicit": lambda m, cfg, c, a: m.vdiff_implicit(
            cfg, c, a["b"], 0.37),
        "convection": lambda m, cfg, c, a: m.convection(a["b"]),
        "forcing_implicit": lambda m, cfg, c, a: m.forcing_implicit(
            cfg, c, a["b"], 0.01),
        "momentum": lambda m, cfg, c, a: m.momentum(cfg, c, a["b"],
                                                    a["ux"], a["uy"]),
        "adjust_bt_velocity": lambda m, cfg, c, a: m.adjust_bt_velocity(
            cfg, c, a["ux"], a["uy"], 1.0),
        "comp_gm": lambda m, cfg, c, a: m.comp_gm(cfg, c, a["b"]),
        "_zero_walls": lambda m, cfg, c, a: m._zero_walls(a["ux"], a["uy"]),
    }
    if name == "cfl_dtmax":
        # from a previous dt above, then below the CFL limit
        for prev in (1.0, 1e-4):
            got = tm.cfl_dtmax(tcfg, t["ux"], t["uy"], tcfg.DT,
                               torch.tensor(prev, dtype=torch.float64))
            want = jm.cfl_dtmax(jcfg, j["ux"], j["uy"], jcfg.DT,
                                jnp.asarray(prev))
            for g, w in zip(got, want):
                assert g.ndim == 0 and rel(g, w) < 1e-12
        return
    got = calls[name](tm, tcfg, tc, t)
    want = calls[name](jm, jcfg, jc, j)
    if not isinstance(got, tuple):
        got, want = (got,), (want,)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        assert rel(g, w) < 1e-12, name
    if name == "convection":
        # the sweep mixed unstable pairs, sequentially
        assert rel(got[0], b) > 1e-3


@pytest.mark.parametrize("run", ["plain", "gm", "b_forc"])
def test_step_matches_jax(built, run):
    """20 predictor-corrector steps from one numpy stratified IC."""
    jcfg, tcfg, jc, tc = built
    if run != "gm":
        jcfg, tcfg = configs()
    if run == "b_forc":
        bf = 1e-2 * np.random.default_rng(8).standard_normal(
            (tcfg.nl, tcfg.N, tcfg.N))
        jc = dataclasses.replace(jc, b_forc=jnp.asarray(bf))
        tc = dataclasses.replace(tc, b_forc=torch.as_tensor(bf))
    b0, _, _ = fields(tcfg, 9)
    js = jm.init_state(jcfg, jc, b0=b0)
    ts = tm.init_state(tcfg, tc, b0=b0)
    import jax
    jstep = jax.jit(jm.make_step(jcfg))
    tstep = tm.make_step(tcfg)
    for i in range(20):
        js, jd = jstep(js, jc, jnp.asarray(1e18))
        ts, td = tstep(ts, tc, 1e18)
        assert abs(float(td.dt) - float(jd.dt)) <= 1e-12 * float(jd.dt)
    assert rel(ts.b, js.b) < 1e-11
    uscale = max(np.abs(np.asarray(js.ux)).max(),
                 np.abs(np.asarray(js.uy)).max())
    for name in ("ux", "uy"):
        assert np.abs(getattr(ts, name).numpy()
                      - np.asarray(getattr(js, name))).max() < 1e-11 * uscale
    assert float(ts.t) == pytest.approx(float(js.t), rel=1e-13)
    assert float(ts.dt_prev) == pytest.approx(float(js.dt_prev), rel=1e-12)
    assert int(ts.i) == int(js.i) == 20
    ts, js = tm.accumulate_means(ts), jm.accumulate_means(js)
    ts, js = tm.accumulate_means(ts), jm.accumulate_means(js)
    assert int(ts.nme) == int(js.nme) == 2
    for name in ("b_me", "ux_me", "uy_me"):
        assert rel(getattr(ts, name), getattr(js, name)) < 1e-11


def test_build_constants_checks_b_forc():
    _, tcfg = configs(N=8, nl=2)
    with pytest.raises(ValueError, match="b_forc"):
        tm.build_constants(tcfg, device="cpu", b_forc=np.zeros((3, 8, 8)))
