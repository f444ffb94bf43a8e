"""The port's tendency API (msom_tpu_torch/api.py) against the JAX
package's msom_tpu.api on identical float64 numpy inputs on the CPU, at
tests/test_api_analysis.py's sizes: msqg at N = 32, nl = 3; mspg at
N = 8, nl = 3.

- q_to_psi/psi_to_q and qg_tendency at direction = +1 and -1: walled,
  doubly periodic, coupled (a large-scale streamfunction and topography),
  with two tracers, and under solver="mg" (tol 1e-9, as JAX's round
  trip); qg_energy_tendencies per term; bfn_integrate after four
  AB3 steps in q and in psi space with the same nudge_fn (which reads the
  step index), and against a hand-written AB3 loop.
- pg_tendency at several random vectors; pg_steady_state and pg_arclength
  on the port, each solution and branch point then evaluated by JAX's
  pg_tendency (one call a point) and held to the f_tol asked; the
  analytic fold of arclength_continuation against JAX's branch.

Tolerances: fields to 1e-12 of their maximum (the same stencils and the
exact spectral solve; the multigrid takes the same V-cycles), where a
multigrid result sits at its residual's roundoff 1e-13 absolute (ROADMAP
section 3); bfn_integrate 1e-10 relative, the tolerance of JAX's own
test; pg_tendency 1e-12; the fold's branch 1e-12 (the same scipy solve on
the same numpy function). The JAX results are computed once a module
(module-scoped fixtures)."""

import dataclasses
import warnings

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from msom_tpu import api as japi
from msom_tpu.models import mspg as jpg
from msom_tpu.models import qg as jqg
from msom_tpu.params import PGConfig as JPG
from msom_tpu.params import QGConfig as JConfig
from msom_tpu_torch import api as tapi
from msom_tpu_torch.models import fused_rhs, fused_tracer
from msom_tpu_torch.models import mspg as tpg
from msom_tpu_torch.models import qg as tqg
from msom_tpu_torch.params import PGConfig as TPG
from msom_tpu_torch.params import QGConfig as TConfig

torch.set_num_threads(1)

N, NL = 32, 3
# tests/test_api_analysis.py's qg_cfg, with the harmonic viscosity and the
# surface Ekman layer on so that every irreversible term is nonzero
BASE = dict(N=N, nl=NL, L0=80, Rom=0.025, Ekb=0.002, tau0=1e-4, Re4=1563,
            beta=0.5, Fr=(0.0023669, 0.0076173), dh=(0.06, 0.14, 0.8),
            DT=5e-2, tend=1.0, dtout=1.0, CFL=0.6, dtype="float64",
            Re=500.0, Eks=0.001)
TRACERS = dict(nptr=2, Pe=(1e3, 2e3), ptr_r=(100.0, 0.0))
CASES = {
    "walled": dict(solver="spectral"),
    "periodic": dict(solver="spectral", sbc=-1.0),
    "coupled": dict(solver="spectral", flsrv=1),
    "tracers": dict(solver="spectral", **TRACERS),
    "mg": dict(solver="mg", tol=1e-9),
}
DIRECTIONS = [1.0, -1.0]
PG = dict(N=8, nl=3, ys=0.3, r=0.05, tau_s=3e-2, tau0=0.05, kv=5e-4,
          kh=5e-4, omega=0.2, DT=5e-3, dtype="float64")


def rel(got, want):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    return np.abs(got - want).max() / np.abs(want).max()


def close(got, want, case):
    """1e-12 of max|want|; a multigrid result 1e-13 absolute."""
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    err = np.abs(got - want).max()
    if case == "mg" and err <= 1e-13:
        return True
    return err <= 1e-12 * np.abs(want).max()


def rough(shape, seed):
    """A smooth gyre plus white noise, so that every stencil point
    counts."""
    rng = np.random.default_rng(seed)
    y = (np.arange(shape[-1]) + 0.5) / shape[-1]
    return (np.sin(np.pi * y)[:, None] * np.sin(2 * np.pi * y)[None, :]
            + 0.1 * rng.standard_normal(shape))


def build(case):
    kw = dict(BASE, **CASES[case])
    jcfg, tcfg = JConfig(**kw).validate(), TConfig(**kw).validate()
    inputs = {}
    if case == "coupled":
        inputs = dict(psipg=0.05 * rough((NL, N, N), 9),
                      topo=0.05 * rough((N, N), 10))
    jc = jqg.build_constants(jcfg, **inputs)
    tc = tqg.build_constants(tcfg, device="cpu", **inputs)
    return jcfg, tcfg, jc, tc


def inputs(case):
    psi = 0.1 * rough((NL, N, N), 1)
    tr = rough((NL, 2, N, N), 2) if case == "tracers" else None
    return psi, tr


@pytest.fixture(scope="module")
def qg_runs():
    """Each case's configs and constants, and JAX's results: psi_to_q of
    the numpy psi, q_to_psi of that q, and qg_tendency of it in each
    direction."""
    out = {}
    for case in CASES:
        jcfg, tcfg, jc, tc = build(case)
        psi, tr = inputs(case)
        q = np.asarray(japi.psi_to_q(jcfg, jc, jnp.asarray(psi)))
        res = dict(q=q, psi=np.asarray(japi.q_to_psi(jcfg, jc,
                                                     jnp.asarray(q))))
        for d in DIRECTIONS:
            if tr is None:
                res[d] = (np.asarray(japi.qg_tendency(jcfg, jc,
                                                      jnp.asarray(q), d)),)
            else:
                dq, dtr = japi.qg_tendency(jcfg, jc, jnp.asarray(q), d,
                                           tracers=jnp.asarray(tr))
                res[d] = (np.asarray(dq), np.asarray(dtr))
        out[case] = (jcfg, tcfg, jc, tc, res)
    return out


@pytest.mark.parametrize("case", list(CASES))
def test_psi_q_conversions_match_jax(qg_runs, case):
    """psi_to_q of one numpy psi and q_to_psi of JAX's q agree with JAX's;
    between walls q_to_psi returns psi (the round trip of JAX's test)."""
    _, tcfg, _, tc, res = qg_runs[case]
    psi, _ = inputs(case)
    q = tapi.psi_to_q(tcfg, tc, torch.as_tensor(psi))
    assert close(q, res["q"], case), rel(q, res["q"])
    back = tapi.q_to_psi(tcfg, tc, torch.as_tensor(res["q"]))
    assert close(back, res["psi"], case), rel(back, res["psi"])
    if case != "periodic":
        np.testing.assert_allclose(back.numpy(), psi, atol=1e-6)


@pytest.mark.parametrize("direction", DIRECTIONS)
@pytest.mark.parametrize("case", list(CASES))
def test_qg_tendency_matches_jax(qg_runs, case, direction):
    """The tendency (and the tracers') of JAX's q in each direction; on
    the CPU the route is K1's and K2's plain versions, with no launch."""
    _, tcfg, _, tc, res = qg_runs[case]
    _, tr = inputs(case)
    n1, n2 = fused_rhs.launches, fused_tracer.launches
    q = torch.as_tensor(res["q"])
    if tr is None:
        got = (tapi.qg_tendency(tcfg, tc, q, direction),)
    else:
        got = tapi.qg_tendency(tcfg, tc, q, direction,
                               tracers=torch.as_tensor(tr))
    assert (fused_rhs.launches, fused_tracer.launches) == (n1, n2)
    for g, w in zip(got, res[direction]):
        assert close(g, w, case), rel(g, w)


def test_backward_flips_dissipation_only(qg_runs):
    """(fwd + bwd)/2 is the reversible tendency (advection, beta, wind:
    the tendency with every dissipation and friction coefficient 0) and
    (fwd - bwd)/2 is nonzero, as in JAX's test."""
    _, tcfg, _, tc, res = qg_runs["walled"]
    q = torch.as_tensor(res["q"])
    fwd = tapi.qg_tendency(tcfg, tc, q, 1.0).numpy()
    bwd = tapi.qg_tendency(tcfg, tc, q, -1.0).numpy()
    assert np.abs(0.5 * (fwd - bwd)).max() > 0
    cfg0 = dataclasses.replace(tcfg, Re=0.0, Re4=0.0, Ekb=0.0, Eks=0.0)
    rev = tapi.qg_tendency(cfg0, tc, q).numpy()
    np.testing.assert_allclose(0.5 * (fwd + bwd), rev, rtol=1e-6,
                               atol=1e-12)


@pytest.mark.parametrize("case", ["walled", "periodic", "coupled"])
def test_energy_tendencies_match_jax(qg_runs, case):
    """Each of the five per-term fields (ediag = 1, dt = 1)."""
    jcfg, tcfg, jc, tc, _ = qg_runs[case]
    psi = 0.1 * rough((NL, N, N), 3)
    want = japi.qg_energy_tendencies(jcfg, jc, jnp.asarray(psi))
    got = tapi.qg_energy_tendencies(tcfg, tc, torch.as_tensor(psi))
    assert set(got) == set(want) == {"de_j1", "de_j2", "de_j3", "de_vd",
                                     "de_bf"}
    for name, w in want.items():
        w = np.asarray(w)
        assert np.isfinite(got[name].numpy()).all()
        if np.abs(w).max() == 0:
            assert np.abs(got[name].numpy()).max() == 0, name
        else:
            assert rel(got[name], w) <= 1e-12, name


def _nudge(q, i):
    """Damping that grows with the step index (reads i)."""
    return -(0.5 + 0.25 * i) * q


BFN = {"q forward": dict(flag_q=True, direction=1.0),
       "psi backward": dict(flag_q=False, direction=-1.0, dt=-1e-2)}


@pytest.mark.parametrize("run", list(BFN))
def test_bfn_integrate_matches_jax(qg_runs, run):
    """Four AB3 steps with the nudging hook, in q space forward and in psi
    space backward (dissipation flipped, dt < 0)."""
    jcfg, tcfg, jc, tc, res = qg_runs["walled"]
    kw = dict(dict(dt=1e-2), **BFN[run])
    var0 = res["q"] if kw["flag_q"] else res["psi"]
    want = np.asarray(japi.bfn_integrate(jcfg, jc, jnp.asarray(var0), 4,
                                         nudge_fn=_nudge, **kw))
    got = tapi.bfn_integrate(tcfg, tc, torch.as_tensor(var0), 4,
                             nudge_fn=_nudge, **kw)
    assert rel(got, want) <= 1e-10


def test_bfn_integrate_matches_manual_ab3(qg_runs):
    """bfn_integrate is the hand-written AB3 loop with a zero history
    (qg_bfn.py:49-56 starts F2 = F3 = 0), as JAX's test holds its scan."""
    _, tcfg, _, tc, res = qg_runs["walled"]
    q = torch.as_tensor(res["q"])
    dt = 1e-2
    got = tapi.bfn_integrate(tcfg, tc, q, 4, dt=dt)
    F2 = torch.zeros_like(q)
    F3 = torch.zeros_like(q)
    for _ in range(4):
        F1 = tapi.qg_tendency(tcfg, tc, q)
        q = q + dt / 12 * (23 * F1 - 16 * F2 + 5 * F3)
        F3, F2 = F2, F1
    np.testing.assert_allclose(got.numpy(), q.numpy(), rtol=1e-10,
                               atol=1e-14)


# ---------------------------------------------------------------------------
# mspg
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def pg_setup():
    """JAX's and the port's constants of the small PG config, and the port
    spun up 400 steps (the warm start JAX's test gives its NK)."""
    jcfg, tcfg = JPG(**PG), TPG(**PG)
    jc = jpg.build_constants(jcfg)
    tc = tpg.build_constants(tcfg, device="cpu")
    state = tpg.init_state(tcfg, tc)
    step = tpg.make_step(tcfg)
    big = torch.tensor(1e9, dtype=torch.float64)
    for _ in range(400):
        state, _ = step(state, tc, big)
    return jcfg, tcfg, jc, tc, tapi.pg_pack(state)


def jax_residual(jcfg, jc, x, lam=1.0):
    c = jc if lam == 1.0 else dataclasses.replace(jc,
                                                  b_surf=jc.b_surf * lam)
    return np.abs(japi.pg_tendency(jcfg, c, x)).max()


def test_pg_pack_unpack_and_tendency_match_jax(pg_setup):
    """pg_pack against JAX's on the same state, pg_unpack's views, and
    pg_tendency at the spun-up vector and at random vectors."""
    jcfg, tcfg, jc, tc, x0 = pg_setup
    b, ux, uy = tapi.pg_unpack(tcfg, x0)
    jstate = jpg.init_state(jcfg, jc, b0=b, u0=(ux, uy))
    np.testing.assert_array_equal(japi.pg_pack(jstate), x0)
    assert (b.shape, ux.shape, uy.shape) == ((3, 8, 8), (3, 8, 9),
                                             (3, 9, 8))
    rng = np.random.default_rng(7)
    vecs = [x0] + [x0 + 0.1 * rng.standard_normal(x0.shape)
                   for _ in range(3)] + [rng.standard_normal(x0.shape)]
    for x in vecs:
        got = tapi.pg_tendency(tcfg, tc, x)
        assert isinstance(got, np.ndarray) and got.shape == x.shape
        assert rel(got, japi.pg_tendency(jcfg, jc, x)) <= 1e-12


def test_pg_steady_state_meets_f_tol_under_jax(pg_setup):
    """The port's NK at an f_tol it reaches (strict: no stall), then JAX's
    tendency at the port's solution within that f_tol."""
    jcfg, tcfg, jc, tc, x0 = pg_setup
    r0 = jax_residual(jcfg, jc, x0)
    f_tol = 0.15 * r0
    sol = tapi.pg_steady_state(tcfg, tc, x0, f_tol=f_tol, maxiter=40,
                               strict=True)
    assert np.isfinite(sol).all()
    assert jax_residual(jcfg, jc, sol) <= f_tol


def test_pg_steady_state_returns_best_iterate(pg_setup):
    """JAX's test's call (f_tol = 1e-8, 40 iterations): the non-smooth
    convection switch sets a Newton floor, so NK stalls, warns and
    returns its best iterate, whose residual under JAX's tendency is
    below 0.15 of the start's; strict=True raises instead."""
    import scipy.optimize

    jcfg, tcfg, jc, tc, x0 = pg_setup
    with pytest.warns(RuntimeWarning, match="best iterate"):
        sol = tapi.pg_steady_state(tcfg, tc, x0, f_tol=1e-8, maxiter=40)
    assert jax_residual(jcfg, jc, sol) < 0.15 * jax_residual(jcfg, jc, x0)
    b, _, _ = tapi.pg_unpack(tcfg, sol)
    assert np.isfinite(b).all()
    with pytest.raises(scipy.optimize.NoConvergence):
        tapi.pg_steady_state(tcfg, tc, x0, f_tol=1e-8, maxiter=3,
                             strict=True)


def test_pg_continuation_and_arclength_meet_f_tol_under_jax(pg_setup):
    """pg_continuation over two forcing magnitudes and pg_arclength's two
    steps (JAX's test's call: f_tol 1.5 x the Newton floor), each point
    held by JAX's tendency at its lam to the f_tol asked; lam moves."""
    jcfg, tcfg, jc, tc, x0 = pg_setup
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        xs = tapi.pg_steady_state(tcfg, tc, x0, f_tol=1e-8, maxiter=40)
    f_tol = 1.5 * np.abs(tapi.pg_tendency(tcfg, tc, xs)).max()
    nat = tapi.pg_continuation(tcfg, tc, [1.0, 1.02], vec0=xs, f_tol=f_tol,
                               maxiter=40, strict=True)
    branch = tapi.pg_arclength(tcfg, tc, 1.0, 0.05, 2, vec0=xs, f_tol=f_tol,
                               maxiter=40)
    assert [m for m, _ in nat] == [1.0, 1.02] and len(branch) == 4
    for lam, x in nat + branch:
        assert np.isfinite(x).all()
        assert jax_residual(jcfg, jc, x, lam) <= f_tol
    assert abs(branch[-1][0] - branch[0][0]) > 0.01


def test_arclength_traverses_analytic_fold_as_jax():
    """Keller pseudo-arclength rounds the fold of F(x, lam) = x^2 + lam at
    lam = 0, from the x > 0 branch to the x < 0 one, on the same points
    as JAX's function."""
    def F(x, lam):
        return np.array([x[0] ** 2 + lam])

    args = (F, np.array([1.0]), -1.0, 0.25, 12)
    got = tapi.arclength_continuation(*args, f_tol=1e-12)
    want = japi.arclength_continuation(*args, f_tol=1e-12)
    lams = np.array([lam for lam, _ in got])
    xs = np.array([x[0] for _, x in got])
    np.testing.assert_allclose(xs ** 2 + lams, 0.0, atol=1e-8)
    assert xs[0] > 0.5 and xs[-1] < -0.5
    assert lams.max() > -0.05 and lams[-1] < lams.max() - 0.1
    assert len(got) == len(want) == 14
    np.testing.assert_allclose(lams, [lam for lam, _ in want], rtol=0,
                               atol=1e-12)
    np.testing.assert_allclose(xs, [x[0] for _, x in want], rtol=0,
                               atol=1e-12)
