"""The port's periodic qg-node grid (bc_fac = -1, qg-node/qg.c:117-121)
against the JAX package in float64 on the CPU: build_constants_periodic,
comp_q, invert_q (the cell-grid periodic multigrid, the same V-cycles),
_rhs_pv_periodic with every term (psi_pg, topography, 3-D forcing, nu4),
adjust_dt, diag_1d and 20 steps of make_step, at nl = 1 (with and without
the Helmholtz shift gp_low) and nl = 3; to_vertex_full, the nullspace
projection of init_state, and convert's periodic state.

Tolerances: 1e-10 of each field's maximum (the inversion's tolerance is
1e-10, and both sides run the same multigrid cycles), dt and the
diagnostics to 1e-10 relative, the constants bit for bit."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from msom_tpu.io.checkpoint import save_state
from msom_tpu.models import qg_node as jqn
from msom_tpu_torch import convert
from msom_tpu_torch.models import qg_node as tqn

torch.set_num_threads(1)

LIMIT = 1e-10
CASES = {
    "nl1": dict(nl=1, dh=(1.0,), N2=(1.0,)),
    "nl1_gp_low": dict(nl=1, dh=(1.0,), N2=(1.0,), gp_low=4.0),
    "nl3": dict(),
}


def _kw(**kw):
    base = dict(N=32, nl=3, L0=100.0, f0=10.0, beta=0.5, hEkb=1e-3,
                tau0=1e-3, tau1=5e-4, tf1=2.0, tf2=3.0, dy_ws=0.3, nu=5.0,
                nu4=2.0, dh=(0.2, 0.3, 0.5), N2=(1.0, 2.0), noise_init=1e-3,
                bc_fac=-1.0, DT=5e-2, tend=10.0, dtout=10.0, CFL=0.2,
                TOLERANCE=1e-10, dtype="float64", use_pallas=False)
    base.update(kw)
    return base


def _inputs(cfg, seed=3):
    """psi_pg, topo and a 3-D forcing on the N owned nodes (topo and the
    forcing on the (N+1)^2 vertex view, whose wrapped copy is dropped)."""
    N, nl = cfg.N, cfg.nl
    rng = np.random.default_rng(seed)
    y = np.arange(N + 1) * cfg.delta
    return dict(
        psi_pg=1e-3 * rng.uniform(-1, 1, (nl, N, N)),
        topo=0.05 * np.outer(np.sin(2 * np.pi * y / cfg.L0),
                             np.cos(2 * np.pi * y / cfg.L0)),
        q_forcing_3d=1e-5 * rng.standard_normal((nl, N + 1, N + 1)))


def _psi(cfg, seed=5):
    rng = np.random.default_rng(seed)
    return 1e-3 * rng.uniform(-1, 1, (cfg.nl, cfg.N, cfg.N))


def _rel(got, want):
    want = np.asarray(want)
    scale = np.abs(want).max()
    err = np.abs(got.numpy() - want).max()
    return err / scale if scale else err


def _both(kw, inputs=None):
    inputs = inputs or {}
    jcfg, tcfg = jqn.NodeQGConfig(**kw), tqn.NodeQGConfig(**kw)
    return (jcfg, jqn.build_constants(jcfg, **inputs), tcfg,
            tqn.build_constants(tcfg, device="cpu", **inputs))


@pytest.mark.parametrize("case", list(CASES))
def test_periodic_constants_match_jax(case):
    kw = _kw(**CASES[case])
    jcfg, jc, tcfg, tc = _both(kw, _inputs(tqn.NodeQGConfig(**kw)))
    assert tc.mask is None and jc.mask is None and tc.nspec is None
    for name in ("psi_pg", "topo", "q_forcing_3d") + (
            ("S2",) if tcfg.nl > 1 else ()):
        np.testing.assert_array_equal(getattr(tc, name).numpy(),
                                      np.asarray(getattr(jc, name)))
    np.testing.assert_array_equal(tc.yv[:, 0].numpy(),
                                  np.asarray(jc.yv)[:, 0])
    assert (tc.idh0, tc.idh1) == (jc.idh0, jc.idh1)
    assert len(tc.vlevels) == len(jc.vlevels) == 5     # n = 32 .. 2


@pytest.mark.parametrize("case", list(CASES))
def test_periodic_operators_match_jax(case):
    kw = _kw(**CASES[case])
    tcfg = tqn.NodeQGConfig(**kw)
    jcfg, jc, tcfg, tc = _both(kw, _inputs(tcfg))
    psi = _psi(tcfg)
    jpsi, tpsi = jnp.asarray(psi), torch.as_tensor(psi)
    jq, tq = jqn.comp_q(jcfg, jc, jpsi), tqn.comp_q(tcfg, tc, tpsi)
    assert _rel(tq, jq) < 1e-14
    # the inversion from a zero guess: the same V-cycles and psi
    jp, jst = jqn.invert_q(jcfg, jc, jnp.zeros_like(jpsi), jq)
    tp, tst = tqn.invert_q(tcfg, tc, torch.zeros_like(tpsi), tq)
    assert tst.iters == int(jst.iters) and 1 <= tst.iters < 40
    assert _rel(tp, jp) < LIMIT
    # the solve's contract: comp_q(psi) is q less its nullspace component
    # within the tolerance (max norm)
    res = tqn.comp_q(tcfg, tc, tp) - tqn._project_nullspace(tcfg, tq)
    assert float(res.abs().max()) <= tcfg.TOLERANCE
    t = 0.37
    jdq = jqn.rhs_pv(jcfg, jc, jq, jpsi, jnp.asarray(t))
    tdq = tqn.rhs_pv(tcfg, tc, tq, tpsi, torch.tensor(t, dtype=torch.float64))
    assert _rel(tdq, jdq) < 1e-13
    jdt, _ = jqn.adjust_dt(jcfg, jpsi, 0.01, jnp.asarray(0.0))
    tdt, _ = tqn.adjust_dt(tcfg, tpsi, 0.01,
                           torch.tensor(0.0, dtype=torch.float64))
    assert float(tdt) == pytest.approx(float(jdt), rel=1e-14)
    jd = jqn.diag_1d(jcfg, jc, jpsi, jq, t)
    td = tqn.diag_1d(tcfg, tc, tpsi, tq,
                     torch.tensor(t, dtype=torch.float64))
    for got, want in zip(td, jd):
        assert float(got) == pytest.approx(float(want), rel=1e-12)


@pytest.mark.parametrize("case", list(CASES))
def test_periodic_steps_match_jax(case):
    """20 steps of make_step in lockstep from one numpy IC."""
    kw = _kw(**CASES[case])
    tcfg = tqn.NodeQGConfig(**kw)
    jcfg, jc, tcfg, tc = _both(kw, _inputs(tcfg))
    psi0 = _psi(tcfg, 11)
    js = jqn.init_state(jcfg, jc, psi0=psi0)
    ts = tqn.init_state(tcfg, tc, psi0=psi0)
    assert _rel(ts.psi, js.psi) < 1e-15 and _rel(ts.q, js.q) < 1e-14
    jstep = jax.jit(jqn.make_step(jcfg))
    tstep = tqn.make_step(tcfg)
    tnext = jnp.asarray(1e18, jnp.float64)
    for i in range(1, 21):
        js, jd = jstep(js, jc, tnext)
        ts, td = tstep(ts, tc, 1e18)
        for name in ("q", "psi"):
            r = _rel(getattr(ts, name), getattr(js, name))
            assert r < LIMIT, f"step {i}: rel {name} = {r:.3e}"
        assert td.mg_iters == int(jd.mg_iters), f"step {i}: V-cycles"
        assert float(td.dt) == pytest.approx(float(jd.dt), rel=LIMIT)
        for name in ("ke", "d_ke", "f_ke"):
            assert float(getattr(td, name)) == pytest.approx(
                float(getattr(jd, name)), rel=LIMIT), f"step {i}: {name}"
    assert ts.q.shape == (tcfg.nl, 32, 32)


def test_init_state_removes_the_nullspace_and_wraps():
    tcfg = tqn.NodeQGConfig(**_kw())
    tc = tqn.build_constants(tcfg, device="cpu")
    st = tqn.init_state(tcfg, tc, seed=2)
    assert st.psi.shape == (3, 32, 32) and st.q.shape == (3, 32, 32)
    w = torch.tensor(tcfg.dh, dtype=torch.float64)
    assert abs(float(torch.einsum("l,lyx->", w, st.psi))) < 1e-15
    full = tqn.to_vertex_full(tcfg, st.psi)
    assert full.shape == (3, 33, 33)
    assert torch.equal(full[:, -1, :-1], st.psi[:, 0])
    assert torch.equal(full[:, :-1, -1], st.psi[:, :, 0])
    assert torch.equal(full[:, -1, -1], st.psi[:, 0, 0])
    walled = dataclasses.replace(tcfg, bc_fac=1.0)
    assert tqn.to_vertex_full(walled, full) is full
    # with the Helmholtz shift there is no nullspace to remove
    shifted = tqn.NodeQGConfig(**_kw(**CASES["nl1_gp_low"]))
    f = torch.ones((1, 4, 4), dtype=torch.float64)
    assert tqn._project_nullspace(shifted, f) is f


def test_periodic_refusals():
    tcfg = tqn.NodeQGConfig(**_kw())
    with pytest.raises(ValueError, match="mask"):
        tqn.build_constants(tcfg, mask=tqn.coastline_mask(32), device="cpu")
    tqn.build_constants(tcfg, mask=np.ones((33, 33)), device="cpu")
    with pytest.raises(ValueError, match="nl == 1"):
        tqn.build_constants(tqn.NodeQGConfig(**_kw(gp_low=4.0)),
                            device="cpu")
    with pytest.raises(ValueError, match="psi_pg"):
        tqn.build_constants(tcfg, psi_pg=np.zeros((3, 33, 33)),
                            device="cpu")


def test_periodic_jax_state_resumes_in_the_port(tmp_path):
    """A periodic JAX state (nl, N, N) saved by save_state goes through
    convert into the port and on by both steps; convert refuses the
    vertex shape for a periodic config."""
    kw = _kw(dtflt=1.0)
    jcfg, jc, tcfg, tc = _both(kw)
    js = jqn.init_state(jcfg, jc, psi0=_psi(tcfg, 4))
    jstep = jax.jit(jqn.make_step(jcfg))
    tnext = jnp.asarray(1e18, jnp.float64)
    for _ in range(3):
        js, _ = jstep(js, jc, tnext)
    path = str(tmp_path / "periodic.npz")
    save_state(path, js)
    leaves = dict(np.load(path))
    ts = convert.node_state_from_numpy(tcfg, leaves, device="cpu")
    assert ts.psi.shape == (3, 32, 32) and ts.psi_f.shape == (3, 32, 32)
    tstep = tqn.make_step(tcfg)
    for _ in range(3):
        js, _ = jstep(js, jc, tnext)
        ts, _ = tstep(ts, tc, 1e18)
    assert _rel(ts.q, js.q) < LIMIT and _rel(ts.psi, js.psi) < LIMIT
    bad = {**leaves, "q": np.zeros((3, 33, 33))}
    with pytest.raises(ValueError, match="shape"):
        convert.node_state_from_numpy(tcfg, bad, device="cpu")
