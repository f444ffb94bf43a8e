"""The port's msqg step with the multigrid inversion (solver="mg") in
lockstep with the JAX package's jitted step on the Verron double gyre at
64^2 x 3 in float64 from one numpy IC: with the warm-start extrapolation on
and off and with the modal inversion (mode_pv_invert); the constants the mg
branch builds; and a JAX mg state carried into the port with its psi_old
leaf.

The two sides run the same cycles on the same data, so they must take the
same number of V-cycles every step (StepDiag.mg_iters) and agree like the
spectral lockstep: q and psi at 1e-10 relative (a solve stops at
tol = 1e-3, but both stop at the same cycle, so only roundoff separates
them), dt at 1e-12, the final residual norm at 1e-9 relative above
RES_FLOOR (the first step starts from the exact psi, and its residual is
roundoff alone)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from msom_tpu.io.checkpoint import save_state
from msom_tpu.models import qg as jqg
from msom_tpu.params import QGConfig as JConfig
from msom_tpu_torch import convert
from msom_tpu_torch.models import qg as tqg
from msom_tpu_torch.params import QGConfig as TConfig
from msom_tpu_torch.solvers import fused_mg

torch.set_num_threads(1)

RES_FLOOR = 1e-13


def verron(N, **kw):
    """tests/test_lockstep.py's deck with the multigrid, for both
    packages."""
    base = dict(N=N, nl=3, L0=80, Rom=0.025, Ekb=0.002, tau0=1e-4, Re4=1563,
                beta=0.5, Fr=(0.0023669, 0.0076173), dh=(0.06, 0.14, 0.8),
                DT=5e-2, tend=500., dtout=1., CFL=0.6, dtype="float64",
                solver="mg")
    base.update(kw)
    return JConfig(**base).validate(), TConfig(**base).validate()


def _psi0(cfg, seed=42):
    rng = np.random.default_rng(seed)
    psi0 = 1e-3 * rng.uniform(-1, 1, (cfg.nl, cfg.N, cfg.N))
    return psi0 - psi0.mean(axis=(-2, -1), keepdims=True)


def _assert_same(i, jstate, jdiag, tstate, tdiag):
    for name in ("q", "psi"):
        want = np.asarray(getattr(jstate, name))
        rel = np.abs(getattr(tstate, name).numpy() - want).max() \
            / np.abs(want).max()
        assert rel < 1e-10, f"step {i}: rel {name} = {rel:.3e}"
    dt = float(jdiag.dt)
    assert abs(float(tdiag.dt) - dt) <= 1e-12 * dt, f"step {i}: dt"
    assert tdiag.mg_iters == int(jdiag.mg_iters), f"step {i}: mg_iters"
    assert abs(tdiag.mg_res - float(jdiag.mg_res)) \
        <= 1e-9 * float(jdiag.mg_res) + RES_FLOOR, f"step {i}: mg_res"
    assert int(tstate.i) == int(jstate.i) == i
    assert (tstate.psi_old is None) == (jstate.psi_old is None)
    if tstate.psi_old is not None:
        want = np.asarray(jstate.psi_old)
        assert np.abs(tstate.psi_old.numpy() - want).max() \
            < 1e-10 * np.abs(want).max()


def _lockstep(jcfg, tcfg, steps, jstate=None, tstate=None, first=1):
    jconst = jqg.build_constants(jcfg)
    tconst = tqg.build_constants(tcfg, device="cpu")
    if jstate is None:
        psi0 = _psi0(jcfg)
        jstate = jqg.init_state(jcfg, jconst, psi0=psi0)
        tstate = tqg.init_state(tcfg, tconst, psi0=psi0)
    jstep = jax.jit(jqg.make_step(jcfg))
    tstep = tqg.make_step(tcfg)
    tnext = jnp.asarray(1e9, jstate.t.dtype)
    iters = []
    for i in range(first, first + steps):
        jstate, jdiag = jstep(jstate, jconst, tnext)
        tstate, tdiag = tstep(tstate, tconst, 1e9)
        _assert_same(i, jstate, jdiag, tstate, tdiag)
        iters.append(tdiag.mg_iters)
    return jstate, tstate, iters


@pytest.mark.parametrize("case", ["extrap", "no_extrap", "modal",
                                  "modal_no_extrap", "tight", "modal_tight"])
def test_mg_lockstep_with_jax_step(case):
    """30 steps; every step both sides take the same V-cycles. At the
    model's tol = 1e-3 this young flow needs one cycle a solve; the "tight"
    cases (tol = 1e-8, 15 steps) take several and adapt nrelax."""
    tight = case.endswith("tight")
    jcfg, tcfg = verron(64, mg_extrap="no_extrap" not in case,
                        mode_pv_invert=case.startswith("modal"),
                        tol=1e-8 if tight else 1e-3)
    before = fused_mg.sweep_launches, fused_mg.residual_launches
    _, tstate, iters = _lockstep(jcfg, tcfg, 15 if tight else 30)
    assert (fused_mg.sweep_launches, fused_mg.residual_launches) == before
    assert all(1 <= n < 100 for n in iters), iters
    assert (max(iters) > 1) == tight, iters
    assert (tstate.psi_old is not None) == tcfg.mg_extrap
    assert torch.isfinite(tstate.q).all()


@pytest.mark.parametrize("modal", [False, True])
def test_mg_constants_match_jax(modal):
    jcfg, tcfg = verron(32, mode_pv_invert=modal)
    jc = jqg.build_constants(jcfg)
    tc = tqg.build_constants(tcfg, device="cpu")
    assert tc.spec is None and jc.spec is None
    jlev, tlev = (jc.mlevels, tc.mlevels) if modal else (jc.levels, tc.levels)
    assert (tc.levels is None) == modal and (tc.mlevels is not None) == modal
    assert len(tlev) == len(jlev) == 5
    for jl, tl in zip(jlev, tlev):
        assert tl.sw is not None and tl.rp is not None
        for name in ("t0", "cp", "im"):
            jf = np.asarray(getattr(jl, name))
            np.testing.assert_allclose(
                getattr(tl, name).expand(*jf.shape).numpy(), jf, rtol=0,
                atol=1e-13)
    if modal:
        N = jcfg.N
        np.testing.assert_allclose(tc.iBu.expand(3, N, N).numpy(),
                                   np.asarray(jc.iBu), rtol=1e-12)
        np.testing.assert_allclose(tc.l2m.numpy(), np.asarray(jc.l2m),
                                   rtol=0, atol=1e-12)
        np.testing.assert_allclose(tc.m2l.numpy(), np.asarray(jc.m2l),
                                   rtol=0, atol=1e-12)


@pytest.mark.parametrize("modal", [False, True])
def test_invert_q_matches_jax_from_the_same_guess(modal):
    jcfg, tcfg = verron(32, mode_pv_invert=modal)
    jc = jqg.build_constants(jcfg)
    tc = tqg.build_constants(tcfg, device="cpu")
    psi = _psi0(jcfg, 5)
    q = np.asarray(jqg.comp_q(jcfg, jc, jnp.asarray(psi)))
    guess = np.zeros_like(psi)
    p_j, st_j = jqg.invert_q(jcfg, jc, jnp.asarray(guess), jnp.asarray(q))
    p_t, st_t = tqg.invert_q(tcfg, tc, torch.tensor(guess), torch.tensor(q))
    assert (st_t.iters, st_t.nrelax) == (int(st_j.iters), int(st_j.nrelax))
    assert st_t.resa <= tcfg.tol < st_t.resb
    np.testing.assert_allclose(st_t.resb, float(st_j.resb), rtol=1e-10)
    np.testing.assert_allclose(p_t.numpy(), np.asarray(p_j), rtol=0,
                               atol=1e-11 * np.abs(psi).max())


def test_mode_pv_invert_with_one_layer_takes_the_layered_solve():
    """No modes to project on (msom_tpu qg.py builds none for nl = 1)."""
    _, tcfg = verron(16, nl=1, Fr=(), dh=(1.0,), mode_pv_invert=True)
    tc = tqg.build_constants(tcfg, device="cpu")
    assert tc.mlevels is None and tc.levels is not None
    state = tqg.init_state(tcfg, tc, psi0=_psi0(tcfg))
    state, diag = tqg.make_step(tcfg)(state, tc, 1e9)
    assert diag.mg_iters >= 1 and torch.isfinite(state.psi).all()


def test_spectral_solver_reports_no_cycles_and_ignores_the_modal_switch():
    _, tcfg = verron(16, solver="spectral", mode_pv_invert=True)
    tc = tqg.build_constants(tcfg, device="cpu")
    assert tc.spec is not None and tc.levels is None and tc.mlevels is None
    state = tqg.init_state(tcfg, tc, psi0=_psi0(tcfg))
    assert state.psi_old is None
    _, st = tqg.invert_q(tcfg, tc, None, state.q)
    assert st == (0, 0.0, 0.0, 0)
    state, diag = tqg.make_step(tcfg)(state, tc, 1e9)
    assert (diag.mg_iters, diag.mg_res) == (0, 0.0)
    with pytest.raises(ValueError, match="fused_mm"):
        tqg.build_constants(verron(16)[1], device="cpu", fused_mm=True)


def test_jax_mg_checkpoint_resumes_in_the_port(tmp_path):
    """A 10-step JAX mg state with its psi_old leaf, written by save_state,
    continues in the port for 5 steps in lockstep; state_to_numpy gives the
    leaves back bit for bit."""
    jcfg, tcfg = verron(32)
    jconst = jqg.build_constants(jcfg)
    jstate = jqg.init_state(jcfg, jconst, psi0=_psi0(jcfg, 3))
    jstep = jax.jit(jqg.make_step(jcfg))
    tnext = jnp.asarray(1e9, jstate.t.dtype)
    for _ in range(10):
        jstate, _ = jstep(jstate, jconst, tnext)
    path = str(tmp_path / "state.npz")
    save_state(path, jstate)
    leaves = dict(np.load(path))
    assert "psi_old" in leaves
    tstate = convert.state_from_numpy(tcfg, leaves, device="cpu")
    back = convert.state_to_numpy(tstate)
    for name in ("q", "psi", "psi_old", "t", "dt_prev", "i"):
        np.testing.assert_array_equal(back[name], leaves[name])
        assert back[name].dtype == leaves[name].dtype, name
    _lockstep(jcfg, tcfg, 5, jstate, tstate, first=11)


def test_psi_old_leaf_must_agree_with_the_config():
    _, mgcfg = verron(16)
    _, plain = verron(16, mg_extrap=False)
    _, spectral = verron(16, solver="spectral")
    z = np.zeros((3, 16, 16))
    leaves = {"q": z, "psi": z, "t": np.float64(0), "dt_prev": np.float64(0),
              "i": np.int32(0)}
    for cfg in (plain, spectral):
        state = convert.state_from_numpy(cfg, leaves, device="cpu")
        assert state.psi_old is None
        assert "psi_old" not in convert.state_to_numpy(state)
        with pytest.raises(ValueError, match="psi_old"):
            convert.state_from_numpy(cfg, {**leaves, "psi_old": z},
                                     device="cpu")
    with pytest.raises(ValueError, match="psi_old"):
        convert.state_from_numpy(mgcfg, leaves, device="cpu")
    with pytest.raises(ValueError, match="shape"):
        convert.state_from_numpy(mgcfg, {**leaves, "psi_old": z[:2]},
                                 device="cpu")
