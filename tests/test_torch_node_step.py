"""The port's qg-node step (msom_tpu_torch.models.qg_node) in lockstep with
the JAX package's jitted step on the CPU in float64 from one numpy IC: the
3-layer walled configuration with the nodal spectral inversion (30 steps),
with the coastline-masked vertex multigrid (solver="vmg", 10 steps, the same
V-cycles every step) and the barotropic module with its Helmholtz shift;
a JAX state carried into the port through `convert`; the configuration
parser; and that the periodic, stochastic and filter configurations run.

Tolerances: q at 1e-11 relative and dt at 1e-12 every step, as the msqg
lockstep holds them: the two sides compute the same formulas and only
roundoff separates them (the spectral solve runs the DST-I basis matmul in
both packages at these sizes). psi at PSI_LIMIT = 5e-11: with this
deck's strong stratification (S2 = f0^2/N^2 = 2162) the inversion turns a
relative change of 1e-16 in q into 1.7e-11 in psi (measured with a random
1-ulp perturbation of q), so psi cannot agree closer than that however
exactly q agrees (q agrees to 1.5e-15); the forward operator of psi's
difference is held at 1e-12 of max|q|."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from msom_tpu.io.checkpoint import save_state
from msom_tpu.models import qg_node as jqn
from msom_tpu_torch import convert
from msom_tpu_torch.models import fused_node_rhs
from msom_tpu_torch.models import qg_node as tqn
from msom_tpu_torch.solvers import fused_vmg

torch.set_num_threads(1)

PSI_LIMIT = 5e-11


def _kw(**kw):
    """tests/test_lockstep_node.py's deck."""
    base = dict(N=64, nl=3, L0=100.0, f0=46.5, beta=0.5, hEkb=1e-3,
                tau0=1e-3, tau1=5e-4, tf1=2.0, tf2=3.0, dy_ws=0.3, nu=5.0,
                dh=(0.2, 0.3, 0.5), N2=(1.0, 2.0), noise_init=1e-3,
                bc_fac=1.0, DT=5e-2, tend=10.0, dtout=10.0, CFL=0.2,
                TOLERANCE=1e-8, dtype="float64", use_pallas=False)
    base.update(kw)
    return base


def _psi0(cfg, seed=11):
    M = cfg.N + 1
    rng = np.random.default_rng(seed)
    y = np.arange(M)[:, None] * cfg.delta
    return cfg.noise_init * (rng.uniform(-1, 1, (cfg.nl, M, M))
                             + np.sin(2 * np.pi * y / cfg.L0))


def _lockstep(kw, steps, inputs=None, jstate=None, tstate=None):
    """Step both packages `steps` times; yields (i, jstate, jdiag, tstate,
    tdiag, tcfg, tconst)."""
    jcfg, tcfg = jqn.NodeQGConfig(**kw), tqn.NodeQGConfig(**kw)
    inputs = inputs or {}
    jconst = jqn.build_constants(jcfg, **inputs)
    tconst = tqn.build_constants(tcfg, device="cpu", **inputs)
    if jstate is None:
        psi0 = _psi0(jcfg)
        jstate = jqn.init_state(jcfg, jconst, psi0=psi0)
        tstate = tqn.init_state(tcfg, tconst, psi0=psi0)
    jstep = jax.jit(jqn.make_step(jcfg))
    tstep = tqn.make_step(tcfg)
    tnext = jnp.asarray(1e18, jnp.float64)
    for i in range(1, steps + 1):
        jstate, jdiag = jstep(jstate, jconst, tnext)
        tstate, tdiag = tstep(tstate, tconst, 1e18)
        yield i, jstate, jdiag, tstate, tdiag, tcfg, tconst


def _assert_same(i, jstate, jdiag, tstate, tdiag, tcfg, tconst):
    for name, limit in (("q", 1e-11), ("psi", PSI_LIMIT)):
        want = np.asarray(getattr(jstate, name))
        rel = np.abs(getattr(tstate, name).numpy() - want).max() \
            / np.abs(want).max()
        assert rel < limit, f"step {i}: rel {name} = {rel:.3e}"
    dpsi = tstate.psi - torch.tensor(np.asarray(jstate.psi))
    dq = tqn.comp_q(tcfg, tconst, dpsi).abs().max()
    assert dq <= 1e-12 * tstate.q.abs().max(), f"step {i}: L(d psi)"
    dt = float(jdiag.dt)
    assert abs(float(tdiag.dt) - dt) <= 1e-12 * dt, f"step {i}: dt"
    assert abs(float(tstate.t) - float(jstate.t)) <= 1e-12 * float(jstate.t)
    for name in ("ke", "d_ke", "f_ke"):
        want = float(getattr(jdiag, name))
        assert abs(float(getattr(tdiag, name)) - want) \
            <= 1e-10 * abs(want), f"step {i}: {name}"
    assert tdiag.mg_iters == int(jdiag.mg_iters), f"step {i}: mg_iters"
    assert int(tstate.i) == int(jstate.i) == i


def test_spectral_lockstep_with_jax():
    """30 steps of the 3-layer no-slip configuration with the nodal
    spectral inversion (zero cycles reported) through the plain K5."""
    before = fused_node_rhs.launches, fused_vmg.launches
    for i, js, jd, ts, td, tc, tk in _lockstep(_kw(), 30):
        _assert_same(i, js, jd, ts, td, tc, tk)
    assert td.mg_iters == 0
    assert (fused_node_rhs.launches, fused_vmg.launches) == before


def test_masked_vmg_lockstep_with_jax():
    """10 steps with the coastline mask and solver="vmg" (the masked vertex
    multigrid): the same V-cycles every step."""
    inputs = dict(mask=tqn.coastline_mask(64))
    cycles = []
    kw = _kw(solver="vmg")
    for i, js, jd, ts, td, tc, tk in _lockstep(kw, 10, inputs):
        _assert_same(i, js, jd, ts, td, tc, tk)
        cycles.append(td.mg_iters)
    assert min(cycles) >= 1


def test_barotropic_lockstep_with_jax():
    """20 steps of the nl = 1 module with the iRd2_low Helmholtz shift."""
    kw = _kw(nl=1, dh=(1.0,), N2=(1.0,), gp_low=4.0, N=32)
    for i, js, jd, ts, td, tc, tk in _lockstep(kw, 20):
        _assert_same(i, js, jd, ts, td, tc, tk)


def test_jax_state_resumes_in_the_port(tmp_path):
    """A JAX run with a filter configured (dtflt > 0: the psi_f leaf)
    saved with save_state after 3 steps, loaded into the port through
    convert and stepped on by both: the same trajectory; the round trip
    through node_state_to_numpy is exact."""
    kw = _kw(N=32, dtflt=1.0, Lfmax=30.0, Lfmin=10.0)
    jcfg, tcfg = jqn.NodeQGConfig(**kw), tqn.NodeQGConfig(**kw)
    jconst = jqn.build_constants(jcfg)
    jstate = jqn.init_state(jcfg, jqn.build_constants(jcfg), psi0=_psi0(jcfg))
    jstep = jax.jit(jqn.make_step(jcfg))
    for _ in range(3):
        jstate, _ = jstep(jstate, jconst, jnp.asarray(1e18))
    path = tmp_path / "node.npz"
    save_state(str(path), jstate)
    leaves = dict(np.load(path))
    assert {"key", "psi_f", "nbar"} <= set(leaves)
    tstate = convert.node_state_from_numpy(tcfg, leaves, device="cpu")
    back = convert.node_state_to_numpy(tstate)
    assert set(back) == set(leaves) - {"key"}
    for name, a in back.items():
        np.testing.assert_array_equal(a, leaves[name])
    for i, js, jd, ts, td, tc, tk in _lockstep(kw, 5, jstate=jstate,
                                               tstate=tstate):
        _assert_same(i + 3, js, jd, ts, td, tc, tk)
    assert ts.psi_f is not None and int(ts.nbar) == 0


def test_node_state_from_numpy_refuses_what_it_cannot_carry():
    cfg = tqn.NodeQGConfig(**_kw(N=16))
    M = 17
    leaves = dict(q=np.zeros((3, M, M)), psi=np.zeros((3, M, M)), t=0.0,
                  dt_prev=0.0, i=0, nbar=0)
    state = convert.node_state_from_numpy(cfg, leaves, device="cpu")
    assert state.psi_f is None and state.q.dtype == torch.float64
    with pytest.raises(ValueError, match="psi_f"):
        convert.node_state_from_numpy(
            cfg, {**leaves, "psi_f": np.zeros((3, M, M))}, device="cpu")
    with pytest.raises(ValueError, match="shape"):
        convert.node_state_from_numpy(
            cfg, {**leaves, "q": np.zeros((3, 16, 16))}, device="cpu")


def test_load_node_config_matches_jax():
    deck = ("N = 128\nnl = 2\nL0 = 50\nf0 = 1.2 # comment\nbeta = 0.3\n"
            "dh = [0.4, 0.6]\nN2 = 2.5\nbc_fac = 0.5\nnu = 2\n"
            "L_filt = 3.0\n")
    got = tqn.load_node_config(deck, solver="vmg")
    want = jqn.load_node_config(deck, solver="vmg")
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    for name in ("delta", "iRd2_low", "periodic"):
        assert getattr(got, name) == getattr(want, name)
    assert got.dt_clamped() == want.dt_clamped()
    stoch = tqn.load_node_config(deck + "amp_stoch = 0.1\n")
    assert stoch.stochastic and stoch.L_filt_stoch == 3.0


def test_noise_ic_from_a_torch_generator():
    cfg = tqn.NodeQGConfig(**_kw(N=16))
    const = tqn.build_constants(cfg, device="cpu")
    a = tqn.init_state(cfg, const, seed=3)
    b = tqn.init_state(cfg, const, generator=torch.Generator().manual_seed(3))
    assert torch.equal(a.psi, b.psi) and a.psi.shape == (3, 17, 17)
    ring = a.psi.clone()
    ring[:, 1:-1, 1:-1] = 0.0
    assert not ring.any() and a.psi.abs().max() <= 2e-3
    assert a.psi_f is None and int(a.nbar) == 0


@pytest.mark.parametrize("override,match", [
    (dict(bc_fac=-1.0), "item 12b"),
    (dict(stochastic=True, amp_stoch=0.1), "item 12c"),
])
def test_configs_outside_the_slice_raise(override, match):
    """The periodic grid (ROADMAP.md item 12b) and stochastic forcing
    (item 12c), once outside the port, build and step on the CPU:
    tests/test_torch_node_periodic.py and test_torch_node_stochastic.py
    hold them against the JAX package."""
    cfg = tqn.NodeQGConfig(**_kw(N=16, **override))
    const = tqn.build_constants(cfg, device="cpu")
    state = tqn.init_state(cfg, const, seed=0)
    state, diag = tqn.make_step(cfg, torch.Generator().manual_seed(0))(
        state, const, 1e18)
    n = 16 if cfg.periodic else 17
    assert state.q.shape == (3, n, n) and bool(torch.isfinite(state.q).all())
    assert float(diag.dt) > 0 and match in ("item 12b", "item 12c")


def test_filter_and_noise_raise_but_dtflt_builds():
    """A config with dtflt > 0 builds and steps, and its filter event and
    the noise run (ROADMAP.md items 12d and 12c; held against the JAX
    package in tests/test_torch_node_filter.py and
    test_torch_node_stochastic.py)."""
    cfg = tqn.NodeQGConfig(**_kw(N=16, dtflt=1.0))
    const = tqn.build_constants(cfg, device="cpu")
    state = tqn.init_state(cfg, const, seed=0)
    state, _ = tqn.make_step(cfg)(state, const, 1e18)
    filtered = tqn.wavelet_filter(cfg, const, state)
    assert int(filtered.nbar) == 1 and filtered.psi.shape == state.psi.shape
    noise = tqn.generate_noise(cfg, const, torch.Generator(), state.q.shape)
    assert noise.shape == state.q.shape


def test_solver_selection_matches_jax():
    """spectral iff the mask is the default rectangle and S2 is uniform;
    solver="spectral" with a coastline raises as in the JAX package."""
    for kw, inputs, spectral in (
            (_kw(N=16), {}, True),
            (_kw(N=16, flag_ms=1), {}, False),
            (_kw(N=16), dict(mask=tqn.coastline_mask(16)), False),
            (_kw(N=16, solver="vmg"), {}, False)):
        j = jqn.build_constants(jqn.NodeQGConfig(**kw), **inputs)
        t = tqn.build_constants(tqn.NodeQGConfig(**kw), device="cpu",
                                **inputs)
        assert (j.nspec is not None) == (t.nspec is not None) == spectral
        assert (t.vlevels is None) == spectral
    bad = tqn.NodeQGConfig(**_kw(N=16, solver="spectral"))
    with pytest.raises(ValueError, match="vmg"):
        tqn.build_constants(bad, mask=tqn.coastline_mask(16), device="cpu")
