"""The port's qg-node step against the independent NumPy/scipy oracle
(tests/oracle_node.py: explicit slice stencils and an exact sparse LU of the
interior nodal system), as tests/test_lockstep_node.py holds the JAX step:
the 3-layer walled configuration with the nodal spectral inversion, the
coupled no-slip one (psi_pg, topography, 3-D forcing, bc_fac = 1, nu4) and
the barotropic module with its Helmholtz shift, in float64 on the CPU from
one numpy noise IC.

Tolerances are test_lockstep_node.py's: q within 1e-8 of its maximum every
step (psi at the end of the baroclinic run too), the model time to 1e-12
relative; the initial q = comp_q(psi0) to 1e-13 of its maximum."""

import numpy as np
import torch

from msom_tpu_torch.models import qg_node as tqn
from tests.oracle_node import NodeOracle

torch.set_num_threads(1)


def node_cfg(**kw):
    base = dict(N=64, nl=3, L0=100.0, f0=46.5, beta=0.5, hEkb=1e-3,
                tau0=1e-3, tau1=5e-4, tf1=2.0, tf2=3.0, dy_ws=0.3, nu=5.0,
                dh=(0.2, 0.3, 0.5), N2=(1.0, 2.0), noise_init=1e-3,
                bc_fac=0.0, DT=5e-2, tend=10.0, dtout=10.0, CFL=0.2,
                TOLERANCE=1e-8, solver="spectral", dtype="float64")
    base.update(kw)
    return tqn.NodeQGConfig(**base)


def run_lockstep(cfg, steps, seed, inputs=None):
    """Yields (i, oracle (q, psi, dt, t), port state) from one numpy noise
    IC of init_state's form, both stepped with the same tnext."""
    inputs = inputs or {}
    M = cfg.N + 1
    rng = np.random.default_rng(seed)
    y = np.arange(M)[:, None] * cfg.delta
    psi0 = cfg.noise_init * (rng.uniform(-1, 1, (cfg.nl, M, M))
                             + np.sin(2 * np.pi * y / cfg.L0))
    const = tqn.build_constants(cfg, device="cpu", **inputs)
    state = tqn.init_state(cfg, const, psi0=psi0)
    orc = NodeOracle(cfg, **inputs)
    psi = state.psi.numpy().copy()
    q = orc.comp_q(psi.copy())
    np.testing.assert_allclose(state.q.numpy(), q, rtol=0,
                               atol=1e-13 * np.abs(q).max())
    step = tqn.make_step(cfg)
    prev, t = 0.0, 0.0
    for i in range(1, steps + 1):
        q, psi, prev, dt_o = orc.step(q, psi, prev, t)
        t += dt_o
        state, _ = step(state, const, 1e18)
        yield i, (q, psi, dt_o, t), state


def _rel(got, want):
    return np.abs(got.numpy() - want).max() / np.abs(want).max()


def test_port_node_baroclinic_matches_oracle():
    """100 steps of the 3-layer free-slip configuration."""
    for i, (q, psi, dt_o, t), state in run_lockstep(node_cfg(), 100, 11):
        assert _rel(state.q, q) < 1e-8, f"step {i}: q"
        np.testing.assert_allclose(float(state.t), t, rtol=1e-12)
    assert _rel(state.psi, psi) < 1e-8


def test_port_node_coupled_noslip_matches_oracle():
    """40 steps with psi_pg, topography, 3-D forcing, no-slip walls and
    the biharmonic nu4: every rhs_pv_baroclinic term (K5's plain version
    with every option) against the oracle."""
    N = 64
    rng = np.random.default_rng(2)
    yv = np.arange(N + 1)[:, None] * (100.0 / N) * np.ones((N + 1, N + 1))
    inputs = dict(
        psi_pg=1e-3 * np.sin(np.pi * yv / 100.0)[None]
        * np.ones((3, N + 1, N + 1)),
        topo=0.02 * np.sin(2 * np.pi * yv / 100.0)
        * np.sin(np.pi * yv.T / 100.0),
        q_forcing_3d=1e-5 * rng.standard_normal((3, N + 1, N + 1)))
    for i, (q, psi, dt_o, t), state in run_lockstep(
            node_cfg(bc_fac=1.0, nu4=50.0), 40, 5, inputs):
        assert _rel(state.q, q) < 1e-8, f"step {i}: q"


def test_port_node_barotropic_matches_oracle():
    """60 steps of the nl = 1 module with the iRd2_low Helmholtz shift."""
    cfg = node_cfg(nl=1, dh=(1.0,), N2=(1.0,), gp_low=4.0)
    for i, (q, psi, dt_o, t), state in run_lockstep(cfg, 60, 3):
        assert _rel(state.q, q) < 1e-8, f"step {i}: q"
