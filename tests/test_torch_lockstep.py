"""The port's msqg step against the independent NumPy/scipy oracle
(tests/oracle_full_step.py: explicitly padded stencils and an exact sparse
LU inversion), as tests/test_lockstep.py holds the JAX step: the Verron
double gyre in float64 on the CPU from one numpy noise IC, at 64^2 and
128^2, with partial-slip walls, and the multigrid's drift from the exact
trajectory.

Tolerances are test_lockstep.py's: q and psi to 1e-11 of their maxima
every step, dt to 1e-12 and the KE to 1e-10 relative; the mg path (tol
1e-3) within 3e-2 of the exact psi over 60 steps."""

import numpy as np
import pytest
import torch

from msom_tpu_torch.models import qg as tqg
from msom_tpu_torch.params import QGConfig
from tests.oracle_full_step import Oracle

torch.set_num_threads(1)


def verron(N, solver="spectral", **kw):
    base = dict(N=N, nl=3, L0=80, Rom=0.025, Ekb=0.002, tau0=1e-4, Re4=1563,
                beta=0.5, Fr=(0.0023669, 0.0076173), dh=(0.06, 0.14, 0.8),
                DT=5e-2, tend=500., dtout=1., CFL=0.6, dtype="float64",
                solver=solver)
    base.update(kw)
    return QGConfig(**base).validate()


def run_lockstep(cfg, steps, seed):
    """Yields (i, oracle (q, psi, dt, ke), port state, port diag), both
    stepped from identical noise ICs."""
    rng = np.random.default_rng(seed)
    psi0 = 1e-3 * rng.uniform(-1, 1, (cfg.nl, cfg.N, cfg.N))
    psi0 -= psi0.mean(axis=(-2, -1), keepdims=True)
    const = tqg.build_constants(cfg, device="cpu")
    state = tqg.init_state(cfg, const, psi0=psi0)
    step = tqg.make_step(cfg)
    orc = Oracle(cfg)
    q, psi, prev, t = orc.comp_q(psi0.copy()), psi0.copy(), 0.0, 0.0
    np.testing.assert_allclose(state.q.numpy(), q, rtol=0,
                               atol=1e-13 * np.abs(q).max())
    for i in range(1, steps + 1):
        q, psi, prev, dt_o, ke_o = orc.step(q, psi, prev, t, 1e9)
        t += dt_o
        state, diag = step(state, const, 1e9)
        yield i, (q, psi, dt_o, ke_o), state, diag


def _rel(got, want):
    return np.abs(got.numpy() - want).max() / np.abs(want).max()


@pytest.mark.parametrize("N,steps,sbc,seed", [
    (64, 120, 0.0, 42),
    (128, 30, 0.0, 42),
    (64, 40, 1.0, 7),      # partial slip: zeta_ghost = c (psi_in - psi_ghost)
], ids=["verron_64", "verron_128", "partial_slip"])
def test_port_step_matches_oracle(N, steps, sbc, seed):
    for i, (q, psi, dt_o, ke_o), state, diag in run_lockstep(
            verron(N, sbc=sbc), steps, seed):
        assert _rel(state.q, q) < 1e-11, f"step {i}: q"
        assert _rel(state.psi, psi) < 1e-11, f"step {i}: psi"
        assert abs(float(diag.dt) - dt_o) <= 1e-12 * dt_o, f"step {i}: dt"
        assert abs(float(diag.ke) - ke_o) <= 1e-10 * abs(ke_o), \
            f"step {i}: ke"


def test_port_mg_path_tracks_exact_within_tolerance():
    worst = 0.0
    for i, (q, psi, dt_o, ke_o), state, diag in run_lockstep(
            verron(64, solver="mg"), 60, 42):
        worst = max(worst, _rel(state.psi, psi))
    assert worst < 3e-2, f"mg drift {worst:.3e}"
