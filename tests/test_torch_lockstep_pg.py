"""Transcription-independent lockstep of the port's mspg step against
tests/oracle_pg.PGOracle (an explicit-loop NumPy re-transcription of the
reference's pg.h), as tests/test_lockstep_pg.py runs the JAX step: from
rest, f64 on the CPU, relb < 1e-12 and relu < 1e-11 of max every step, dt
to 1e-12. The oracle takes the barotropic velocities from the port's
constants (its docstring: the one-time bt solve is set-up, held against
the JAX solve in tests/test_torch_mspg.py)."""

import numpy as np
import torch

from msom_tpu_torch.models import mspg
from msom_tpu_torch.params import PGConfig
from tests.oracle_pg import PGOracle

torch.set_num_threads(1)


def pg_cfg(**kw):
    base = dict(N=32, nl=8, ys=0.3, r=0.02, tau_s=3e-2, tau0=0.12, kv=1e-4,
                kh=1e-4, omega=0.2, DT=1e-2, CFL=0.4, tend=10.0, dtout=10.0,
                dtype="float64")
    base.update(kw)
    return PGConfig(**base)


def lockstep(cfg, const, steps, check_u=True):
    state = mspg.init_state(cfg, const)
    step = mspg.make_step(cfg)
    orc = PGOracle(cfg, const)
    b = np.zeros((cfg.nl, cfg.N, cfg.N))
    ux = np.zeros((cfg.nl, cfg.N, cfg.N + 1))
    uy = np.zeros((cfg.nl, cfg.N + 1, cfg.N))
    prev, t = 0.0, 0.0
    for i in range(1, steps + 1):
        b, ux, uy, prev, dt_o = orc.step(b, ux, uy, prev, t)
        t += dt_o
        state, diag = step(state, const, 1e18)
        relb = np.abs(state.b.numpy() - b).max() / max(np.abs(b).max(),
                                                        1e-30)
        assert relb < 1e-12, f"step {i}: relb={relb:.3e}"
        if check_u:
            uscale = max(np.abs(ux).max(), np.abs(uy).max(), 1e-30)
            relu = max(np.abs(state.ux.numpy() - ux).max(),
                       np.abs(state.uy.numpy() - uy).max()) / uscale
            assert relu < 1e-11, f"step {i}: relu={relu:.3e}"
            np.testing.assert_allclose(float(diag.dt), dt_o, rtol=1e-12)
    return t, b


def test_lockstep_pg_120_steps():
    """120 steps of the gyre spin-up from rest: advection with the
    diagnostic w, horizontal and implicit vertical diffusion, convection,
    surface relaxation, momentum and the barotropic adjustment."""
    cfg = pg_cfg()
    t, b = lockstep(cfg, mspg.build_constants(cfg, device="cpu"), 120)
    assert t > 0 and np.abs(b).max() > 0


def test_lockstep_pg_with_qg_forcing():
    """40 steps with a QG eddy buoyancy forcing (qg_forcing,
    pg.h:598-606)."""
    cfg = pg_cfg(nl=4)
    bf = 1e-3 * np.random.default_rng(8).standard_normal((4, 32, 32))
    lockstep(cfg, mspg.build_constants(cfg, device="cpu", b_forc=bf), 40,
             check_u=False)
