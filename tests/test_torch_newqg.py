"""The port's newqg model (models/newqg.py) against the JAX package's
(msom_tpu.models.newqg), float64 on the CPU at 32^2.

Tolerances: the deck parser and the Helmholtz field exactly; comp_q to
1e-14 of max|q| (the same stencil); 10 steps to 1e-11 of max|q| and
max|psi| (dt to 1e-12 every step), for nl = 1 and nl = 2 with gp_low,
with the multigrid and the spectral solve, walled (free and partial slip)
and periodic; one multigrid solve with the same V-cycles as the JAX
package's (its step does not report them). The periodic cases have no
wind: the pulse has a nonzero mean, which the doubly periodic inversion
cannot carry."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from msom_tpu.models import newqg as jnq
from msom_tpu_torch import convert
from msom_tpu_torch.models import newqg as tnq

torch.set_num_threads(1)

DECK = """
N  = 32
L0 = 100
tau0 = 1e-3
nu = 5
beta = 0.5
dh   = [1.0]
sbc = 0
DT    = 5.e-2
tend  = 200.
dtout = 10
CFL   = 0.2
TOLERANCE = 1e-8
"""

CASES = {
    "nl1 mg walled": dict(),
    "nl1 spectral periodic": dict(solver="spectral", sbc=-1.0, tau0=0.0),
    "nl2 mg periodic": dict(nl=2, gp_low=2.0, dh=(0.5, 0.5), sbc=-1.0,
                            tau0=0.0, hEkb=1e-2, f0=2.0),
    "nl2 spectral slip": dict(nl=2, gp_low=2.0, dh=(0.5, 0.5), sbc=1.0,
                              hEkb=1e-2, f0=2.0, solver="spectral"),
    "nl2 mg slip": dict(nl=2, gp_low=2.0, dh=(0.5, 0.5), sbc=1.0,
                        hEkb=1e-2, f0=2.0),
}


def rel(got, want):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-300)


def configs(**kw):
    return (jnq.load_newqg_config(DECK, dtype="float64", **kw),
            tnq.load_newqg_config(DECK, dtype="float64", **kw))


def psi_ic(cfg, seed=4):
    rng = np.random.default_rng(seed)
    y = (np.arange(cfg.N) + 0.5) / cfg.N
    return 1e-2 * (rng.uniform(-1, 1, (cfg.nl, cfg.N, cfg.N))
                   + np.sin(2 * np.pi * y)[:, None])


def test_deck_and_helmholtz_field():
    jcfg, tcfg = configs(nl=2, gp_low=2.0, dh=(0.5, 0.5))
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    assert tcfg.iRd2_low == pytest.approx(-1.0 / (2.0 * 0.5))
    np.testing.assert_array_equal(tnq.lam_per_layer(tcfg),
                                  jnq.lam_per_layer(jcfg))
    levels, lam = tnq.build_levels(tcfg, device="cpu")
    _, jlam = jnq.build_levels(jcfg)
    assert rel(lam, jlam) == 0
    # the (nl, N, N) field collapses to y-profiles on every level: the
    # walled sweeps and residuals take kernels K3/K4 on the card
    assert all(lvl.sw is not None and lvl.lam.shape[-1] == 1
               for lvl in levels)
    assert tnq.build_levels(configs()[1], device="cpu")[1] is None
    with pytest.raises(ValueError, match="solver"):
        tnq.NewQGConfig(solver="vmg")


@pytest.mark.parametrize("case", list(CASES))
def test_step_matches_jax(case):
    jcfg, tcfg = configs(**CASES[case])
    psi0 = psi_ic(tcfg)
    _, jlam = jnq.build_levels(jcfg)
    _, tlam = tnq.build_levels(tcfg, device="cpu")
    js = jnq.init_state(jcfg, jlam, psi0=psi0)
    ts = tnq.init_state(tcfg, tlam, psi0=psi0, device="cpu")
    assert rel(ts.q, js.q) < 1e-14
    jstep = jax.jit(jnq.make_step(jcfg))
    tstep = tnq.make_step(tcfg, device="cpu")
    spectral = tcfg.solver == "spectral"
    for i in range(10):
        js, jd = jstep(js, jnp.asarray(1e18))
        ts, td = tstep(ts, 1e18)
        assert float(td.dt) == pytest.approx(float(jd.dt), rel=1e-12)
        assert (td.mg_iters == 0) == spectral, f"step {i}"
    assert rel(ts.q, js.q) < 1e-11 and rel(ts.psi, js.psi) < 1e-11
    assert float(td.ke) == pytest.approx(float(jd.ke), rel=1e-11)
    assert int(ts.i) == 10 and float(ts.t) == pytest.approx(float(js.t),
                                                            rel=1e-12)


def test_mg_cycles_match_jax_solve():
    """The multigrid inversion inside the step, once, against the JAX
    package's solve_layered on the same q and guess: the same V-cycles."""
    from msom_tpu.solvers import mg as jmg
    from msom_tpu_torch.ops.bc import BC
    from msom_tpu_torch.solvers import mg as tmg
    jcfg, tcfg = configs(**CASES["nl2 mg slip"])
    levels, lam = tnq.build_levels(tcfg, device="cpu")
    jlevels, jlam = jnq.build_levels(jcfg)
    q = 1e-3 * np.random.default_rng(5).standard_normal((2, 32, 32))
    psi, st = tmg.solve_layered(torch.zeros(2, 32, 32), torch.as_tensor(q),
                                L0=tcfg.L0, lam=lam, bc=BC.DIRICHLET,
                                tolerance=1e-10, levels=levels)
    jpsi, jst = jmg.solve_layered(jnp.zeros((2, 32, 32)), jnp.asarray(q),
                                  L0=jcfg.L0, s=None, lam=jlam,
                                  tolerance=1e-10, levels=jlevels)
    assert st.iters == int(jst.iters) and rel(psi, jpsi) < 1e-11


def test_convert_roundtrip():
    jcfg, tcfg = configs(nl=2, gp_low=2.0, dh=(0.5, 0.5))
    _, jlam = jnq.build_levels(jcfg)
    js = jnq.init_state(jcfg, jlam, psi0=psi_ic(tcfg))
    js = dataclasses.replace(js, i=js.i + 3, t=js.t + 0.25)
    leaves = {k: np.asarray(getattr(js, k)) for k in convert.NEWQG_LEAVES}
    ts = convert.newqg_state_from_numpy(tcfg, leaves, device="cpu")
    assert ts.i.dtype == torch.int32 and int(ts.i) == 3
    back = convert.newqg_state_to_numpy(ts)
    for k in convert.NEWQG_LEAVES:
        np.testing.assert_array_equal(back[k], leaves[k])
    with pytest.raises(ValueError, match="psi"):
        convert.newqg_state_from_numpy(
            tcfg, dict(leaves, psi=leaves["psi"][:1]), device="cpu")
