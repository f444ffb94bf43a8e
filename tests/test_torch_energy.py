"""The port's msqg energy budget (models/qg_energy.py) against the JAX
package on identical float64 numpy inputs: energy_tend over several steps,
filter_de and reset_window, uncoupled and coupled (a large-scale
streamfunction with _LS_RV), walled, partial slip and doubly periodic,
with ediag = 0 (energy weights) and 1 (unit weights); and the budget's own
identity on the port: with ediag = 1, dt = 1 and no wind, the five terms
sum to the port's tendency.

Tolerances: every field to 1e-12 of its maximum (the same stencils in the
same order; the filter's inversion exact to roundoff); the identity to
1e-10 of max|dq| (the terms are summed in another order than the RHS)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from msom_tpu.models import qg as jqg
from msom_tpu.models import qg_energy as jen
from msom_tpu_torch.models import qg as tqg
from msom_tpu_torch.models import qg_energy as ten
from msom_tpu_torch.ops.ghost import ghosted, laplacian_g

from test_torch_wavelet import rdpg_field, rel, rough, verron

torch.set_num_threads(1)

# Re (harmonic) and both Ekman layers on, so that every term is nonzero
PHYSICS = dict(Re=500.0, Eks=0.001, dtflt=0.5)
FLOW = dict(upg=(0.02, 0.01, 0.0), vpg=(0.01, -0.005, 0.0), flsrv=1)
CASES = {
    "walled": dict(),
    "partial slip": dict(sbc=1.0),
    "periodic": dict(sbc=-1.0),
    "coupled": dict(psipg=True, flsrv=1),
    "coupled periodic": dict(sbc=-1.0, **FLOW),
    "one layer": dict(nl=1, Fr=(), dh=(1.0,)),
}


def _build(case, ediag, N=64, **over):
    kw = dict(CASES[case], **over)
    with_psipg = kw.pop("psipg", False)
    jcfg, tcfg = verron(N, ediag=ediag, **PHYSICS, **kw)
    inputs = {}
    if with_psipg:
        inputs["psipg"] = 0.05 * rough((jcfg.nl, N, N), 9)
    jc = jqg.build_constants(jcfg, rdpg=rdpg_field(N), **inputs)
    tc = tqg.build_constants(tcfg, device="cpu", rdpg=rdpg_field(N),
                             **inputs)
    return jcfg, tcfg, jc, tc


def _check(tacc, jacc, what):
    for name in ten.FIELDS + ("po_mft",):
        want = np.asarray(getattr(jacc, name))
        got = getattr(tacc, name).numpy()
        if np.abs(want).max() == 0:
            assert np.abs(got).max() == 0, f"{what}: {name}"
        else:
            assert rel(got, want) < 1e-12, f"{what}: {name}"
    assert int(tacc.nme_ft) == int(jacc.nme_ft)
    assert tacc.nme_ft.dtype == torch.int32


@pytest.mark.parametrize("ediag", [0, 1])
@pytest.mark.parametrize("case", list(CASES))
def test_energy_budget_matches_jax(case, ediag):
    """Three energy_tend steps, a filter_de event, two more steps, then
    reset_window: every accumulator agrees with JAX's at each stage."""
    jcfg, tcfg, jc, tc = _build(case, ediag)
    nl = jcfg.nl
    jacc, tacc = jen.init_energy(jcfg), ten.init_energy(tcfg, device="cpu")
    psis = [0.1 * rough((nl, 64, 64), 20 + k) for k in range(5)]
    dts = [0.05, 0.04, 0.045, 0.05, 0.03]
    for k in range(3):
        jacc = jen.energy_tend(jcfg, jc, jacc, jnp.asarray(psis[k]), dts[k])
        tacc = ten.energy_tend(tcfg, tc, tacc, torch.as_tensor(psis[k]),
                               torch.tensor(dts[k], dtype=torch.float64))
    _check(tacc, jacc, "after 3 steps")
    q = np.array(jqg.comp_q(jcfg, jc, jnp.asarray(psis[2])))
    jacc = jen.filter_de(jcfg, jc, jacc, jnp.asarray(q),
                         jnp.asarray(psis[2]))
    tacc = ten.filter_de(tcfg, tc, tacc, torch.as_tensor(q),
                         torch.as_tensor(psis[2]))
    _check(tacc, jacc, "after filter_de")
    assert float(tacc.de_ft.abs().max()) > 0
    for k in range(3, 5):
        jacc = jen.energy_tend(jcfg, jc, jacc, jnp.asarray(psis[k]), dts[k])
        tacc = ten.energy_tend(tcfg, tc, tacc, torch.as_tensor(psis[k]),
                               dts[k])
    _check(tacc, jacc, "after 5 steps")
    jacc, tacc = jen.reset_window(jacc), ten.reset_window(tacc)
    _check(tacc, jacc, "after reset_window")
    assert all(float(getattr(tacc, n).abs().max()) == 0 for n in ten.FIELDS)
    assert float(tacc.po_mft.abs().max()) > 0     # the psi mean stays


@pytest.mark.parametrize("case", ["walled", "partial slip", "periodic",
                                  "coupled", "coupled periodic"])
def test_budget_terms_sum_to_the_tendency(case):
    """ediag = 1, dt = 1, no wind: de_j1 + de_j2 + de_j3 + de_vd + de_bf
    is the port's own dq (the jc cross terms cancel, the upward swap
    rebuilds the cascade)."""
    _, tcfg, _, tc = _build(case, 1, tau0=0.0)
    psi = torch.as_tensor(0.1 * rough((3, 64, 64), 31))
    psi_g = ghosted(psi, tqg._bc_psi(tcfg))
    zeta = laplacian_g(psi_g, tcfg.delta)
    zeta_g = tqg._ghost_deriv(tcfg, zeta, psi_g)
    q = tqg.comp_q(tcfg, tc, psi)
    dq, _ = tqg.rhs(tcfg, tc, q, psi_g, zeta, zeta_g)
    acc = ten.energy_tend(tcfg, tc, ten.init_energy(tcfg, device="cpu"),
                          psi, 1.0)
    total = acc.de_j1 + acc.de_j2 + acc.de_j3 + acc.de_vd + acc.de_bf
    assert rel(total, dq.numpy()) < 1e-10
