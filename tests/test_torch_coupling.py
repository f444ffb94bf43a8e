"""The port's PG <-> QG coupling loop (coupling.py, analysis.py, mspg with
b_forc, msqg with a 2-D frpg and the wavelet filter) at the sizes of
tests/test_coupling_workflow.py: PG 32^2 x 8 spun up 150 steps, QG
64^2 x 3 (IL = [0, 2, 4, 8]) for 40 steps with a filter event every 5,
the feedback regridded to the PG grid and 30 PG steps with and without
it, f64 on the CPU.

The port's loop runs alone (fixture `loop`) and passes the workflow
test's own checks; then each stage of the JAX package runs on the port's
inputs to that stage, and its outputs agree with the port's to 1e-10 of
their maxima (the QG stage over its first 10 steps and two filter events,
with the same V-cycles every step)."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from msom_tpu import analysis as janalysis
from msom_tpu import coupling as jcoupling
from msom_tpu.models import mspg as jm
from msom_tpu.models import qg as jqg
from msom_tpu.ops import wavelet as jwv
from msom_tpu.params import PGConfig as JPG
from msom_tpu.params import QGConfig as JQG
from msom_tpu_torch import analysis as tanalysis
from msom_tpu_torch import coupling as tcoupling
from msom_tpu_torch.models import mspg as tm
from msom_tpu_torch.models import qg as tqg
from msom_tpu_torch.ops import wavelet as twv
from msom_tpu_torch.params import PGConfig as TPG
from msom_tpu_torch.params import QGConfig as TQG

torch.set_num_threads(1)

N_PG, NL_PG = 32, 8
N_QG = 64
IL = [0, 2, 4, 8]          # sigma bands -> 3 QG layers
PG = dict(N=N_PG, nl=NL_PG, ys=0.3, r=0.02, tau_s=3e-2, tau0=0.12, kv=1e-4,
          kh=1e-4, omega=0.2, DT=1e-2, CFL=0.4, tend=1e18, dtout=1e18,
          dtype="float64")


def qg_config(Config, inp):
    return Config(N=N_QG, nl=len(IL) - 1, L0=1.0, Rom=inp["Rom"], Ekb=0.002,
                  tau0=1e-5, Re4=50.0, beta=0.5, Fr=(0.003,) * (len(IL) - 2),
                  dh=inp["dh"], DT=2e-2, tend=1e18, dtout=1e18, dtflt=0.1,
                  afilt=10.0, Lfmax=0.5, CFL=0.5, solver="mg",
                  dtype="float64").validate()


def rel(got, want):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-300)


def cell_velocities(ux, uy):
    """PG faces (nl, N, N+1), (nl, N+1, N) -> cell centres."""
    return 0.5 * (ux[:, :, :-1] + ux[:, :, 1:]), 0.5 * (uy[:, :-1, :]
                                                         + uy[:, 1:, :])


def pg_run(const, state, steps):
    step = tm.make_step(TPG(**PG))
    for _ in range(steps):
        state, _ = step(state, const, 1e18)
    return state


def qg_run(m, cfg, const, state, step, steps=40):
    """Steps with a filter event after every 5th; the V-cycles."""
    filt = jwv if m is jqg else twv
    iters = []
    for k in range(steps):
        state, d = step(state, const, 1e18 if m is tqg else jnp.asarray(1e18))
        iters.append(int(d.mg_iters))
        if k % 5 == 4:
            state = filt.wavelet_filter_step(cfg, const, state)
    return state, iters


def flux_psi(m, cfg, const, state):
    """The filter-mean flux as a streamfunction, from a zero guess."""
    qof_mean = np.asarray(state.qof) / int(state.nbar)
    if m is tqg:
        pf, _ = tqg.invert_q(cfg, const, torch.zeros_like(state.qof),
                             torch.as_tensor(qof_mean))
        return pf.numpy()
    pf, _ = jqg.invert_q(cfg, const, jnp.zeros_like(state.qof),
                         jnp.asarray(qof_mean))
    return np.asarray(pf)


@pytest.fixture(scope="module")
def loop():
    """The port's five stages, each fed the port's previous output."""
    out = {}
    pcfg = TPG(**PG)
    pconst = tm.build_constants(pcfg, device="cpu")
    s1 = pg_run(pconst, tm.init_state(pcfg, pconst), 150)
    out["pg"] = (pconst, s1)
    u_c, v_c = cell_velocities(s1.ux.numpy(), s1.uy.numpy())
    inp = tcoupling.pg_to_qg_inputs(pcfg, s1.b.numpy(), u_c, v_c, il=IL,
                                    N_qg=N_QG, device="cpu")
    out["stage2"] = ((s1.b.numpy(), u_c, v_c), inp)
    qcfg = qg_config(TQG, inp)
    qconst = tqg.build_constants(qcfg, device="cpu", psipg=inp["psipg"],
                                 frpg=inp["frpg"], rdpg=inp["rdpg"])
    psi0 = 1e-3 * np.random.default_rng(0).uniform(-1, 1,
                                                    (3, N_QG, N_QG))
    qs, iters = qg_run(tqg, qcfg, qconst,
                       tqg.init_state(qcfg, qconst, psi0=psi0),
                       tqg.make_step(qcfg))
    pf = flux_psi(tqg, qcfg, qconst, qs)
    out["stage3"] = (psi0, qconst, qs, iters, pf)
    Fr_prof = np.array([np.median(inp["frpg"][k]) for k in range(len(IL) - 2)])
    bf = tcoupling.qg_feedback_forcing(pf, np.asarray(inp["dh"]), Fr_prof,
                                       inp["Rom"], NL_PG)
    bf_coarse = tanalysis.regrid_bicubic(bf, 1.0, N_PG)
    out["stage4"] = ((pf, Fr_prof), bf, bf_coarse)
    amp = 1e-2 / max(np.abs(bf_coarse).max(), 1e-30)
    forced = dataclasses.replace(pconst,
                                 b_forc=torch.as_tensor(amp * bf_coarse))
    out["stage5"] = (amp * bf_coarse, pg_run(forced, s1, 30),
                     pg_run(pconst, s1, 30))
    return out


def test_port_loop_passes_the_workflow_checks(loop):
    """tests/test_coupling_workflow.py's checks on the port's own loop."""
    assert torch.isfinite(loop["pg"][1].b).all()
    inp = loop["stage2"][1]
    nl_qg = len(IL) - 1
    assert inp["psipg"].shape == inp["frpg"].shape == (nl_qg, N_QG, N_QG)
    assert inp["rdpg"].shape == (N_QG, N_QG)
    assert np.isfinite(inp["psipg"]).all() and np.isfinite(inp["frpg"]).all()
    assert (inp["frpg"][:-1] > 0).all() and (inp["rdpg"] > 0).all()
    assert 0.05 < np.median(inp["rdpg"]) < 50.0
    assert abs(sum(inp["dh"]) - 1.0) < 1e-12
    assert np.abs(inp["psipg"]).max() > 0
    _, qconst, qs, _, pf = loop["stage3"]
    assert not qconst.rhs_kernel and int(qs.nbar) == 8
    assert np.isfinite(pf).all() and np.abs(pf).max() > 0
    _, bf, bf_coarse = loop["stage4"]
    assert bf.shape == (NL_PG, N_QG, N_QG)
    assert np.isfinite(bf).all() and np.abs(bf).max() > 0
    b_forc, forced, plain = loop["stage5"]
    db = (forced.b - plain.b).numpy()
    assert np.isfinite(db).all()
    elapsed = float(forced.t) - float(loop["pg"][1].t)
    expect = np.abs(b_forc).max() * elapsed
    assert 0.1 * expect < np.abs(db).max() < 50.0 * expect


@pytest.fixture(scope="module")
def jax_pg():
    jcfg = JPG(**PG)
    return jcfg, jm.build_constants(jcfg), jax.jit(jm.make_step(jcfg))


def test_stage1_pg_spinup_matches_jax(loop, jax_pg):
    jcfg, jc, jstep = jax_pg
    js = jm.init_state(jcfg, jc)
    for _ in range(150):
        js, _ = jstep(js, jc, jnp.asarray(1e18))
    s1 = loop["pg"][1]
    for name in ("b", "ux", "uy"):
        assert rel(getattr(s1, name), getattr(js, name)) < 1e-10, name
    assert float(s1.t) == pytest.approx(float(js.t), rel=1e-12)


def test_stage2_inputs_match_jax(loop):
    (b, u_c, v_c), inp = loop["stage2"]
    want = jcoupling.pg_to_qg_inputs(JPG(**PG), b, u_c, v_c, il=IL,
                                     N_qg=N_QG)
    for name in ("psipg", "frpg", "rdpg"):
        assert rel(inp[name], want[name]) < 1e-10, name
    assert np.allclose(inp["dh"], want["dh"], rtol=1e-14, atol=0)
    assert inp["Rom"] == pytest.approx(want["Rom"], rel=1e-14)


def test_stage3_qg_matches_jax(loop):
    inp = loop["stage2"][1]
    psi0, qconst, _, _, _ = loop["stage3"]
    qcfg = qg_config(TQG, inp)
    qs, iters = qg_run(tqg, qcfg, qconst,
                       tqg.init_state(qcfg, qconst, psi0=psi0),
                       tqg.make_step(qcfg), steps=10)
    pf = flux_psi(tqg, qcfg, qconst, qs)
    jcfg = qg_config(JQG, inp)
    jc = jqg.build_constants(jcfg, psipg=inp["psipg"], frpg=inp["frpg"],
                             rdpg=inp["rdpg"])
    js, jiters = qg_run(jqg, jcfg, jc, jqg.init_state(jcfg, jc, psi0=psi0),
                        jax.jit(jqg.make_step(jcfg)), steps=10)
    assert iters == jiters
    assert int(qs.nbar) == int(js.nbar)
    for name in ("q", "psi", "qof"):
        assert rel(getattr(qs, name), getattr(js, name)) < 1e-10, name
    assert rel(pf, flux_psi(jqg, jcfg, jc, js)) < 1e-10


def test_stage4_feedback_matches_jax(loop):
    inp = loop["stage2"][1]
    (pf, Fr_prof), bf, bf_coarse = loop["stage4"]
    want = jcoupling.qg_feedback_forcing(pf, np.asarray(inp["dh"]), Fr_prof,
                                         inp["Rom"], NL_PG)
    assert rel(bf, want) < 1e-10
    assert rel(bf_coarse, janalysis.regrid_bicubic(bf, 1.0, N_PG)) < 1e-10
    # the analysis functions alone, on a 2-D field and with a mode cut
    assert rel(tanalysis.regrid_bicubic(bf[0], 1.0, 16),
               janalysis.regrid_bicubic(bf[0], 1.0, 16)) < 1e-12
    s = (Fr_prof / inp["Rom"]) ** 2
    assert rel(tanalysis.qg_flux_to_pg_forcing(pf, inp["dh"], s, 5,
                                               mode_cut=2),
               janalysis.qg_flux_to_pg_forcing(pf, inp["dh"], s, 5,
                                               mode_cut=2)) < 1e-12


def test_stage5_continuations_match_jax(loop, jax_pg):
    jcfg, jc, jstep = jax_pg
    b_forc, forced, plain = loop["stage5"]
    s1 = loop["pg"][1]
    j0 = jm.PGState(**{f.name: jnp.asarray(getattr(s1, f.name).numpy())
                       for f in dataclasses.fields(s1)})
    for b_f, port in ((b_forc, forced), (None, plain)):
        const = dataclasses.replace(
            jc, b_forc=None if b_f is None else jnp.asarray(b_f))
        js = j0
        for _ in range(30):
            js, _ = jstep(js, const, jnp.asarray(1e18))
        for name in ("b", "ux", "uy"):
            assert rel(getattr(port, name), getattr(js, name)) < 1e-10, name
