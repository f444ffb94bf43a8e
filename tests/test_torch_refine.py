"""The port's bf16 + refinement spectral solve (build_spectral(refine=True),
modal_residual, the msqg step on it) against the JAX package's on the CPU,
where both packages' reduced-precision pass is the working type's own
product (JAX's Precision.DEFAULT is full precision on its CPU), so these
check the algebra as tests/test_spectral.py:272-306 does for JAX: float64
to 1e-12 of the maxima (the step 1e-11), float32 to 1e-5; the build's
selection and refusals; and the plain emulation of the card's bf16 pass,
whose refinement must lower the one-pass error."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from msom_tpu.models import qg as jqg
from msom_tpu.ops.bc import BC as JBC
from msom_tpu.ops.ghost import ghosted as jghosted
from msom_tpu.ops.ghost import laplacian_g as jlaplacian
from msom_tpu.ops.stretch import layer_metrics
from msom_tpu.ops.stretch import stretch as jstretch
from msom_tpu.params import QGConfig as JConfig
from msom_tpu.solvers import spectral as jspec
from msom_tpu_torch import convert
from msom_tpu_torch.models import qg as tqg
from msom_tpu_torch.ops.bc import BC as TBC
from msom_tpu_torch.ops.ghost import ghosted as tghosted
from msom_tpu_torch.ops.ghost import laplacian_g as tlaplacian
from msom_tpu_torch.ops.stretch import stretch as tstretch
from msom_tpu_torch.params import QGConfig as TConfig
from msom_tpu_torch.solvers import spectral as tspec

torch.set_num_threads(1)

# tests/test_spectral.py:272-306's problem
N, NL, L0 = 32, 3, 3.0
DH = np.array([0.2, 0.3, 0.5])
SPROF = np.array([12.0, 30.0])
STEPS = 4


def _kw(**over):
    kw = dict(nl=NL, N=N, L0=L0, dh=DH, s_profile=SPROF, periodic=False)
    kw.update(over)
    return kw


def _jax(dtype=jnp.float64, **over):
    return jspec.build_spectral(dtype=dtype, **_kw(**over))


def _port(dtype=torch.float64, **over):
    return tspec.build_spectral(dtype=dtype, device="cpu", **_kw(**over))


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / np.abs(want).max()


@pytest.fixture(scope="module")
def jax_solves():
    """{periodic: (q, psi_true, JAX's refine solve of q)}, float64: q is
    the model operator (5-point Laplacian + stretching) of a seeded
    psi_true."""
    out = {}
    _, idh0, idh1 = layer_metrics(DH)
    strl = jnp.asarray(np.broadcast_to(SPROF[:, None, None], (NL - 1, N, N)))
    for periodic in (False, True):
        bc = JBC.PERIODIC if periodic else JBC.DIRICHLET
        psi_true = np.random.default_rng(11).standard_normal((NL, N, N))
        pt = jnp.asarray(psi_true)
        q = jlaplacian(jghosted(pt, bc), L0 / N) \
            + jstretch(pt, strl, idh0, idh1)
        data = _jax(periodic=periodic, force_matmul=True, refine=True)
        assert data.refine and data.S is not None
        out[periodic] = (np.array(q), psi_true,
                         np.array(jspec.solve_spectral(data, q)))
    return out


@pytest.mark.parametrize("periodic", [False, True])
def test_refine_solve_matches_jax(jax_solves, periodic):
    """The refine solve (two passes and the residual between them) against
    JAX's at 1e-12, and psi_true recovered to 1e-9 (periodic: up to the
    mean, the gauge)."""
    q, psi_true, want = jax_solves[periodic]
    data = _port(periodic=periodic, transform="matmul", refine=True)
    assert data.refine and data.S is not None and data.fac is None
    got = tspec.solve_spectral(data, torch.as_tensor(q)).numpy()
    assert _rel(got, want) < 1e-12
    if periodic:
        got, psi_true = got - got.mean(), psi_true - psi_true.mean()
    np.testing.assert_allclose(got, psi_true, atol=1e-9)


def test_float32_refine_solve_matches_jax_float32(jax_solves):
    """In float32 on the CPU both packages run full-f32 passes: the port's
    refine solve within 1e-5 of JAX's (relative to its maximum)."""
    q = jax_solves[False][0].astype(np.float32)
    want = jspec.solve_spectral(
        _jax(jnp.float32, force_matmul=True, refine=True), jnp.asarray(q))
    data = _port(torch.float32, transform="matmul", refine=True)
    assert data.Sb is not None and data.Sb.dtype == torch.bfloat16
    got = tspec.solve_spectral(data, torch.as_tensor(q))
    assert got.dtype == torch.float32
    assert _rel(got.numpy(), want) < 1e-5


def test_build_selection_matches_jax(jax_solves):
    """JAX's choices: float64 "auto" keeps the FFT path with the flag set
    (the solve does not read it); periodic "auto" keeps rfft2 so too;
    "factored" with refine raises; float32 "auto" at N = 512 with refine
    builds no fold, the basis matrix and JAX's inv_den bit for bit; and
    the port's own refusal of fused_mm with refine."""
    for periodic in (False, True):
        j, t = _jax(periodic=periodic, refine=True), \
            _port(periodic=periodic, refine=True)
        assert j.refine and t.refine
        assert j.S is None and t.S is None and t.fac is None
        qp = jax_solves[periodic][0]
        assert _rel(tspec.solve_spectral(t, torch.as_tensor(qp)).numpy(),
                    jspec.solve_spectral(j, jnp.asarray(qp))) < 1e-12
    assert not _port().refine and not _jax().refine      # "auto": False
    for build in (_jax, _port):
        with pytest.raises(ValueError, match="refine"):
            build(transform="factored", refine=True)
    kw = dict(N=512, refine=True)
    j, t = _jax(jnp.float32, **kw), _port(torch.float32, **kw)
    assert j.fac is None and t.fac is None
    assert j.S is not None and t.S is not None
    np.testing.assert_array_equal(t.inv_den.numpy(), np.asarray(j.inv_den))
    np.testing.assert_array_equal(t.S.numpy(), np.asarray(j.S))
    assert _port(torch.float32, N=512).fac is not None    # without refine
    with pytest.raises(ValueError, match="refine"):
        _port(torch.float32, N=128, transform="matmul", fused_mm=True,
              refine=True)


@pytest.mark.parametrize("periodic", [False, True])
def test_modal_residual_matches_jax(periodic):
    """r = q_m - lap(p_m) - iBu p_m under the model BC against JAX's
    modal_residual at 1e-12, and zero for the refine solve's own p_m."""
    rng = np.random.default_rng(3)
    qm, pm = rng.standard_normal((2, NL, N, N))
    j = _jax(periodic=periodic, force_matmul=True, refine=True)
    t = _port(periodic=periodic, transform="matmul", refine=True)
    np.testing.assert_allclose(t.iBu.numpy(), np.asarray(j.iBu), rtol=1e-13)
    assert t.delta == j.delta and t.periodic == j.periodic
    want = np.asarray(jspec.modal_residual(j, jnp.asarray(qm),
                                           jnp.asarray(pm)))
    got = tspec.modal_residual(t, torch.as_tensor(qm), torch.as_tensor(pm))
    assert _rel(got.numpy(), want) < 1e-12
    qt = torch.as_tensor(qm)
    p1 = tspec.refine_pass(t, qt)
    r = tspec.modal_residual(t, qt, p1)
    if periodic:          # the mean mode has no inverse: its residual stays
        r = r - r.mean(dim=(-2, -1), keepdim=True)
    assert float(r.abs().max()) < 1e-8 * float(qt.abs().max())


def test_bf16_emulation_refinement_lowers_the_one_pass_error():
    """The plain version of the card's bf16 pass (refine_pass_reference)
    in float32 on tools/refine_error.py's problem at N = 32 and 64, nl = 4:
    against the float64 solve, one pass leaves a bf16-sized error and the
    refined solve a smaller one."""
    nl, L0_ = 4, 80.0
    dh = np.full(nl, 1.0 / nl)
    sprof = np.full(nl - 1, (0.003 / 0.025) ** 2)
    _, idh0, idh1 = layer_metrics(dh)
    for n in (32, 64):
        kw = dict(nl=nl, N=n, L0=L0_, dh=dh, s_profile=sprof,
                  transform="matmul", device="cpu")
        d64 = tspec.build_spectral(dtype=torch.float64, **kw)
        d32 = tspec.build_spectral(dtype=torch.float32, refine=True, **kw)
        psi_t = torch.as_tensor(
            np.random.default_rng(0).standard_normal((nl, n, n)))
        strl = torch.as_tensor(sprof)[:, None, None].expand(nl - 1, n, n)
        q = tlaplacian(tghosted(psi_t, TBC.DIRICHLET), L0_ / n) \
            + tstretch(psi_t, strl, idh0, idh1)
        want = tspec.solve_spectral(d64, q).numpy()
        qm = torch.einsum("ml,lyx->myx", d32.l2m, q.float())
        p1 = tspec.refine_pass_reference(d32, qm)
        p2 = p1 + tspec.refine_pass_reference(
            d32, tspec.modal_residual(d32, qm, p1))
        e1, e2 = (_rel(torch.einsum("lm,myx->lyx", d32.m2l, p).numpy(), want)
                  for p in (p1, p2))
        print(f"N = {n}: one bf16 pass {e1:.3e}, refined {e2:.3e}")
        assert 1e-4 < e1 < 1.0 and e2 < 0.5 * e1


def _step_config():
    base = dict(N=64, nl=3, L0=80, Rom=0.025, Ekb=0.002, tau0=1e-4,
                Re4=1563, beta=0.5, Fr=(0.0023669, 0.0076173),
                dh=(0.06, 0.14, 0.8), DT=5e-2, tend=500., dtout=1., CFL=0.6,
                dtype="float64", solver="spectral")
    return JConfig(**base).validate(), TConfig(**base).validate()


def test_refine_step_matches_jax():
    """The msqg step with the refine constants (dataclasses.replace of the
    constants' spec, as tools/refine_error.py and the JAX tests build
    them; no config knob in either package) against JAX's step, 64^2 x 3
    float64, STEPS steps from JAX's initial state carried over by
    convert.state_from_numpy: q and psi within 1e-11 of their maxima, dt
    and KE at 1e-12 and 1e-10."""
    jcfg, tcfg = _step_config()
    psi0 = 1e-3 * np.random.default_rng(5).uniform(-1, 1, (3, 64, 64))
    jconst = jqg.build_constants(jcfg)
    sprof = np.asarray(jconst.strl)[:, 0, 0]
    kw = dict(nl=3, N=64, L0=80.0, dh=np.asarray(jcfg.dh[:3]),
              s_profile=sprof, periodic=False)
    jconst = dataclasses.replace(jconst, spec=jspec.build_spectral(
        dtype=jnp.float64, force_matmul=True, refine=True, **kw))
    tconst = dataclasses.replace(
        tqg.build_constants(tcfg, device="cpu"),
        spec=tspec.build_spectral(dtype=torch.float64, transform="matmul",
                                  refine=True, device="cpu", **kw))
    jstate = jqg.init_state(jcfg, jconst, psi0=psi0)
    tstate = convert.state_from_numpy(tcfg, {
        k: np.asarray(getattr(jstate, k))
        for k in ("q", "psi", "t", "dt_prev", "i")}, device="cpu")
    jstep, tstep = jax.jit(jqg.make_step(jcfg)), tqg.make_step(tcfg)
    for i in range(1, STEPS + 1):
        jstate, jd = jstep(jstate, jconst, jnp.asarray(1e9))
        tstate, td = tstep(tstate, tconst, 1e9)
        assert _rel(tstate.q.numpy(), jstate.q) < 1e-11, i
        assert _rel(tstate.psi.numpy(), jstate.psi) < 1e-11, i
        assert abs(float(td.dt) - float(jd.dt)) <= 1e-12 * float(jd.dt)
        assert abs(float(td.ke) - float(jd.ke)) <= 1e-10 * abs(float(jd.ke))
