"""The port's doubly periodic msqg (sbc = -1) against the JAX package on
identical float64 numpy inputs: the periodic constants (pp's non-wrap ghost
law, zetap's wrapped ring, topography's Neumann ring, the pp CFL maxima),
the periodic spectral inversion (fourier_matrix, rfft2 and the Fourier
basis matmul, also through K7's data path), the plain versions of K1's
and K2's periodic modes against the Pallas kernels in interpret mode and
qg.rhs, the hazards that only the boundary rows and columns show, the
periodic steps in lockstep with the JAX step (spectral, mg with the same
V-cycles, modal), the tracer integral the Arakawa advection conserves,
and csrc/fused_rhs.cu itself in tools/k1_emulation.py's host emulation.

Tolerances: the constants and the spectral solves to 1e-12 (relative,
roundoff of the same arithmetic); dq at atol 1e-12 x max(|dq|, 1) and the
face-speed maxima at rtol 1e-12 (tests/test_pallas_rhs.py's); the steps to
1e-11 of max|q|, max|psi| and max|tracers| over 10 steps (tests/
test_lockstep.py's), mg to 1e-10 with the same V-cycles every step."""

import dataclasses
import shutil
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from msom_tpu.models import pallas_rhs
from msom_tpu.models import qg as jqg
from msom_tpu.ops.ghost import (ghosted, ghosted_from_padded, laplacian_g,
                                max_face_speed_layers)
from msom_tpu.params import QGConfig as JConfig
from msom_tpu.solvers import spectral as jspec
from msom_tpu_torch.models import fused_rhs, fused_tracer
from msom_tpu_torch.models import qg as tqg
from msom_tpu_torch.params import QGConfig as TConfig
from msom_tpu_torch.solvers import spectral as tspec

torch.set_num_threads(1)

FLOW = dict(upg=(0.02, 0.01, 0.0), vpg=(0.01, -0.005, 0.0))
TRACERS = dict(nptr=2, Pe=(1e3, 2e3), ptr_r=(100.0, 0.0))


def _configs(N=64, nl=3, **kw):
    """tests/test_pallas_rhs.py's `_base_kw` with sbc = -1, both packages."""
    base = dict(N=N, nl=nl, L0=80, Rom=0.025, Ekb=0.002, Eks=0.001,
                tau0=1e-4, Re4=391, beta=0.5, Fr=(0.0023669,) * (nl - 1),
                dh=tuple([1.0 / nl] * nl), DT=5e-2, tend=500.0, dtout=1.0,
                CFL=0.6, dtype="float64", solver="spectral", sbc=-1.0)
    base.update(kw)
    return JConfig(**base).validate(), TConfig(**base).validate()


def _verron(N=64, **kw):
    """tests/test_lockstep.py's deck, doubly periodic, both packages."""
    base = dict(N=N, nl=3, L0=80, Rom=0.025, Ekb=0.002, tau0=1e-4, Re4=1563,
                beta=0.5, Fr=(0.0023669, 0.0076173), dh=(0.06, 0.14, 0.8),
                DT=5e-2, tend=500., dtout=1., CFL=0.6, dtype="float64",
                solver="spectral", sbc=-1.0)
    base.update(kw)
    return JConfig(**base).validate(), TConfig(**base).validate()


def _smooth(rng, shape, N):
    """A smooth random field: a few low modes plus noise."""
    x = (np.arange(N) + 0.5) / N
    X, Y = np.meshgrid(x, x, indexing="xy")
    out = np.zeros(shape)
    flat = out.reshape(-1, N, N)
    for k in range(flat.shape[0]):
        flat[k] = (np.sin(np.pi * (k % 3 + 1) * Y) * np.cos(np.pi * X)
                   + 0.3 * np.cos(2 * np.pi * X) * np.sin(2 * np.pi * Y))
    return out + 0.05 * rng.standard_normal(shape)


def _psi(shape, seed):
    rng = np.random.default_rng(seed)
    psi = 1e-3 * rng.uniform(-1, 1, shape) + 0.1 * rng.standard_normal(shape)
    return psi - psi.mean(axis=(-2, -1), keepdims=True)


def _rel(got, want):
    want = np.asarray(want)
    return np.abs(np.asarray(got) - want).max() / np.abs(want).max()


# ---------------------------------------------------------------------------
# constants
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("flsrv", [0, 1])
@pytest.mark.parametrize("with_psipg", [False, True])
def test_periodic_constants_match_jax(flsrv, with_psipg):
    """pp_pad (the non-wrap ghost law 2 (vpg x - upg y) - interior, from
    the flow even where psipg sets the interior), zetap_pad (wrapped),
    topo_pad (Neumann) and the pp face-speed maxima."""
    jcfg, tcfg = _configs(flsrv=flsrv, **FLOW)
    rng = np.random.default_rng(3)
    inputs = dict(topo=_smooth(rng, (64, 64), 64))
    if with_psipg:
        inputs["psipg"] = _smooth(rng, (3, 64, 64), 64)
    jc = jqg.build_constants(jcfg, **inputs)
    tc = tqg.build_constants(tcfg, device="cpu", **inputs)
    for name in ("pp_pad", "topo_pad") + (("zetap_pad",) if flsrv else ()):
        np.testing.assert_allclose(getattr(tc, name).numpy(),
                                   np.asarray(getattr(jc, name)), rtol=0,
                                   atol=1e-12 * np.abs(getattr(jc,
                                                               name)).max())
    if not flsrv:
        assert tc.zetap_pad is None
    upp = max_face_speed_layers(ghosted_from_padded(jc.pp_pad), jcfg.delta)
    np.testing.assert_allclose(tc.umax_pp.numpy(), np.asarray(upp),
                               rtol=1e-12, atol=0)
    # the ghosts are not a wrap of the interior
    pad = tc.pp_pad.numpy()
    assert np.abs(pad[:, 1:-1, 0] - pad[:, 1:-1, -2]).max() > 1e-3


def test_periodic_pp_ghost_law_is_the_flow_at_the_faces():
    """The mean of a ghost and the cell beside it is vpg x - upg y at the
    face between them: x = 0 and L0 on the x-faces, y = 0 and L0 on the
    y-faces (msqg/qg.h:1105-1114)."""
    _, tcfg = _configs(**FLOW)
    pad = tqg.build_constants(tcfg, device="cpu").pp_pad.numpy()
    N, d, L0 = tcfg.N, tcfg.delta, tcfg.L0
    y = (np.arange(N) + 0.5) * d
    u, v = np.array(FLOW["upg"])[:, None], np.array(FLOW["vpg"])[:, None]
    np.testing.assert_allclose(0.5 * (pad[:, 1:-1, 0] + pad[:, 1:-1, 1]),
                               -u * y, atol=1e-14)
    np.testing.assert_allclose(0.5 * (pad[:, 1:-1, -1] + pad[:, 1:-1, -2]),
                               v * L0 - u * y, atol=1e-14)
    np.testing.assert_allclose(0.5 * (pad[:, -1, 1:-1] + pad[:, -2, 1:-1]),
                               v * y - u * L0, atol=1e-14)


def test_sbc_between_minus_one_and_zero_is_refused():
    _, tcfg = _configs(N=16, sbc=-0.5)
    with pytest.raises(ValueError, match="sbc"):
        tqg.build_constants(tcfg, device="cpu")


# ---------------------------------------------------------------------------
# the periodic spectral inversion
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("N", [8, 32, 64])
def test_fourier_matrix_matches_jax(N):
    R, freq = tspec.fourier_matrix(N)
    Rj, freqj = jspec.fourier_matrix(N)
    np.testing.assert_allclose(R, Rj, rtol=0, atol=1e-14)
    np.testing.assert_array_equal(freq, freqj)
    np.testing.assert_allclose(R @ R.T, np.eye(N), atol=1e-13)
    with pytest.raises(ValueError, match="even"):
        tspec.fourier_matrix(N + 1)


@pytest.mark.parametrize("transform", ["auto", "fft", "matmul"])
@pytest.mark.parametrize("nl", [1, 3])
def test_periodic_spectral_solve_matches_jax(transform, nl):
    """build_spectral/solve_spectral, periodic: "auto" and "fft" keep
    rfft2 (inv_den (nl, N, N//2+1), 0 where the denominator is 0),
    "matmul" takes the Fourier basis; each against the JAX solve."""
    N, L0 = 64, 3.0
    kw = dict(nl=nl, N=N, L0=L0, dh=[0.2, 0.3, 0.5][:nl],
              s_profile=[12.0, 30.0][:nl - 1] if nl > 1 else None,
              periodic=True)
    jd = jspec.build_spectral(**kw, dtype=jnp.float64, transform=transform)
    td = tspec.build_spectral(**kw, dtype=torch.float64, transform=transform,
                              device="cpu")
    assert (td.S is None) == (transform != "matmul") == (jd.S is None)
    width = N if transform == "matmul" else N // 2 + 1
    assert tuple(td.inv_den.shape) == (nl, N, width)
    np.testing.assert_allclose(td.inv_den.numpy(), np.asarray(jd.inv_den),
                               rtol=1e-13, atol=0)
    assert (td.inv_den == 0).sum() >= 1      # the gauge
    q = np.random.default_rng(nl).standard_normal((nl, N, N))
    pj = np.asarray(jspec.solve_spectral(jd, jnp.asarray(q)))
    pt = tspec.solve_spectral(td, torch.as_tensor(q)).numpy()
    assert _rel(pt, pj) < 1e-12


def test_periodic_matmul_basis_matches_rfft():
    """tests/test_spectral.py's case in the port: the Fourier basis and the
    rfft2 path solve with the same inverse operator."""
    N, nl = 32, 3
    kw = dict(nl=nl, N=N, L0=3.0, dh=[0.2, 0.3, 0.5], s_profile=[12.0, 30.0],
              periodic=True, dtype=torch.float64, device="cpu")
    d_fft = tspec.build_spectral(**kw)
    d_mm = tspec.build_spectral(**kw, transform="matmul")
    assert d_fft.S is None and d_mm.S is not None
    q = torch.as_tensor(np.random.default_rng(7).standard_normal((nl, N, N)))
    p1 = tspec.solve_spectral(d_fft, q).numpy()
    p2 = tspec.solve_spectral(d_mm, q).numpy()
    np.testing.assert_allclose(p1, p2, atol=1e-12)


def test_periodic_fourier_basis_through_the_fused_solve():
    """fused_mm=True on the periodic matmul basis hands fourier_matrix and
    the naturally ordered inv_den to K7 (its plain version on the CPU), as
    the JAX package hands them to its fused kernel (spectral.py:322-330);
    the solve agrees with the JAX solve."""
    N, nl = 128, 3
    kw = dict(nl=nl, N=N, L0=80.0, dh=[0.2, 0.3, 0.5], s_profile=[12.0, 30.0],
              periodic=True, transform="matmul")
    td = tspec.build_spectral(**kw, dtype=torch.float64, fused_mm=True,
                              device="cpu")
    jd = jspec.build_spectral(**kw, dtype=jnp.float64)
    assert td.fused_mm and td.S is not None
    np.testing.assert_allclose(td.S.numpy(), tspec.fourier_matrix(N)[0])
    q = np.random.default_rng(2).standard_normal((nl, N, N))
    pj = np.asarray(jspec.solve_spectral(jd, jnp.asarray(q)))
    pt = tspec.solve_spectral(td, torch.as_tensor(q)).numpy()
    assert _rel(pt, pj) < 1e-12
    with pytest.raises(ValueError, match="factored"):
        tspec.build_spectral(**{**kw, "transform": "factored"},
                             dtype=torch.float64, device="cpu")


def test_periodic_invert_q_inverts_comp_q():
    """psi = invert_q(q) satisfies comp_q(psi) = q with wrapped ghosts, for
    a q of zero mean in each mode (the gauge drops the mean)."""
    _, tcfg = _configs()
    const = tqg.build_constants(tcfg, device="cpu")
    psi0 = torch.as_tensor(_psi((3, 64, 64), 1))
    q = tqg.comp_q(tcfg, const, psi0)
    psi, _ = tqg.invert_q(tcfg, const, None, q)
    assert _rel(tqg.comp_q(tcfg, const, psi), q) < 1e-12
    assert _rel(psi, psi0) < 1e-10


# ---------------------------------------------------------------------------
# the tendency: K1's and K2's periodic plain versions
# ---------------------------------------------------------------------------

def _check_rhs(jcfg, tcfg, psi, **inputs):
    """The plain version against the Pallas kernel (interpret) and qg.rhs;
    returns the port's dq."""
    jc = jqg.build_constants(jcfg, **inputs)
    assert pallas_rhs.applicable(jcfg, jc)
    p = jnp.asarray(psi)
    jq = jqg.comp_q(jcfg, jc, p)
    need_q = jcfg.energy_conserv or jcfg.stochastic
    dq_k, umax_k = pallas_rhs.rhs_fused(jcfg, jc, p, jq if need_q else None,
                                        interpret=True)
    psi_g = ghosted(p, jqg._bc_psi(jcfg))
    zeta = laplacian_g(psi_g, jcfg.delta)
    dq_x, _ = jqg.rhs(jcfg, jc, jq, p, psi_g, zeta,
                      jqg._ghost_deriv(jcfg, zeta, psi_g), None)
    umax_x = max_face_speed_layers(psi_g, jcfg.delta)

    tc = tqg.build_constants(tcfg, device="cpu", **inputs)
    tp = torch.as_tensor(psi)
    tq = tqg.comp_q(tcfg, tc, tp)
    np.testing.assert_allclose(tq.numpy(), np.asarray(jq), rtol=0,
                               atol=1e-13 * np.abs(jq).max())
    dq, umax = fused_rhs.rhs_fused_reference(tcfg, tc, tp,
                                             tq if need_q else None)
    dq, umax = dq.numpy(), umax.numpy()
    for want in (np.asarray(dq_k), np.asarray(dq_x)):
        np.testing.assert_allclose(dq, want, rtol=0,
                                   atol=1e-12 * max(np.abs(want).max(), 1.0))
    for want in (umax_k, umax_x):
        np.testing.assert_allclose(umax, np.asarray(want), rtol=1e-12, atol=0)
    if jc.rhsk.umax_pp is not None:
        np.testing.assert_allclose(tc.umax_pp.numpy(),
                                   np.asarray(jc.rhsk.umax_pp), rtol=1e-12,
                                   atol=0)
    dq_w, _ = fused_rhs.rhs_fused(tcfg, tc, tp, tq if need_q else None)
    assert torch.equal(dq_w, torch.as_tensor(dq))
    return dq


def _case(name, N=64):
    """(config overrides, input fields) of tests/test_pallas_rhs.py's
    periodic cases (:260-320)."""
    rng = np.random.default_rng(sum(map(ord, name)))
    topo = _smooth(rng, (N, N), N)
    qforc = 1e-4 * rng.standard_normal((3, N, N))
    return {
        "uncoupled": (dict(), dict()),
        "tracers_topo": (dict(**TRACERS), dict(topo=topo)),
        "pp": (dict(upg=(0.1, 0.0, 0.0)), dict()),
        "pp_flsrv_topo_qforc": (dict(flsrv=1, Re=500.0, **FLOW),
                                dict(topo=topo, qforc=qforc)),
        "pp_energy_conserv": (dict(energy_conserv=True, upg=(0.02, 0.0, 0.0),
                                   vpg=(0.0, -0.005, 0.0)), dict()),
        "psipg_flsrv": (dict(flsrv=1, **FLOW),
                        dict(psipg=_smooth(rng, (3, N, N), N))),
    }[name]


@pytest.mark.parametrize("name", ["uncoupled", "tracers_topo", "pp",
                                  "pp_flsrv_topo_qforc", "pp_energy_conserv",
                                  "psipg_flsrv"])
def test_periodic_rhs_matches_pallas_and_xla(name):
    over, inputs = _case(name)
    jcfg, tcfg = _configs(**over)
    _check_rhs(jcfg, tcfg, _psi((3, 64, 64), len(name)), **inputs)


def _one_line(shape, where, seed):
    f = np.zeros(shape)
    rng = np.random.default_rng(seed)
    if where == "row0":
        f[..., 0, :] = rng.standard_normal(shape[-1])
    elif where == "col0":
        f[..., :, 0] = rng.standard_normal(shape[-2])
    else:
        f[..., 0, 0] = 1.0
        f[..., -1, -1] = -0.5
    return f


@pytest.mark.parametrize("where", ["row0", "col0", "corner"])
def test_periodic_rhs_boundary_only_psi(where):
    """A psi that is zero but on row 0, column 0 or two opposite corners:
    only a wrap that reaches across the boundary gives its tendency the
    cells of row N - 1 and column N - 1 (through zeta, lap zeta and the
    brackets) and the faces between the last and the first cell."""
    jcfg, tcfg = _configs(Re=1000.0, flsrv=1, **FLOW)
    psi = _one_line((3, 64, 64), where, 5)
    dq = _check_rhs(jcfg, tcfg, psi)
    if where != "col0":
        assert np.abs(dq[:, -1, :]).max() > 0
    if where != "row0":
        assert np.abs(dq[:, :, -1]).max() > 0


def test_periodic_rhs_pp_with_a_ghost_law_only():
    """pp zero in the interior with a nonzero ghost law (psipg = 0, the
    flow nonzero): the pp terms live on the boundary cells alone and come
    from pp_pad's ghosts, which a wrap of pp (zero) would lose; zetap's
    wrapped ring is lap(pp_pad) at the other end, not lap of a wrapped pp."""
    jcfg, tcfg = _configs(flsrv=1, **FLOW)
    psi = _psi((3, 64, 64), 9)
    dq = _check_rhs(jcfg, tcfg, psi, psipg=np.zeros((3, 64, 64)))
    _, free = _configs()
    base = fused_rhs.rhs_fused_reference(
        free, tqg.build_constants(free, device="cpu"),
        torch.as_tensor(psi))[0].numpy()
    diff = np.abs(dq - base)
    assert diff[:, 2:-2, 2:-2].max() == 0
    assert diff[:, 0, :].max() > 0 and diff[:, :, 0].max() > 0


@pytest.mark.parametrize("nptr", [1, 2, 3])
@pytest.mark.parametrize("with_relax", [False, True])
def test_periodic_tracer_reference_matches_pallas(nptr, with_relax):
    """tracer_fused_reference, periodic, against the Pallas tracer kernel
    (interpret) and qg.rhs's tracer block."""
    over = dict(nptr=nptr, Pe=(1e3, 2e3, 7e2)[:nptr],
                ptr_r=(100.0, 0.0, 13.0)[:nptr])
    jcfg, tcfg = _configs(**over)
    rng = np.random.default_rng(10 * nptr + with_relax)
    inputs = {}
    if with_relax:
        inputs["ptr_relax"] = rng.standard_normal((3, nptr, 64, 64))
    tr = rng.uniform(-1, 1, (3, nptr, 64, 64))
    psi = _psi((3, 64, 64), nptr)
    jc = jqg.build_constants(jcfg, **inputs)
    want = np.asarray(pallas_rhs.tracer_fused(jcfg, jc, jnp.asarray(psi),
                                              jnp.asarray(tr),
                                              interpret=True))
    tc = tqg.build_constants(tcfg, device="cpu", **inputs)
    got = fused_tracer.tracer_fused_reference(tcfg, tc, torch.as_tensor(psi),
                                              torch.as_tensor(tr)).numpy()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-12 * max(np.abs(want).max(), 1.0))
    assert torch.equal(fused_tracer.tracer_fused(
        tcfg, tc, torch.as_tensor(psi), torch.as_tensor(tr)),
        torch.as_tensor(got))


# ---------------------------------------------------------------------------
# the periodic step
# ---------------------------------------------------------------------------

def _lockstep(jcfg, tcfg, steps=10, fields=None, tr=False, limit=1e-11,
              same_cycles=False):
    fields = fields or {}
    rng = np.random.default_rng(0)
    N, nl = jcfg.N, jcfg.nl
    psi0 = 1e-3 * rng.uniform(-1, 1, (nl, N, N))
    tr0 = 1e-3 * rng.uniform(-1, 1, (nl, jcfg.nptr, N, N)) if tr else None
    jc = jqg.build_constants(jcfg, **fields)
    js = jqg.init_state(jcfg, jc, psi0=psi0, tracers0=tr0)
    tc = tqg.build_constants(tcfg, device="cpu", **fields)
    ts = tqg.init_state(tcfg, tc, psi0=psi0, tracers0=tr0)
    jstep, tstep = jax.jit(jqg.make_step(jcfg)), tqg.make_step(tcfg)
    tnext = jnp.asarray(1e9, js.t.dtype)
    for i in range(1, steps + 1):
        js, jd = jstep(js, jc, tnext)
        ts, td = tstep(ts, tc, 1e9)
        assert _rel(ts.q, js.q) < limit, f"step {i}: q"
        assert _rel(ts.psi, js.psi) < limit, f"step {i}: psi"
        if tr:
            assert _rel(ts.tracers, js.tracers) < limit, f"step {i}: tr"
        assert abs(float(td.dt) - float(jd.dt)) <= 1e-12 * float(jd.dt)
        assert abs(float(td.ke) - float(jd.ke)) <= 1e-10 * abs(float(jd.ke))
        if same_cycles:
            assert td.mg_iters == int(jd.mg_iters), f"step {i}: cycles"
    return ts


def test_periodic_uncoupled_step_matches_jax():
    _lockstep(*_verron())


@pytest.mark.parametrize("over", [
    dict(transform="matmul"),
    dict(energy_conserv=True, **FLOW),
    dict(nl=1, Fr=(), dh=(1.0,), upg=(0.02,), vpg=(0.01,))],
    ids=["fourier_basis", "energy_conserv_pp", "nl1_pp"])
def test_periodic_step_variants_match_jax(over):
    """The periodic step with the Fourier-basis matmul solve, with
    ENERGY_CONSERV advection under a large-scale flow, and barotropic with
    a flow (nl = 1: the advection block, pp terms included, is skipped)."""
    _lockstep(*_verron(**over))


def test_periodic_coupled_step_matches_jax():
    """upg/vpg with _LS_RV, topography, a 3-D forcing and two tracers."""
    jcfg, tcfg = _verron(flsrv=1, **FLOW, **TRACERS)
    rng = np.random.default_rng(4)
    N = jcfg.N
    fields = dict(topo=0.05 * np.sin(np.linspace(0, 2 * np.pi, N))[:, None]
                  * np.ones((N, N)),
                  qforc=1e-5 * rng.standard_normal((3, N, N)))
    _lockstep(jcfg, tcfg, fields=fields, tr=True)


def test_periodic_mg_step_matches_jax():
    """solver="mg" on the periodic grid: the same V-cycles every step."""
    ts = _lockstep(*_verron(N=32, solver="mg"), limit=1e-10,
                   same_cycles=True)
    assert ts.psi_old is not None


def test_periodic_modal_step_matches_jax():
    """mode_pv_invert: the modal Helmholtz solves on the periodic grid."""
    _lockstep(*_verron(N=32, solver="mg", mode_pv_invert=True), limit=1e-10,
              same_cycles=True)


def test_periodic_tracer_advection_conserves_the_integral():
    """tests/test_qg_model.py:100-117 in the port: periodic, Pe = 0, no
    relaxation: the Arakawa advection conserves the tracer integral."""
    cfg = TConfig(N=32, nl=2, L0=1.0, Rom=0.1, beta=0.0, sbc=-1, Fr=(0.1,),
                  dh=(0.5, 0.5), nptr=1, Pe=(0.0,), ptr_r=(0.0,), DT=1e-3,
                  tend=1.0, dtype="float64", solver="spectral").validate()
    const = tqg.build_constants(cfg, device="cpu")
    state = tqg.init_state(cfg, const, seed=4)
    tr0 = state.tracers.clone()
    step = tqg.make_step(cfg)
    for _ in range(10):
        state, _ = step(state, const, 1e9)
    np.testing.assert_allclose(state.tracers.sum(dim=(-2, -1)).numpy(),
                               tr0.sum(dim=(-2, -1)).numpy(), rtol=1e-10,
                               atol=1e-10)
    assert (state.tracers - tr0).std() > 0


def test_periodic_bound_work_counts_the_padded_pp():
    """The periodic kernel reads pp with its ghost ring: nl (N + 2)^2
    cells, where the walled one reads nl N^2."""
    _, per = _configs(N=32, **FLOW)
    _, wall = _configs(N=32, sbc=0.0, **FLOW)
    b_per = fused_rhs.bound_work(per, tqg.build_constants(per, device="cpu"),
                                 8)[0]
    b_wall = fused_rhs.bound_work(wall,
                                  tqg.build_constants(wall, device="cpu"),
                                  8)[0]
    assert b_per - b_wall == 3 * (34 ** 2 - 32 ** 2) * 8


def test_periodic_kernel_options():
    """The wrapper's options in the periodic run: pp_t and zetap_t (pp_pad
    and zetap_pad with three zero columns either side, for aligned copies)
    go to the kernel, with the PERIODIC and FLSRV flags."""
    _, tcfg = _configs(N=16, flsrv=1, **FLOW)
    const = tqg.build_constants(tcfg, device="cpu")
    pp, zetap, *_, cslip, flags = fused_rhs._options(tcfg, const)
    assert pp is const.pp_t and zetap is const.zetap_t
    for t, pad in ((pp, const.pp_pad), (zetap, const.zetap_pad)):
        assert tuple(t.shape) == (3, 18, 24) and t.is_contiguous()
        assert torch.equal(t[..., 3:-3], pad)
        assert t[..., :3].abs().max() == 0 and t[..., -3:].abs().max() == 0
    assert flags == fused_rhs.FLSRV | fused_rhs.PERIODIC and cslip == 0.0
    walled = dataclasses.replace(tcfg, sbc=0.0)
    pp, zetap, *_, flags = fused_rhs._options(walled, const)
    assert pp is const.pp and zetap is None and flags == fused_rhs.FLSRV


@pytest.mark.parametrize("early", [False, True])
def test_k1_kernel_source_in_host_emulation(tmp_path, early):
    """csrc/fused_rhs.cu itself, its copies landing at their wait or at
    their issue, matches the plain version on the CPU, periodic and walled,
    every option set (the stochastic variant too), f64 and f32, at N = 48
    (one strip holds the grid: the wrapped halo is the strip's own
    interior) and 130 (partial strips, one-element copies in f32)."""
    if shutil.which("g++") is None:
        pytest.skip("the host emulation needs g++")
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "tools"))
    import k1_emulation as emu
    lib = emu.load(emu.build("k1", early=early, out=tmp_path))
    errs = emu.errors(lib, cases=[(48, 3), (130, 4)])
    assert max(errs.values()) <= 1.0, max(errs, key=errs.get)
