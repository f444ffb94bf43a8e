"""The port's coupled msqg step (large-scale streamfunction, topography,
3-D forcing, two passive tracers; and the upg/vpg + _LS_RV + partial-slip
variant) in lockstep with the JAX package's jitted step at 128^2 x 3 in
float64 from the same numpy inputs; the derived coupling constants; and a
JAX checkpoint with tracers resuming in the port.

Tolerances are those of tests/test_lockstep.py: q, psi and the tracers to
1e-11 of their maxima, dt to 1e-12 and KE to 1e-10 relative."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from msom_tpu.io.checkpoint import save_state
from msom_tpu.models import qg as jqg
from msom_tpu.params import QGConfig as JConfig
from msom_tpu_torch import convert
from msom_tpu_torch.models import fused_rhs, fused_tracer
from msom_tpu_torch.models import qg as tqg
from msom_tpu_torch.ops.bc import BC as TBC
from msom_tpu_torch.ops.ghost import ghosted as tghosted
from msom_tpu_torch.params import QGConfig as TConfig

torch.set_num_threads(1)

TRACERS = dict(nptr=2, Pe=(1e3, 2e3), ptr_r=(100.0, 0.0))


def verron(N, **kw):
    """tests/test_lockstep.py's deck, for both packages."""
    base = dict(N=N, nl=3, L0=80, Rom=0.025, Ekb=0.002, tau0=1e-4, Re4=1563,
                beta=0.5, Fr=(0.0023669, 0.0076173), dh=(0.06, 0.14, 0.8),
                DT=5e-2, tend=500., dtout=1., CFL=0.6, dtype="float64",
                solver="spectral")
    base.update(kw)
    return JConfig(**base).validate(), TConfig(**base).validate()


def _inputs(cfg, seed=0):
    """bench.py's coupled fields (a gyre-shaped psipg, a sine topography)
    plus a weak 3-D forcing, and numpy-seeded noise ICs."""
    N, nl = cfg.N, cfg.nl
    rng = np.random.default_rng(seed)
    y = (np.arange(N) + 0.5) * cfg.delta
    gyre = np.sin(np.pi * y / cfg.L0)
    fields = dict(
        psipg=0.01 * gyre[None, :, None] * np.ones((nl, N, N)),
        topo=0.05 * np.outer(gyre, np.sin(2 * np.pi * y / cfg.L0)),
        qforc=1e-5 * rng.standard_normal((nl, N, N)))
    psi0 = 1e-3 * rng.uniform(-1, 1, (nl, N, N))
    tr0 = 1e-3 * rng.uniform(-1, 1, (nl, cfg.nptr, N, N)) \
        if cfg.nptr else None
    return fields, psi0 - psi0.mean(axis=(-2, -1), keepdims=True), tr0


def _rel(got, want):
    want = np.asarray(want)
    return np.abs(got.numpy() - want).max() / np.abs(want).max()


def _assert_same(i, jstate, jdiag, tstate, tdiag):
    assert _rel(tstate.q, jstate.q) < 1e-11, f"step {i}: q"
    assert _rel(tstate.psi, jstate.psi) < 1e-11, f"step {i}: psi"
    if jstate.tracers is not None:
        assert _rel(tstate.tracers, jstate.tracers) < 1e-11, f"step {i}: tr"
    else:
        assert tstate.tracers is None
    dt, ke = float(jdiag.dt), float(jdiag.ke)
    assert abs(float(tdiag.dt) - dt) <= 1e-12 * dt, f"step {i}: dt"
    assert abs(float(tdiag.ke) - ke) <= 1e-10 * abs(ke), f"step {i}: ke"
    assert abs(float(tstate.t) - float(jstate.t)) <= 1e-12 * float(jstate.t)
    assert int(tstate.i) == int(jstate.i) == i


def _pair(jcfg, tcfg, fields, psi0, tr0):
    jconst = jqg.build_constants(jcfg, **fields)
    jstate = jqg.init_state(jcfg, jconst, psi0=psi0, tracers0=tr0)
    tconst = tqg.build_constants(tcfg, device="cpu", **fields)
    tstate = tqg.init_state(tcfg, tconst, psi0=psi0, tracers0=tr0)
    return (jconst, jstate, jax.jit(jqg.make_step(jcfg)),
            tconst, tstate, tqg.make_step(tcfg))


@pytest.mark.parametrize("variant", ["coupled", "upg_vpg_flsrv_slip"])
def test_coupled_lockstep_with_jax_step(variant):
    """30 steps at 128^2 x 3 f64. "coupled": psipg, topo, qforc and two
    tracers; the other run builds pp from upg/vpg, advects its relative
    vorticity (_LS_RV) and has partial-slip walls, with one tracer."""
    if variant == "coupled":
        jcfg, tcfg = verron(128, **TRACERS)
        fields, psi0, tr0 = _inputs(jcfg)
    else:
        jcfg, tcfg = verron(128, upg=(0.02, 0.01, 0.0),
                            vpg=(0.01, -0.005, 0.0), flsrv=1, sbc=1.0,
                            nptr=1, Pe=(500.0,), ptr_r=(50.0,))
        _, psi0, tr0 = _inputs(jcfg, 1)
        fields = {}
    jconst, jstate, jstep, tconst, tstate, tstep = _pair(
        jcfg, tcfg, fields, psi0, tr0)
    tnext = jnp.asarray(1e9, jstate.t.dtype)
    before = fused_rhs.launches, fused_tracer.launches
    for i in range(1, 31):
        jstate, jdiag = jstep(jstate, jconst, tnext)
        tstate, tdiag = tstep(tstate, tconst, 1e9)
        _assert_same(i, jstate, jdiag, tstate, tdiag)
    assert (fused_rhs.launches, fused_tracer.launches) == before
    assert tstate.tracers.shape == (3, jcfg.nptr, 128, 128)


@pytest.mark.parametrize("flsrv", [0, 1])
def test_coupling_constants_match_jax(flsrv):
    """pp_pad, zetap_pad, topo_pad, Ro, qforc, ptr_relax and the build-time
    pp face-speed maxima against the JAX package's, from psipg and from
    upg/vpg."""
    jcfg, tcfg = verron(64, flsrv=flsrv, upg=(0.02, 0.01, 0.0),
                        vpg=(0.01, -0.005, 0.0), **TRACERS)
    fields, _, _ = _inputs(jcfg, 2)
    relax = np.random.default_rng(3).standard_normal((3, 2, 64, 64))
    for kw in (dict(fields, ptr_relax=relax), dict(topo=fields["topo"])):
        jc = jqg.build_constants(jcfg, **kw)
        tc = tqg.build_constants(tcfg, device="cpu", **kw)
        for name in ("pp_pad", "zetap_pad", "topo_pad", "qforc",
                     "ptr_relax"):
            j, t = getattr(jc, name), getattr(tc, name)
            assert (j is None) == (t is None), name
            if j is not None:
                np.testing.assert_allclose(
                    t.numpy(), np.asarray(j), rtol=0,
                    atol=1e-13 * np.abs(j).max(), err_msg=name)
        assert (tc.zetap_pad is not None) == bool(flsrv)
        np.testing.assert_allclose(tc.Ro.expand(64, 64).numpy(),
                                   np.asarray(jc.Ro), rtol=1e-15)
        np.testing.assert_allclose(tc.umax_pp.numpy(),
                                   np.asarray(jc.rhsk.umax_pp), rtol=1e-12)
        np.testing.assert_array_equal(tc.pp.numpy(),
                                      tc.pp_pad[:, 1:-1, 1:-1].numpy())
        np.testing.assert_array_equal(tc.topo.numpy(),
                                      tc.topo_pad[1:-1, 1:-1].numpy())
        np.testing.assert_allclose(
            tc.iro.numpy()[:, 0],
            np.asarray(jc.rhsk.iro)[0, 0, 3, 0] * np.ones(64), rtol=1e-15)
    bare = tqg.build_constants(tcfg.__class__(**{
        **tcfg.__dict__, "upg": (), "vpg": ()}).validate(), device="cpu")
    assert bare.pp_pad is None and bare.umax_pp is None and bare.pp is None


@pytest.mark.parametrize("amp", [1e-3, 0.0])
def test_cfl_chain_visits_psi_then_pp_per_layer(amp):
    """cfl_dtmax with a pp: the chain visits psi[l] then pp[l] for each
    layer, sharing the smoothing state (msqg/qg.h:383-391)."""
    from msom_tpu.ops.bc import BC as JBC
    from msom_tpu.ops.ghost import ghosted as jghosted
    jcfg, tcfg = verron(32)
    fields, psi0, _ = _inputs(jcfg, 4)
    psipg = 1e6 * fields["psipg"]        # fast enough to bind the CFL
    psi = amp / 1e-3 * psi0
    jc = jqg.build_constants(jcfg, psipg=psipg)
    tc = tqg.build_constants(tcfg, device="cpu", psipg=psipg)
    dtmax0 = jcfg.dt_clamped()
    for prev in (0.0, 1e-4, 1e9):
        jdt, jprev = jqg.cfl_dtmax(jcfg, jc, jghosted(jnp.asarray(psi),
                                                      JBC.DIRICHLET),
                                   dtmax0, jnp.asarray(prev))
        tdt, tprev = tqg.cfl_dtmax(
            tcfg, tc, tghosted(torch.as_tensor(psi), TBC.DIRICHLET),
            dtmax0, torch.tensor(prev, dtype=torch.float64))
        np.testing.assert_allclose(tdt.numpy(), np.asarray(jdt), rtol=1e-14)
        np.testing.assert_allclose(tprev.numpy(), np.asarray(jprev),
                                   rtol=1e-14)
    # the pp part changes the answer: without it dt is larger
    bare = tqg.build_constants(tcfg, device="cpu")
    tdt0, _ = tqg.cfl_dtmax(
        tcfg, bare, tghosted(torch.as_tensor(psi), TBC.DIRICHLET),
        dtmax0, torch.tensor(1e9, dtype=torch.float64))
    assert float(tdt0) > float(tdt)


def test_jax_checkpoint_with_tracers_resumes_in_the_port(tmp_path):
    """A 10-step coupled JAX state, written by save_state and read with
    np.load, continues in the port for 10 steps in lockstep with the JAX
    run; state_to_numpy gives the leaves back bit for bit, tracers
    included."""
    jcfg, tcfg = verron(64, **TRACERS)
    fields, psi0, tr0 = _inputs(jcfg, 5)
    jconst, jstate, jstep, tconst, _, tstep = _pair(jcfg, tcfg, fields, psi0,
                                                    tr0)
    tnext = jnp.asarray(1e9, jstate.t.dtype)
    for _ in range(10):
        jstate, _ = jstep(jstate, jconst, tnext)
    path = str(tmp_path / "state.npz")
    save_state(path, jstate)
    leaves = dict(np.load(path))
    assert leaves["tracers"].shape == (3, 2, 64, 64)
    tstate = convert.state_from_numpy(tcfg, leaves, device="cpu")
    back = convert.state_to_numpy(tstate)
    for name in ("q", "psi", "t", "dt_prev", "i", "tracers"):
        np.testing.assert_array_equal(back[name], leaves[name])
        assert back[name].dtype == leaves[name].dtype, name
    for i in range(11, 21):
        jstate, jdiag = jstep(jstate, jconst, tnext)
        tstate, tdiag = tstep(tstate, tconst, 1e9)
        _assert_same(i, jstate, jdiag, tstate, tdiag)


def test_state_from_numpy_checks_the_tracers_leaf():
    _, with_tr = verron(16, **TRACERS)
    _, without = verron(16)
    leaves = {"q": np.zeros((3, 16, 16)), "psi": np.zeros((3, 16, 16)),
              "t": np.float64(0), "dt_prev": np.float64(0), "i": np.int32(0)}
    tr = np.zeros((3, 2, 16, 16))
    with pytest.raises(ValueError, match="tracers"):
        convert.state_from_numpy(with_tr, leaves, device="cpu")
    with pytest.raises(ValueError, match="tracers"):
        convert.state_from_numpy(without, {**leaves, "tracers": tr},
                                 device="cpu")
    with pytest.raises(ValueError, match="shape"):
        convert.state_from_numpy(with_tr, {**leaves, "tracers": tr[:, :1]},
                                 device="cpu")
    state = convert.state_from_numpy(with_tr, {**leaves, "tracers": tr},
                                     device="cpu")
    assert state.tracers.shape == (3, 2, 16, 16)


def test_tracer_noise_ic_from_a_torch_generator():
    """Without tracers0 the tracers draw 1e-3 noise from the same generator
    as psi, after it; tracers0 of the wrong shape is refused."""
    _, tcfg = verron(32, **TRACERS)
    const = tqg.build_constants(tcfg, device="cpu")
    a = tqg.init_state(tcfg, const, seed=5)
    b = tqg.init_state(tcfg, const,
                       generator=torch.Generator().manual_seed(5))
    assert torch.equal(a.tracers, b.tracers) and torch.equal(a.psi, b.psi)
    assert a.tracers.shape == (3, 2, 32, 32)
    assert 0 < a.tracers.abs().max() <= 1e-3
    _, bare = verron(32)
    assert torch.equal(tqg.init_state(bare, const, seed=5).psi, a.psi)
    with pytest.raises(ValueError, match="tracers0"):
        tqg.init_state(tcfg, const, tracers0=np.zeros((3, 1, 32, 32)))
