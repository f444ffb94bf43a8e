"""The port's msqg step (msom_tpu_torch.models.qg.make_step) in lockstep
with the JAX package's jitted step on the Verron double gyre at 64^2 x 3 in
float64, from one numpy IC; the GOLDEN.md KE trajectory; a JAX state
carried into the port through its checkpoint leaves; and the configurations
not ported yet, which must refuse to run.

Tolerances are those of tests/test_lockstep.py: relq, relpsi < 1e-11,
dt to 1e-12 and KE to 1e-10 relative, GOLDEN.md KE to 1e-9."""

import re

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from msom_tpu.io.checkpoint import save_state
from msom_tpu.models import qg as jqg
from msom_tpu.params import QGConfig as JConfig
from msom_tpu_torch import convert
from msom_tpu_torch.models import fused_rhs
from msom_tpu_torch.models import qg as tqg
from msom_tpu_torch.params import QGConfig as TConfig

torch.set_num_threads(1)


def verron(N, **kw):
    """tests/test_lockstep.py's deck, for both packages."""
    base = dict(N=N, nl=3, L0=80, Rom=0.025, Ekb=0.002, tau0=1e-4, Re4=1563,
                beta=0.5, Fr=(0.0023669, 0.0076173), dh=(0.06, 0.14, 0.8),
                DT=5e-2, tend=500., dtout=1., CFL=0.6, dtype="float64",
                solver="spectral")
    base.update(kw)
    return JConfig(**base).validate(), TConfig(**base).validate()


def _psi0(cfg, seed=42):
    rng = np.random.default_rng(seed)
    psi0 = 1e-3 * rng.uniform(-1, 1, (cfg.nl, cfg.N, cfg.N))
    return psi0 - psi0.mean(axis=(-2, -1), keepdims=True)


def _golden_ke():
    with open("GOLDEN.md") as f:
        text = f.read()
    sec = text.split('solver="spectral" (exact)')[1].split("##")[0]
    golden = {}
    for line in sec.splitlines():
        mm = re.match(r"\| (\d+) \| [\d.]+ \| [\d.e+-]+ \| ([\d.e+-]+) \|",
                      line)
        if mm:
            golden[int(mm.group(1))] = float(mm.group(2))
    return golden


def _assert_same(i, jstate, jdiag, tstate, tdiag):
    q, psi = np.asarray(jstate.q), np.asarray(jstate.psi)
    relq = np.abs(tstate.q.numpy() - q).max() / np.abs(q).max()
    relpsi = np.abs(tstate.psi.numpy() - psi).max() / np.abs(psi).max()
    assert relq < 1e-11, f"step {i}: relq={relq:.3e}"
    assert relpsi < 1e-11, f"step {i}: relpsi={relpsi:.3e}"
    dt, ke = float(jdiag.dt), float(jdiag.ke)
    assert abs(float(tdiag.dt) - dt) <= 1e-12 * dt, f"step {i}: dt"
    assert abs(float(tdiag.ke) - ke) <= 1e-10 * abs(ke), f"step {i}: ke"
    assert abs(float(tstate.t) - float(jstate.t)) <= 1e-12 * float(jstate.t)
    assert int(tstate.i) == int(jstate.i) == i


@pytest.mark.parametrize("nl", [1, 3])
def test_derived_constants_match_jax(nl):
    """build_constants: the y-profiles of strl and wind broadcast to the JAX
    package's (N, N) fields, the layer metrics, and the solve's inv_den."""
    kw = {} if nl == 3 else dict(nl=1, Fr=(), dh=(1.0,))
    jcfg, tcfg = verron(32, **kw)
    jc = jqg.build_constants(jcfg)
    tc = tqg.build_constants(tcfg, device="cpu")
    N = jcfg.N
    np.testing.assert_allclose(tc.wind.expand(N, N).numpy(),
                               np.asarray(jc.wind), rtol=1e-13, atol=0)
    if nl > 1:
        np.testing.assert_allclose(tc.strl.expand(nl - 1, N, N).numpy(),
                                   np.asarray(jc.strl), rtol=1e-13, atol=0)
    else:
        assert tc.strl is None and jc.strl is None
    assert tc.idh0 == jc.idh0 and tc.idh1 == jc.idh1
    np.testing.assert_allclose(tc.spec.inv_den.numpy(),
                               np.asarray(jc.spec.inv_den), rtol=1e-13)


@pytest.mark.parametrize("transform", ["auto", "factored"])
def test_lockstep_with_jax_step(transform):
    """50 steps at 64^2 x 3 f64: "auto" takes the FFT DST on both sides,
    "factored" the folded matmul DST."""
    jcfg, tcfg = verron(64, transform=transform)
    psi0 = _psi0(jcfg)
    jconst = jqg.build_constants(jcfg)
    jstate = jqg.init_state(jcfg, jconst, psi0=psi0)
    jstep = jax.jit(jqg.make_step(jcfg))
    tconst = tqg.build_constants(tcfg, device="cpu")
    tstate = tqg.init_state(tcfg, tconst, psi0=psi0)
    tstep = tqg.make_step(tcfg)
    np.testing.assert_allclose(tstate.q.numpy(), np.asarray(jstate.q),
                               rtol=0, atol=1e-13 * np.abs(jstate.q).max())
    golden, kes = _golden_ke(), {}
    tnext = jnp.asarray(1e9, jstate.t.dtype)
    for i in range(1, 51):
        jstate, jdiag = jstep(jstate, jconst, tnext)
        tstate, tdiag = tstep(tstate, tconst, 1e9)
        _assert_same(i, jstate, jdiag, tstate, tdiag)
        kes[i] = float(tdiag.ke)
    checked = [i for i in (1, 5, 10, 25, 50) if i in golden]
    assert len(checked) == 5
    for i in checked:
        assert abs(kes[i] - golden[i]) <= 1e-9 * abs(golden[i]), i


@pytest.mark.parametrize("amp,prev", [(1e-3, 0.0), (1e-3, 1e-4),
                                      (1e-3, 1e9), (0.0, 0.0)])
def test_cfl_chain_and_dtnext_match_jax(amp, prev):
    """cfl_dtmax from psi (the smoothing recurrence off, on, and the
    still-fluid case where no face moves), then dtnext landing on an event
    time that is a fraction of a step, a few steps, or far away."""
    from msom_tpu.ops.bc import BC as JBC
    from msom_tpu.ops.ghost import ghosted as jghosted
    from msom_tpu_torch.ops.bc import BC as TBC
    from msom_tpu_torch.ops.ghost import ghosted as tghosted
    jcfg, tcfg = verron(32)
    psi = amp * _psi0(jcfg, 9)
    dtmax0 = jcfg.dt_clamped()
    jdt, jprev = jqg.cfl_dtmax(jcfg, jqg.build_constants(jcfg),
                               jghosted(jnp.asarray(psi), JBC.DIRICHLET),
                               dtmax0, jnp.asarray(prev))
    tdt, tprev = tqg.cfl_dtmax(tcfg, tqg.build_constants(tcfg, device="cpu"),
                               tghosted(torch.as_tensor(psi), TBC.DIRICHLET),
                               dtmax0, torch.tensor(prev, dtype=torch.float64))
    np.testing.assert_allclose(tdt.numpy(), np.asarray(jdt), rtol=1e-14)
    np.testing.assert_allclose(tprev.numpy(), np.asarray(jprev), rtol=1e-14)
    for t, tnext in [(0.0, 0.3 * float(tdt)), (1.0, 1.0 + 3.5 * float(tdt)),
                     (0.0, 1e9)]:
        want = jqg.dtnext(jnp.asarray(t), jnp.asarray(tnext), jdt)
        got = tqg.dtnext(torch.tensor(t, dtype=torch.float64),
                         torch.tensor(tnext, dtype=torch.float64), tdt)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-14)


def test_jax_checkpoint_resumes_in_the_port(tmp_path):
    """A 20-step JAX state, written by save_state and read with np.load,
    continues in the port for 10 steps in lockstep with the JAX run; the
    port's state_to_numpy gives the leaves back bit for bit."""
    jcfg, tcfg = verron(64)
    jconst = jqg.build_constants(jcfg)
    jstate = jqg.init_state(jcfg, jconst, psi0=_psi0(jcfg, 3))
    jstep = jax.jit(jqg.make_step(jcfg))
    tnext = jnp.asarray(1e9, jstate.t.dtype)
    for _ in range(20):
        jstate, _ = jstep(jstate, jconst, tnext)
    path = str(tmp_path / "state.npz")
    save_state(path, jstate)
    leaves = dict(np.load(path))
    assert "key" in leaves           # ignored by the port
    tstate = convert.state_from_numpy(tcfg, leaves, device="cpu")
    back = convert.state_to_numpy(tstate)
    for name in ("q", "psi", "t", "dt_prev", "i"):
        np.testing.assert_array_equal(back[name], leaves[name])
        assert back[name].dtype == leaves[name].dtype, name
    tconst = tqg.build_constants(tcfg, device="cpu")
    tstep = tqg.make_step(tcfg)
    for i in range(21, 31):
        jstate, jdiag = jstep(jstate, jconst, tnext)
        tstate, tdiag = tstep(tstate, tconst, 1e9)
        _assert_same(i, jstate, jdiag, tstate, tdiag)


def test_state_from_numpy_refuses_what_it_cannot_carry():
    _, tcfg = verron(16)
    leaves = {"q": np.zeros((3, 16, 16)), "psi": np.zeros((3, 16, 16)),
              "t": np.float64(0), "dt_prev": np.float64(0),
              "i": np.int32(0)}
    with pytest.raises(ValueError, match="qof"):
        convert.state_from_numpy(tcfg, {**leaves, "qof": 0}, device="cpu")
    with pytest.raises(ValueError, match="shape"):
        convert.state_from_numpy(tcfg, {**leaves, "q": np.zeros((3, 8, 8))},
                                 device="cpu")


def test_noise_ic_from_a_torch_generator():
    """The noise IC draws from a torch.Generator: reproducible from its
    seed, zero-mean per layer, 1e-3 in amplitude (a different stream from
    jax.random, so lockstep runs share psi0 instead)."""
    _, tcfg = verron(32)
    const = tqg.build_constants(tcfg, device="cpu")
    a = tqg.init_state(tcfg, const, seed=5)
    b = tqg.init_state(tcfg, const,
                       generator=torch.Generator().manual_seed(5))
    assert torch.equal(a.psi, b.psi) and torch.equal(a.q, b.q)
    assert a.psi.abs().max() <= 2e-3
    assert a.psi.mean(dim=(-2, -1)).abs().max() < 1e-18
    c = tqg.init_state(tcfg, const, seed=6)
    assert not torch.equal(a.psi, c.psi)


def test_step_on_cpu_launches_no_kernel():
    _, tcfg = verron(32)
    const = tqg.build_constants(tcfg, device="cpu")
    state = tqg.init_state(tcfg, const, seed=0)
    step = tqg.make_step(tcfg)
    before = fused_rhs.launches
    state, diag = step(state, const, 1e9)
    assert fused_rhs.launches == before
    assert diag.dt.ndim == 0 and diag.ke.ndim == 0 and float(diag.dt) > 0


@pytest.mark.parametrize("override,match", [
    (dict(varRo=1, sbc=-1.0), "use solver='mg'"),
])
def test_configs_outside_the_slice_raise(override, match):
    """varRo is ported (tests/test_torch_vary.py); the spectral solve of a
    periodic varRo has no direct form, and raises the JAX package's
    ValueError."""
    _, tcfg = verron(16, **override)
    with pytest.raises(ValueError, match=match):
        tqg.build_constants(tcfg, device="cpu")


@pytest.mark.parametrize("name", ["frpg"])
def test_input_fields_outside_the_slice_raise(name):
    """An input field of the wrong shape raises ValueError naming it (frpg
    is ported: a field needs nl-1 or more (N, N) blocks); a field that
    build_constants does not know raises TypeError."""
    _, tcfg = verron(16)
    with pytest.raises(ValueError, match=name):
        tqg.build_constants(tcfg, device="cpu", **{name: np.zeros(1)})
    with pytest.raises(TypeError):
        tqg.build_constants(tcfg, device="cpu", not_a_field=None)
