"""The msqg Froude-number input `frpg` (the PG coupling's 2-D field) in
the port against the JAX package, f64 on the CPU at 32^2 x 3 with the
coupling workflow's QG physics (tests/test_coupling_workflow.py:59-65).

A strl = (Fr/Ro)^2 that varies in x is no mode of the fused tendency in
either package (pallas_rhs.strl_profile): the port's constants then say
rhs_kernel = False and the step runs the tendency as torch ops, with full-
field multigrid levels. A strl that varies in y only keeps the kernel.

Tolerances: 20 steps to 1e-10 of max|q| and max|psi| with the same
V-cycles every step (layered and mode_pv_invert), the energy budget to
1e-12 (the stencils in the same order), a filter event's q to 1e-12 and
its psi and flux, which the multigrid re-inverts, to 1e-10, the backed-up
frpg file within float32 rounding."""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from msom_tpu import driver as jdriver
from msom_tpu.models import qg as jqg
from msom_tpu.models.pallas_rhs import strl_profile
from msom_tpu.models import qg_energy as jen
from msom_tpu.ops import wavelet as jwv
from msom_tpu.params import QGConfig as JConfig
from msom_tpu_torch import driver as tdriver
from msom_tpu_torch.io import bas as tbas
from msom_tpu_torch.models import qg as tqg
from msom_tpu_torch.models import qg_energy as ten
from msom_tpu_torch.ops import wavelet as twv
from msom_tpu_torch.params import QGConfig as TConfig
from msom_tpu_torch.solvers import vary as tvary

torch.set_num_threads(1)

N = 32
QG = dict(N=N, nl=3, L0=1.0, Rom=0.2, Ekb=0.002, tau0=1e-5, Re4=50.0,
          beta=0.5, Fr=(0.003, 0.004), dh=(0.25, 0.25, 0.5), DT=2e-2,
          tend=1e18, dtout=1e18, dtflt=0.1, afilt=10.0, Lfmax=0.5, CFL=0.5,
          solver="mg", dtype="float64")


def configs(**kw):
    base = dict(QG, **kw)
    return JConfig(**base).validate(), TConfig(**base).validate()


def rel(got, want):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-300)


def frpg_field(vary="xy"):
    """Fr at the two interfaces (and a zero third block, as the coupling
    writes it): varying in x and y, or in y only."""
    x = (np.arange(N) + 0.5) / N
    X, Y = np.meshgrid(x, x, indexing="xy")
    if vary == "y":
        X = np.zeros_like(X)
    return np.stack([0.003 * (1 + 0.3 * np.sin(2 * np.pi * X)
                              * np.cos(np.pi * Y) + 0.2 * Y),
                     0.004 * (1 + 0.2 * np.cos(2 * np.pi * X + Y)),
                     np.zeros((N, N))])


def inputs(vary="xy"):
    x = (np.arange(N) + 0.5) / N
    psipg = 0.02 * np.sin(np.pi * x)[None, :, None] * np.sin(
        np.pi * x)[None, None, :] * np.array([1.0, 0.5, 0.1])[:, None, None]
    rdpg = 0.3 + 0.1 * np.outer(x, x)
    return dict(frpg=frpg_field(vary), psipg=psipg, rdpg=rdpg)


@functools.cache
def jax_step(jcfg):
    """One jitted JAX step a configuration, shared by the cases whose
    constants differ only in their values."""
    return jax.jit(jqg.make_step(jcfg))


def psi_ic(seed=0):
    return 1e-3 * np.random.default_rng(seed).uniform(-1, 1, (3, N, N))


@pytest.mark.parametrize("vary,modal", [("xy", False), ("xy", True),
                                        ("y", False), ("y", True)])
def test_frpg_step_matches_jax(vary, modal):
    """20 mg steps with the coupling fields: the same V-cycles every step,
    q and psi to 1e-10. x-varying: the tendency as torch ops and full-field
    levels; y-varying: the kernel's route (profiles on every level)."""
    jcfg, tcfg = configs(mode_pv_invert=modal)
    fields = inputs(vary)
    jc = jqg.build_constants(jcfg, **fields)
    tc = tqg.build_constants(tcfg, device="cpu", **fields)
    # the JAX package's kernel gate decides the same
    assert tc.rhs_kernel == (vary == "y") == strl_profile(jc.strl)[0]
    assert tuple(tc.strl.shape) == (2, N, N if vary == "xy" else 1)
    assert rel(tc.strl.expand(2, N, N), jc.strl) == 0
    levels = tc.mlevels if modal else tc.levels
    assert all((lvl.sw is None) == (vary == "xy") for lvl in levels)
    assert rel(tc.Rd, jc.Rd) < 1e-12 and rel(tc.sig_filt, jc.sig_filt) < 1e-12
    if modal:
        assert rel(tc.iBu.expand(3, N, N), jc.iBu) < 1e-12
        assert tc.l2m.ndim == {"xy": 4, "y": 3}[vary]
    js = jqg.init_state(jcfg, jc, psi0=psi_ic())
    ts = tqg.init_state(tcfg, tc, psi0=psi_ic())
    jstep, tstep = jax_step(jcfg), tqg.make_step(tcfg)
    for i in range(20):
        js, jd = jstep(js, jc, jnp.asarray(1e18))
        ts, td = tstep(ts, tc, 1e18)
        assert td.mg_iters == int(jd.mg_iters), f"step {i}"
    assert rel(ts.q, js.q) < 1e-10 and rel(ts.psi, js.psi) < 1e-10
    assert float(ts.t) == pytest.approx(float(js.t), rel=1e-12)


@pytest.fixture(scope="module")
def coupled():
    """Both packages' constants with the x-varying frpg, and a state
    after a few port steps (the same numpy psi for both)."""
    jcfg, tcfg = configs(ediag=0)
    fields = inputs()
    jc = jqg.build_constants(jcfg, **fields)
    tc = tqg.build_constants(tcfg, device="cpu", **fields)
    ts = tqg.init_state(tcfg, tc, psi0=1e2 * psi_ic(3))
    step = tqg.make_step(tcfg)
    for _ in range(3):
        ts, _ = step(ts, tc, 1e18)
    return jcfg, tcfg, jc, tc, ts


def test_energy_tend_with_a_2d_strl(coupled):
    jcfg, tcfg, jc, tc, ts = coupled
    psi = ts.psi.numpy()
    jacc = jen.energy_tend(jcfg, jc, jen.init_energy(jcfg),
                           jnp.asarray(psi), 0.02)
    tacc = ten.energy_tend(tcfg, tc, ten.init_energy(tcfg, device="cpu"),
                           ts.psi, 0.02)
    for name in ten.FIELDS:
        want = np.asarray(getattr(jacc, name))
        if np.abs(want).max() > 0:
            assert rel(getattr(tacc, name), want) < 1e-12, name


def test_filter_event_with_a_2d_strl(coupled):
    jcfg, tcfg, jc, tc, ts = coupled
    js = jqg.init_state(jcfg, jc, psi0=ts.psi.numpy())
    js = jwv.wavelet_filter_step(jcfg, jc, js)
    tsf = twv.wavelet_filter_step(
        tcfg, tc, tqg.init_state(tcfg, tc, psi0=ts.psi.numpy()))
    assert int(tsf.nbar) == int(js.nbar) == 1
    assert rel(tsf.q, js.q) < 1e-12
    # psi and the flux come from the multigrid's re-inversion
    for name in ("psi", "qof"):
        assert rel(getattr(tsf, name), getattr(js, name)) < 1e-10, name


def test_output_writer_backs_up_the_2d_frpg(coupled, tmp_path):
    jcfg, tcfg, jc, tc, _ = coupled
    jdriver.OutputWriter(jcfg, jc, outdir=str(tmp_path / "jax"))
    tdriver.OutputWriter(tcfg, tc, outdir=str(tmp_path / "port"))
    name = f"frpg_3l_N{N}.bas"
    got = tbas.read_bas(str(tmp_path / "port" / name))[0]
    want = tbas.read_bas(str(tmp_path / "jax" / name))[0]
    assert got.shape == want.shape == (2, N, N)
    assert np.abs(got - want).max() <= 2.0 ** -23 * np.abs(want).max()
    assert np.abs(got - frpg_field()[:2]).max() <= 1e-7 * 0.005


def test_spectral_refusals():
    """x-varying strl: the JAX package's ValueError; y-varying with walls:
    the direct y-profile solve (solvers/vary.py, tested against the JAX
    package in tests/test_torch_vary.py); periodic: ValueError; a frpg of
    the wrong size: ValueError."""
    _, tcfg = configs(solver="spectral")
    with pytest.raises(ValueError, match="use solver='mg'"):
        tqg.build_constants(tcfg, device="cpu", frpg=frpg_field())
    tc = tqg.build_constants(tcfg, device="cpu", frpg=frpg_field("y"))
    assert tc.rhs_kernel and isinstance(tc.spec, tvary.VarySpectralData)
    _, pcfg = configs(solver="spectral", sbc=-1.0)
    with pytest.raises(ValueError, match="use solver='mg'"):
        tqg.build_constants(pcfg, device="cpu", frpg=frpg_field("y"))
    # a frpg uniform in both directions is the config's Fr: spectral runs
    uniform = np.ones((2, N, N)) * np.array([0.003, 0.004])[:, None, None]
    tc = tqg.build_constants(tcfg, device="cpu", frpg=uniform)
    assert tc.rhs_kernel and tc.spec is not None
    _, mcfg = configs()
    with pytest.raises(ValueError, match="frpg"):
        tqg.build_constants(mcfg, device="cpu", frpg=np.zeros((1, N, N)))
