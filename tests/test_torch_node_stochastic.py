"""The port's qg-node stochastic forcing (qg-node/qg_stochastic.h: a white
normal field high-passed by the wavelet pyramid) against the JAX package in
float64 on the CPU.

torch.Generator and jax.random draw different numbers from one seed, so
the port splits generate_noise into a draw (`draw_white`) and a plain
function of the white field (`filter_noise`). The filter is held against
JAX's generate_noise fed with JAX's own white field (jax.random.normal(key,
shape) x amp_stoch, recomputed here), walled (Neumann pyramid, edge-padded
return to the nodes, times the default or the coastline mask) and periodic,
within 1e-13 of its maximum; the draw in distribution (mean and std of the
normalised field within four standard errors); the step at amp_stoch = 0
equals the deterministic step bit for bit and the JAX stochastic step
within 1e-11 over 10 steps; and the kick of one step is the drawn noise."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from msom_tpu.models import qg_node as jqn
from msom_tpu_torch.models import qg_node as tqn

torch.set_num_threads(1)


def _kw(**kw):
    base = dict(N=32, nl=3, L0=100.0, f0=10.0, beta=0.5, hEkb=1e-3,
                tau0=1e-3, tau1=5e-4, tf1=2.0, tf2=3.0, dy_ws=0.3, nu=5.0,
                dh=(0.2, 0.3, 0.5), N2=(1.0, 2.0), noise_init=1e-3,
                bc_fac=1.0, DT=5e-2, tend=10.0, dtout=10.0, CFL=0.2,
                TOLERANCE=1e-10, stochastic=True, amp_stoch=1e-4,
                L_filt_stoch=20.0, dtype="float64", use_pallas=False)
    base.update(kw)
    return base


GRIDS = {"walled": ({}, {}),
         "coastline": (dict(solver="vmg"), "coast"),
         "periodic": (dict(bc_fac=-1.0), {}),
         "white": (dict(L_filt_stoch=0.0), {})}


def _both(kw, inputs):
    jcfg, tcfg = jqn.NodeQGConfig(**kw), tqn.NodeQGConfig(**kw)
    return (jcfg, jqn.build_constants(jcfg, **inputs), tcfg,
            tqn.build_constants(tcfg, device="cpu", **inputs))


def _rel(got, want):
    want = np.asarray(want)
    return np.abs(got.numpy() - want).max() / np.abs(want).max()


@pytest.mark.parametrize("grid", list(GRIDS))
def test_noise_filter_matches_jax(grid):
    over, inputs = GRIDS[grid]
    if inputs == "coast":
        inputs = dict(mask=tqn.coastline_mask(32))
    jcfg, jc, tcfg, tc = _both(_kw(**over), inputs)
    n = 32 if tcfg.periodic else 33
    shape = (3, n, n)
    key = jax.random.PRNGKey(7)
    want = jqn.generate_noise(jcfg, jc, key, shape)
    white = jax.random.normal(key, shape, jnp.float64) * jcfg.amp_stoch
    got = tqn.filter_noise(tcfg, tc, torch.as_tensor(np.array(white)))
    assert got.shape == shape
    assert _rel(got, want) < 1e-13
    if grid == "white":
        assert tc.sig_noise is None
        np.testing.assert_array_equal(got.numpy(), np.asarray(white))
    else:
        assert len(tc.sig_noise) == 6
        # the large scales are damped: the filtered field is smoother
        assert float(got.abs().max()) < float(np.abs(white).max())
    if grid in ("walled", "coastline"):
        assert not (got * (1 - tc.mask)).any()


@pytest.mark.parametrize("periodic", [False, True])
def test_noise_draw_in_distribution(periodic):
    """The normalised white draw xi = white / amp_stoch, n = 3 x 64^2 or
    3 x 65^2 samples, has |mean| < 4 / sqrt(n) and |std - 1| < 4 /
    sqrt(2 n), four standard errors of a standard normal sample (seeded,
    so deterministic); generate_noise is filter_noise of that draw."""
    tcfg = tqn.NodeQGConfig(**_kw(N=64, bc_fac=-1.0 if periodic else 1.0))
    tc = tqn.build_constants(tcfg, device="cpu")
    n = 64 if periodic else 65
    white = tqn.draw_white(tcfg, tc, torch.Generator().manual_seed(1),
                           (3, n, n))
    xi = white.numpy() / tcfg.amp_stoch
    m = xi.size
    assert abs(xi.mean()) < 4 / np.sqrt(m)
    assert abs(xi.std() - 1) < 4 / np.sqrt(2 * m)
    noise = tqn.generate_noise(tcfg, tc, torch.Generator().manual_seed(1),
                               (3, n, n))
    assert torch.equal(noise, tqn.filter_noise(tcfg, tc, white))


@pytest.mark.parametrize("periodic", [False, True])
def test_step_at_zero_amplitude(periodic):
    """amp_stoch = 0: the stochastic step draws and adds nothing, so it is
    the deterministic step bit for bit, and agrees with the JAX stochastic
    step at amp_stoch = 0 as a deterministic one (10 steps)."""
    kw = _kw(amp_stoch=0.0, bc_fac=-1.0 if periodic else 1.0)
    jcfg, jc, tcfg, tc = _both(kw, {})
    det = dataclasses.replace(tcfg, stochastic=False)
    n = 32 if periodic else 33
    psi0 = 1e-3 * np.random.default_rng(3).uniform(-1, 1, (3, n, n))
    js = jqn.init_state(jcfg, jc, psi0=psi0)
    ts = tqn.init_state(tcfg, tc, psi0=psi0)
    ds = tqn.init_state(det, tc, psi0=psi0)
    jstep = jax.jit(jqn.make_step(jcfg))
    tstep = tqn.make_step(tcfg, torch.Generator().manual_seed(4))
    dstep = tqn.make_step(det)
    tnext = jnp.asarray(1e18, jnp.float64)
    for i in range(1, 11):
        js, jd = jstep(js, jc, tnext)
        ts, td = tstep(ts, tc, 1e18)
        ds, _ = dstep(ds, tc, 1e18)
        assert torch.equal(ts.q, ds.q) and torch.equal(ts.psi, ds.psi)
        assert _rel(ts.q, js.q) < 1e-11, f"step {i}: q"
        assert _rel(ts.psi, js.psi) < 1e-11, f"step {i}: psi"
        assert float(td.dt) == pytest.approx(float(jd.dt), rel=1e-12)


def test_one_step_kick_is_the_drawn_noise():
    """One step from the same state with amp_stoch = A and 0, the same
    seed (the step draws once): psi is the inversion of the predictor q,
    so with the exact spectral solve comp_q(psi_A - psi_0) is the
    predictor's share of the kick, noise x sqrt(dt) / 2, to 1e-10 of its
    maximum (amp_stoch = 1e-2 makes the kick's psi large enough against
    psi's roundoff); the kick is there."""
    tcfg = tqn.NodeQGConfig(**_kw(amp_stoch=1e-2))
    tc = tqn.build_constants(tcfg, device="cpu")
    assert tc.nspec is not None
    st = tqn.init_state(tcfg, tc, seed=5)
    quiet = dataclasses.replace(tcfg, amp_stoch=0.0)
    a, da = tqn.make_step(tcfg, torch.Generator().manual_seed(9))(
        st, tc, 1e18)
    b, _ = tqn.make_step(quiet, torch.Generator().manual_seed(9))(
        st, tc, 1e18)
    noise = tqn.generate_noise(tcfg, tc, torch.Generator().manual_seed(9),
                               st.q.shape)
    kick = noise * torch.sqrt(da.dt) / 2
    share = tqn.comp_q(tcfg, tc, a.psi - b.psi)
    inner = (slice(None), slice(1, -1), slice(1, -1))
    err = (share[inner] - kick[inner]).abs().max() / kick.abs().max()
    assert float(err) < 1e-10
    assert not torch.equal(a.q, b.q)


def test_stochastic_step_needs_a_generator():
    tcfg = tqn.NodeQGConfig(**_kw())
    with pytest.raises(ValueError, match="Generator"):
        tqn.make_step(tcfg)
