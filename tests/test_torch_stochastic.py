"""The port's stochastic msqg (Euler-Maruyama forcing, qg_stochastic.h)
against the JAX package: the plain version of K1's stochastic mode against
the Pallas kernel in interpret mode and qg.rhs, walled and periodic, with
and without a large-scale streamfunction; the step at amp_stoch = 0 in
lockstep with the JAX step; the s_stoch constant; and the kick itself,
which can agree only in distribution (PARITY.md §2.1: torch.Generator and
jax.random draw different numbers from one seed).

Tolerances: dq and the face-speed maxima as in tests/test_pallas_rhs.py
(atol 1e-12 x max(|dq|, 1), rtol 1e-12); the steps at amp_stoch = 0 to
1e-11 of max|q| and max|psi| over 10 steps (tests/test_lockstep.py's). The
distribution test's bounds are stated where it makes them."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from msom_tpu.models import qg as jqg
from msom_tpu_torch.models import fused_rhs
from msom_tpu_torch.models import qg as tqg

from test_torch_periodic import (FLOW, _check_rhs, _configs, _psi, _rel,
                                 _smooth, _verron)

torch.set_num_threads(1)

STOCH = dict(stochastic=True, tr_stoch=50.0)


@pytest.mark.parametrize("sbc", [0.0, -1.0])
@pytest.mark.parametrize("with_pp", [False, True])
def test_stochastic_rhs_matches_pallas_and_xla(sbc, with_pp):
    """K1's stochastic mode (pallas_rhs.py:526-564): layer 0 without its
    self-advection, the cascade without J(psi_l, psi_l+1), -q / tr_stoch;
    beta and the pp terms stay."""
    over = dict(sbc=sbc, **STOCH, **(FLOW if with_pp else {}))
    inputs = {}
    if with_pp and sbc == 0.0:
        inputs["psipg"] = _smooth(np.random.default_rng(1), (3, 64, 64), 64)
    jcfg, tcfg = _configs(**over)
    _check_rhs(jcfg, tcfg, _psi((3, 64, 64), 3), **inputs)


def test_stochastic_rhs_differs_from_the_deterministic_one_as_it_should():
    """The stochastic tendency minus the standard one is -J(psi_0, zeta_0)
    removed from layer 0, the self part of the cascade removed, and
    -q / tr_stoch; at nl = 1 nothing differs (no advection block)."""
    _, det = _configs(sbc=0.0)
    stoch = dataclasses.replace(det, **STOCH)
    const = tqg.build_constants(det, device="cpu")
    psi = torch.as_tensor(_psi((3, 64, 64), 4))
    q = tqg.comp_q(det, const, psi)
    d0 = fused_rhs.rhs_fused_reference(det, const, psi)[0]
    d1 = fused_rhs.rhs_fused_reference(stoch, const, psi, q)[0]
    assert (d1 - d0).abs().max() > 0
    _, one = _configs(sbc=0.0, nl=1, Fr=())
    c1 = tqg.build_constants(one, device="cpu")
    p1 = torch.as_tensor(_psi((1, 64, 64), 5))
    q1 = tqg.comp_q(one, c1, p1)
    assert torch.equal(
        fused_rhs.rhs_fused_reference(one, c1, p1)[0],
        fused_rhs.rhs_fused_reference(dataclasses.replace(one, **STOCH), c1,
                                      p1, q1)[0])


def test_s_stoch_matches_jax():
    jcfg, tcfg = _verron(sbc=0.0, **STOCH)
    s = 0.5 + np.random.default_rng(2).uniform(0, 1, (3, 64, 64))
    jc = jqg.build_constants(jcfg, s_stoch=s)
    tc = tqg.build_constants(tcfg, device="cpu", s_stoch=s)
    np.testing.assert_array_equal(tc.s_stoch.numpy(), np.asarray(jc.s_stoch))
    with pytest.raises(ValueError, match="s_stoch"):
        tqg.build_constants(tcfg, device="cpu", s_stoch=s[:2])


@pytest.mark.parametrize("sbc", [0.0, -1.0])
def test_stochastic_step_at_zero_amplitude_matches_jax(sbc):
    """amp_stoch = 0: both steps draw their noise and add none of it, so
    they agree as deterministic steps (10 steps at 64^2 x 3)."""
    jcfg, tcfg = _verron(sbc=sbc, amp_stoch=0.0, **STOCH)
    rng = np.random.default_rng(0)
    psi0 = 1e-3 * rng.uniform(-1, 1, (3, 64, 64))
    jc = jqg.build_constants(jcfg)
    js = jqg.init_state(jcfg, jc, psi0=psi0)
    tc = tqg.build_constants(tcfg, device="cpu")
    ts = tqg.init_state(tcfg, tc, psi0=psi0)
    jstep = jax.jit(jqg.make_step(jcfg))
    tstep = tqg.make_step(tcfg, torch.Generator().manual_seed(3))
    tnext = jnp.asarray(1e9, js.t.dtype)
    for i in range(1, 11):
        js, jd = jstep(js, jc, tnext)
        ts, td = tstep(ts, tc, 1e9)
        assert _rel(ts.q, js.q) < 1e-11, f"step {i}: q"
        assert _rel(ts.psi, js.psi) < 1e-11, f"step {i}: psi"
        assert abs(float(td.dt) - float(jd.dt)) <= 1e-12 * float(jd.dt)


def test_stochastic_kick_in_distribution():
    """One step from the same state with amp_stoch = A and 0, the same
    generator seed on both sides (each step draws once), for the port and
    for the JAX package (the same key). The state's psi comes from the
    inversion of the predictor q1, so comp_q(psi_A - psi_0) is the
    predictor's share of the kick, exactly (the spectral solve is linear
    and exact to roundoff); q_A - q_0 is the corrector's, to within the
    corrector tendency's response to the predictor's kick.

    Held: (1) the port's predictor share is the regenerated draw x
    sqrt(dt) / 2 to 1e-10; (2) its normalised draw xi = 2 share / (A sigma
    sqrt(dt)), n = 3 x 64^2 = 12288 samples, has |mean| < 4 / sqrt(n) and
    |std - 1| < 4 / sqrt(2 n), four standard errors of a standard normal
    sample (the draw is seeded, so the test is deterministic), and so has
    the JAX package's; (3) the corrector's share is twice the predictor's
    to 1e-2 of its maximum (dt times the linear operator's response to a
    grid-scale kick: biharmonic dissipation 0.017 dt, damping dt / 50 at
    this grid, dt = 0.05)."""
    A, N = 1e-5, 64
    sigma = 1.0 + 0.5 * np.sin(np.linspace(0, 3 * np.pi, N))[None, :, None] \
        * np.ones((3, N, N))
    jcfg, tcfg = _verron(sbc=0.0, amp_stoch=A, **STOCH)
    rng = np.random.default_rng(8)
    psi0 = 1e-3 * rng.uniform(-1, 1, (3, N, N))
    n = sigma.size
    shares = {}
    # the port
    tc = tqg.build_constants(tcfg, device="cpu", s_stoch=sigma)
    ts = tqg.init_state(tcfg, tc, psi0=psi0)
    out = {}
    for amp in (A, 0.0):
        cfg = dataclasses.replace(tcfg, amp_stoch=amp)
        out[amp] = tqg.make_step(cfg, torch.Generator().manual_seed(11))(
            ts, tc, 1e9)
    dt = float(out[A][1].dt)
    pred = tqg.comp_q(tcfg, tc, out[A][0].psi - out[0.0][0].psi).numpy()
    corr = (out[A][0].q - out[0.0][0].q).numpy()
    noise = tqg.draw_noise(tcfg, tc, ts.q,
                           torch.Generator().manual_seed(11)).numpy()
    assert _rel(pred, noise * np.sqrt(dt) / 2) < 1e-10
    shares["port"] = (pred, corr, dt)
    # the JAX package
    jc = jqg.build_constants(jcfg, s_stoch=sigma)
    js = jqg.init_state(jcfg, jc, psi0=psi0)
    jout = {}
    for amp in (A, 0.0):
        cfg = dataclasses.replace(jcfg, amp_stoch=amp)
        jout[amp] = jax.jit(jqg.make_step(cfg))(js, jc, jnp.asarray(1e9))
    jdt = float(jout[A][1].dt)
    jpred = np.asarray(jqg.comp_q(jcfg, jc, jout[A][0].psi
                                  - jout[0.0][0].psi))
    shares["jax"] = (jpred, np.asarray(jout[A][0].q - jout[0.0][0].q), jdt)
    assert abs(dt - jdt) <= 1e-12 * jdt
    for who, (p, c, d) in shares.items():
        xi = 2 * p / (A * sigma * np.sqrt(d))
        assert abs(xi.mean()) < 4 / np.sqrt(n), (who, xi.mean())
        assert abs(xi.std() - 1) < 4 / np.sqrt(2 * n), (who, xi.std())
        assert np.abs(c - 2 * p).max() < 1e-2 * np.abs(c).max(), who
    # the two draws are different numbers
    assert _rel(shares["port"][0], shares["jax"][0]) > 0.5


def test_seeded_generator_gives_the_same_trajectory_twice():
    _, tcfg = _verron(N=32, amp_stoch=1e-4, **STOCH)
    const = tqg.build_constants(tcfg, device="cpu")
    runs = []
    for seed in (5, 5, 6):
        state = tqg.init_state(tcfg, const, seed=0)
        step = tqg.make_step(tcfg, torch.Generator().manual_seed(seed))
        for _ in range(3):
            state, _ = step(state, const, 1e9)
        runs.append(state.q)
    assert torch.equal(runs[0], runs[1])
    assert not torch.equal(runs[0], runs[2])


def test_stochastic_step_needs_a_generator_on_the_state_device():
    _, tcfg = _verron(N=16, **STOCH)
    with pytest.raises(ValueError, match="Generator"):
        tqg.make_step(tcfg)
    const = tqg.build_constants(tcfg, device="cpu")
    q = torch.zeros((3, 16, 16), dtype=torch.float64, device="meta")
    with pytest.raises(ValueError, match="generator"):
        tqg.draw_noise(tcfg, const, q, torch.Generator())
