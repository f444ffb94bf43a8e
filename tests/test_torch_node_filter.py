"""The port's qg-node filter event (models/qg_node.wavelet_filter, the
masked wavelet filter with its eddy/mean split, qg_baroclinic_ms.h:345-400)
and its constants against the JAX package, in float64 on the CPU.

The filter constants: the low-pass pyramid sig_lev_c from the y-ramp of
Lfmax/Lfmin and from fac_filt_Rd with S2 averaged to cells, and the
fractional centred-mask pyramid mask_c, bit for bit (both sides round the
same float64 numpy arrays to the working type). The event: the walled grid
with the default mask, with bench.py's coastline mask and solver="vmg",
and the periodic grid (bc_fac = -1), two events with three steps between
them, so psi_f's running mean takes its second event; psi, q and psi_f
within 1e-11 of their maxima. The deck's stratification is milder than
tests/test_torch_node_step.py's (f0 = 10, S2 = 100 and 50): there the
inversion's conditioning limits psi to 5e-11."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from msom_tpu.models import qg_node as jqn
from msom_tpu_torch.models import fused_node_rhs
from msom_tpu_torch.models import qg_node as tqn

torch.set_num_threads(1)

LIMIT = 1e-11


def _kw(**kw):
    base = dict(N=32, nl=3, L0=100.0, f0=10.0, beta=0.5, hEkb=1e-3,
                tau0=1e-3, tau1=5e-4, tf1=2.0, tf2=3.0, dy_ws=0.3, nu=5.0,
                dh=(0.2, 0.3, 0.5), N2=(1.0, 2.0), noise_init=1e-3,
                bc_fac=1.0, DT=5e-2, tend=10.0, dtout=10.0, CFL=0.2,
                TOLERANCE=1e-10, dtflt=1.0, Lfmax=30.0, Lfmin=10.0,
                dtype="float64", use_pallas=False)
    base.update(kw)
    return base


def _psi0(cfg, seed=7):
    n = cfg.N if cfg.periodic else cfg.N + 1
    rng = np.random.default_rng(seed)
    y = np.arange(n)[:, None] * cfg.delta
    return cfg.noise_init * (rng.uniform(-1, 1, (cfg.nl, n, n))
                             + np.sin(2 * np.pi * y / cfg.L0))


def _rel(got, want):
    want = np.asarray(want)
    return np.abs(got.numpy() - want).max() / np.abs(want).max()


def _both(kw, inputs=None):
    inputs = inputs or {}
    jcfg, tcfg = jqn.NodeQGConfig(**kw), tqn.NodeQGConfig(**kw)
    return (jcfg, jqn.build_constants(jcfg, **inputs), tcfg,
            tqn.build_constants(tcfg, device="cpu", **inputs))


@pytest.mark.parametrize("lf", ["ramp", "fac_filt_Rd", "periodic"])
def test_filter_constants_match_jax(lf):
    over = {"ramp": {}, "fac_filt_Rd": dict(fac_filt_Rd=500.0),
            "periodic": dict(bc_fac=-1.0)}[lf]
    inputs = {} if lf == "periodic" else dict(mask=tqn.coastline_mask(32))
    if lf == "fac_filt_Rd":
        # an N2 field, so that S2's average to the cells varies
        y = np.arange(33) / 32
        inputs["N2"] = (1.0 + 0.5 * np.sin(3 * y)[:, None]
                        * np.cos(2 * y)[None, :]) * np.ones((2, 1, 1))
    jcfg, jc, tcfg, tc = _both(_kw(solver="vmg", **over), inputs)
    assert len(tc.sig_lev_c) == len(jc.sig_lev_c) == 6
    for got, want in zip(tc.sig_lev_c, jc.sig_lev_c):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    if lf == "periodic":
        assert tc.mask_c is None and jc.mask_c is None
        return
    for got, want in zip(tc.mask_c, jc.mask_c):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # fractional at the coast, and both branches pass (nothing all 0 or 1)
    fine = tc.mask_c[-1].numpy()
    assert ((fine > 0) & (fine < 1)).any()
    assert 0 < tc.sig_lev_c[-2].numpy().mean() < 1


def test_filter_constants_follow_the_working_type():
    kw = _kw(dtype="float32", fac_filt_Rd=500.0)
    jcfg, jc, tcfg, tc = _both(kw, dict(mask=tqn.coastline_mask(32)))
    for got, want in zip(tc.sig_lev_c + tc.mask_c,
                         jc.sig_lev_c + jc.mask_c):
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_filter_refuses_what_its_pyramid_cannot_take():
    cfg = tqn.NodeQGConfig(**_kw(nl=1, dh=(1.0,), N2=(1.0,),
                                 fac_filt_Rd=0.5))
    with pytest.raises(ValueError, match="fac_filt_Rd"):
        tqn.build_constants(cfg, device="cpu")
    for over in (dict(N=24), dict(N=24, dtflt=-1.0, stochastic=True,
                                  L_filt_stoch=5.0)):
        with pytest.raises(ValueError, match="power of 2"):
            tqn.build_constants(tqn.NodeQGConfig(**_kw(**over)),
                                device="cpu")
    tqn.build_constants(tqn.NodeQGConfig(**_kw(N=24, dtflt=-1.0)),
                        device="cpu")


@pytest.mark.parametrize("grid", ["walled", "coastline", "periodic"])
def test_wavelet_filter_matches_jax(grid):
    over = {"walled": {}, "coastline": dict(solver="vmg"),
            "periodic": dict(bc_fac=-1.0)}[grid]
    inputs = dict(mask=tqn.coastline_mask(32)) if grid == "coastline" \
        else {}
    jcfg, jc, tcfg, tc = _both(_kw(**over), inputs)
    psi0 = _psi0(tcfg)
    js = jqn.init_state(jcfg, jc, psi0=psi0)
    ts = tqn.init_state(tcfg, tc, psi0=psi0)
    jstep = jax.jit(jqn.make_step(jcfg))
    tstep = tqn.make_step(tcfg)
    tnext = jnp.asarray(1e18, jnp.float64)
    for event in (1, 2):
        js = jqn.wavelet_filter(jcfg, jc, js)
        ts = tqn.wavelet_filter(tcfg, tc, ts)
        assert int(ts.nbar) == int(js.nbar) == event
        assert ts.nbar.dtype == torch.int32
        for name in ("psi", "q", "psi_f"):
            r = _rel(getattr(ts, name), getattr(js, name))
            assert r < LIMIT, f"event {event}: rel {name} = {r:.3e}"
        for _ in range(3):
            js, _ = jstep(js, jc, tnext)
            ts, _ = tstep(ts, tc, 1e18)
    # the event takes the large scales out: psi_loc = dtflt psi_f is a
    # sizeable part of psi, and the walled psi stays zero off the mask
    assert float(ts.psi_f.abs().max()) > 0.1 * float(ts.psi.abs().max())
    if grid != "periodic":
        assert not (ts.psi * (1 - tc.mask)).any()


def test_filter_keeps_the_state_on_its_device_and_type():
    kw = _kw(dtype="float32")
    tcfg = tqn.NodeQGConfig(**kw)
    tc = tqn.build_constants(tcfg, device="cpu")
    ts = tqn.wavelet_filter(tcfg, tc, tqn.init_state(tcfg, tc, seed=1))
    for name in ("psi", "q", "psi_f"):
        assert getattr(ts, name).dtype == torch.float32
        assert getattr(ts, name).shape == (3, 33, 33)


def test_k5_refuses_the_periodic_grid():
    """The walled kernel's wrapper refuses a periodic config on either
    device (rhs_pv sends it to the periodic torch ops)."""
    tcfg = tqn.NodeQGConfig(**_kw(bc_fac=-1.0))
    tc = tqn.build_constants(tcfg, device="cpu")
    psi = torch.zeros((3, 32, 32), dtype=torch.float64)
    qf = torch.zeros(32, dtype=torch.float64)
    with pytest.raises(ValueError, match="periodic"):
        fused_node_rhs.rhs_fused_node(tcfg, tc, psi, psi, qf)
    before = fused_node_rhs.launches
    dq = tqn.rhs_pv(tcfg, tc, psi, psi, torch.tensor(0.0,
                                                     dtype=torch.float64))
    assert dq.shape == psi.shape and fused_node_rhs.launches == before
    walled = dataclasses.replace(tcfg, bc_fac=1.0)
    assert not walled.periodic
